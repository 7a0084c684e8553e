"""The port's language detection, word timestamps, forced alignment and
previous-text conditioning against the JAX package's.

Language detection on the trained ``tests/fixtures/whisper_multilingual``
must give the golden ``detected``, ``auto_text`` and ``auto_language``,
with probabilities within 1e-3 of JAX's. The rest runs on
``tests/fixtures/whisper_tiny`` in f32: DTW paths equal to the JAX
package's Python DP (its C++ twin accumulates in float32, so it is
switched off here), word text exact, word times within 1e-6 and word
probabilities within ``AUX_TOL["f32"]`` (``tests/test_torch_pipeline.py``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yoho_tpu.native
from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer import word_timestamps as jax_wt
from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
from yoho_tpu.nn.layers import realized_token_probs as jax_rtp
from yoho_tpu.nn.layers import realized_token_probs_streamed as jax_rtp_streamed
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer import word_timestamps as wt
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.nn.layers import realized_token_probs, realized_token_probs_streamed
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

FIXTURES = Path(__file__).parent / "fixtures"
AUX_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=5e-2, atol=1e-4)}


class _PieceBackend:
    """The fixtures' word vocabulary as a BPE-like backend: every word is
    one token whose piece carries the leading-space marker."""

    def __init__(self, word_ids):
        self.word_ids = {k: int(v) for k, v in word_ids.items()}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)

    def convert_ids_to_tokens(self, ids):
        return ["Ġ" + self.id_words.get(int(i), "?") for i in ids]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU: one intra-op thread keeps the eager
    decode loops from oversubscribing it (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone_clip(hz: float, n_samples: int) -> np.ndarray:
    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002
             ).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * hz * np.arange(int(0.25 * 16000)) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


class _Fixture:
    """One trained fixture in both packages: ``pair(**kw)`` builds a JAX
    and a port Transcriber with the same options."""

    def __init__(self, name, dtype):
        fx = FIXTURES / name
        self.cfg = json.loads((fx / "config.json").read_text())
        self.golden = json.loads((fx / "golden.json").read_text())
        self.words = json.loads((fx / "word_vocab.json").read_text())
        jcfg = JaxConfig(**self.cfg)
        template = jax.eval_shape(
            JaxWhisper(jcfg).init, jax.random.PRNGKey(0),
            jnp.zeros((1, jcfg.n_frames, jcfg.n_mels), jnp.float32),
            jnp.zeros((1, 4), jnp.int32))["params"]
        template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
        self.params = jax.device_get(load_params(fx / "params.msgpack", template))
        self.jdtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
        self.model = load_jax_params(Whisper(WhisperConfig(**self.cfg), dtype={
            "f32": torch.float32, "bf16": torch.bfloat16}[dtype], device="cpu"), self.params)
        self.n = jcfg.n_samples

    def jax_model(self):
        return JaxWhisper(JaxConfig(**self.cfg), dtype=self.jdtype)

    def pair(self, **kw):
        jt = JaxTranscriber(self.jax_model(), {"params": self.params}, family="whisper",
                            token_table=JaxTable(multilingual=True,
                                                 text_backend=_PieceBackend(self.words)),
                            **kw)
        tt = Transcriber(self.model, token_table=WhisperTokenTable(
            multilingual=True, text_backend=_PieceBackend(self.words)), device="cpu", **kw)
        return jt, tt


@pytest.fixture(scope="module")
def multilingual():
    return _Fixture("whisper_multilingual", "bf16")


@pytest.fixture(scope="module")
def multilingual_f32():
    return _Fixture("whisper_multilingual", "f32")


@pytest.fixture(scope="module")
def tiny():
    return _Fixture("whisper_tiny", "f32")


@pytest.fixture
def python_dtw(monkeypatch):
    """The JAX package's DTW through its Python DP (the reference the
    port's wavefront follows), not its float32 C++ twin."""
    monkeypatch.setattr(yoho_tpu.native, "dtw_path_native", lambda cost: None)


def test_detect_language_matches_golden_and_jax(multilingual, multilingual_f32):
    """Float clips in bf16, and the same clips as int16 PCM: detection casts
    an array to float32 as it is, as the JAX package does (no PCM scaling).
    The int16 case runs in f32: its probabilities sit near 0.6, where the
    documented bf16 rounding difference of the two packages (ROADMAP.md,
    reference tolerances) moves them by more than the pin."""
    for fx, pcm in ((multilingual, False), (multilingual_f32, True)):
        jt, tt = fx.pair(batch_size=1, timestamps=False, language=None)
        for s in fx.golden["samples"]:
            audio = _tone_clip(s["tone"], fx.n)
            if pcm:
                audio = np.round(audio * 32767).astype(np.int16)
            lang, probs = tt.detect_language(audio)
            want_lang, want_probs = jt.detect_language(audio)
            assert lang == want_lang
            if not pcm:
                assert lang == s["detected"]
            assert probs[lang] == pytest.approx(want_probs[lang], abs=1e-3)
            assert abs(sum(probs.values()) - 1.0) < 1e-3


def test_language_auto_detection_transcripts(multilingual):
    """``language=None``: ``detect_language_many`` and ``transcribe_many``
    detect every request in one shared batch, and transcribe it in its
    language; a request with an override is not detected."""
    fx = multilingual
    jt, tt = fx.pair(batch_size=4, timestamps=False, language=None)
    samples = fx.golden["samples"]
    clips = [_tone_clip(s["tone"], fx.n) for s in samples]
    langs, probs = tt.detect_language_many(clips + [np.zeros(0, np.float32)],
                                           return_probs=True)
    assert langs == [s["detected"] for s in samples] + ["en"] and probs[-1] is None
    got, want = tt.transcribe_many(clips), jt.transcribe_many(clips)
    assert [(r.text, r.language) for r in got] == \
        [(s["auto_text"], s["auto_language"]) for s in samples]
    for g, w in zip(got, want):
        assert g.language_probability == pytest.approx(w.language_probability, abs=1e-3)
    mixed = tt.transcribe_many(clips[2:], languages=["de", None])
    assert [r.language_probability is None for r in mixed] == [True, False]


@pytest.mark.parametrize("kind", ["random", "ties", "row", "column"])
def test_dtw_matches_the_python_dp(python_dtw, kind):
    g = np.random.default_rng(3)
    cost = {"random": lambda: g.standard_normal((9, 31)),
            "ties": lambda: g.integers(0, 2, size=(12, 20)).astype(np.float64),
            "row": lambda: g.standard_normal((1, 7)),
            "column": lambda: g.standard_normal((6, 1))}[kind]()
    for got, want in zip(wt.dtw_path(cost), jax_wt.dtw_path(cost)):
        np.testing.assert_array_equal(got, want)
    attn = np.abs(cost).astype(np.float32)
    np.testing.assert_array_equal(wt.token_frame_alignment(attn),
                                  jax_wt.token_frame_alignment(attn))


def test_words_match_jax():
    """``split_words`` and ``words_from_alignment``: boundaries at pieces
    with a leading space, both ends clamped, word probability the mean of
    its tokens."""
    pieces = {1: " hel", 2: "lo", 3: " wor", 4: "ld", 5: " !", 6: " again"}

    def decode(ids):
        return "".join(pieces[i] for i in ids)

    ids = [1, 2, 3, 4, 5, 6]
    frames = np.array([0, 3, 9, 20, 40, 49])
    probs = np.array([0.5, 0.25, 0.9, 0.8, 0.1, 0.3])
    assert wt.split_words(ids, decode) == jax_wt.split_words(ids, decode)
    for kw in (dict(max_duration=0.95, probs=probs), dict(), dict(decode_group=decode)):
        got = wt.words_from_alignment(ids, frames, 0.02, decode, **kw)
        want = jax_wt.words_from_alignment(ids, frames, 0.02, decode, **kw)
        assert [vars(w) for w in got] == [vars(w) for w in want]


def test_realized_token_probs_match_jax():
    g = np.random.default_rng(4)
    h = g.standard_normal((3, 19, 8)).astype(np.float32)
    w = g.standard_normal((8, 13)).astype(np.float32)
    tokens = g.integers(0, 13, size=(3, 19))
    want = np.asarray(jax_rtp(jnp.asarray(h @ w), jnp.asarray(tokens)))
    np.testing.assert_allclose(
        realized_token_probs(torch.from_numpy(h @ w), torch.from_numpy(tokens)).numpy(),
        want, rtol=1e-5, atol=1e-7)
    streamed = realized_token_probs_streamed(
        torch.from_numpy(h), lambda hc: hc @ torch.from_numpy(w), torch.from_numpy(tokens),
        chunk=4)
    np.testing.assert_allclose(streamed.numpy(), np.asarray(jax_rtp_streamed(
        jnp.asarray(h), lambda hc: hc @ jnp.asarray(w), jnp.asarray(tokens), chunk=4)),
        rtol=1e-5, atol=1e-7)


def test_cross_attention_map_matches_jax(tiny):
    """The teacher-forced alignment pass (flash for the causal
    self-attention and the cross-attention, the head-averaged weights of the
    upper layers in plain PyTorch) equals JAX's in f32."""
    g = np.random.default_rng(5)
    cfg = WhisperConfig(**tiny.cfg)
    xa = g.standard_normal((2, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32)
    tokens = g.integers(0, 2000, size=(2, cfg.n_text_ctx))
    with torch.inference_mode():
        amap, probs = tiny.model.cross_attention_map(torch.from_numpy(tokens),
                                                     torch.from_numpy(xa), True)
    jm = tiny.jax_model()
    want_map, want_probs = jm.apply({"params": tiny.params}, jnp.asarray(tokens),
                                    jnp.asarray(xa), True,
                                    method=type(jm).cross_attention_map)
    assert amap.shape == (2, cfg.n_text_ctx, cfg.n_audio_ctx)
    np.testing.assert_allclose(amap.numpy(), np.asarray(want_map), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), rtol=1e-4, atol=1e-7)


def _words_of(results):
    return [[(w.word, w.start, w.end, w.probability) for s in r.segments
             for w in (s.words or [])] for r in results]


def _assert_words_equal(got, want):
    assert [[w[0] for w in r] for r in got] == [[w[0] for w in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.array([x[1:3] for x in g]).reshape(-1, 2),
                                   np.array([x[1:3] for x in w]).reshape(-1, 2),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose([x[3] for x in g], [x[3] for x in w], **AUX_TOL["f32"])


def test_word_timestamps_match_jax(tiny, python_dtw):
    """``word_timestamps=True`` through ``transcribe_many`` (three golden
    clips and a long request in batches of 2, one per-request prompt)."""
    kw = dict(batch_size=2, word_timestamps=True, overlap_seconds=0.25)
    jt, tt = tiny.pair(**kw)
    clips = [_tone_clip(hz, tiny.n) for hz in tiny.golden["tones"]]
    audios = clips + [np.concatenate(clips)]
    prompts = [None, "hello world", None, None]
    got = tt.transcribe_many(audios, prompts=prompts)
    want = jt.transcribe_many(audios, prompts=prompts)
    assert [r.text for r in got] == [r.text for r in want]
    words = _words_of(got)
    assert sum(len(w) for w in words) >= 6
    _assert_words_equal(words, _words_of(want))


def test_align_and_align_many_match_jax(tiny, python_dtw):
    jt, tt = tiny.pair(batch_size=2, timestamps=False)
    clips = [_tone_clip(hz, tiny.n) for hz in tiny.golden["tones"]]
    pairs = list(zip(clips, tiny.golden["sentences"]))
    got = [tt.align(*pairs[0])] + tt.align_many(pairs)
    want = [jt.align(*pairs[0])] + jt.align_many(pairs)
    _assert_words_equal([[(w.word, w.start, w.end, w.probability) for w in r] for r in got],
                        [[(w.word, w.start, w.end, w.probability) for w in r] for r in want])
    with pytest.raises(ValueError, match="one window"):
        tt.align(np.zeros(2 * tiny.n, np.float32), "hello")
    with pytest.raises(FileNotFoundError, match="no such audio file"):
        tt.align("no-such-clip.wav", "hello")


def test_condition_on_previous_text_matches_jax(tiny, python_dtw):
    """Window by window on a long clip: the conditioned prompts (a fixed
    budget of the history), the segments and their words equal JAX's."""
    kw = dict(batch_size=1, condition_on_previous_text=True, initial_prompt="thank you",
              word_timestamps=True)
    jt, tt = tiny.pair(**kw)
    tones = tiny.golden["tones"]
    long_clip = np.concatenate([_tone_clip(tones[i % 3], tiny.n) for i in range(5)])
    got, want = tt.transcribe(long_clip), jt.transcribe(long_clip)
    assert got.text == want.text and got.text
    assert [(s.start, s.end, s.text, s.tokens) for s in got.segments] == \
        [(s.start, s.end, s.text, s.tokens) for s in want.segments]
    _assert_words_equal(_words_of([got]), _words_of([want]))
    # Two prompt lengths: the base prompt and the conditioned one.
    assert {k[3] for k in tt._programs} == {k[3] for k in jt._jitted
                                            if isinstance(k, tuple) and len(k) == 4}
    assert len(tt._programs) == 2
    for tr in (jt, tt):
        with pytest.raises(ValueError, match="condition_on_previous_text"):
            tr.transcribe(long_clip, prompt="hello")
        with pytest.raises(ValueError, match="condition_on_previous_text"):
            tr.transcribe_many([long_clip], temperatures=[0.3])
