"""The port's Transcriber against the committed goldens and the JAX
Transcriber (the ``tests/test_whisper_fixture.py`` pattern).

Transcripts must be exact: ``whisper_tiny/golden.json`` for bf16, int8
and int4 cross-K/V, ``whisper_multilingual/golden.json`` for explicit
language transcribe and translate; with timestamps on, the token streams
and segments equal the JAX Transcriber's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

FIXTURES = Path(__file__).parent / "fixtures"


class _WordBackend:
    def __init__(self, word_ids):
        self.word_ids = {k: int(v) for k, v in word_ids.items()}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)


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


def _load(name):
    """(config dict, golden, word vocab, flax params as numpy)."""
    fx = FIXTURES / name
    cfg = json.loads((fx / "config.json").read_text())
    jcfg = JaxConfig(**cfg)
    template = jax.eval_shape(
        JaxWhisper(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jcfg.n_frames, jcfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = jax.device_get(load_params(fx / "params.msgpack", template))
    return (cfg, json.loads((fx / "golden.json").read_text()),
            json.loads((fx / "word_vocab.json").read_text()), params)


@pytest.fixture(scope="module")
def tiny():
    cfg, golden, words, params = _load("whisper_tiny")
    model = load_jax_params(Whisper(WhisperConfig(**cfg), dtype=torch.bfloat16,
                                    device="cpu"), params)
    table = WhisperTokenTable(multilingual=True, text_backend=_WordBackend(words))
    return cfg, golden, words, params, model, table


@pytest.fixture(scope="module")
def multilingual():
    cfg, golden, words, params = _load("whisper_multilingual")
    model = load_jax_params(Whisper(WhisperConfig(**cfg), dtype=torch.bfloat16,
                                    device="cpu"), params)
    table = WhisperTokenTable(multilingual=True, text_backend=_WordBackend(words))
    return cfg, golden, model, table


@pytest.mark.parametrize("quant,key", [(False, "bf16"), ("int8", "bf16"),
                                       ("int4", "int4")])
def test_tiny_golden_transcripts(tiny, quant, key):
    cfg, golden, _, _, model, table = tiny
    t = Transcriber(model, token_table=table, batch_size=1, timestamps=False,
                    quantized_cross_kv=quant, quantized_cache=True, device="cpu")
    n = WhisperConfig(**cfg).n_samples
    texts = [t.transcribe(_tone_clip(golden["tones"][i], n)).text for i in range(3)]
    assert texts == golden["texts"][key] == golden["sentences"]


def test_tiny_golden_batched(tiny):
    """One padded batch of 4 serves the 3 clips (the micro-batching path)."""
    cfg, golden, _, _, model, table = tiny
    t = Transcriber(model, token_table=table, batch_size=4, timestamps=False,
                    quantized_cross_kv="int8", quantized_cache=True, device="cpu")
    n = WhisperConfig(**cfg).n_samples
    res = t.transcribe_many([_tone_clip(hz, n) for hz in golden["tones"]])
    assert [r.text for r in res] == golden["sentences"]


def test_multilingual_transcribe_and_translate(multilingual):
    cfg, golden, model, table = multilingual
    n = WhisperConfig(**cfg).n_samples
    for s in golden["samples"]:
        clip = _tone_clip(s["tone"], n)
        t = Transcriber(model, token_table=table, batch_size=1, timestamps=False,
                        language=s["language"], device="cpu")
        res = t.transcribe(clip)
        assert res.text == s["text"] and res.language == s["language"]
        if "translated" in s:
            tr = Transcriber(model, token_table=table, batch_size=1,
                             timestamps=False, language=s["language"],
                             task="translate", device="cpu")
            assert tr.transcribe(clip).text == s["translated"]


def test_multilingual_per_request_languages(multilingual):
    """Mixed-language requests share one batch through per-request
    language overrides."""
    cfg, golden, model, table = multilingual
    n = WhisperConfig(**cfg).n_samples
    t = Transcriber(model, token_table=table, batch_size=4, timestamps=False,
                    device="cpu")
    res = t.transcribe_many([_tone_clip(s["tone"], n) for s in golden["samples"]],
                            languages=[s["language"] for s in golden["samples"]])
    assert [r.text for r in res] == [s["text"] for s in golden["samples"]]


def _jax_transcriber(tiny, dtype=jnp.bfloat16, **kw):
    from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
    from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable

    cfg, _, words, params, _, _ = tiny
    model = JaxWhisper(JaxConfig(**cfg), dtype=dtype)
    table = JaxTable(multilingual=True, text_backend=_WordBackend(words))
    return JaxTranscriber(model, {"params": params}, family="whisper",
                          token_table=table, **kw)


# Quality signals in bf16 differ by ~2% between the packages: the two
# frameworks round bf16 activations at different places (one rounding per
# fused linear here, matmul then bias there), which moves each logprob by
# a few bf16 ulps; tokens stay equal. In f32 they agree to 1e-4.
AUX_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=5e-2, atol=1e-4)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_timestamped_token_streams_match_jax(tiny, dtype):
    """Timestamps on (the default): the decode program's tokens, lengths
    and quality signals equal the JAX Transcriber's on the same mel."""
    cfg, golden, _, params, model, table = tiny
    if dtype == "f32":
        model = load_jax_params(Whisper(WhisperConfig(**cfg), device="cpu"), params)
    kw = dict(batch_size=3, quantized_cross_kv="int8", quantized_cache=True)
    jt = _jax_transcriber(tiny, {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype], **kw)
    tt = Transcriber(model, token_table=table, device="cpu", **kw)
    n = WhisperConfig(**cfg).n_samples
    wins = np.stack([_tone_clip(hz, n) for hz in golden["tones"]])
    mel = np.array(jt._features(jnp.asarray(wins)))
    want, want_len, want_aux = jt._decode_fn(3)(jt.variables, jnp.asarray(mel))
    got, got_len, got_aux = tt._decode_fn(3)(torch.from_numpy(mel))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_len, np.asarray(want_len))
    for k in ("sum_logprob", "no_speech_prob"):
        np.testing.assert_allclose(got_aux[k], np.asarray(want_aux[k]), **AUX_TOL[dtype])
    assert (got[:, 3] >= table.timestamp_begin).all()  # timestamps were decoded


def test_timestamped_segments_match_jax(tiny):
    """End to end through each package's own frontend: same text and the
    same segment times for a long request (three overlapping windows)."""
    cfg, golden, _, _, model, table = tiny
    kw = dict(batch_size=2, quantized_cross_kv="int8", quantized_cache=True,
              overlap_seconds=0.25)
    n = WhisperConfig(**cfg).n_samples
    long_clip = np.concatenate([_tone_clip(hz, n) for hz in golden["tones"]])
    audios = [long_clip, _tone_clip(golden["tones"][1], n // 2)]
    want = _jax_transcriber(tiny, **kw).transcribe_many(audios)
    got = Transcriber(model, token_table=table, device="cpu", **kw).transcribe_many(audios)
    for g, w in zip(got, want):
        assert g.text == w.text
        assert [(s.start, s.end, s.text, s.tokens) for s in g.segments] == \
            [(s.start, s.end, s.text, s.tokens) for s in w.segments]


def test_per_request_prompt_matches_jax(tiny):
    """A per-request <|startofprev|> context (padded to the fixed budget)
    gives the JAX Transcriber's transcript and segments."""
    cfg, golden, _, _, model, table = tiny
    kw = dict(batch_size=2, timestamps=False, quantized_cross_kv="int8",
              quantized_cache=True)
    n = WhisperConfig(**cfg).n_samples
    audios = [_tone_clip(hz, n) for hz in golden["tones"][:2]]
    prompts = ["hello world", None]
    want = _jax_transcriber(tiny, **kw).transcribe_many(audios, prompts=prompts)
    got = Transcriber(model, token_table=table, device="cpu", **kw).transcribe_many(
        audios, prompts=prompts)
    assert [(g.text, [s.tokens for s in g.segments]) for g in got] == \
        [(w.text, [s.tokens for s in w.segments]) for w in want]


def test_sampling_rungs_are_seeded(tiny):
    """Temperature sampling draws from a seeded torch.Generator: the same
    call twice gives the same tokens, and segments record the rung."""
    cfg, golden, _, _, model, table = tiny
    t = Transcriber(model, token_table=table, batch_size=2, timestamps=False,
                    temperatures=(0.7,), best_of=2, device="cpu")
    n = WhisperConfig(**cfg).n_samples
    audios = [_tone_clip(hz, n) for hz in golden["tones"][:2]]
    first, second = t.transcribe_many(audios), t.transcribe_many(audios)
    assert [[s.tokens for s in r.segments] for r in first] == \
        [[s.tokens for s in r.segments] for r in second]
    segs = [s for r in first for s in r.segments]
    assert segs and all(s.temperature == pytest.approx(0.7) for s in segs)


@pytest.mark.parametrize("kw", [
    {"mesh": object()}, {"family": "yoho"}, {"diarize_encoder": object()},
    {"diarize_variables": object()}, {"enrolled_speakers": {"a": [0.0]}},
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(tiny, kw):
    _, _, _, _, model, table = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item"):
        Transcriber(model, token_table=table, device="cpu", **kw)
