"""The port's beam search and logit rules against the JAX package's.

On the trained ``tests/fixtures/whisper_tiny`` (n_text_ctx 32), the same
mel through both packages' decode programs: beam tokens and lengths
exact, the best beam's summed and length-penalized scores within 1e-4 in
f32, and within ``AUX_TOL`` (``tests/test_torch_pipeline.py``) in bf16 with
int8 cross-K/V and cache. The folded cross read, the ``lax.top_k`` tie
order, the cache reorder and the repetition rules are held to JAX's on
constructed inputs.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.beam import _gather_beams as jax_gather_beams
from yoho_tpu.infer.beam import tile_beams as jax_tile_beams
from yoho_tpu.infer.logit_rules import make_repetition_rules as jax_rep_rules
from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
from yoho_tpu.nn.layers import _fold_queries as jax_fold_queries
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.beam import _gather_beams, tile_beams, top_k
from yoho_tpu_torch.infer.logit_rules import make_repetition_rules
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.nn.kv_cache import QuantizedKVCache
from yoho_tpu_torch.nn.layers import _fold_queries
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

FIXTURE = Path(__file__).parent / "fixtures" / "whisper_tiny"
CFG = json.loads((FIXTURE / "config.json").read_text())
GOLDEN = json.loads((FIXTURE / "golden.json").read_text())
WORDS = json.loads((FIXTURE / "word_vocab.json").read_text())
# As tests/test_torch_pipeline.py pins them: bf16 rounds at other places in
# the two frameworks (a few ulps per logprob); f32 agrees to 1e-4.
AUX_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=5e-2, atol=1e-4)}


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


@pytest.fixture(scope="module")
def tiny():
    """(flax params, port models by dtype, the three golden clips' mel)."""
    jcfg = JaxConfig(**CFG)
    template = jax.eval_shape(
        JaxWhisper(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jcfg.n_frames, jcfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = jax.device_get(load_params(FIXTURE / "params.msgpack", template))
    models = {d: load_jax_params(Whisper(WhisperConfig(**CFG), dtype=td, device="cpu"),
                                 params)
              for d, td in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    wins = np.stack([_tone_clip(hz, jcfg.n_samples) for hz in GOLDEN["tones"]])
    return params, models, wins


def _jax(tiny, dtype="f32", **kw):
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    return JaxTranscriber(JaxWhisper(JaxConfig(**CFG), dtype=jd), {"params": tiny[0]},
                          family="whisper", token_table=JaxTable(
                              multilingual=True, text_backend=_WordBackend(WORDS)), **kw)


def _port(tiny, dtype="f32", **kw):
    return Transcriber(tiny[1][dtype], token_table=WhisperTokenTable(
        multilingual=True, text_backend=_WordBackend(WORDS)), device="cpu", **kw)


def _pair(tiny, dtype="f32", **kw):
    """A JAX and a port Transcriber with the same options."""
    return _jax(tiny, dtype, **kw), _port(tiny, dtype, **kw)


def _decode_both(jt, tt, wins):
    mel = np.array(jt._features(jnp.asarray(wins)))
    want = jt._decode_fn(len(wins))(jt.variables, jnp.asarray(mel))
    got = tt._decode_fn(len(wins))(torch.from_numpy(mel))
    return got, [np.asarray(w) if not isinstance(w, dict) else
                 {k: np.asarray(v) for k, v in w.items()} for w in want]


@pytest.mark.parametrize("dtype,beams,length_penalty", [
    ("f32", 2, 0.0), ("f32", 2, 1.0), ("f32", 3, 0.0), ("f32", 3, 1.0),
    ("bf16", 2, 1.0), ("bf16", 3, 0.0)])
def test_beam_decode_matches_jax(tiny, dtype, beams, length_penalty):
    """Tokens and lengths exact; the best beam's raw summed logprob and its
    length-penalized score within the pinned tolerance (bf16 cases run int8
    cross-K/V and the int8 cache, the serving lane)."""
    kw = dict(batch_size=3, beams=beams, length_penalty=length_penalty)
    if dtype == "bf16":
        kw.update(quantized_cross_kv="int8", quantized_cache=True)
    jt, tt = _pair(tiny, dtype, **kw)
    (got, got_len, got_aux), (want, want_len, want_aux) = _decode_both(jt, tt, tiny[2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    for k in ("sum_logprob", "no_speech_prob"):
        np.testing.assert_allclose(got_aux[k], want_aux[k], **AUX_TOL[dtype])
    p = len(tt._prompt_ids())

    def penalized(aux, lengths):
        return aux["sum_logprob"] / ((5.0 + (lengths - p)) / 6.0) ** length_penalty

    np.testing.assert_allclose(penalized(got_aux, got_len), penalized(want_aux, want_len),
                               **AUX_TOL[dtype])
    assert (got[:, p] >= tt.token_table.timestamp_begin).all()


def test_beams_bypass_the_fallback_ladder(tiny):
    """With beams > 1 the ladder and best_of do not run (as in JAX): every
    window ends on the first rung, and one program was built."""
    tt = _port(tiny, batch_size=3, beams=2, temperatures=(0.0, 0.4, 0.8), best_of=3,
               logprob_threshold=0.0)
    _, _, aux = tt._decode_with_fallback(3, tt._features(tiny[2]))
    assert (aux["used_temperature"] == 0.0).all() and len(tt._programs) == 1


@pytest.mark.parametrize("quantized", [False, True])
def test_folded_cross_read_equals_tiled_and_jax(tiny, quantized):
    """One decode step of B*K rows: against the untiled (B) cross-K/V
    (queries folded) equals the same step against K-tiled cross-K/V, in the
    port and in JAX, and the two packages agree."""
    params, models, _ = tiny
    model, cfg = models["f32"], WhisperConfig(**CFG)
    jm = JaxWhisper(JaxConfig(**CFG))
    b, k, p = 2, 3, 4
    g = np.random.default_rng(0)
    xa = g.standard_normal((b, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32)
    toks = g.integers(0, 1000, size=(b * k, p))
    quant = "int8" if quantized else False
    with torch.inference_mode():
        ckv = model.cross_kvs(torch.from_numpy(xa), quant)
        outs = [model.decode_step(torch.from_numpy(toks), model.init_caches(b * k), c, 0)[0]
                for c in (ckv, tile_beams(ckv, k))]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    var = {"params": params}
    jckv = jm.apply(var, jnp.asarray(xa), quant, method=type(jm).cross_kvs)
    jcaches = jm.apply(var, b * k, None, None, method=type(jm).init_caches)
    want = jm.apply(var, jnp.asarray(toks), jcaches, jckv, 0,
                    method=type(jm).decode_step)[0]
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    q = g.standard_normal((b * k, 4, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(_fold_queries(torch.from_numpy(q), k).numpy(),
                                  np.asarray(jax_fold_queries(jnp.asarray(q), k)))


def test_top_k_ties_go_to_the_lowest_index():
    """Constructed ties (inside the top k, straddling the k-th value, and
    at -inf) select what ``lax.top_k`` selects, in its order."""
    neg = float(np.finfo(np.float32).min)
    rows = np.array([
        [1.0, 3.0, 3.0, 2.0, 3.0, 3.0, 0.5, 3.0],
        [2.0, 1.0, 2.0, 1.0, 2.0, 1.0, 1.0, 0.0],
        [-np.inf, 5.0, -np.inf, -np.inf, neg, -np.inf, neg, -np.inf],
        [0.0] * 8,
    ], np.float32)
    rows = np.concatenate([rows, np.random.default_rng(0).integers(
        0, 3, size=(8, 8)).astype(np.float32)])
    for k in (1, 3, 5):
        vals, idx = top_k(torch.from_numpy(rows), k)
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(rows), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_cache_reorder_matches_jax():
    """The per-step cache reorder (one gather per cache tensor) equals the
    JAX package's ``_gather_beams`` on an int8 cache."""
    b, k = 2, 3
    g = np.random.default_rng(1)
    cache = QuantizedKVCache.zeros(b * k, 2, 8, 4)
    for name in ("k_q", "v_q"):
        setattr(cache, name, torch.from_numpy(g.integers(-127, 128, (b * k, 2, 4, 8),
                                                          dtype=np.int8)))
    src = np.array([[2, 0, 0], [1, 1, 2]], np.int32)
    want = jax_gather_beams({"k": jnp.asarray(cache.k_q.numpy()),
                             "v": jnp.asarray(cache.v_q.numpy())}, jnp.asarray(src))
    _gather_beams([cache], torch.from_numpy(src).long())
    np.testing.assert_array_equal(cache.k_q.numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(cache.v_q.numpy(), np.asarray(want["v"]))
    x = g.standard_normal((b, 5)).astype(np.float32)
    np.testing.assert_array_equal(tile_beams(torch.from_numpy(x), k).numpy(),
                                  np.asarray(jax_tile_beams(jnp.asarray(x), k)))


@pytest.mark.parametrize("penalty,ngram", [(1.3, 0), (None, 3), (0.7, 2)])
def test_repetition_rules_match_jax(penalty, ngram):
    """``make_repetition_rules`` on random logits and token buffers with
    repeats, every pos from the prompt's end: exact in f32, the prompt
    region never penalized, ids outside ``bannable`` left alone."""
    g = np.random.default_rng(2)
    b, v, t, n_prompt = 3, 40, 18, 4
    tokens = g.integers(0, 12, size=(b, t))
    logits = g.standard_normal((b, v)).astype(np.float32) * 3
    bannable = g.random(v) > 0.2
    got_fn = make_repetition_rules(penalty, ngram, n_prompt, bannable)
    want_fn = jax_rep_rules(penalty, ngram, n_prompt, bannable)
    for pos in range(n_prompt, t):
        got = got_fn(torch.from_numpy(logits), torch.from_numpy(tokens), pos)
        want = want_fn(jnp.asarray(logits), jnp.asarray(tokens), pos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert make_repetition_rules(None, 1) is None and make_repetition_rules(1.0, 0) is None


@pytest.mark.parametrize("beams", [0, 2])
def test_bias_hotwords_and_repetition_transcripts_match_jax(tiny, beams):
    """Greedy and beam transcripts with a logit bias, hotwords and both
    repetition rules equal JAX's (bf16, int8 cross-K/V and cache, timestamps
    on): the same token streams, which start with a timestamp although the
    bias pushes a text token there (the timestamp rules run after it)."""
    kw = dict(batch_size=3, beams=beams, quantized_cross_kv="int8", quantized_cache=True,
              logit_bias={WORDS["morning"]: 3.0, WORDS["you"]: -2.0},
              hotwords="hello, thank you", hotword_boost=2.5,
              repetition_penalty=1.1, no_repeat_ngram_size=3)
    jt, tt = _pair(tiny, "bf16", **kw)
    assert tt._logit_bias_entries == jt._logit_bias_entries
    (got, got_len, _), (want, want_len, _) = _decode_both(jt, tt, tiny[2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    p = len(tt._prompt_ids())
    assert (got[:, p] >= tt.token_table.timestamp_begin).all()
    # The processors' order: the bias runs before the timestamp rules. Here
    # the timestamps' mass would force a timestamp, but a text token biased
    # by 1e4 beforehand outweighs it and is picked.
    tt = _port(tiny, logit_bias={WORDS["hello"]: 1e4})
    logits = torch.zeros((1, WhisperConfig(**CFG).n_vocab))
    logits[:, tt.token_table.timestamp_begin:] = 5.0
    buf = torch.full((1, 32), tt.eot, dtype=torch.long)
    buf[0, :p + 2] = torch.as_tensor(tt._prompt_ids() + [tt.token_table.timestamp_begin,
                                                         WORDS["good"]])
    unbiased = _port(tiny)._logits_fn(p)(logits, buf, p + 2)
    assert int(unbiased.argmax()) >= tt.token_table.timestamp_begin
    assert int(tt._logits_fn(p)(logits, buf, p + 2).argmax()) == WORDS["hello"]


@pytest.mark.parametrize("kw,match", [
    (dict(logit_bias={51865: 1.0}), "out of range"),
    (dict(logit_bias={-1: 1.0}), "out of range"),
    (dict(hotwords=" , "), "no phrases"),
    (dict(repetition_penalty=0.0), "repetition_penalty"),
    (dict(no_repeat_ngram_size=-1), "no_repeat_ngram_size"),
    (dict(beams=2, condition_on_previous_text=True), "greedy"),
], ids=["bias-high", "bias-negative", "hotwords-empty", "penalty", "ngram", "beams-cond"])
def test_option_refusals_match_jax(tiny, kw, match):
    for build in (_jax, _port):
        with pytest.raises(ValueError, match=match):
            build(tiny, **kw)


def test_beam_refusals(tiny):
    """Hotwords need a text backend, and beams take no per-request
    temperature (both packages raise)."""
    with pytest.raises(ValueError, match="text backend"):
        Transcriber(tiny[1]["f32"], token_table=WhisperTokenTable(), device="cpu",
                    hotwords="hello")
    for tr in _pair(tiny, batch_size=1, beams=2):
        with pytest.raises(ValueError, match="greedy-only"):
            tr.transcribe_many([tiny[2][0]], temperatures=[0.5])
