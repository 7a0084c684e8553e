"""The port's speculative decoding against greedy decoding, in float32.

For any weights, speculative greedy decoding must give the target model's
greedy tokens (``tests/test_speculative.py`` holds the JAX package to the
same): an independent random draft (partial acceptance) and the target as
its own draft (full acceptance, which stresses the S = 2 refill of the
draft cache), at gamma 1 and 4, with token suppression. The tokens equal
the port's greedy and the JAX package's greedy; ``sum_logprob`` and
``no_speech_prob`` are within 1e-4 of the port's greedy. Through the
``Transcriber``: the trained target and draft of
``tests/fixtures/whisper_quality`` (carried across by ``load_jax_params``)
at gamma 1, 2 and 4, with and without the timestamp rules, equal the
port's target-only greedy and the JAX ``Transcriber`` with the same draft.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.decode import greedy_decode as jax_greedy
from yoho_tpu.infer.decode import make_whisper_step_fn as jax_step_fn
from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.decode import greedy_decode, make_whisper_step_fn
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.infer.speculative import (
    make_verify_step_fn,
    speculative_greedy_decode,
)
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

EOT, MAX_LEN, NO_SPEECH = 7, 20, 5
SUPPRESS = (3, 9, 11)
PROMPT = np.asarray([[1, 2], [4, 5], [1, 3]], np.int64)
QUALITY = Path(__file__).parent / "fixtures" / "whisper_quality"
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU: one intra-op thread keeps the eager
    decode loops from oversubscribing it (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(state, heads, layers):
    return dict(n_mels=8, n_audio_ctx=16, n_audio_state=state, n_audio_head=heads,
                n_audio_layer=layers, n_vocab=50, n_text_ctx=32, n_text_state=state,
                n_text_head=heads, n_text_layer=layers)


@pytest.fixture(scope="module")
def models():
    """The target and the independent draft of ``tests/test_speculative.py``
    (flax initialization from seeds 0 and 1) in both packages, a batch of
    three mels, and the JAX package's greedy tokens."""
    g = np.random.default_rng(0)
    mel = g.standard_normal((3, 32, 8)).astype(np.float32)
    out = {}
    for name, seed, cfg in (("target", 0, _cfg(32, 4, 2)), ("draft", 1, _cfg(16, 2, 1))):
        jm = JaxWhisper(JaxConfig(**cfg))
        toks = jnp.asarray(np.random.default_rng(seed).integers(0, 50, size=(3, 4)))
        params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                                 jnp.asarray(mel), toks)["params"])
        out[name] = (jm, params, load_jax_params(
            Whisper(WhisperConfig(**cfg), device="cpu"), params))
    jm, params, _ = out["target"]
    variables = {"params": params}
    xa = jm.apply(variables, jnp.asarray(mel), method=JaxWhisper.encode_audio)
    ckv = jm.apply(variables, xa, method=JaxWhisper.cross_kvs)
    caches = jm.apply(variables, 3, jnp.float32, method=JaxWhisper.init_caches)
    want, _ = jax.jit(lambda c, p: jax_greedy(jax_step_fn(jm, variables, ckv), c, p, MAX_LEN,
                                              EOT, suppress_ids=SUPPRESS))(
        caches, jnp.asarray(PROMPT))
    return out["target"][2], out["draft"][2], torch.from_numpy(mel), np.asarray(want)


@torch.inference_mode()
def _greedy(model, mel):
    ckv = model.cross_kvs(model.encode_audio(mel))
    return greedy_decode(make_whisper_step_fn(model, ckv), model.init_caches(3),
                         torch.from_numpy(PROMPT), MAX_LEN, EOT, suppress_ids=SUPPRESS,
                         return_aux=True, no_speech_id=NO_SPEECH, sot_index=0)


@torch.inference_mode()
def _speculative(target, draft, mel, gamma, stats):
    horizon = MAX_LEN + gamma + 2
    steps = [make_verify_step_fn(m, m.cross_kvs(m.encode_audio(mel)))
             for m in (target, draft)]
    return speculative_greedy_decode(
        *steps, target.init_caches(3, None, horizon), draft.init_caches(3, None, horizon),
        torch.from_numpy(PROMPT), MAX_LEN, EOT, gamma=gamma, suppress_ids=SUPPRESS,
        return_aux=True, no_speech_id=NO_SPEECH, sot_index=0, stats=stats)


@pytest.mark.parametrize("gamma", [1, 4])
@pytest.mark.parametrize("draft", ["independent", "perfect"])
def test_speculative_equals_greedy_in_both_packages(models, draft, gamma):
    target, independent, mel, want_jax = models
    stats = {}
    tokens, lengths, aux = _speculative(
        target, target if draft == "perfect" else independent, mel, gamma, stats)
    want, want_len, want_aux = _greedy(target, mel)
    np.testing.assert_array_equal(tokens.numpy(), want.numpy())
    np.testing.assert_array_equal(tokens.numpy(), want_jax)
    np.testing.assert_array_equal(lengths.numpy(), want_len.numpy())
    assert not np.isin(tokens[:, PROMPT.shape[1]:].numpy(), SUPPRESS).any()
    for key in ("sum_logprob", "no_speech_prob"):
        np.testing.assert_allclose(aux[key].numpy(), want_aux[key].numpy(), **TOL)
    # One host sync per round; a round commits 1 to gamma + 1 tokens.
    assert stats["syncs"] == stats["rounds"] >= 1
    assert stats["rounds"] <= stats["committed"] <= stats["rounds"] * (gamma + 1)
    if draft == "perfect":  # every round but the last commits gamma + 1
        assert stats["committed"] >= (stats["rounds"] - 1) * (gamma + 1)


def test_speculative_refuses_short_caches_and_gamma_0(models):
    target, draft, mel, _ = models
    # The caches round up to 128 positions: too few for max_len 126.
    with pytest.raises(ValueError, match="max_len \\+ gamma \\+ 2"):
        speculative_greedy_decode(
            None, None, target.init_caches(3, None, 126), draft.init_caches(3, None, 126),
            torch.from_numpy(PROMPT), 126, EOT, gamma=4)
    with pytest.raises(ValueError, match="gamma must be >= 1"):
        _speculative(target, draft, mel, 0, {})


class _WordBackend:
    def __init__(self, word_ids):
        self.word_ids = {k: int(v) for k, v in word_ids.items()}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)


def _flax_params(config: Path, params: Path):
    cfg = JaxConfig(**json.loads(config.read_text()))
    template = jax.eval_shape(
        JaxWhisper(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, jnp.bfloat16), template)
    return cfg, jax.device_get(load_params(params, template))


@pytest.fixture(scope="module")
def quality():
    """The trained target and draft of ``whisper_quality`` (stored bf16) in
    float32 in both packages, and its first held-out clips."""
    from test_quality_fixture import synth

    spec = json.loads((QUALITY / "spec.json").read_text())
    pairs = [_flax_params(QUALITY / c, QUALITY / p) for c, p in
             (("config.json", "params.msgpack"),
              ("draft_config.json", "draft_params.msgpack"))]
    port = [load_jax_params(Whisper(WhisperConfig(**json.loads((QUALITY / c).read_text())),
                                    device="cpu"), params)
            for c, (_, params) in zip(("config.json", "draft_config.json"), pairs)]
    rng = np.random.default_rng(spec["eval_seed"])
    clips = [synth(s, spec["words"], spec["base_hz"], spec["word_sec"], rng,
                   spec["noise"], pairs[0][0].n_samples)
             for s in spec["eval_sentences"][:4]]
    return spec, pairs, port, clips


def _tokens(results):
    return [[s.tokens for s in r.segments] for r in results]


@pytest.mark.parametrize("timestamps", [False, True])
def test_transcriber_with_trained_draft_equals_greedy(quality, timestamps):
    """gamma 1, 2 and 4 without timestamps, 4 with the timestamp rules."""
    spec, pairs, (target, draft), clips = quality
    kw = dict(batch_size=4, timestamps=timestamps, device="cpu",
              token_table=WhisperTokenTable(multilingual=True,
                                            text_backend=_WordBackend(spec["word_ids"])))
    want = Transcriber(target, **kw).transcribe_many(clips)
    assert any(r.text for r in want)
    for gamma in ((4,) if timestamps else (1, 2, 4)):
        tr = Transcriber(target, draft_model=draft, speculative_gamma=gamma, **kw)
        got = tr.transcribe_many(clips)
        assert _tokens(got) == _tokens(want), gamma
        assert [r.text for r in got] == [r.text for r in want]
        assert tr.speculative_stats["rounds"] >= 1
    if not timestamps:  # one JAX speculative program
        (cfg, params), (dcfg, dparams) = pairs
        jt = JaxTranscriber(JaxWhisper(cfg), {"params": params}, family="whisper",
                            token_table=JaxTable(multilingual=True,
                                                 text_backend=_WordBackend(spec["word_ids"])),
                            batch_size=4, timestamps=False, draft_model=JaxWhisper(dcfg),
                            draft_variables={"params": dparams}, speculative_gamma=2)
        assert _tokens(jt.transcribe_many(clips)) == _tokens(want)


def test_transcriber_refuses_draft_with_beams_or_gamma_0(quality):
    spec, pairs, (target, draft), _ = quality
    table = WhisperTokenTable(multilingual=True)
    with pytest.raises(ValueError, match="greedy-only"):
        Transcriber(target, token_table=table, device="cpu", draft_model=draft, beams=5)
    with pytest.raises(ValueError, match="speculative_gamma must be >= 1"):
        Transcriber(target, token_table=table, device="cpu", draft_model=draft,
                    speculative_gamma=0)
    (cfg, params), (dcfg, dparams) = pairs
    with pytest.raises(ValueError, match="greedy-only"):
        JaxTranscriber(JaxWhisper(cfg), {"params": params}, family="whisper",
                       token_table=JaxTable(multilingual=True), draft_model=JaxWhisper(dcfg),
                       draft_variables={"params": dparams}, beams=5)
    with pytest.raises(TypeError, match="draft_variables"):
        Transcriber(target, token_table=table, device="cpu", draft_model=draft,
                    draft_variables={})
