"""The port's decoding against the JAX package's: greedy token streams on
the trained ``tests/fixtures/whisper_tiny`` are equal, in f32 and in bf16
with int8 or int4 cross-K/V and the int8 self-cache, and the timestamp
rules produce the same logits on random inputs.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.audio.frontend import whisper_log_mel
from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.decode import greedy_decode as jax_greedy
from yoho_tpu.infer.decode import make_whisper_step_fn as jax_step_fn
from yoho_tpu.infer.whisper_rules import make_timestamp_rules as jax_rules
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.whisper_tokens import WhisperTokenTable
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.decode import greedy_decode, make_whisper_step_fn
from yoho_tpu_torch.infer.whisper_rules import make_timestamp_rules
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper

FIXTURE = Path(__file__).parent / "fixtures" / "whisper_tiny"
CFG = json.loads((FIXTURE / "config.json").read_text())
TONES = json.loads((FIXTURE / "golden.json").read_text())["tones"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU: one intra-op thread keeps the eager
    decode loops from oversubscribing it (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_params():
    cfg = JaxConfig(**CFG)
    template = jax.eval_shape(
        JaxWhisper(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    return jax.device_get(load_params(FIXTURE / "params.msgpack", template))


def _models(params, dtype):
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jm = JaxWhisper(JaxConfig(**CFG), dtype=jd)
    tm = load_jax_params(Whisper(WhisperConfig(**CFG), dtype=td, device="cpu"), params)
    return jm, tm


def _mel(n=3):
    n_samples = JaxConfig(**CFG).n_samples
    clips = np.zeros((n, n_samples), np.float32)
    for i in range(n):
        clips[i] = np.random.default_rng(9).standard_normal(n_samples) * 0.002
        tone = 0.4 * np.sin(2 * np.pi * TONES[i % 3] * np.arange(4000) / 16000)
        clips[i, 800:4800] += tone.astype(np.float32)
    return np.array(whisper_log_mel(jnp.asarray(clips)))


@pytest.mark.parametrize("dtype,quant", [("f32", False), ("bf16", "int8"),
                                         ("bf16", "int4")])
def test_greedy_tokens_match_jax(fixture_params, dtype, quant):
    jm, tm = _models(fixture_params, dtype)
    cfg = JaxConfig(**CFG)
    table = WhisperTokenTable(multilingual=True)
    prompt = np.asarray([table.sot_sequence("en", timestamps=False)] * 3, np.int32)
    suppress = tuple(table.non_speech_tokens) + tuple(
        range(table.timestamp_begin, table.n_vocab))
    mel = _mel(3)
    variables = {"params": fixture_params}
    cached = quant is not False

    xa = jm.apply(variables, jnp.asarray(mel), method=JaxWhisper.encode_audio)
    ckv = jm.apply(variables, xa, quant, method=JaxWhisper.cross_kvs)
    caches = jm.apply(variables, 3, jnp.float32, None, cached,
                      method=JaxWhisper.init_caches)
    want, want_len = jax_greedy(jax_step_fn(jm, variables, ckv), caches,
                                jnp.asarray(prompt), cfg.n_text_ctx, table.eot,
                                suppress_ids=suppress)
    with torch.no_grad():
        t_xa = tm.encode_audio(torch.from_numpy(mel))
        t_ckv = tm.cross_kvs(t_xa, quant)
        t_caches = tm.init_caches(3, torch.float32, None, cached)
        got, got_len = greedy_decode(make_whisper_step_fn(tm, t_ckv), t_caches,
                                     torch.from_numpy(prompt).long(), cfg.n_text_ctx,
                                     table.eot, suppress_ids=suppress)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert ((got[:, 4] >= 1000) & (got[:, 4] <= 1005)).all()  # real words


@pytest.mark.parametrize("pos", [3, 4, 5, 9])
def test_timestamp_rules_match_jax(pos):
    """Random logits and token buffers holding text and timestamps: the
    port's rules mask exactly the ids JAX's rules mask."""
    table = WhisperTokenTable(multilingual=True)
    g = np.random.default_rng(pos)
    prompt = table.sot_sequence("en")  # timestamps on: 3 tokens
    b, v, prompt_len = 6, table.n_vocab, len(prompt)
    logits = (g.standard_normal((b, v)) * 3).astype(np.float32)
    logits[:3, table.timestamp_begin:] += 4.0  # some rows where timestamps win
    tokens = np.full((b, 16), table.eot, np.int32)
    tokens[:, :prompt_len] = prompt
    for r in range(b):
        for p in range(prompt_len, pos):
            ts = g.random() < 0.5
            tokens[r, p] = (table.timestamp_begin + int(g.integers(0, 60)) if ts
                            else int(g.integers(1000, 1010)))
    want = np.asarray(jax_rules(table, prompt_len)(jnp.asarray(logits), jnp.asarray(tokens), pos))
    got = make_timestamp_rules(table, prompt_len)(
        torch.from_numpy(logits), torch.from_numpy(tokens).long(), pos).numpy()
    masked = np.finfo(np.float32).min
    np.testing.assert_array_equal(got == masked, want == masked)
    np.testing.assert_allclose(got, want, rtol=1e-6)
