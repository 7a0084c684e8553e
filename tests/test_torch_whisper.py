"""The port's Whisper against the JAX package's on the trained fixture.

``tests/fixtures/whisper_tiny`` params are restored by the JAX package's
``load_params`` and carried across with ``load_jax_params``. Encoder
output and logits agree in f32 at atol 2e-4 (the bound of
``tests/test_whisper_parity.py``), and so do the cached decode steps.
Greedy decoding is held in ``tests/test_torch_decode.py``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.decode import make_whisper_step_fn as jax_step_fn
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.decode import make_whisper_step_fn
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper

FIXTURE = Path(__file__).parent / "fixtures" / "whisper_tiny"
CFG = json.loads((FIXTURE / "config.json").read_text())
TONES = json.loads((FIXTURE / "golden.json").read_text())["tones"]
TOKENS = np.array([[50258, 50259, 50359, 50363, 1000, 1001],
                   [50258, 50259, 50359, 50363, 1002, 1003]], np.int32)


@pytest.fixture(scope="module")
def fixture_params():
    cfg = JaxConfig(**CFG)
    model = JaxWhisper(cfg)
    template = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
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
    from yoho_tpu.audio.frontend import whisper_log_mel

    n_samples = JaxConfig(**CFG).n_samples
    clips = np.zeros((n, n_samples), np.float32)
    for i in range(n):
        clips[i] = np.random.default_rng(9).standard_normal(n_samples) * 0.002
        tone = 0.4 * np.sin(2 * np.pi * TONES[i % 3] * np.arange(4000) / 16000)
        clips[i, 800:4800] += tone.astype(np.float32)
    return np.array(whisper_log_mel(jnp.asarray(clips)))


def test_load_jax_params_is_bit_identical(fixture_params):
    _, tm = _models(fixture_params, "f32")
    state = dict(tm.named_parameters())
    wq = fixture_params["decoder"]["blocks_1"]["cross_attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(state["decoder.blocks.1.cross_attn.q_proj.weight"]
                                  .detach().numpy(), np.asarray(wq).T)
    conv = fixture_params["encoder"]["conv2"]["kernel"]  # (k, in, out)
    np.testing.assert_array_equal(state["encoder.conv2.weight"].detach().numpy(),
                                  np.asarray(conv).transpose(2, 1, 0))
    np.testing.assert_array_equal(
        state["encoder.ln_post.weight"].detach().numpy(),
        np.asarray(fixture_params["encoder"]["ln_post"]["scale"]))
    np.testing.assert_array_equal(
        state["decoder.positional_embedding"].detach().numpy(),
        np.asarray(fixture_params["decoder"]["positional_embedding"]))
    n_leaves = len(jax.tree_util.tree_leaves(fixture_params))
    assert n_leaves == len(state)


def test_load_jax_params_rejects_mismatch(fixture_params):
    params = jax.tree_util.tree_map(lambda x: x, fixture_params)
    del params["decoder"]["ln"]
    with pytest.raises(KeyError, match="decoder.ln.weight"):
        _models(params, "f32")


def test_encoder_and_logits_match_jax_f32(fixture_params):
    jm, tm = _models(fixture_params, "f32")
    mel = _mel(2)
    variables = {"params": fixture_params}
    want_xa = np.asarray(jm.apply(variables, jnp.asarray(mel), method=JaxWhisper.encode_audio))
    want = np.asarray(jm.apply(variables, jnp.asarray(mel), jnp.asarray(TOKENS)))
    with torch.no_grad():
        got_xa = tm.encode_audio(torch.from_numpy(mel)).numpy()
        got = tm(torch.from_numpy(mel), torch.from_numpy(TOKENS).long()).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got_xa, want_xa, atol=2e-4)
    np.testing.assert_allclose(got, want, atol=2e-4)


def _step_logits(step, tokens, caches):
    logits, caches = step(tokens[:, :3], caches, 0)
    out = [np.asarray(logits)]
    for p in range(3, tokens.shape[1]):
        logits, caches = step(tokens[:, p:p + 1], caches, p)
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def test_decode_step_equals_full_forward(fixture_params):
    """Prefill + cached steps give the teacher-forced logits (f32)."""
    _, tm = _models(fixture_params, "f32")
    mel = torch.from_numpy(_mel(2))
    tokens = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        full = tm(mel, tokens).numpy()
        ckv = tm.cross_kvs(tm.encode_audio(mel))
        got = _step_logits(make_whisper_step_fn(tm, ckv), tokens, tm.init_caches(2))
    np.testing.assert_allclose(got, full, atol=2e-4)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_decode_step_matches_jax(fixture_params, quant):
    """int8/int4 cross-K/V and the int8 cache: the port's cached steps give
    JAX's logits (same codes, bit for bit; f32 arithmetic)."""
    jm, tm = _models(fixture_params, "f32")
    mel = _mel(2)
    variables = {"params": fixture_params}
    xa = jm.apply(variables, jnp.asarray(mel), method=JaxWhisper.encode_audio)
    ckv = jm.apply(variables, xa, quant, method=JaxWhisper.cross_kvs)
    caches = jm.apply(variables, 2, jnp.float32, None, True,
                      method=JaxWhisper.init_caches)
    want = _step_logits(jax_step_fn(jm, variables, ckv), jnp.asarray(TOKENS), caches)
    with torch.no_grad():
        t_ckv = tm.cross_kvs(tm.encode_audio(torch.from_numpy(mel)), quant)
        got = _step_logits(make_whisper_step_fn(tm, t_ckv),
                           torch.from_numpy(TOKENS).long(),
                           tm.init_caches(2, quantized=True))
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_cross_kvs_are_jax_padded_layout(fixture_params, quant):
    """The port's quantized cross-K/V are the JAX package's
    ``quantize_kv(..., pad_to=128, time_major=True)`` of the same
    projections, bit for bit: T padded to a multiple of 128 with zero codes
    and scales, ``kv_len`` the valid length (the layout the decode kernel's
    bulk copies need). The cached steps' logits over that layout are held
    to JAX's by ``test_quantized_decode_step_matches_jax``."""
    from yoho_tpu.nn import kv_cache as jkv

    _, tm = _models(fixture_params, "f32")
    quantize = jkv.quantize_kv if quant == "int8" else jkv.quantize_kv4
    t = CFG["n_audio_ctx"]
    with torch.no_grad():
        xa = tm.encode_audio(torch.from_numpy(_mel(2)))
        got = tm.cross_kvs(xa, quant)
        projections = [blk.cross_attn.kv_tm(xa) for blk in tm.decoder.blocks]
    assert len(got) == len(projections) == CFG["n_text_layer"]
    for g, (k, v) in zip(got, projections):
        want = quantize(jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), pad_to=128,
                        time_major=True)
        assert g.kv_len == want.kv_len == t and g.packing == want.packing
        for name in ("k_q", "v_q", "k_scale", "v_scale"):
            tg = getattr(g, name)
            tg = (tg.float() if tg.dtype == torch.bfloat16 else tg).numpy()
            jw = getattr(want, name)
            jw = np.asarray(jw.astype(jnp.float32) if jw.dtype == jnp.bfloat16 else jw)
            assert tg.shape == jw.shape and tg.shape[3] == -(-t // 128) * 128, name
            np.testing.assert_array_equal(tg[..., :t], jw[..., :t], err_msg=name)
            assert not tg[..., t:].any(), f"{name}: padding is not zero"
