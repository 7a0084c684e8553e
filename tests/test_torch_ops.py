"""The port's decode attention and flash forward against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as ``tests/test_ops.py``
does. Tolerances are that file's: rtol 0.05 / atol 0.02 for decode
attention (bf16 weights), atol 2e-5 for the f32 flash forward. The CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yoho_tpu.nn.layers import (
    QuantizedKV,
    _attend,
    _attend_quantized,
    decode_mask,
    quantize_kv4,
)
from yoho_tpu.ops.decode_attention import fused_decode_attention as jax_decode
from yoho_tpu.ops.flash_attention import flash_attention as jax_flash
from yoho_tpu_torch.nn import kv_cache as tkv
from yoho_tpu_torch.ops import decode_attention as tda
from yoho_tpu_torch.ops import flash_attention as tfa


def _quantize_ref(x):
    scale = np.maximum(np.abs(x).max(axis=2, keepdims=True) / 127.0, 1e-8)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale.astype(np.float32)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _close(got, *wants):
    g = got.float().numpy()
    for w in wants:
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("s,kv_len", [(1, 384), (1, 300), (4, 384)])
def test_decode_attention_cross_matches_jax(s, kv_len):
    g = np.random.default_rng(10)
    b, h, d, t = 2, 3, 64, 384
    q = _bf16(g.standard_normal((b, h, s, d)).astype(np.float32))
    k_q, k_s = _quantize_ref(g.standard_normal((b, h, d, t)).astype(np.float32))
    v_q, v_s = _quantize_ref(g.standard_normal((b, h, d, t)).astype(np.float32))
    ks, vs = _bf16(k_s), _bf16(v_s)
    qj = jnp.asarray(q, jnp.bfloat16)
    jargs = (jnp.asarray(k_q), jnp.asarray(v_q), jnp.asarray(ks, jnp.bfloat16),
             jnp.asarray(vs, jnp.bfloat16))
    want_kernel = jax_decode(qj, *jargs, kv_len=kv_len)
    mask = (jnp.arange(t) < kv_len)[None, None, None, :]
    want_xla = _attend_quantized(qj, QuantizedKV(*jargs), mask, jnp.bfloat16)
    got = tda.fused_decode_attention(
        _t(q, torch.bfloat16), _t(k_q), _t(v_q), _t(ks, torch.bfloat16),
        _t(vs, torch.bfloat16), kv_len=kv_len)
    assert got.shape == (b, s, h, d) and got.dtype == torch.bfloat16
    _close(got, want_kernel, want_xla)


@pytest.mark.parametrize("pos", [0, 5, 250])
def test_decode_attention_causal_matches_jax(pos):
    g = np.random.default_rng(11)
    b, h, d, t, s = 2, 2, 64, 256, 1
    q = _bf16(g.standard_normal((b, h, s, d)).astype(np.float32))
    k_q, k_s = _quantize_ref(g.standard_normal((b, h, d, t)).astype(np.float32))
    v_q, v_s = _quantize_ref(g.standard_normal((b, h, d, t)).astype(np.float32))
    ks, vs = _bf16(k_s), _bf16(v_s)
    qj = jnp.asarray(q, jnp.bfloat16)
    jargs = (jnp.asarray(k_q), jnp.asarray(v_q), jnp.asarray(ks, jnp.bfloat16),
             jnp.asarray(vs, jnp.bfloat16))
    want_kernel = jax_decode(qj, *jargs, pos=jnp.int32(pos))
    want_xla = _attend_quantized(qj, QuantizedKV(*jargs), decode_mask(t, pos, s),
                                 jnp.bfloat16)
    got = tda.fused_decode_attention(
        _t(q, torch.bfloat16), _t(k_q), _t(v_q), _t(ks, torch.bfloat16),
        _t(vs, torch.bfloat16), pos=pos)
    _close(got, want_kernel, want_xla)


def test_decode_attention_bf16_gqa_matches_jax():
    g = np.random.default_rng(12)
    b, hkv, groups, d, t, s = 2, 2, 2, 64, 128, 1
    q = _bf16(g.standard_normal((b, hkv * groups, s, d)).astype(np.float32))
    k = _bf16(g.standard_normal((b, hkv, d, t)).astype(np.float32))
    v = _bf16(g.standard_normal((b, hkv, d, t)).astype(np.float32))
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want_kernel = jax_decode(qj, kj, vj, pos=jnp.int32(63), groups=groups)
    want_xla = _attend(qj, jnp.repeat(kj, groups, axis=1), jnp.repeat(vj, groups, axis=1),
                       decode_mask(t, 63, s), jnp.bfloat16)
    got = tda.fused_decode_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                                     pos=63, groups=groups)
    _close(got, want_kernel, want_xla)


def test_decode_attention_int4_matches_jax():
    g = np.random.default_rng(13)
    b, h, d, t, s = 2, 3, 64, 300, 1
    q = _bf16(g.standard_normal((b, h, s, d)).astype(np.float32))
    k = g.standard_normal((b, h, d, t)).astype(np.float32)
    v = g.standard_normal((b, h, d, t)).astype(np.float32)
    qkv = quantize_kv4(jnp.asarray(k), jnp.asarray(v), pad_to=128)
    qj = jnp.asarray(q, jnp.bfloat16)
    want_kernel = jax_decode(qj, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale,
                             kv_len=t, packing=2)
    want_xla = _attend_quantized(qj, qkv, None, jnp.bfloat16)
    tq = tkv.quantize_kv4(_t(k), _t(v))  # unpadded: the port masks any T
    got = tda.fused_decode_attention(_t(q, torch.bfloat16), tq.k_q, tq.v_q,
                                     tq.k_scale, tq.v_scale, packing=2)
    _close(got, want_kernel, want_xla)


@pytest.mark.parametrize("pos", [0, 100, None])
def test_decode_attention_chunks_long_query_runs(pos):
    """S = 224 (a per-request prompt's prefill) goes through the wrapper in
    chunks of 32 queries, a causal chunk at ``pos`` + its first query: the
    same as the plain version over all 224 queries at once, and as JAX's
    XLA route for S > 32."""
    g = np.random.default_rng(14)
    b, h, d, t, s = 2, 2, 64, 512, 224
    q = g.standard_normal((b, h, s, d)).astype(np.float32)
    k_q, k_s = _quantize_ref(g.standard_normal((b, h, d, t)).astype(np.float32))
    v_q, v_s = _quantize_ref(g.standard_normal((b, h, d, t)).astype(np.float32))
    ks, vs = _bf16(k_s), _bf16(v_s)
    args = (_t(q), _t(k_q), _t(v_q), _t(ks, torch.bfloat16), _t(vs, torch.bfloat16))
    got = tda.fused_decode_attention(*args, pos=pos, kv_len=500)
    assert got.shape == (b, s, h, d) and s > tda.MAX_QUERIES
    torch.testing.assert_close(
        got, tda.decode_attention_reference(*args, pos=pos, kv_len=500),
        rtol=1e-5, atol=1e-6)
    mask = (jnp.arange(t) < 500)[None, None, None, :]
    if pos is not None:
        mask = mask & decode_mask(t, pos, s)
    want = _attend_quantized(jnp.asarray(q), QuantizedKV(
        jnp.asarray(k_q), jnp.asarray(v_q), jnp.asarray(ks, jnp.bfloat16),
        jnp.asarray(vs, jnp.bfloat16)), mask, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_decode_attention_rejects_bad_shapes():
    q = torch.zeros(1, 2, 1, 8)
    k = torch.zeros(1, 2, 8, 16, dtype=torch.int8)
    s = torch.zeros(1, 2, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(q, k, k[..., :8], s, s)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(q, k, k, s, None)


@pytest.mark.parametrize("causal,tq,tk", [
    (False, 256, 256), (False, 300, 300), (False, 128, 384),
    (True, 256, 256), (True, 300, 300)])
def test_flash_forward_matches_jax(causal, tq, tk):
    g = np.random.default_rng(0)
    b, h, d = 2, 2, 64
    q, k, v = (g.standard_normal((b, n, h, d)).astype(np.float32) for n in (tq, tk, tk))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=128, block_k=128))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("causal,t,kv_len", [
    (False, 384, 300), (False, 300, 129), (True, 256, 200)])
def test_flash_forward_kv_len_matches_jax(causal, t, kv_len):
    """Keys at and past ``kv_len`` are masked: the same as JAX's flash
    attention on the first ``kv_len`` keys (queries past ``kv_len`` in
    causal mode see all of them)."""
    g = np.random.default_rng(1)
    b, h, d = 2, 2, 64
    q, k, v = (g.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k[:, :kv_len]),
                                jnp.asarray(v[:, :kv_len]), block_q=128, block_k=128))
    if causal:  # rows before kv_len see only the keys up to their own
        head = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=True, block_q=128, block_k=128))
        want = np.where(np.arange(t)[None, :, None, None] < kv_len, head, want)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal, kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_flash_rejects_bad_kv_len():
    x = torch.zeros(1, 6, 1, 8)
    for kv_len in (0, 7):
        with pytest.raises(ValueError, match="kv_len"):
            tfa.flash_attention(x, x, x, kv_len=kv_len)


def test_flash_rejects_causal_rectangle():
    with pytest.raises(ValueError, match="S == T"):
        tfa.flash_attention(torch.zeros(1, 4, 1, 8), torch.zeros(1, 6, 1, 8),
                            torch.zeros(1, 6, 1, 8), causal=True)
