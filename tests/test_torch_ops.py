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
    """S = 224 (a per-request prompt's prefill) in f32 (the FMA route) goes
    through the wrapper in chunks of 32 queries, a causal chunk at ``pos`` +
    its first query: the same as the plain version over all 224 queries at
    once, and as JAX's XLA route for S > 32."""
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


@pytest.mark.parametrize("s,d,groups", [(5, 64, 1), (224, 64, 1), (5, 200, 2), (5, 264, 2),
                                         (5, 512, 1)])
def test_decode_attention_several_queries_one_call_matches_jax(s, d, groups, monkeypatch):
    """Several bf16 queries (the tensor-core route on the card: a verify
    step, a prompt's prefill) go through the wrapper in one call at any S,
    never in chunks: with one causal position per row, the same as JAX's
    fused_decode_attention (Pallas, interpret mode) at that row's position,
    row by row; int8 K/V, grouped heads at D = 200 and 264 (the split
    route's head dims above 256 on the card: 264 and 512)."""
    g = np.random.default_rng(15)
    b, hkv, t = 3, 2, 256
    rows = [0, 13, t - s]
    q = _bf16(g.standard_normal((b, hkv * groups, s, d)).astype(np.float32) * d ** -0.5)
    k_q, k_s = _quantize_ref(g.standard_normal((b, hkv, d, t)).astype(np.float32))
    v_q, v_s = _quantize_ref(g.standard_normal((b, hkv, d, t)).astype(np.float32))
    ks, vs = _bf16(k_s), _bf16(v_s)
    calls = []
    plain = tda.decode_attention_reference
    monkeypatch.setattr(tda, "decode_attention_reference",
                        lambda *a, **kw: calls.append(a[0].shape) or plain(*a, **kw))
    assert tda.kernel_route(s) == "mma"
    got = tda.fused_decode_attention(
        _t(q, torch.bfloat16), _t(k_q), _t(v_q), _t(ks, torch.bfloat16),
        _t(vs, torch.bfloat16), pos=torch.tensor(rows, dtype=torch.int32), groups=groups)
    assert calls == [(b, hkv * groups, s, d)] and got.shape == (b, s, hkv * groups, d)
    for r, p in enumerate(rows):
        jargs = (jnp.asarray(k_q[r:r + 1]), jnp.asarray(v_q[r:r + 1]),
                 jnp.asarray(ks[r:r + 1], jnp.bfloat16), jnp.asarray(vs[r:r + 1], jnp.bfloat16))
        want = jax_decode(jnp.asarray(q[r:r + 1], jnp.bfloat16), *jargs, pos=jnp.int32(p),
                          groups=groups)
        _close(got[r:r + 1], want)


def test_int4_at_an_odd_head_dim_is_the_references_limit():
    """Int4 K/V at an odd head dim: the JAX package's ``quantize_kv4``
    cannot pack it (its halves D // 2 and D - D // 2 do not broadcast), and
    the port refuses it too, in its quantizer and in the decode kernels'
    head-dim set; every even head dim, above 256 too, packs in both."""
    x = np.random.default_rng(3).standard_normal((1, 2, 263, 8)).astype(np.float32)
    with pytest.raises(TypeError, match="broadcast"):
        quantize_kv4(jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(ValueError, match="even head dim, got 263"):
        tkv.quantize_kv4(_t(x), _t(x))
    with pytest.raises(ValueError, match="head dim 263 .*int4 K/V"):
        tda.kernel_width(263, "int4")
    even = x[:, :, :262]
    want, got = quantize_kv4(jnp.asarray(even), jnp.asarray(even)), \
        tkv.quantize_kv4(_t(even), _t(even))
    np.testing.assert_array_equal(got.k_q.numpy(), np.asarray(want.k_q))
    assert tda.kernel_slices(262, "int4") == (256, 256)


def test_decode_attention_rejects_bad_shapes():
    q = torch.zeros(1, 2, 1, 8)
    k = torch.zeros(1, 2, 8, 16, dtype=torch.int8)
    s = torch.zeros(1, 2, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(q, k, k[..., :8], s, s)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(q, k, k, s, None)


@pytest.mark.parametrize("causal,tq,tk,h,hkv,d", [
    pytest.param(False, 256, 256, 2, 2, 64, id="False-256-256"),
    pytest.param(False, 300, 300, 2, 2, 64, id="False-300-300"),
    pytest.param(False, 128, 384, 2, 2, 64, id="False-128-384"),
    pytest.param(True, 256, 256, 2, 2, 64, id="True-256-256"),
    pytest.param(True, 300, 300, 2, 2, 64, id="True-300-300"),
    # Grouped K/V: the port gets Hkv heads, JAX their repeated copies.
    pytest.param(False, 300, 300, 4, 2, 64, id="gqa2-False-300-300"),
    pytest.param(True, 256, 256, 6, 2, 32, id="gqa3-True-256-256-d32"),
    pytest.param(False, 128, 384, 6, 3, 16, id="gqa2-False-128-384-d16"),
    # Head dims the kernel runs on FMAs only: not a multiple of 8, past 128.
    pytest.param(False, 300, 300, 4, 2, 12, id="gqa2-False-300-300-d12"),
    pytest.param(True, 256, 256, 3, 1, 136, id="gqa3-True-256-256-d136"),
    # Head dims above 256: the split route's output slices on the card.
    pytest.param(False, 64, 96, 2, 1, 264, id="gqa2-False-64-96-d264"),
    pytest.param(True, 80, 80, 2, 1, 264, id="gqa2-True-80-80-d264"),
    pytest.param(False, 48, 80, 2, 1, 512, id="gqa2-False-48-80-d512"),
    pytest.param(True, 64, 64, 2, 1, 512, id="gqa2-True-64-64-d512")])
def test_flash_forward_matches_jax(causal, tq, tk, h, hkv, d):
    g = np.random.default_rng(0)
    b = 2
    q = g.standard_normal((b, tq, h, d)).astype(np.float32)
    k, v = (g.standard_normal((b, tk, hkv, d)).astype(np.float32) for _ in range(2))
    kj, vj = (jnp.asarray(np.repeat(x, h // hkv, axis=2)) for x in (k, v))
    want = np.asarray(jax_flash(jnp.asarray(q), kj, vj, causal=causal, block_q=128,
                                block_k=128))
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
