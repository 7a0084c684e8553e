"""The PyTorch port's KV quantization against the JAX package's, bit for
bit: int8/int4 codes and bf16 scales are a stored format (absmax is a
selection, the scale is f32 / 127 stored as bf16, rounding is half to
even in both frameworks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yoho_tpu.nn import kv_cache as jkv
from yoho_tpu_torch.nn import kv_cache as tkv


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 1.7
    x[..., 0] = 0.5  # exact-half ratios exercise round-half-to-even
    return x if dtype == "f32" else np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _pair(x, dtype):
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _same(t, j):
    jn = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j)
    tn = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    assert tn.shape == jn.shape
    np.testing.assert_array_equal(tn, jn)


def _same_qkv(t, j):
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        _same(getattr(t, name), getattr(j, name))
    assert t.kv_len == j.kv_len and t.packing == j.packing


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("pad_to", [None, 128])
def test_quantize_kv_bit_exact(dtype, time_major, pad_to):
    shape = (2, 40, 3, 16) if time_major else (2, 3, 16, 40)
    kj, kt = _pair(_x(0, shape, dtype), dtype)
    vj, vt = _pair(_x(1, shape, dtype), dtype)
    _same_qkv(tkv.quantize_kv(kt, vt, pad_to=pad_to, time_major=time_major),
              jkv.quantize_kv(kj, vj, pad_to=pad_to, time_major=time_major))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("time_major", [False, True])
def test_quantize_kv4_bit_exact(dtype, time_major):
    shape = (2, 33, 3, 16) if time_major else (2, 3, 16, 33)
    kj, kt = _pair(_x(2, shape, dtype), dtype)
    vj, vt = _pair(_x(3, shape, dtype), dtype)
    got = tkv.quantize_kv4(kt, vt, pad_to=128, time_major=time_major)
    want = jkv.quantize_kv4(kj, vj, pad_to=128, time_major=time_major)
    _same_qkv(got, want)
    assert got.k_q.dtype == torch.uint8 and got.k_q.shape == (2, 3, 8, 128)
    _same(tkv.unpack_int4(got.k_q), jkv.unpack_int4(want.k_q))


@pytest.mark.parametrize("pos,s", [(0, 3), (5, 1), (124, 4)])
def test_quantized_cache_update_bit_exact(pos, s):
    b, h, d, t = 2, 3, 16, 128
    kj, kt = _pair(_x(4, (b, h, d, s), "bf16"), "bf16")
    vj, vt = _pair(_x(5, (b, h, d, s), "bf16"), "bf16")
    want = jkv.QuantizedKVCache.zeros(b, h, t, d).update(pos, kj, vj)
    got = tkv.QuantizedKVCache.zeros(b, h, t, d).update(pos, kt, vt)
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        _same(getattr(got, name), getattr(want, name))


def test_kv_cache_update_matches_jax():
    b, h, d, t, s, pos = 2, 3, 8, 128, 2, 7
    kj, kt = _pair(_x(6, (b, h, d, s), "f32"), "f32")
    vj, vt = _pair(_x(7, (b, h, d, s), "f32"), "f32")
    want = jkv.KVCache.zeros(b, h, t, d, jnp.float32).update(pos, kj, vj)
    got = tkv.KVCache.zeros(b, h, t, d, torch.float32).update(pos, kt, vt)
    _same(got.k, want.k)
    _same(got.v, want.v)


def test_per_row_positions_are_not_ported():
    """Per-row positions were refused until continuous batching came to the
    port (the name is kept): now each row is written at its own position,
    bit-exact with JAX's scatter."""
    k_new, v_new = (np.random.default_rng(i).standard_normal((2, 1, 8, 1)).astype(np.float32)
                    for i in (1, 2))
    pos = np.asarray([1, 2], np.int32)
    got = tkv.QuantizedKVCache.zeros(2, 1, 128, 8).update(
        torch.from_numpy(pos), torch.from_numpy(k_new), torch.from_numpy(v_new))
    want = jkv.QuantizedKVCache.zeros(2, 1, 128, 8).update(
        jnp.asarray(pos), jnp.asarray(k_new), jnp.asarray(v_new))
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(got, name).float().numpy(),
                                      np.asarray(getattr(want, name), np.float32))


@pytest.mark.parametrize("packing", [1, 2])
def test_attend_quantized_matches_jax(packing):
    """``_attend_quantized`` (the plain path with a padded-length mask)
    against JAX's on the same codes."""
    b, h, d, t, s = 2, 3, 16, 100, 2
    kj, kt = _pair(_x(8, (b, h, d, t), "f32"), "f32")
    vj, vt = _pair(_x(9, (b, h, d, t), "f32"), "f32")
    quant_j = jkv.quantize_kv4 if packing == 2 else jkv.quantize_kv
    quant_t = tkv.quantize_kv4 if packing == 2 else tkv.quantize_kv
    qj_kv, qt_kv = quant_j(kj, vj, pad_to=128), quant_t(kt, vt, pad_to=128)
    q = np.random.default_rng(10).standard_normal((b, h, s, d)).astype(np.float32) * 0.3
    want = np.asarray(jkv._attend_quantized(jnp.asarray(q), qj_kv, None, jnp.float32))
    got = tkv._attend_quantized(torch.from_numpy(q), qt_kv, None, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
