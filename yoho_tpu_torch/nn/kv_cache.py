"""Decode caches: float, int8 and int4 KV in the time-minor (B, H, D, T)
layout of the JAX package's ``nn/kv_cache.py``.

On the GPU the time-minor layout is kept because the decode kernel reads
it coalesced: neighbouring threads take neighbouring positions of a row.
The int8 codes and bf16 scales are bit-exact with the JAX package: the
scale is an absmax (a selection) divided by 127 in f32 and stored as bf16,
and ``torch.round``, like ``jnp.round``, rounds half to even. The int4
nibble order is a stored format: ``D[0:D/2]`` in the low nibbles.

Unlike the JAX caches, which are immutable pytrees, ``update`` writes the
new entries into the cache tensors in place (one cache buffer per layer
instead of a copy per step) and returns the same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from yoho_tpu_torch.core.device import div_exact
from yoho_tpu_torch.ops.decode_attention import (
    attend_time_minor,
    fused_decode_attention,
    is_row_pos,
    unpack_int4,
)

__all__ = ["KVCache", "QuantizedKV", "QuantizedKVCache", "attend_quantized",
           "_attend_quantized", "quantize_kv", "quantize_kv4", "unpack_int4"]


def _write_rows(big: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Writes ``new`` (B, H, D|1, S) into ``big`` (B, H, D|1, T) in place,
    row b at positions ``pos[b] .. pos[b] + S - 1`` (a device tensor (B,);
    the host never reads it).

    Entries at or past T are dropped, as a JAX scatter drops them (an
    index out of range would be a device-side assert on CUDA): each one is
    sent to its row's spare column ``clamp(pos[b] - 1, 0, T - 1)``, which
    no kept entry of the row writes when ``pos[b] >= 1``, and writes back
    the value that column holds. Every dropped entry of a row writes the
    same value there, so the duplicate indices agree."""
    t, s = big.shape[3], new.shape[3]
    p = pos.long()
    idx = p[:, None] + torch.arange(s, device=p.device)[None, :]  # (B, S)
    keep = idx < t
    dst = torch.where(keep, idx, torch.clamp(p - 1, 0, t - 1)[:, None])
    rows = torch.arange(big.shape[0], device=p.device)[:, None]
    # Advanced indices at dims 0 and 3: the indexed shape is (B, S, H, D|1).
    vals = new.permute(0, 3, 1, 2).to(big.dtype)
    big[rows, :, :, dst] = torch.where(keep[:, :, None, None], vals,
                                       big[rows, :, :, dst])


@dataclass
class KVCache:
    """Float decode cache for one attention layer: k/v (B, H, D, T)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, batch: int, kv_heads: int, max_len: int, head_dim: int,
              dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, kv_heads, head_dim, max_len)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def update(self, pos, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write (B, H, D, S) new entries at time offset ``pos``, in place.

        ``pos`` is an int, or a (B,) int tensor on the cache's device: row
        b is written at ``pos[b] .. pos[b] + S - 1`` (the per-slot layout of
        continuous batching and its draft-verify blocks), and entries past
        the horizon are dropped (:func:`_write_rows`)."""
        if is_row_pos(pos):
            _write_rows(self.k, k_new, pos)
            _write_rows(self.v, v_new, pos)
            return self
        p = int(pos)
        s = k_new.shape[3]
        self.k[..., p:p + s] = k_new.to(self.k.dtype)
        self.v[..., p:p + s] = v_new.to(self.v.dtype)
        return self


@dataclass
class QuantizedKV:
    """Int8 (or packed int4) cross-attention KV with per-(batch, head,
    position) scales: values (B, H, D/packing, T), scales (B, H, 1, T)."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    kv_len: Optional[int] = None  # valid prefix when T is padded
    packing: int = 1              # 1 = int8, 2 = two int4 nibbles along D


def _absmax_scale(x: torch.Tensor, axis: int, qmax: float) -> torch.Tensor:
    scale = div_exact(x.abs().amax(dim=axis, keepdim=True).to(torch.float32), qmax)
    return torch.clamp_min(scale, 1e-8)


def _pad_time(q: QuantizedKV, t: int, pad_to: Optional[int]) -> QuantizedKV:
    if pad_to is None or t % pad_to == 0:
        return q
    pad = (0, pad_to - t % pad_to)
    F = torch.nn.functional
    return QuantizedKV(k_q=F.pad(q.k_q, pad), v_q=F.pad(q.v_q, pad),
                       k_scale=F.pad(q.k_scale, pad), v_scale=F.pad(q.v_scale, pad),
                       kv_len=t, packing=q.packing)


def quantize_kv(k: torch.Tensor, v: torch.Tensor, pad_to: Optional[int] = None,
                time_major: bool = False) -> QuantizedKV:
    """Quantize K/V to int8, absmax per (batch, head, position).

    Inputs are time-minor (B, H, D, T), or time-major (B, T, H, D) with
    ``time_major=True`` (the projections' layout: quantize first, then
    transpose the int8 codes). Output is time-minor: codes (B, H, D, T)
    int8, scales (B, H, 1, T) bf16. ``pad_to`` zero-pads T to a multiple
    and records the valid length as ``kv_len``."""
    d_axis = 3 if time_major else 2

    def _q(x):
        scale = _absmax_scale(x, d_axis, 127.0)
        q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
        q, scale = q.to(torch.int8), scale.to(torch.bfloat16)
        if time_major:  # (B, T, H, D|1) -> (B, H, D|1, T)
            q = q.permute(0, 2, 3, 1).contiguous()
            scale = scale.permute(0, 2, 3, 1).contiguous()
        return q, scale

    t = k.shape[1] if time_major else k.shape[3]
    k_q, k_scale = _q(k)
    v_q, v_scale = _q(v)
    return _pad_time(QuantizedKV(k_q, v_q, k_scale, v_scale), t, pad_to)


def quantize_kv4(k: torch.Tensor, v: torch.Tensor, pad_to: Optional[int] = None,
                 time_major: bool = False) -> QuantizedKV:
    """Int4 variant of :func:`quantize_kv`: codes in [-8, 7] stored two per
    byte along D, (B, H, D//2, T) uint8 with ``D[0:D/2]`` in the low
    nibbles and ``D[D/2:D]`` in the high nibbles."""
    d_axis = 3 if time_major else 2

    def _q(x):
        scale = _absmax_scale(x, d_axis, 7.0)
        q = torch.clamp(torch.round(x.to(torch.float32) / scale), -8, 7) + 8.0
        q = q.to(torch.uint8)
        half = q.shape[d_axis] // 2
        lo, hi = q.narrow(d_axis, 0, half), q.narrow(d_axis, half, half)
        packed = lo | (hi << 4)
        scale = scale.to(torch.bfloat16)
        if time_major:
            packed = packed.permute(0, 2, 3, 1).contiguous()
            scale = scale.permute(0, 2, 3, 1).contiguous()
        return packed, scale

    t = k.shape[1] if time_major else k.shape[3]
    k_q, k_scale = _q(k)
    v_q, v_scale = _q(v)
    return _pad_time(QuantizedKV(k_q, v_q, k_scale, v_scale, packing=2), t,
                     pad_to)


def attend_quantized(q: torch.Tensor, qkv: QuantizedKV, pos=None) -> torch.Tensor:
    """Attention of pre-scaled q (B, H, S, D) against quantized KV through
    the decode kernel (plain version on the CPU); ``pos`` (an int or a
    per-row (B,) tensor) makes it causal. Returns (B, S, H, D) in q's
    type."""
    t = qkv.k_q.shape[3]
    return fused_decode_attention(
        q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale, pos=pos,
        kv_len=qkv.kv_len or t, packing=qkv.packing)


def _attend_quantized(q: torch.Tensor, qkv: QuantizedKV, mask,
                      dtype) -> torch.Tensor:
    """Plain attention against int8/int4 time-minor KV, the JAX package's
    arithmetic (the numerics oracle of :func:`attend_quantized`); returns
    (B, S, H, D)."""
    t = qkv.k_q.shape[3]
    if qkv.kv_len is not None and qkv.kv_len < t:
        valid = (torch.arange(t, device=q.device) < qkv.kv_len)[None, None, None, :]
        mask = valid if mask is None else mask & valid
    k_q, v_q = qkv.k_q, qkv.v_q
    if qkv.packing == 2:
        k_q, v_q = unpack_int4(k_q), unpack_int4(v_q)
    return attend_time_minor(q, k_q, v_q, qkv.k_scale, qkv.v_scale, mask, dtype)


@dataclass
class QuantizedKVCache:
    """Int8 self-attention decode cache: values (B, H, D, T) int8 + scales
    (B, H, 1, T) bf16, each position quantized once when it is written."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @classmethod
    def zeros(cls, batch: int, kv_heads: int, max_len: int, head_dim: int,
              dtype=torch.bfloat16, device=None) -> "QuantizedKVCache":
        vals = (batch, kv_heads, head_dim, max_len)
        scales = (batch, kv_heads, 1, max_len)
        return cls(
            k_q=torch.zeros(vals, dtype=torch.int8, device=device),
            v_q=torch.zeros(vals, dtype=torch.int8, device=device),
            k_scale=torch.zeros(scales, dtype=torch.bfloat16, device=device),
            v_scale=torch.zeros(scales, dtype=torch.bfloat16, device=device))

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]

    def update(self, pos, k_new: torch.Tensor,
               v_new: torch.Tensor) -> "QuantizedKVCache":
        """Quantize + write (B, H, D, S) new entries at offset ``pos``, in
        place; ``pos`` an int or a per-row (B,) tensor, as in
        :meth:`KVCache.update`."""

        def _q(x):
            xf = x.to(torch.float32)
            scale = _absmax_scale(xf, 2, 127.0)
            q = torch.clamp(torch.round(xf / scale), -127, 127)
            return q.to(torch.int8), scale.to(torch.bfloat16)

        kq, ks = _q(k_new)
        vq, vs = _q(v_new)
        if is_row_pos(pos):
            for big, new in ((self.k_q, kq), (self.v_q, vq), (self.k_scale, ks),
                             (self.v_scale, vs)):
                _write_rows(big, new, pos)
            return self
        p = int(pos)
        s = k_new.shape[3]
        self.k_q[..., p:p + s] = kq
        self.v_q[..., p:p + s] = vq
        self.k_scale[..., p:p + s] = ks
        self.v_scale[..., p:p + s] = vs
        return self

    def as_quantized_kv(self) -> QuantizedKV:
        return QuantizedKV(k_q=self.k_q, v_q=self.v_q, k_scale=self.k_scale,
                           v_scale=self.v_scale)
