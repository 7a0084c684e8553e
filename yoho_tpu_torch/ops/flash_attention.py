"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/flash_attention.py::
flash_attention`` (forward only; the backward comes with training). Same
(B, S, H, D) layout and unscaled inputs: pass ``scale``. ``kv_len`` masks
the keys at and past it (padded keys), as the TPU kernel's ``kv_len``
does. bf16 runs on Hopper's wgmma fed by TMA (sm_90a), f32 on FMAs. The
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from yoho_tpu_torch.ops._build import F, I, P, CudaKernel, ptr, stream_of

KERNEL = CudaKernel(
    "flash_attention_forward", "flash_attention.cu", "flash_attention_forward",
    [I, P, P, P, P, I, I, I, I, I, I, F, I, P],
    replaces="yoho_tpu/ops/flash_attention.py:116 _flash_forward_impl")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)  # every whisper size
NEG_INF = torch.finfo(torch.float32).min


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain attention, (B, S, H, D) layout: f32 scores, finfo.min mask
    (keys >= ``kv_len``, and above the diagonal when causal), softmax,
    weights rounded to the input type for the value product."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    tq, tk = scores.shape[-2:]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = kpos < (tk if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos <= torch.arange(tq, device=q.device)[:, None])
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, T, H, D) -> (B, S, H, D) in q's type.
    Keys at and past ``kv_len`` (default T) are masked."""
    b, s, h, d = q.shape
    t = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kv_len = t if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    if k.shape != (b, t, h, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if causal and s != t:
        raise ValueError("causal flash attention needs S == T")
    if not q.is_cuda:
        return attention_reference(q, k, v, causal, scale, kv_len)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32 or bf16 q/k/v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head dim {d} not in {_HEAD_DIMS}")
    # The bf16 kernel's TMA loads need 16-byte aligned bases: a view that
    # starts mid-allocation is copied.
    q, k, v = (x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    out = torch.empty_like(q)
    KERNEL.launch(_DTYPES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(out), b, h,
                  s, t, kv_len, d, float(scale), int(causal), stream_of(q))
    return out
