"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/flash_attention.py::
flash_attention``. Same (B, S, H, D) layout and unscaled inputs: pass
``scale``. ``kv_len`` masks the keys at and past it (padded keys), as the
TPU kernel's ``kv_len`` does. k and v may carry fewer heads than q
(grouped-query attention): with Hkv dividing H, query head h reads KV head
``h // (H // Hkv)``, which is what the JAX model's ``jnp.repeat`` of the KV
heads gives; the kernel reads each KV head once, and the plain version
repeats them itself. The kernel takes every head dim D >= 1, each at
instantiated widths (:func:`kernel_width`, :func:`kernel_slices`;
zero-padded in shared memory): bf16 at a multiple of 8 up to 128 runs on
Hopper's wgmma fed by TMA (sm_90a) at W = 16, 32, 64 or 128; f32, and bf16
at any other D up to 256, on FMAs at W = 16, 32, 64, 128 or 256; D above
256 on the split route, which cuts the output dims into slices of width
256 and a rest at the smallest FMA width that holds it, a block per slice
summing the scores over all of D (:func:`kernel_route`). The FMA and split
kernels put B x H blocks on a grid axis of at most 65,535: a larger batch
launches in runs of rows, one count each (``_build.row_chunks``); the
wgmma route is persistent and takes any batch in one launch. The wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor
it launches the kernel or raises.

The gradient is the JAX package's: its ``custom_vjp`` backward is
``jax.vjp`` of the plain attention, a recompute, not a kernel. Here
:class:`FlashAttentionFunction` saves q, k and v and recomputes through
:func:`attention_reference` under ``torch.autograd.grad``, on either
device; the gradients of grouped k and v come back in their own
(unrepeated) shape. It runs only when an input requires a gradient;
otherwise the forward is the plain call above.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from yoho_tpu_torch.ops._build import F, I, P, CudaKernel, ptr, row_chunks, stream_of

KERNEL = CudaKernel(
    "flash_attention_forward", "flash_attention.cu", "flash_attention_forward",
    [I, P, P, P, P, I, I, I, I, I, I, I, F, I, P],
    replaces="yoho_tpu/ops/flash_attention.py:116 _flash_forward_impl")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The wgmma route's widths (bf16 at a multiple of 8): 64 whisper and the
# full-width YOHO model, 16, 32 and 128 YOHO sessions.
WIDTHS = (16, 32, 64, 128)
# The FMA route's widths: f32, and the bf16 head dims TMA cannot take.
FMA_WIDTHS = (16, 32, 64, 128, 256)
NEG_INF = torch.finfo(torch.float32).min


def kernel_route(d: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """``"wgmma"`` (bf16 at a multiple of 8 up to 128: wgmma fed by TMA),
    ``"fma"`` (f32, and every other bf16 head dim up to 256) or ``"split"``
    (every head dim above 256: output slices, :func:`kernel_slices`).
    Raises ``ValueError`` for a head dim below 1."""
    if d < 1:
        raise ValueError(f"flash kernel head dim {d} below 1")
    if d > FMA_WIDTHS[-1]:
        return "split"
    return "wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and d <= WIDTHS[-1] else "fma"


def kernel_slices(d: int, dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The widths of the slices of the output dims that the kernel computes
    head dim ``d`` in, in order: one slice up to 256, at the smallest width
    of its route that holds ``d``; above 256 (the split route) one of width
    256 per 256 dims and the rest at the smallest FMA width that holds it
    (264 -> (256, 16), 512 -> (256, 256)). Every slice's block computes the
    scores over all of ``d``. Raises ``ValueError`` for a head dim below 1."""
    route = kernel_route(d, dtype)
    if route != "split":
        return (next(w for w in (WIDTHS if route == "wgmma" else FMA_WIDTHS) if w >= d),)
    full, rest = divmod(d, FMA_WIDTHS[-1])
    return (FMA_WIDTHS[-1],) * full + \
        ((next(w for w in FMA_WIDTHS if w >= rest),) if rest else ())


def kernel_width(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The widest instantiated width W the kernel runs head dim ``d`` at in
    ``dtype`` (sessions serve in bf16, the default): up to 256 the smallest
    width of its route (:func:`kernel_route`) that holds it, above 256 the
    split route's 256. Raises ``ValueError`` for a head dim below 1."""
    return kernel_slices(d, dtype)[0]


def _repeat_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """KV heads -> ``heads`` query heads: head h reads KV head h // groups."""
    return x if x.shape[2] == heads else x.repeat_interleave(heads // x.shape[2], 2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain attention, (B, S, H, D) layout: f32 scores, finfo.min mask
    (keys >= ``kv_len``, and above the diagonal when causal), softmax,
    weights rounded to the input type for the value product. Grouped k and
    v (fewer heads than q) are repeated to q's heads first. Autocast does
    not reach it: the scores stay f32 whatever the caller's autocast."""
    k, v = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2])
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        tq, tk = scores.shape[-2:]
        kpos = torch.arange(tk, device=q.device)[None, :]
        mask = kpos < (tk if kv_len is None else kv_len)
        if causal:
            mask = mask & (kpos <= torch.arange(tq, device=q.device)[:, None])
        scores = scores.masked_fill(~mask, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _forward(q, k, v, causal: bool, scale: float, kv_len: int) -> torch.Tensor:
    if not q.is_cuda:
        return attention_reference(q, k, v, causal, scale, kv_len)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32 or bf16 q/k/v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    route = kernel_route(d, q.dtype)
    # The bf16 kernel's TMA loads need 16-byte aligned bases: a view that
    # starts mid-allocation is copied.
    q, k, v = (x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    out = torch.empty_like(q)
    # The FMA and split kernels put batch x heads on the grid's y axis (at
    # most 65,535 blocks): a larger batch launches in runs of rows, each
    # counted. The wgmma route is persistent and takes any batch at once.
    for b0, b1 in [(0, b)] if route == "wgmma" else row_chunks(b, h):
        rows = slice(b0, b1)
        KERNEL.launch(_DTYPES[q.dtype], ptr(q[rows]), ptr(k[rows]), ptr(v[rows]),
                      ptr(out[rows]), b1 - b0, h, k.shape[2], s, k.shape[1], kv_len, d,
                      float(scale), int(causal), stream_of(q))
    return out


class FlashAttentionFunction(torch.autograd.Function):
    """The forward through the kernel (CUDA) or the plain version (CPU),
    keeping no graph; the backward recomputes the plain version and takes
    its gradient, as the JAX package's ``_flash_bwd`` does. ``causal``,
    ``scale`` and ``kv_len`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, kv_len: int):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, kv_len)
        return _forward(q, k, v, causal, scale, kv_len)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        # The recompute keeps the saved types: no autocast casts them.
        with torch.enable_grad(), torch.autocast(saved[0].device.type, enabled=False):
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            out = attention_reference(*inputs, *ctx.args)
            wanted = [t for t, n in zip(inputs, needs) if n]
            got = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(got) if n else None for n in needs), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, T, Hkv, D) with Hkv dividing H -> (B, S,
    H, D) in q's type; query head h reads KV head h // (H // Hkv). Keys at
    and past ``kv_len`` (default T) are masked."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kv_len = t if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    if hkv < 1 or h % hkv or k.shape != (b, t, hkv, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if causal and s != t:
        raise ValueError("causal flash attention needs S == T")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, float(scale), kv_len)
    return _forward(q, k, v, causal, scale, kv_len)
