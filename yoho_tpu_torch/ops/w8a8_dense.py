"""W8A8 dense: the CUDA kernel ``csrc/w8a8_dense.cu`` and its plain PyTorch
version.

Counterpart of the JAX package's ``ops/w8a8_dense.py::w8a8_dense``, the
encoder's int8 serving engine (``Whisper(encoder_int8=True)``):

  out = act((quant(x) @ w_q^T) * x_scale * w_scale + bias)

with ``quant`` the per-row absmax int8 quantization of ``x``
(:func:`quantize_rows`), an exact int32 accumulation, per-output-channel
weight scales and the optional tanh-GELU (:func:`gelu_tanh`).

  x        (..., K)  f32/bf16
  w_q      (N, K)    int8, K contiguous (``nn.Linear``'s layout)
  w_scale  (N,) or (1, N) f32
  bias     (N,) f32 or None
  returns  (..., N)  ``out_dtype``

The kernel takes K a multiple of 32 up to 8192 and N a multiple of 8
(every whisper width) and any number of rows. The wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from yoho_tpu_torch.core.device import div_exact
from yoho_tpu_torch.ops._build import I, P, CudaKernel, ptr, stream_of

KERNEL = CudaKernel(
    "w8a8_dense", "w8a8_dense.cu", "w8a8_dense",
    [I, I, P, P, P, P, P, P, P, I, I, I, I, P],
    replaces="yoho_tpu/ops/w8a8_dense.py:93 w8a8_dense")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTIVATIONS = (None, "gelu_tanh")
_MAX_K = 8192  # the quantize pass holds a row in registers
_GELU_C = 0.7978845608028654  # sqrt(2/pi)


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """The tanh GELU approximation in the reference's order of operations."""
    return 0.5 * y * (1.0 + torch.tanh(_GELU_C * (y + 0.044715 * y * y * y)))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric absmax int8 quantization: (codes int8,
    scale f32 with the last axis kept). The dynamic half of the W8A8 scheme
    for activations, and the weight scheme of ``nn/quantize.py`` for the rows
    of an (out, in) weight; a true division and round-half-to-even, as JAX
    computes them."""
    xf = x.float()
    scale = torch.clamp_min(div_exact(xf.abs().amax(dim=-1, keepdim=True), 127.0), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _check_activation(activation: Optional[str]) -> None:
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")


def _exact_int_product(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``xq @ w_q.T`` of int8 codes, exact (every partial sum is at most
    K * 127^2 < 2^31). On the CPU the product runs in integer arithmetic
    (``torch._int_mm``: int8 operands, int32 sums; a tenth of the time of
    an int32 ``mm``), not through the float64 BLAS: a multithreaded float64
    GEMM is exact only while every thread computes what it should, and the
    plain version once returned non-integer sums for a block of rows on the
    CPU (ROADMAP Queue 3). On CUDA (the plain version the kernel is held
    against) integer matmuls are refused, and the float64 product, exact
    here, runs."""
    if xq.is_cuda:
        return xq.double() @ w_q.double().T
    return torch._int_mm(xq, w_q.T)


def w8a8_dense_reference(x, w_q, w_scale, bias=None, *, activation=None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same contract)."""
    _check_activation(activation)
    n, k = w_q.shape
    lead = x.shape[:-1]
    xq, xs = quantize_rows(x.reshape(-1, k))
    y = _exact_int_product(xq, w_q).float() * xs * w_scale.reshape(1, n).float()
    if bias is not None:
        y = y + bias.float()
    if activation == "gelu_tanh":
        y = gelu_tanh(y)
    return y.to(out_dtype).reshape(*lead, n)


def w8a8_dense(x, w_q, w_scale, bias=None, *, activation=None,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8 dense through the kernel (CUDA) or its plain version (CPU); see
    the module docstring for the contract."""
    _check_activation(activation)
    if w_q.dim() != 2 or x.shape[-1] != w_q.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} disagree "
                         "(w_q is (N, K))")
    n, k = w_q.shape
    if w_scale.numel() != n or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} / bias "
                         f"{None if bias is None else tuple(bias.shape)} do not "
                         f"match N = {n}")
    if not x.is_cuda:
        return w8a8_dense_reference(x, w_q, w_scale, bias, activation=activation,
                                    out_dtype=out_dtype)
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"w8a8 kernel takes f32/bf16 x and output, got {x.dtype} "
                        f"-> {out_dtype}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError("w8a8 kernel takes int8 w_q and f32 w_scale and bias")
    if k % 32 or k > _MAX_K or n % 8:
        raise ValueError(f"w8a8 kernel takes K % 32 == 0, K <= {_MAX_K} and "
                         f"N % 8 == 0, got K={k}, N={n}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    w_q, w_scale = w_q.contiguous(), w_scale.reshape(n).contiguous()
    bias = bias.contiguous() if bias is not None else None
    for name, t in (("x", x2), ("w_q", w_q), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"{name} must lie on {x.device}, 16-byte aligned")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    KERNEL.launch(_DTYPES[x2.dtype], _DTYPES[out_dtype], ptr(x2), ptr(w_q),
                  ptr(w_scale), ptr(bias) if bias is not None else None, ptr(xq),
                  ptr(xs), ptr(out), m, n, k, int(activation == "gelu_tanh"),
                  stream_of(out))
    return out.reshape(*lead, n)
