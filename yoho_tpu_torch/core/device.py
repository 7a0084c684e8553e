"""Device selection and float32 precision shared by the port.

Entry points run on the GPU unless the caller asks for the CPU: with
``device=None`` a machine without CUDA is an error, never a silent CPU
run.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:  # "cuda" -> "cuda:<current>", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _scalar_on(device: torch.device, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def div_exact(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as an IEEE division on every device. PyTorch's CUDA
    division by a Python number multiplies by its reciprocal instead, which
    can land one ulp away from the quotient JAX computes (and flip an int8
    code on an exact half); a divisor tensor on the same device is divided
    by exactly."""
    return x / _scalar_on(x.device, float(value))


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Runs float32 matrix products and convolutions in full FP32 inside
    the block, and restores the caller's settings after it.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` (the frontend's
    DFT and the f32 logits need all 24 mantissa bits: the JAX reference
    runs them at ``Precision.HIGHEST``) and
    ``torch.backends.cudnn.allow_tf32 = False`` (a float32 convolution in
    cuDNN defaults to TF32, which keeps about three decimal digits). Both
    are process-wide flags, so they are set only for the block."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
