"""Fused log-mel frontend: the CUDA kernel ``csrc/mel_kernel.cu`` and its
plain PyTorch version.

Counterpart of the JAX package's ``ops/mel_kernel.py::fused_log_mel``.
The kernel computes framing -> windowed DFT (3xTF32 on the tensor cores)
-> power -> sparse mel projection -> log10 without writing the frame
matrix to device memory; the plain version is
``audio.frontend.log_mel_spectrogram`` (the same matmul-DFT math). The
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. Normalization (the whisper clamp,
the YOHO per-sample standardization) needs per-sample statistics and stays
outside the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from yoho_tpu_torch.audio.filters import mel_filter_bank
from yoho_tpu_torch.audio.frontend import (
    _dft_bases,
    _hann_periodic,
    log_mel_spectrogram,
    normalize_standardize,
    normalize_whisper,
    pad_for_convention,
)
from yoho_tpu_torch.ops._build import F, I, P, CudaKernel, ptr, stream_of

KERNEL = CudaKernel(
    "mel_log_spectrogram", "mel_kernel.cu", "mel_log_spectrogram",
    [P, I, I, I, P, P, P, P, I, I, I, I, F, P],
    replaces="yoho_tpu/ops/mel_kernel.py:104 fused_log_mel")


def fragment_bases(cos_w: np.ndarray, sin_w: np.ndarray) -> np.ndarray:
    """The windowed DFT bases (n_fft, n_freq) in the kernel's mma fragment
    order, (n_k8, n_grp, 32, 4) f32: for 8 samples ``kb``, 8 frequencies
    ``gp`` and lane ``4 g + t4``, the cosine at samples ``8 kb + t4`` and
    ``8 kb + t4 + 4`` of frequency ``8 gp + g``, then the sine at the same
    two (zero past n_fft and n_freq)."""
    n_fft, n_freq = cos_w.shape
    n_k8, n_grp = -(-n_fft // 8), -(-n_freq // 8)
    pad = ((0, 8 * n_k8 - n_fft), (0, 8 * n_grp - n_freq))
    c, s = np.pad(cos_w, pad), np.pad(sin_w, pad)
    lane = np.arange(32)
    k0 = 8 * np.arange(n_k8)[:, None, None] + lane % 4
    f = 8 * np.arange(n_grp)[None, :, None] + lane // 4
    return np.ascontiguousarray(
        np.stack([c[k0, f], c[k0 + 4, f], s[k0, f], s[k0 + 4, f]], -1), np.float32)


def mel_bands(filt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The mel projection (n_freq, n_mels) as its bands' nonzero spans:
    ``bands`` int32 = n_mels first bins, then n_mels + 1 offsets into
    ``wts``, each band's weights from its first to its last nonzero bin."""
    first, offsets, weights = [], [0], []
    for m in range(filt.shape[1]):
        nz = np.flatnonzero(filt[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        first.append(lo)
        weights.append(filt[lo:hi, m])
        offsets.append(offsets[-1] + hi - lo)
    wts = np.concatenate(weights + [np.zeros(1, np.float32)]).astype(np.float32)
    return np.asarray(first + offsets, np.int32), wts


@functools.lru_cache(maxsize=None)
def _windowed(n_fft: int, scaled: bool):
    """Windowed DFT bases (n_fft, n_freq), float64 -> float32 on the host as
    the TPU kernel's ``_constants`` makes them (``scaled``: scipy's
    1/sum(win))."""
    win = _hann_periodic(n_fft).astype(np.float64)
    if scaled:
        win = win / win.sum()
    cos_b, sin_b = _dft_bases(n_fft)
    cos_w = (win[:, None] * cos_b.astype(np.float64)).astype(np.float32)
    sin_w = (win[:, None] * sin_b.astype(np.float64)).astype(np.float32)
    return cos_w, sin_w


@functools.lru_cache(maxsize=None)
def _constants(sample_rate: int, n_fft: int, hop: int, n_mels: int,
               mel_scale: str, scaled: bool):
    """The kernel's constants: fragment-ordered bases, band spans, band
    weights."""
    filt = np.ascontiguousarray(
        mel_filter_bank(sample_rate, n_fft, n_mels, mel_scale=mel_scale).T,
        dtype=np.float32)
    return (fragment_bases(*_windowed(n_fft, scaled)), *mel_bands(filt))


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device, *key):
    return tuple(torch.from_numpy(c).to(device) for c in _constants(*key))


def fused_log_mel(
    audio: torch.Tensor,  # (..., n_samples) f32
    *,
    sample_rate: int = 16000,
    n_fft: int = 400,
    hop: int = 160,
    n_mels: int = 80,
    mel_scale: str = "slaney",
    convention: str = "whisper",
    log_floor: float = 1e-10,
) -> torch.Tensor:
    """Un-normalized log10-mel, (..., frames, n_mels).

    ``convention="whisper"``: reflect-pad + centre frames (n // hop frames).
    ``convention="scipy"``: boundary=None framing with 1/sum(win) scaling.
    """
    lead = audio.shape[:-1]
    audio = audio.reshape(-1, audio.shape[-1]).to(torch.float32)
    if convention not in ("whisper", "scipy"):
        raise ValueError(f"unknown convention {convention!r}")
    if not audio.is_cuda:
        out = log_mel_spectrogram(
            audio, sample_rate=sample_rate, n_fft=n_fft, hop=hop,
            n_mels=n_mels, mel_scale=mel_scale, convention=convention,
            log_floor=log_floor)
        return out.reshape(*lead, out.shape[-2], n_mels)
    padded, num_frames = pad_for_convention(audio, n_fft, hop, convention)
    padded = padded.contiguous()
    bases, bands, wts = _device_constants(
        padded.device, sample_rate, n_fft, hop, n_mels, mel_scale,
        convention == "scipy")
    b = padded.shape[0]
    out = torch.empty((b, num_frames, n_mels), dtype=torch.float32,
                      device=padded.device)
    KERNEL.launch(ptr(padded), b, padded.shape[1], num_frames, ptr(bases),
                  ptr(bands), ptr(wts), ptr(out), n_fft, hop,
                  n_fft // 2 + 1, n_mels, float(log_floor), stream_of(out))
    return out.reshape(*lead, num_frames, n_mels)


def fused_whisper_log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper-normalized fused frontend: drop-in for
    ``audio.frontend.whisper_log_mel``."""
    if getattr(audio, "ndim", None) != 2:
        raise ValueError(
            "expected audio of shape (batch, n_samples), got "
            f"{getattr(audio, 'shape', type(audio))}")
    return normalize_whisper(
        fused_log_mel(audio, n_mels=n_mels, mel_scale="slaney",
                      convention="whisper", log_floor=1e-10))


def fused_yoho_log_mel(audio: torch.Tensor, config) -> torch.Tensor:
    """The YOHO frontend through the kernel (scipy framing, HTK filters,
    log floor 1e-13), then the per-sample standardization over (time,
    mel): drop-in for ``audio.frontend.yoho_log_mel``."""
    if getattr(audio, "ndim", None) != 2:
        raise ValueError(
            "expected audio of shape (batch, n_samples), got "
            f"{getattr(audio, 'shape', type(audio))}")
    return normalize_standardize(
        fused_log_mel(audio, sample_rate=config.sample_rate, n_fft=config.n_fft,
                      hop=config.stft_hop, n_mels=config.n_mel_bands,
                      mel_scale="htk", convention="scipy", log_floor=1e-13))
