"""Audio frontend: framing -> window -> DFT -> power -> mel -> log.

The same matmul-DFT math as the JAX package's ``audio/frontend.py``: the
STFT is two float32 matrix products (frames x DFT cosine/sine bases), then
power x mel filterbank. This module is the plain PyTorch version of the
fused log-mel kernel (``yoho_tpu_torch.ops.mel_kernel``) and its numerics
oracle. The JAX reference runs these products at ``Precision.HIGHEST``;
here they run in full FP32 inside ``core.device.full_fp32``, which sets
``torch.backends.cuda.matmul.allow_tf32 = False`` for them (TF32 keeps
about three decimal digits, which the power -> log chain amplifies).

Two framing/scaling conventions:

* ``convention="scipy"``  — ``scipy.signal.stft(..., boundary=None,
  padded=True)``: periodic Hann, end zero-padding, 1/sum(window) scaling.
* ``convention="whisper"`` — OpenAI Whisper / HF WhisperFeatureExtractor:
  center=True, reflect padding, unscaled, last frame dropped
  (480,000 samples -> 3000 frames).

Output layout is time-major ``(batch, frames, mels)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from yoho_tpu_torch.audio.filters import mel_filter_bank
from yoho_tpu_torch.core.device import full_fp32


@lru_cache(maxsize=None)
def _hann_periodic(n_fft: int) -> np.ndarray:
    k = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft)).astype(np.float32)


@lru_cache(maxsize=None)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cosine/sine bases, each (n_fft, n_fft//2 + 1), float32."""
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def n_frames_scipy(n_samples: int, n_fft: int, hop: int) -> int:
    """Frame count of scipy stft with boundary=None, padded=True."""
    return int(np.ceil(max(n_samples - n_fft, 0) / hop)) + 1


def pad_for_convention(audio: torch.Tensor, n_fft: int, hop: int,
                       convention: str) -> tuple[torch.Tensor, int]:
    """(B, n) audio -> (padded audio, frame count) for one convention.

    Frame ``f`` then covers ``padded[:, f*hop : f*hop + n_fft]``; samples
    past the end of ``padded`` read as zero (the scipy end padding)."""
    n_samples = audio.shape[-1]
    if convention == "scipy":
        return audio, n_frames_scipy(n_samples, n_fft, hop)
    if convention == "whisper":
        half = n_fft // 2
        if n_samples <= max(half, hop):
            # reflect padding needs width < axis size, and the frame count
            # n_samples // hop needs at least one hop of audio.
            grow = max(half + 1, hop) - n_samples
            audio = F.pad(audio, (0, grow))
            n_samples += grow
        # torch.stft(center=True) gives 1 + n_samples // hop frames;
        # whisper drops the last one.
        audio = F.pad(audio[:, None], (half, half), mode="reflect")[:, 0]
        return audio, n_samples // hop
    raise ValueError(f"unknown stft convention {convention!r}")


def stft_power(audio: torch.Tensor, n_fft: int, hop: int,
               convention: str = "scipy") -> torch.Tensor:
    """Power spectrogram |STFT|^2, (B, frames, n_fft//2 + 1), float32."""
    audio = audio.to(torch.float32)
    audio, num_frames = pad_for_convention(audio, n_fft, hop, convention)
    need = (num_frames - 1) * hop + n_fft
    if audio.shape[-1] < need:
        audio = F.pad(audio, (0, need - audio.shape[-1]))
    frames = audio.unfold(-1, n_fft, hop)[:, :num_frames]  # (B, T, n_fft)
    win = torch.from_numpy(_hann_periodic(n_fft)).to(audio.device)
    cos_b, sin_b = (torch.from_numpy(b).to(audio.device)
                    for b in _dft_bases(n_fft))
    windowed = frames * win
    re = windowed @ cos_b
    im = windowed @ sin_b
    power = re * re + im * im
    if convention == "scipy":  # scipy scaling="spectrum": 1/sum(win)
        scale = 1.0 / float(_hann_periodic(n_fft).sum())
        power = power * (scale * scale)
    return power


def normalize_standardize(log_spec: torch.Tensor) -> torch.Tensor:
    """Per-sample mean/std standardization over (time, mel), with the
    reference's std == 0 guard (the population std, as ``jnp.std``)."""
    mean = log_spec.mean(dim=(-1, -2), keepdim=True)
    std = log_spec.std(dim=(-1, -2), keepdim=True, correction=0)
    return (log_spec - mean) / torch.where(std != 0, std, torch.ones_like(std))


def normalize_whisper(log_spec: torch.Tensor) -> torch.Tensor:
    """OpenAI Whisper dynamic-range compression: clamp to per-sample
    max-8 dB, then (x + 4) / 4."""
    mx = log_spec.amax(dim=(-1, -2), keepdim=True)
    log_spec = torch.maximum(log_spec, mx - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(
    audio: torch.Tensor,
    *,
    sample_rate: int,
    n_fft: int,
    hop: int,
    n_mels: int,
    mel_scale: str,
    convention: str,
    log_floor: float,
) -> torch.Tensor:
    """Un-normalized log10 mel spectrogram, (B, frames, n_mels)."""
    if getattr(audio, "ndim", None) != 2:
        raise ValueError(
            "expected audio of shape (batch, n_samples), got "
            f"{getattr(audio, 'shape', type(audio))}")
    with full_fp32():
        power = stft_power(audio, n_fft, hop, convention=convention)
        filters = torch.from_numpy(
            mel_filter_bank(sample_rate, n_fft, n_mels, mel_scale=mel_scale).T
            .copy()).to(power.device)  # (n_freq, n_mels)
        mel = power @ filters
    return torch.log10(torch.clamp_min(mel, log_floor))


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 80,
                    sample_rate: int = 16000, n_fft: int = 400,
                    hop: int = 160) -> torch.Tensor:
    """OpenAI-Whisper-compatible frontend: (B, 480000) -> (B, 3000, n_mels)."""
    log_spec = log_mel_spectrogram(
        audio, sample_rate=sample_rate, n_fft=n_fft, hop=hop, n_mels=n_mels,
        mel_scale="slaney", convention="whisper", log_floor=1e-10)
    return normalize_whisper(log_spec)


def yoho_log_mel(audio: torch.Tensor, config) -> torch.Tensor:
    """The YOHO frontend: scipy STFT + HTK mel + log10 (floor 1e-13) +
    per-sample standardization. (B, n_samples) -> (B, frames, n_mels),
    1,024 frames for a 164,080-sample window."""
    log_spec = log_mel_spectrogram(
        audio, sample_rate=config.sample_rate, n_fft=config.n_fft,
        hop=config.stft_hop, n_mels=config.n_mel_bands, mel_scale="htk",
        convention="scipy", log_floor=1e-13)
    return normalize_standardize(log_spec)
