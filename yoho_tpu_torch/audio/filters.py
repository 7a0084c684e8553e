"""Mel filterbank construction (host-side numpy, cached).

Supports both mel scales in the wild:
  * ``htk``    — 2595*log10(1+f/700); what the reference uses
                 (``yoho/src/preprocessing/mel_filterbanks.py:5-12``).
  * ``slaney`` — piecewise linear below 1 kHz, log above; what OpenAI
                 Whisper / librosa-default use. Needed to reproduce
                 pretrained-Whisper features exactly.

Both use Slaney area normalization (2/bandwidth), triangular filters,
fmin=0, fmax=sr/2 — matching the reference's construction loop
(``mel_filterbanks.py:22-42``) and librosa.filters.mel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def hz_to_mel(freq, mel_scale: str = "htk"):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale == "slaney":
        f_min, f_sp = 0.0, 200.0 / 3
        mels = (freq - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            freq >= min_log_hz,
            min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
            mels,
        )
    raise ValueError(f"unknown mel scale {mel_scale!r}")


def mel_to_hz(mels, mel_scale: str = "htk"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    if mel_scale == "slaney":
        f_min, f_sp = 0.0, 200.0 / 3
        freqs = f_min + f_sp * mels
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            mels >= min_log_mel,
            min_log_hz * np.exp(logstep * (mels - min_log_mel)),
            freqs,
        )
    raise ValueError(f"unknown mel scale {mel_scale!r}")


@lru_cache(maxsize=None)
def mel_filter_bank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, n_fft // 2 + 1), float32.

    ``mel_scale="htk"`` reproduces the reference filterbank bit-for-bit;
    ``mel_scale="slaney"`` reproduces OpenAI Whisper's (librosa default).
    """
    if fmax is None:
        fmax = sample_rate / 2.0

    n_freqs = 1 + n_fft // 2
    fftfreqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sample_rate)

    mel_pts = np.linspace(
        hz_to_mel(fmin, mel_scale), hz_to_mel(fmax, mel_scale), n_mels + 2
    )
    hz_pts = mel_to_hz(mel_pts, mel_scale)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    weights = np.zeros((n_mels, n_freqs), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
