"""Host-side audio augmentation pipeline (numpy/scipy, per-worker CPU).

Capability parity with the reference's audiomentations stack
(``train/utils/augmenter.py:4-18``): Compose(p=0.8) over ten transforms each
applied with p=0.3 — GaussianSNR, AirAbsorption, Aliasing, BandPass,
BandStop, ClippingDistortion, Gain, GainTransition, PeakingFilter,
PitchShift. Implemented from scratch on scipy.signal primitives so the
dataloader needs no extra dependencies; every transform is deterministic
given the ``rng`` and bounded to keep outputs finite.

The port's copy of the JAX package's ``audio/augment.py``, which imports no JAX
(the port imports nothing of ``yoho_tpu``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
from scipy import signal as sps


def _db_to_amp(db: float) -> float:
    return 10.0 ** (db / 20.0)


# ----------------------------------------------------------------- transforms
def add_gaussian_snr(audio, sr, rng, min_snr_db=5.0, max_snr_db=40.0):
    snr = rng.uniform(min_snr_db, max_snr_db)
    rms = np.sqrt(np.mean(audio**2)) + 1e-9
    noise_rms = rms / _db_to_amp(snr)
    noise = rng.standard_normal(len(audio)).astype(np.float32)
    return (audio + noise * noise_rms).astype(np.float32)


def air_absorption(audio, sr, rng, min_distance=10.0, max_distance=100.0):
    """Distance-dependent high-frequency rolloff (one-pole lowpass whose
    cutoff shrinks with simulated distance)."""
    distance = rng.uniform(min_distance, max_distance)
    cutoff = np.clip(8000.0 * (10.0 / distance) ** 0.5, 800.0, sr / 2 - 100)
    b, a = sps.butter(2, cutoff / (sr / 2), btype="low")
    return sps.lfilter(b, a, audio).astype(np.float32)


def aliasing(audio, sr, rng, min_rate=4000, max_rate=12000):
    """Downsample without a proper anti-alias filter, then back up.

    Fractional resample (linear interp, deliberately NO filter — the
    aliasing is the point); integer-step decimation would be a silent
    no-op for every target rate above sr/2."""
    target = rng.uniform(min_rate, max_rate)
    n = len(audio)
    n_down = max(int(n * target / sr), 2)
    down = np.interp(np.linspace(0.0, n - 1, n_down), np.arange(n), audio)
    up = np.interp(np.linspace(0.0, n_down - 1, n), np.arange(n_down), down)
    return up.astype(np.float32)


def _band_edges(center: float, bw: float, sr: float):
    """(lo, hi) clamped inside (0, Nyquist) with lo < hi — at low sample
    rates a center near max_center could land lo above the Nyquist
    clamp, making sps.butter raise and killing a dataloader worker
    stochastically (sub-8 kHz corpora)."""
    hi = min(sr / 2 - 100, center + bw / 2)
    lo = max(20.0, min(center - bw / 2, hi - 50.0))
    return lo, hi


def band_pass(audio, sr, rng, min_center=200.0, max_center=4000.0):
    center = rng.uniform(min_center, min(max_center, sr / 2 - 200))
    bw = center * rng.uniform(0.5, 1.9)
    lo, hi = _band_edges(center, bw, sr)
    b, a = sps.butter(2, [lo / (sr / 2), hi / (sr / 2)], btype="band")
    return sps.lfilter(b, a, audio).astype(np.float32)


def band_stop(audio, sr, rng, min_center=200.0, max_center=4000.0):
    center = rng.uniform(min_center, min(max_center, sr / 2 - 200))
    bw = center * rng.uniform(0.25, 1.0)
    lo, hi = _band_edges(center, bw, sr)
    b, a = sps.butter(2, [lo / (sr / 2), hi / (sr / 2)], btype="bandstop")
    return sps.lfilter(b, a, audio).astype(np.float32)


def clipping_distortion(audio, sr, rng, max_percentile_threshold=40):
    pct = rng.uniform(0, max_percentile_threshold)
    if pct <= 0:
        return audio
    lo, hi = np.percentile(audio, [pct / 2, 100 - pct / 2])
    return np.clip(audio, lo, hi).astype(np.float32)


def gain(audio, sr, rng, min_gain_db=-12.0, max_gain_db=12.0):
    return (audio * _db_to_amp(rng.uniform(min_gain_db, max_gain_db))).astype(np.float32)


def gain_transition(audio, sr, rng, min_gain_db=-24.0, max_gain_db=6.0):
    """Smoothly ramp between two gains over a random span."""
    g0 = _db_to_amp(rng.uniform(min_gain_db, max_gain_db))
    g1 = _db_to_amp(rng.uniform(min_gain_db, max_gain_db))
    n = len(audio)
    a, b = sorted(rng.integers(0, n, size=2))
    if b <= a:
        return (audio * g0).astype(np.float32)
    env = np.concatenate([
        np.full(a, g0),
        np.linspace(g0, g1, b - a, dtype=np.float32),
        np.full(n - b, g1),
    ])
    return (audio * env).astype(np.float32)


def peaking_filter(audio, sr, rng, min_center=50.0, max_center=7000.0,
                   min_gain_db=-24.0, max_gain_db=24.0, q=1.0):
    """Biquad peaking EQ (Audio EQ Cookbook)."""
    f0 = rng.uniform(min_center, min(max_center, sr / 2 - 200))
    gain_db = rng.uniform(min_gain_db, max_gain_db)
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2 * np.pi * f0 / sr
    alpha = np.sin(w0) / (2 * q)
    b = [1 + alpha * A, -2 * np.cos(w0), 1 - alpha * A]
    a = [1 + alpha / A, -2 * np.cos(w0), 1 - alpha / A]
    return sps.lfilter(np.asarray(b) / a[0], np.asarray(a) / a[0], audio).astype(np.float32)


def pitch_shift(audio, sr, rng, min_semitones=-4.0, max_semitones=4.0):
    """Duration-preserving pitch shift: STFT phase-vocoder time stretch
    followed by resampling (librosa-style, self-contained).

    For +s semitones: stretch LONGER by 2^(s/12) at constant pitch
    (``rate`` < 1), then play the long signal back over the original
    duration — the speed-up raises pitch by exactly 2^(s/12). (The
    opposite rate convention silently shifts DOWN for positive
    semitones; caught by the spectral test in tests/test_augment.py.)"""
    semitones = rng.uniform(min_semitones, max_semitones)
    if abs(semitones) < 1e-3:
        return audio
    rate = 2.0 ** (-semitones / 12.0)
    stretched = _time_stretch(audio, rate)
    n, m = len(audio), len(stretched)
    out = np.interp(np.linspace(0.0, m - 1, n), np.arange(m), stretched)
    return out.astype(np.float32)


def _time_stretch(audio, rate, n_fft=1024, hop=256):
    """Phase vocoder time stretch by ``rate`` (rate>1 -> shorter)."""
    if len(audio) < n_fft:
        return audio
    # boundary='zeros' pads nperseg//2 on both ends; the matching istft
    # (boundary=True) trims the same amount — a consistent round trip
    # that keeps the onset (boundary=None + default istft trimming
    # erased the first ~30 ms of every pitch-shifted clip and skewed
    # the shift ~60 cents flat on a 2 s tone).
    _, _, Z = sps.stft(audio, nperseg=n_fft, noverlap=n_fft - hop,
                       boundary="zeros", padded=True)
    n_frames = Z.shape[1]
    steps = np.arange(0, n_frames, rate)
    phase_adv = np.linspace(0, np.pi * hop, Z.shape[0])
    out = np.zeros((Z.shape[0], len(steps)), dtype=np.complex64)
    phase = np.angle(Z[:, 0])
    for i, step in enumerate(steps):
        j = int(step)
        frac = step - j
        mag = (1 - frac) * np.abs(Z[:, j]) + frac * np.abs(Z[:, min(j + 1, n_frames - 1)])
        out[:, i] = mag * np.exp(1j * phase)
        dphase = np.angle(Z[:, min(j + 1, n_frames - 1)]) - np.angle(Z[:, j]) - phase_adv
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase = phase + phase_adv + dphase
    _, x = sps.istft(out, nperseg=n_fft, noverlap=n_fft - hop,
                     boundary=True)
    return x.astype(np.float32)


# ------------------------------------------------------------------- pipeline
@dataclass
class Augmenter:
    """Compose(p=compose_p) of transforms each applied with p=member_p —
    the reference pipeline's shape (``augmenter.py:4-18``)."""

    sample_rate_transforms: Sequence[Callable] = field(default_factory=lambda: [
        add_gaussian_snr, air_absorption, aliasing, band_pass, band_stop,
        clipping_distortion, gain, gain_transition, peaking_filter, pitch_shift,
    ])
    compose_p: float = 0.8
    member_p: float = 0.3

    def __call__(self, audio: np.ndarray, sample_rate: int,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        audio = np.asarray(audio, np.float32)
        if rng.uniform() > self.compose_p or len(audio) == 0:
            return audio
        for fn in self.sample_rate_transforms:
            if rng.uniform() < self.member_p:
                audio = fn(audio, sample_rate, rng)
                audio = np.nan_to_num(audio, copy=False)
        # Keep headroom sane after chained gains/filters.
        peak = np.abs(audio).max()
        if peak > 1.0:
            audio = audio / peak
        return audio.astype(np.float32)


augmenter = Augmenter()


def _preview_main():  # pragma: no cover - manual tool
    """Preview the augmentation pipeline (parity with the reference's
    listening test, ``train/utils/augmenter.py:20-49``, which played
    augmented batches through speakers). Headless equivalent: write
    original + N augmented variants as WAVs next to the input and print
    per-transform stats so the pipeline can be audited by ear or by eye.

    Usage: python -m yoho_tpu_torch.audio.augment <audio-file> [n_variants]
    """
    import sys
    from pathlib import Path

    from yoho_tpu_torch.audio.io import load_audio_f32, save_audio

    if len(sys.argv) < 2:
        print(__doc__)
        print("usage: python -m yoho_tpu_torch.audio.augment <audio> [n_variants]")
        raise SystemExit(2)
    path = Path(sys.argv[1])
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sr = 16000
    audio = load_audio_f32(path, sr)
    rng = np.random.default_rng(0)
    out_dir = path.parent
    save_audio(audio, out_dir / f"{path.stem}_orig.wav", sr)
    for i in range(n):
        aug = augmenter(audio, sr, rng)
        rms = float(np.sqrt(np.mean(aug**2)))
        peak = float(np.abs(aug).max())
        out = out_dir / f"{path.stem}_aug{i}.wav"
        save_audio(aug, out, sr)
        print(f"{out.name}: rms={rms:.4f} peak={peak:.4f}")
    print(f"wrote {n} augmented variants to {out_dir}/")


if __name__ == "__main__":  # pragma: no cover
    _preview_main()
