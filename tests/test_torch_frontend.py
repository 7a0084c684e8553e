"""The PyTorch port's log-mel frontend against the JAX package's.

The same numpy audio goes through JAX's ``whisper_log_mel`` /
``log_mel_spectrogram`` / ``fused_log_mel`` (the Pallas kernel in interpret
mode) and through the port's frontend and the plain version of its mel
kernel. Tolerances are those of ``tests/test_ops.py``: rtol/atol 1e-4 for
un-normalized whisper features, 1e-3/2e-3 for scipy and normalized ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yoho_tpu.audio import frontend as jfront
from yoho_tpu.ops.mel_kernel import fused_log_mel as jax_fused_log_mel
from yoho_tpu_torch.audio import frontend as tfront
from yoho_tpu_torch.audio.filters import mel_filter_bank
from yoho_tpu_torch.ops import mel_kernel as tmel

WHISPER = dict(sample_rate=16000, n_fft=400, hop=160, n_mels=80,
               mel_scale="slaney", convention="whisper", log_floor=1e-10)
SCIPY = dict(sample_rate=16000, n_fft=400, hop=160, n_mels=32,
             mel_scale="htk", convention="scipy", log_floor=1e-13)
TOL = {"whisper": dict(rtol=1e-4, atol=1e-4), "scipy": dict(rtol=1e-3, atol=2e-3)}


def _audio(seed, shape):
    return (0.2 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kw", [WHISPER, SCIPY], ids=["whisper", "scipy"])
def test_log_mel_spectrogram_matches_jax(kw):
    audio = _audio(2, (2, 24_000))
    want = np.asarray(jfront.log_mel_spectrogram(jnp.asarray(audio), **kw))
    got = tfront.log_mel_spectrogram(torch.from_numpy(audio), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[kw["convention"]])


@pytest.mark.parametrize("kw", [WHISPER, SCIPY], ids=["whisper", "scipy"])
def test_plain_mel_kernel_matches_jax_fused(kw):
    """The wrapper on a CPU tensor (its plain version) against the Pallas
    kernel in interpret mode."""
    audio = _audio(3, (2, 16_000))
    want = np.asarray(jax_fused_log_mel(jnp.asarray(audio), tile_f=64, **kw))
    got = tmel.fused_log_mel(torch.from_numpy(audio), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[kw["convention"]])


def test_whisper_log_mel_normalized_matches_jax():
    audio = _audio(4, (1, 480_000)) * 0.5
    want = np.asarray(jfront.whisper_log_mel(jnp.asarray(audio)))
    got = tfront.whisper_log_mel(torch.from_numpy(audio)).numpy()
    fused = tmel.fused_whisper_log_mel(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (1, 3000, 80)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(fused, want, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("n", [100, 160, 350])
def test_tiny_clips_match_jax(n):
    """Sub-window clips take the zero-extend branch of the reflect pad."""
    audio = _audio(5, (1, n))
    want = np.asarray(jfront.log_mel_spectrogram(jnp.asarray(audio), **WHISPER))
    got = tfront.log_mel_spectrogram(torch.from_numpy(audio), **WHISPER).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL["whisper"])


def test_fused_whisper_rejects_wrong_rank():
    for bad in (np.zeros(16_000, np.float32), np.zeros((2, 3, 16_000), np.float32)):
        with pytest.raises(ValueError, match="batch, n_samples"):
            tmel.fused_whisper_log_mel(torch.from_numpy(bad))


# ------------------------------------------- the mel kernel's host constants


def _unpack_bases(bases, n_fft, n_freq):
    """The kernel's fragment-ordered bases back to dense (n_fft, n_freq)."""
    n_k8, n_grp = bases.shape[:2]
    cos = np.zeros((8 * n_k8, 8 * n_grp), np.float32)
    sin = np.zeros_like(cos)
    lane = np.arange(32)
    for kb in range(n_k8):
        for gp in range(n_grp):
            k0, f = 8 * kb + lane % 4, 8 * gp + lane // 4
            cos[k0, f], cos[k0 + 4, f] = bases[kb, gp, :, 0], bases[kb, gp, :, 1]
            sin[k0, f], sin[k0 + 4, f] = bases[kb, gp, :, 2], bases[kb, gp, :, 3]
    assert not cos[n_fft:].any() and not cos[:, n_freq:].any()
    assert not sin[n_fft:].any() and not sin[:, n_freq:].any()
    return cos[:n_fft, :n_freq], sin[:n_fft, :n_freq]


@pytest.mark.parametrize("n_fft,scaled", [(400, False), (400, True), (100, False), (1020, True)])
def test_fragment_bases_are_the_f32_bases(n_fft, scaled):
    """The kernel's fragment-ordered bases hold exactly the windowed f32
    DFT bases (zero past n_fft and n_freq), which fold the window into the
    same products the plain version computes."""
    cos_w, sin_w = tmel._windowed(n_fft, scaled)
    cos, sin = _unpack_bases(tmel.fragment_bases(cos_w, sin_w), n_fft, n_fft // 2 + 1)
    np.testing.assert_array_equal(cos, cos_w)
    np.testing.assert_array_equal(sin, sin_w)
    win = tfront._hann_periodic(n_fft).astype(np.float64)
    cos_b, _ = tfront._dft_bases(n_fft)
    want = win[:, None] * cos_b / (win.sum() if scaled else 1.0)
    np.testing.assert_allclose(cos_w, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_mels,mel_scale,n_fft", [(80, "slaney", 400), (128, "slaney", 400),
                                                    (32, "htk", 400), (256, "htk", 400)])
def test_mel_bands_are_the_dense_bank(n_mels, mel_scale, n_fft):
    """The sparse projection's bands (first bin, weights from the first to
    the last nonzero bin) scatter back to the dense filterbank exactly, so
    the kernel's ascending sum over a band equals the dense sum over all
    bins (the skipped terms are exact zeros)."""
    filt = np.ascontiguousarray(
        mel_filter_bank(16000, n_fft, n_mels, mel_scale=mel_scale).T, dtype=np.float32)
    bands, wts = tmel.mel_bands(filt)
    first, offset = bands[:n_mels], bands[n_mels:]
    dense = np.zeros_like(filt)
    for m in range(n_mels):
        w = wts[offset[m]:offset[m + 1]]
        dense[first[m]:first[m] + len(w), m] = w
    np.testing.assert_array_equal(dense, filt)
    assert offset[-1] < filt.size // 4  # each band covers a few bins
    power = np.random.default_rng(0).random((3, filt.shape[0])).astype(np.float32)
    for f in range(3):
        for m in range(n_mels):
            full = np.float32(0)
            for k in range(filt.shape[0]):
                full = np.float32(full + power[f, k] * filt[k, m])
            part = np.float32(0)
            for j in range(offset[m + 1] - offset[m]):
                part = np.float32(part + power[f, first[m] + j] * wts[offset[m] + j])
            assert part == full


def _tf32(x):
    """Round to TF32 (10 mantissa bits), nearest with ties away, as
    ``cvt.rna.tf32.f32`` does."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("kw", [WHISPER, dict(WHISPER, n_mels=128), SCIPY],
                         ids=["whisper", "whisper128", "scipy"])
def test_3xtf32_dft_meets_the_pin(kw):
    """The kernel's DFT route, emulated: frames and bases split into
    TF32 hi + lo and hi*lo + lo*hi + hi*hi summed in f32, then power, the
    sparse mel projection and log10, within the plain version's pin at
    the CUDA tests' inputs (a single TF32 product misses it)."""
    audio = torch.from_numpy(_audio(6, (3, 12_345)))
    padded, frames_n = tfront.pad_for_convention(audio, 400, 160, kw["convention"])
    need = (frames_n - 1) * 160 + 400
    padded = torch.nn.functional.pad(padded, (0, max(0, need - padded.shape[-1])))
    frames = padded.unfold(-1, 400, 160)[:, :frames_n]
    bases, bands, wts = tmel._constants(16000, 400, 160, kw["n_mels"], kw["mel_scale"],
                                        kw["convention"] == "scipy")
    cos, sin = _unpack_bases(bases, 400, 201)
    b = torch.from_numpy(np.concatenate([cos, sin], 1))
    ah, bh = _tf32(frames), _tf32(b)
    al, bl = _tf32(frames - ah), _tf32(b - bh)
    spec = ah @ bl + al @ bh + ah @ bh
    power = spec[..., :201] * spec[..., :201] + spec[..., 201:] * spec[..., 201:]
    n_mels = kw["n_mels"]
    filt = np.zeros((201, n_mels), np.float32)
    for m in range(n_mels):
        w = wts[bands[n_mels + m]:bands[n_mels + m + 1]]
        filt[bands[m]:bands[m] + len(w), m] = w
    got = torch.log10(torch.clamp_min(power @ torch.from_numpy(filt), kw["log_floor"]))
    want = tfront.log_mel_spectrogram(audio, **kw)
    torch.testing.assert_close(got, want, **TOL[kw["convention"]])
    single = ah @ bh
    power1 = single[..., :201] ** 2 + single[..., 201:] ** 2
    got1 = torch.log10(torch.clamp_min(power1 @ torch.from_numpy(filt), kw["log_floor"]))
    if kw["convention"] == "whisper":
        assert not torch.allclose(got1, want, **TOL["whisper"])
