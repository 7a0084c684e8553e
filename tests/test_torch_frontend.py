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
