"""Stage-2 model: the voice-reconstruction Transformer VAE (the JAX
package's ``nn/reconstruction.py``).

The YOHO audio encoder, then per-position (mu, logvar), a sampled z, a
projection back to the model width, ``max(1, n_audio_blocks // 2)`` dense
encoder blocks (``dec_blocks``: no experts even in an MoE session), an
RMSNorm, a 2x upsample in time (each position repeated) and the mel
projection. The parameter tree is flax's: ``encoder``, ``to_mu``,
``to_logvar``, ``from_latent``, ``dec_blocks_{i}``, ``ln``, ``to_mel``
(``nn/params.py``); stage 3 warm-starts its encoder from ``encoder``.

The noise is the caller's: ``forward`` takes ``eps``, or draws it from an
explicit ``torch.Generator``; no global random state is read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from yoho_tpu_torch.core.config import YOHOConfig
from yoho_tpu_torch.core.device import resolve_device
from yoho_tpu_torch.nn.layers import RMSNorm
from yoho_tpu_torch.nn.yoho import YOHOAudioEncoder, YOHOEncoderBlock, _run


class VoiceReconstructionVAE(nn.Module):
    def __init__(self, cfg: YOHOConfig, latent_dim: int = 64, dtype=torch.float32,
                 device=None, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        c = cfg
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.latent_dim = latent_dim
        self.remat = remat
        self.encoder = YOHOAudioEncoder(c, remat=remat, **kw)
        self.to_mu = nn.Linear(c.dims, latent_dim, **kw)
        self.to_logvar = nn.Linear(c.dims, latent_dim, **kw)
        self.from_latent = nn.Linear(latent_dim, c.dims, **kw)
        self.dec_blocks = nn.ModuleList(
            YOHOEncoderBlock(c.n_audio_heads, max(1, c.n_audio_heads // 2), c.dims, **kw)
            for _ in range(max(1, c.n_audio_blocks // 2)))
        self.ln = RMSNorm(c.dims, **kw)
        self.to_mel = nn.Linear(c.dims, c.n_mel_bands, **kw)

    @property
    def device(self) -> torch.device:
        return self.ln.scale.device

    def encode(self, mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.encoder(mel)
        return self.to_mu(h), self.to_logvar(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = self.from_latent(z)
        for blk in self.dec_blocks:
            x = _run(blk, self.remat, x)
        # Back to the mel frame rate (the encoder pooled time once).
        return self.to_mel(self.ln(x).repeat_interleave(2, dim=1))

    def forward(self, mel: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(B, T_mel, M) -> (reconstruction (B, 2 * (T_mel // 2), M), mu,
        logvar), logvar clipped to [-10, 10] before the reparameterized
        sample ``z = mu + exp(logvar / 2) * eps``. ``eps`` (the shape of
        mu) or a ``generator`` to draw it from (float32 normal) is
        required."""
        mu, logvar = self.encode(mel)
        logvar = torch.clamp(logvar, -10.0, 10.0)
        if eps is None:
            if generator is None:
                raise ValueError("pass the noise: eps, or a torch.Generator to draw it")
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self.decode(z), mu, logvar


def vae_loss(recon: torch.Tensor, mel: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, kl_weight: float):
    """MSE over all frames + ``kl_weight`` x the mean KL to N(0, I), in
    float32. Returns (loss, (mse, kl))."""
    recon, mel, mu, logvar = recon.float(), mel.float(), mu.float(), logvar.float()
    mse = torch.mean((recon - mel) ** 2)
    kl = -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    return mse + kl_weight * kl, (mse, kl)
