"""Stage 2: voice-reconstruction VAE pretraining (the JAX package's
``train/stages/stage2_reconstruction.py``).

Trains :class:`nn.reconstruction.VoiceReconstructionVAE` on audio-only
chunks of the noisy and clean corpora (``AudioChunkDataloader``): the
log-mel through the mel kernel, the VAE under ``torch.autocast`` at
``compute_dtype`` with float32 parameters, ``vae_loss`` (MSE + ``kl_weight``
x KL), AdamW under ``MultiSteps``. The whole VAE goes to
``weights.voice_reconstruction``; stage 3 takes its encoder. No
validation: a checkpoint every ``validation_frequency`` updates.

The sampling noise comes from ``torch.Generator(device).manual_seed(42)``
through :meth:`ReconstructionTrainer._noise`; JAX draws it from
``PRNGKey(42)`` split at every step, which torch cannot reproduce (its
parity test puts JAX's draws in place of ``_noise``). Over a mesh every
rank draws the global batch's noise and keeps its own rows, so a run does
not depend on the mesh; the loss (two means) is divided by the ``data``
size, each rank's share.
"""

from __future__ import annotations

import torch

from yoho_tpu_torch.core.config import SessionConfig
from yoho_tpu_torch.train.trainer import SessionTrainer, data_size


class ReconstructionTrainer(SessionTrainer):
    _batch_types = (torch.float32,)  # audio

    def __init__(self, config: SessionConfig, mesh=None, use_multiprocessing: bool = False,
                 compute_dtype=torch.float32, device=None):
        from yoho_tpu_torch.nn.params import init_random
        from yoho_tpu_torch.nn.reconstruction import VoiceReconstructionVAE
        from yoho_tpu_torch.train.dataloader import AudioChunkDataloader

        hp = config.hyperparameters.reconstruct_pretrain
        self._setup(config, 2, hp, mesh, device, compute_dtype)
        self.weights_path = config.weights.voice_reconstruction
        self.model = init_random(VoiceReconstructionVAE(
            config.yoho, latent_dim=hp.latent_dim, device=self.device, remat=hp.remat), seed=0)
        self.train_dataloader = AudioChunkDataloader(
            config, augment=False, use_multiprocessing=use_multiprocessing,
            disable_warnings=True, warmup_queue=False, **self._loader_shard())
        self._generator = torch.Generator(self.device).manual_seed(42)
        self._init_state()

    def _noise(self, shape) -> torch.Tensor:
        """The reparameterization noise of one mini-step (float32 normal):
        the global batch's, this rank's rows of it."""
        from yoho_tpu_torch.parallel.mesh import data_shard

        i, d = data_shard(self.mesh)
        eps = torch.randn((shape[0] * d, *shape[1:]), generator=self._generator,
                          device=self.device)
        return eps[i * shape[0]:(i + 1) * shape[0]]

    def _batch_loss(self, audio) -> torch.Tensor:
        from yoho_tpu_torch.nn.reconstruction import vae_loss

        with torch.no_grad():
            mel = self._mel(audio)
        eps = self._noise((mel.shape[0], mel.shape[1] // 2, self.hp.latent_dim))
        with self._autocast():
            recon, mu, logvar = self.model(mel, eps)
        return vae_loss(recon, mel, mu, logvar, self.hp.kl_weight)[0] / data_size(self.mesh)


def main(config: SessionConfig, max_updates=None, use_multiprocessing: bool = True,
         device=None, **trainer_kw) -> None:
    ReconstructionTrainer(config, use_multiprocessing=use_multiprocessing, device=device,
                          **trainer_kw).run(max_updates=max_updates, progress=True)
