"""Stage 3: contrastive fine-tuning of the voiceprint encoder (the JAX
package's ``train/stages/stage3_voiceprint.py``).

Trains :class:`nn.voiceprint.VoiceprintEncoder` with supervised NT-Xent
over ``SpeakerDataloader`` batches (``clips_per_speaker`` clips of each
speaker in a batch are its positives). The encoder starts from the stage-2
artifact's ``encoder`` when ``weights.voice_reconstruction`` exists (its
other keys are ignored, as flax's ``from_state_dict`` ignores them). The
export goes to ``weights.voiceprint``, stage 4's teacher. No validation: a
checkpoint every ``validation_frequency`` updates. Over a mesh the loss
takes its negatives and positives from the whole global batch: the
embeddings are gathered over ``data`` (the gradient of each rank's share
summed before it keeps its rows), each rank scores the anchors of its own
rows, and the normaliser counts the global batch's anchors.
"""

from __future__ import annotations

import torch

from yoho_tpu_torch.core.config import SessionConfig
from yoho_tpu_torch.train.trainer import SessionTrainer


class VoiceprintTrainer(SessionTrainer):
    _batch_types = (torch.float32, torch.long)  # audio, speaker ids

    def __init__(self, config: SessionConfig, mesh=None, use_multiprocessing: bool = False,
                 compute_dtype=torch.float32, device=None):
        from yoho_tpu_torch.nn import params as nn_params
        from yoho_tpu_torch.nn.voiceprint import VoiceprintEncoder
        from yoho_tpu_torch.train.checkpoint import load_params
        from yoho_tpu_torch.train.dataloader import SpeakerDataloader

        hp = config.hyperparameters.voiceprint_finetune
        self._setup(config, 3, hp, mesh, device, compute_dtype)
        self.weights_path = config.weights.voiceprint
        self.model = nn_params.init_random(VoiceprintEncoder(
            config.yoho, embedding_dim=hp.embedding_dim, device=self.device,
            remat=hp.remat), seed=0)
        # Warm start: the stage-2 VAE's encoder (both are a YOHOAudioEncoder
        # named "encoder").
        vae = load_params(config.weights.voice_reconstruction,
                          {"encoder": nn_params.to_jax_params(self.model.encoder)})
        if vae is not None:
            nn_params.load_jax_params(self.model.encoder, vae["encoder"])
        self.train_dataloader = SpeakerDataloader(
            config, use_multiprocessing=use_multiprocessing,
            disable_warnings=True, warmup_queue=False, **self._loader_shard())
        self._init_state()

    def _batch_loss(self, audio, speaker_ids) -> torch.Tensor:
        from yoho_tpu_torch.nn.voiceprint import nt_xent_loss

        with torch.no_grad():
            mel = self._mel(audio)
        with self._autocast():
            emb = self.model(mel)
        return nt_xent_loss(emb.float(), speaker_ids, self.hp.temperature, self.mesh)


def main(config: SessionConfig, max_updates=None, use_multiprocessing: bool = True,
         device=None, **trainer_kw) -> None:
    VoiceprintTrainer(config, use_multiprocessing=use_multiprocessing, device=device,
                      **trainer_kw).run(max_updates=max_updates, progress=True)
