"""Stage 1: transcription pretraining without voiceprint supervision
(the JAX package's ``train/stages/stage1_asr_pretrain.py``)."""

from __future__ import annotations

from yoho_tpu_torch.core.config import SessionConfig
from yoho_tpu_torch.train.trainer import ASRTrainer


def main(config: SessionConfig, max_updates=None, use_multiprocessing: bool = True,
         device=None, **trainer_kw) -> None:
    trainer = ASRTrainer(config, stage=1, use_multiprocessing=use_multiprocessing,
                         device=device, **trainer_kw)
    trainer.run(max_updates=max_updates, progress=True)
