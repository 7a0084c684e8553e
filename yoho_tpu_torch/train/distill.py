"""Whisper knowledge distillation: train a small same-vocab draft model.

The port's counterpart of the JAX package's ``train/distill.py``: a student
Whisper trains against a frozen teacher with ``alpha * CE(labels) + (1 -
alpha) * KL(teacher || student)`` at temperature ``tau``, reports the
masked argmax agreement (a direct proxy for speculative acceptance), and
exports an HF checkpoint dir. It reuses the fine-tuner's machinery
(dataloader, step, optimizer, provenance-guarded resume); the teacher runs
its own mel frontend and is teacher-forced on the same target tokens.
Over a mesh the teacher stays whole on every rank (frozen, no optimizer
state), and the CE, the KL and the agreement count the global batch's
mask.
"""

from __future__ import annotations

import warnings

import torch

from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.nn import params as nn_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
from yoho_tpu_torch.parallel.mesh import data_sum, is_coordinator
from yoho_tpu_torch.train.trainer import masked_ce_loss
from yoho_tpu_torch.train.whisper_finetune import WhisperFinetuner, _f32_tree


def distill_kl_loss(t_logits: torch.Tensor, s_logits: torch.Tensor,
                    loss_mask: torch.Tensor, tau: float, mesh=None) -> torch.Tensor:
    """Masked KL(teacher || student) at temperature ``tau``, aligned with
    :func:`masked_ce_loss`'s next-token shift, scaled by tau^2 (Hinton et
    al.) so gradients keep magnitude as tau grows; float32. Under a mesh
    the global batch's mask count divides (this rank's share)."""
    t = torch.log_softmax(t_logits[:, :-1].float() / tau, dim=-1)
    s = torch.log_softmax(s_logits[:, :-1].float() / tau, dim=-1)
    per_pos = torch.sum(torch.exp(t) * (t - s), dim=-1)
    mask = loss_mask[:, 1:].float()
    return tau * tau * torch.sum(per_pos * mask) / torch.clamp_min(
        data_sum(torch.sum(mask), mesh), 1.0)


def masked_agreement(t_logits: torch.Tensor, s_logits: torch.Tensor,
                     loss_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Masked next-token argmax agreement of two teacher-forced logits (over
    the global batch under a mesh)."""
    same = (torch.argmax(t_logits[:, :-1], -1) == torch.argmax(s_logits[:, :-1], -1)).float()
    mask = loss_mask[:, 1:].float()
    return data_sum(torch.sum(same * mask), mesh) / torch.clamp_min(
        data_sum(torch.sum(mask), mesh), 1.0)


class WhisperDistiller(WhisperFinetuner):
    """Train ``student`` to match a frozen ``teacher`` on an SRT corpus.
    ``teacher_params`` and ``student_params`` are flax params trees or port
    ``Whisper`` modules."""

    def __init__(self, teacher_cfg: WhisperConfig, teacher_params,
                 student_cfg: WhisperConfig, student_params, table,
                 data_dir, out_dir, *, alpha: float = 0.5, tau: float = 2.0,
                 **kwargs):
        if teacher_cfg.n_vocab != student_cfg.n_vocab:
            raise ValueError(
                f"teacher vocab {teacher_cfg.n_vocab} != student vocab "
                f"{student_cfg.n_vocab} — speculative verify compares "
                "token ids, so the draft must share the tokenizer")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if kwargs.get("lora_rank"):
            raise ValueError(
                "LoRA adapts a PRETRAINED base; the distilled student "
                "starts from random init, so every weight must train — "
                "use LoRA with the fine-tuner instead")
        if tau <= 0:
            raise ValueError(
                f"tau must be > 0, got {tau} — log_softmax(logits/tau) "
                "would NaN the loss on the first step")
        if teacher_cfg.n_mels != student_cfg.n_mels:
            warnings.warn(
                f"student n_mels {student_cfg.n_mels} != teacher "
                f"{teacher_cfg.n_mels}: distillation itself handles "
                "distinct frontends, but the speculative Transcriber "
                "feeds ONE shared mel to both models — this draft will "
                "not plug into a speculative Transcriber.", stacklevel=2)
        self.teacher_cfg = teacher_cfg
        self.alpha = float(alpha)
        self.tau = float(tau)
        self.last_agreement = None
        super().__init__(student_cfg, student_params, table, data_dir, out_dir, **kwargs)
        if isinstance(teacher_params, torch.nn.Module):
            self.teacher = teacher_params.to(self.device, torch.float32)
        else:
            self.teacher = nn_params.load_jax_params(
                Whisper(teacher_cfg, torch.float32, device=self.device),
                _f32_tree(teacher_params))
        self.teacher.requires_grad_(False)
        self.teacher.remat = False

    def _teacher_logits(self, audio, tokens) -> torch.Tensor:
        with torch.no_grad(), self._autocast():
            mel = fused_whisper_log_mel(audio.float(), n_mels=self.teacher_cfg.n_mels)
            return self.teacher(mel, tokens)

    def _batch_loss(self, audio, tokens, mask) -> torch.Tensor:
        t_logits = self._teacher_logits(audio, tokens)
        with torch.no_grad():
            mel = self._mel(audio)
        with self._autocast():
            s_logits = self.model(mel, tokens)
        ce = masked_ce_loss(s_logits, tokens, mask, self.mesh)
        kl = distill_kl_loss(t_logits, s_logits, mask, self.tau, self.mesh)
        return self.alpha * ce + (1.0 - self.alpha) * kl

    @torch.no_grad()
    def agreement(self, audio, tokens, mask) -> float:
        with self._autocast():
            s_logits = self.model(self._mel(audio), tokens)
        return float(masked_agreement(self._teacher_logits(audio, tokens), s_logits, mask,
                                      self.mesh))

    def _validate(self, update: int) -> float:
        val_loss = super()._validate(update)
        self.last_agreement = self.agreement(*self._place(self._last_val_batch))
        if is_coordinator():
            print(f"[distill] update {update}: teacher-agreement "
                  f"{self.last_agreement:.3f} (projected speculative acceptance)",
                  flush=True)
        return val_loss

    def export(self):
        """Student params as an HF dir; tokenizer files come from the
        TEACHER checkpoint (``src_dir``), config.json describes the student
        (always synthesized)."""
        from yoho_tpu_torch.nn.export import export_hf_whisper

        params = self._full_params(self.model)
        if not is_coordinator():
            return self.out_dir
        return export_hf_whisper(params, self.cfg, self.out_dir,
                                 src_dir=self.src_dir, copy_config=False)
