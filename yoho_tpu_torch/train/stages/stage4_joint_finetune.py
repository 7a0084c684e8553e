"""Stage 4: joint transcription + voiceprint fine-tuning (the JAX
package's ``train/stages/stage4_joint_finetune.py``).

The decoder emits a speaker embedding at each ``<|voiceprint|>`` slot
(slots carry no CE loss); the frozen stage-3 voiceprint encoder, evaluated
on each utterance's span of the audio, supervises it. Loss = masked
next-token CE + ``voiceprint_loss_weight`` x the sum over utterances of
``1 - cos(student, teacher)`` divided by the number of valid spans (no
MoE auxiliary term, as in JAX's). The student is the embedding at the
position before the u-th slot (the state that predicts the slot), paired
with span u. The model starts from ``weights.asr`` when it loads (a tree
that does not fit, such as another voiceprint width, gives a fresh
init); the export goes to ``weights.yoho``.

The teacher's encoder runs once per batch and each of the
``max_utterances`` span masks pools its output
(``VoiceprintEncoder.embed_spans``); JAX's ``vmap`` runs the encoder once
per span. The mask enters only the pooling, so the two compute the same
function. Over a mesh both terms are this rank's share: the CE by the
global mask count, the voiceprint sum by the global batch's valid spans.
"""

from __future__ import annotations

import torch

from yoho_tpu_torch.core.config import SessionConfig
from yoho_tpu_torch.parallel.mesh import data_sum
from yoho_tpu_torch.train.trainer import ASRTrainer, masked_ce_loss


class JointTrainer(ASRTrainer):
    # audio, tokens, loss mask, spans (B, U, 2) in samples, span validity (B, U)
    _batch_types = ASRTrainer._batch_types + (torch.long, torch.float32)

    def __init__(self, config: SessionConfig, tokenizer=None,
                 voiceprint_loss_weight: float = 1.0, mesh=None,
                 use_multiprocessing: bool = False, compute_dtype=torch.float32,
                 device=None):
        from yoho_tpu_torch.parallel.mesh import Mesh, local_device
        from yoho_tpu_torch.nn import params as nn_params
        from yoho_tpu_torch.nn.voiceprint import VoiceprintEncoder
        from yoho_tpu_torch.nn.yoho import YOHOModel
        from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
        from yoho_tpu_torch.train.checkpoint import load_params

        self.vp_weight = voiceprint_loss_weight
        tokenizer = tokenizer or YOHOTokenizer.load(config.weights.tokenizer)
        vp_dim = config.hyperparameters.voiceprint_finetune.embedding_dim
        hp = config.hyperparameters.transcribe_finetune
        # The rank's device (a mesh's, or cuda:LOCAL_RANK under a launcher)
        # before the teacher and the model are placed.
        device = mesh.device if isinstance(mesh, Mesh) else local_device(device)

        # The frozen teacher: the stage-3 voiceprint encoder.
        teacher = VoiceprintEncoder(config.yoho, embedding_dim=vp_dim, device=device)
        teacher_params = load_params(config.weights.voiceprint,
                                     nn_params.to_jax_params(teacher))
        if teacher_params is None:
            raise FileNotFoundError(
                f"Stage 4 needs the stage-3 voiceprint artifact at "
                f"{config.weights.voiceprint}; run stage 3 first.")
        self.teacher = nn_params.load_jax_params(teacher, teacher_params).requires_grad_(False)

        model = YOHOModel(config.yoho, tokenizer.vocab_size, voiceprint_dim=vp_dim,
                          device=device, remat=hp.remat)
        # Warm start from the stage-1 export, leniently: a tree that lacks a
        # leaf or holds one of another shape keeps the fresh init.
        init_params = None
        if config.weights.asr.exists():
            try:
                init_params = load_params(config.weights.asr, nn_params.to_jax_params(model))
            except (KeyError, ValueError):
                init_params = None

        super().__init__(config, tokenizer=tokenizer, stage=4, hp=hp, mesh=mesh,
                         use_multiprocessing=use_multiprocessing, model=model,
                         init_params=init_params, dataloader_kwargs={"return_spans": True},
                         compute_dtype=compute_dtype, device=device)

    def _teacher_embeddings(self, mel: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
        """(B, U, E) float32: the teacher's embedding of each span, frames
        at ``arange(max_audio_len) * stft_hop`` samples inside [start,
        end)."""
        cfg = self.config.yoho
        frame_pos = torch.arange(cfg.max_audio_len, device=mel.device) * cfg.stft_hop
        fmask = (frame_pos >= spans[..., 0:1]) & (frame_pos < spans[..., 1:2])  # (B, U, T)
        with torch.no_grad(), self._autocast():
            return self.teacher.embed_spans(mel, fmask).float()

    def _batch_loss(self, audio, tokens, mask, spans, span_valid) -> torch.Tensor:
        ce, vp_loss = self._losses(audio, tokens, mask, spans, span_valid)
        return ce + self.vp_weight * vp_loss

    def _losses(self, audio, tokens, mask, spans, span_valid):
        """(masked CE, voiceprint loss), float32 device scalars."""
        with torch.no_grad():
            mel = self._mel(audio)
        with self._autocast():
            logits, vp_pred = self.model.forward_with_voiceprints(tokens, mel)
        ce = masked_ce_loss(logits, tokens, mask, self.mesh)
        teach = self._teacher_embeddings(mel, spans)
        U = spans.shape[1]

        # The student's embedding of utterance u: the state BEFORE the u-th
        # voiceprint token (the one that predicts the slot).
        vp_mask = tokens == self.tokenizer.voiceprint_id
        order = torch.cumsum(vp_mask.long(), dim=1) * vp_mask  # 1-based at the slots
        match = (order[:, None, :] == torch.arange(1, U + 1, device=order.device)[:, None])
        match_prev = torch.nn.functional.pad(match[..., 1:].float(), (0, 1))  # (B, U, T)
        pred = torch.einsum("but,bte->bue", match_prev, vp_pred.float())
        has = torch.clamp(match_prev.sum(dim=-1), 0, 1)
        cos = (pred * teach).sum(dim=-1)
        vp_loss = ((1.0 - cos) * span_valid * has).sum() / torch.clamp_min(
            data_sum(span_valid.sum(), self.mesh), 1.0)
        return ce, vp_loss


def main(config: SessionConfig, max_updates=None, use_multiprocessing: bool = True,
         device=None, **trainer_kw) -> None:
    JointTrainer(config, use_multiprocessing=use_multiprocessing, device=device,
                 **trainer_kw).run(max_updates=max_updates, progress=True)
