"""Voiceprint (speaker-embedding) encoder and its contrastive loss.

The JAX package's ``nn/voiceprint.py``: the YOHO audio encoder, pooled
over time (optionally under a per-frame mask) and projected into an
L2-normalized speaker embedding; ``nt_xent_loss`` is supervised NT-Xent
(clips of the same speaker are positives). Whisper-family diarization
(``--diarize-session``) and ``enroll --diarize-session`` embed audio spans
with it; stage 3 trains it, and stage 4's frozen teacher embeds every
utterance span of a batch from one encoder pass (:meth:`embed_spans`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from yoho_tpu_torch.core.config import YOHOConfig
from yoho_tpu_torch.core.device import resolve_device
from yoho_tpu_torch.nn.yoho import YOHOAudioEncoder, l2_normalize


class VoiceprintEncoder(nn.Module):
    def __init__(self, cfg: YOHOConfig, embedding_dim: int = 256,
                 dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embedding_dim = embedding_dim
        self.encoder = YOHOAudioEncoder(cfg, dtype=dtype, device=device, remat=remat)
        self.proj = nn.Linear(cfg.dims, embedding_dim, bias=False, dtype=dtype,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    def forward(self, mel: torch.Tensor,
                time_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T_mel, M) [+ a (B, T_mel) frame mask] -> (B, E), unit norm.
        The mask pools to the encoder's rate (two mel frames a position)."""
        if time_mask is not None:
            return self.embed_spans(mel, time_mask[:, None])[:, 0]
        return l2_normalize(self.proj(self.encoder(mel).mean(dim=1)))

    def embed_spans(self, mel: torch.Tensor, time_masks: torch.Tensor) -> torch.Tensor:
        """(B, T_mel, M) and U frame masks (B, U, T_mel) -> (B, U, E): one
        encoder pass, then each mask's pooled embedding, equal to
        ``forward(mel, time_masks[:, u])`` for every u (the mask enters
        only the pooling)."""
        h = self.encoder(mel)  # (B, T_mel // 2, D)
        m = time_masks.to(h.dtype)
        t2 = h.shape[1]
        m = m[..., : 2 * t2].unflatten(-1, (t2, 2)).amax(dim=-1)  # (B, U, T2)
        denom = torch.clamp_min(m.sum(dim=-1, keepdim=True), 1.0)
        return l2_normalize(self.proj(torch.bmm(m, h) / denom))


def nt_xent_loss(embeddings: torch.Tensor, speaker_ids: torch.Tensor,
                 temperature: float = 0.07, mesh=None) -> torch.Tensor:
    """Supervised NT-Xent: for each anchor, the positives are the other
    clips of its speaker; every non-self pair is in the denominator.

    Over a mesh ``embeddings`` and ``speaker_ids`` are this rank's rows of
    the global batch: the rows are gathered over ``data`` (the gradient of
    this rank's share is summed over the axis before it keeps its rows),
    the anchors are this rank's rows, and the anchor count is the global
    batch's, so the ranks' results sum to the global loss."""
    from yoho_tpu_torch.parallel.mesh import AXIS_DATA, data_shard, data_sum, gather_over

    i, d = data_shard(mesh)
    anchors, ids = embeddings, speaker_ids
    n = embeddings.shape[0]
    if mesh is not None and AXIS_DATA in mesh.shape:
        embeddings = gather_over(embeddings.contiguous(), mesh, AXIS_DATA, 0, grad="sum")
        speaker_ids = gather_over(speaker_ids.contiguous(), mesh, AXIS_DATA, 0)
    sim = anchors @ embeddings.T / temperature
    eye = torch.zeros(sim.shape, dtype=torch.bool, device=sim.device)
    eye[:, i * n:(i + 1) * n] = torch.eye(n, dtype=torch.bool, device=sim.device)
    pos = (ids[:, None] == speaker_ids[None, :]) & ~eye
    sim = sim.masked_fill(eye, torch.finfo(sim.dtype).min)
    log_prob = torch.log_softmax(sim, dim=1)
    pos_count = torch.clamp_min(pos.sum(dim=1), 1)
    per_anchor = -(log_prob * pos).sum(dim=1) / pos_count
    has_pos = pos.any(dim=1)
    return (torch.where(has_pos, per_anchor, torch.zeros_like(per_anchor)).sum()
            / torch.clamp_min(data_sum(has_pos.sum(), mesh), 1))
