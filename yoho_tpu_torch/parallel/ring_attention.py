"""Ring attention: exact bidirectional attention over a sequence sharded
across the ranks of a mesh axis.

The JAX package's ``parallel/ring_attention.py``: every rank holds its
(B, H, S_local, D) of q, k and v. For n ranks, n - 1 steps each fold the
resident K/V block into an online-softmax accumulator (running max ``m``,
normalizer ``l``, weighted sum ``acc``: the flash recurrence, in float32)
and pass the block to the next rank (rank i sends to i + 1 and receives
from i - 1, one ``batch_isend_irecv``); the last resident block is folded
with no send (the transfer would be dead traffic). GQA: the unexpanded
K/V blocks ride the ring and the query groups broadcast against their KV
head inside the contraction. The fold is plain float32 ``torch.einsum``,
as the JAX package's is an ``einsum`` outside any Pallas kernel.

Training: the pass along the ring is ``mesh.ring_shift``, whose backward
sends the gradients back the reverse way (JAX's transpose of
``ppermute``), and autograd differentiates the float32 fold as JAX's
autodiff differentiates its einsum fold.
"""

from __future__ import annotations

from typing import Optional

import torch

from yoho_tpu_torch.core.device import full_fp32
from yoho_tpu_torch.parallel.mesh import ring_shift

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "seq", scale: Optional[float] = None) -> torch.Tensor:
    """This rank's (B, Hq, S_local, D) attention output over the whole
    sequence: ``q`` (B, Hq, S_local, D) its queries, ``k``/``v`` (B, Hkv,
    S_local, D) its resident keys and values, ``Hq`` a multiple of
    ``Hkv``. Softmax statistics in float32 whatever the input type; the
    result in q's type. Every rank of the axis must call it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.shape[axis_name]
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    qf = (q.float() * scale).reshape(b, hkv, g, s, d)
    acc = torch.zeros_like(qf)
    m = torch.full((b, hkv, g, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)

    def fold(acc, m, l, kb, vb):
        with full_fp32():
            scores = torch.einsum("bhgsd,bhtd->bhgst", qf, kb.float())
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            p = torch.exp(scores - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd", p, vb.float())
        return acc, m_new, l

    kb, vb = k.contiguous(), v.contiguous()
    for _ in range(n - 1):
        acc, m, l = fold(acc, m, l, kb, vb)
        kb, vb = ring_shift(mesh, axis_name, kb, vb)
    acc, m, l = fold(acc, m, l, kb, vb)
    return (acc / l).reshape(b, hq, s, d).to(q.dtype)
