"""Mixture-of-Experts SwiGLU (static shapes): the JAX package's
``nn/moe.py``.

Routing is top-k (default 2, Mixtral-renormalized gates; k = 1 is Switch)
through dense one-hot dispatch and combine tensors with a static capacity
per expert: tokens past an expert's capacity are dropped by that expert.
Routing is per sample (each batch row competes only against its own tokens
for capacity), so a sample's output never depends on what it is batched
with. The expert products are plain ``torch.matmul`` over the stacked
expert weights, as JAX computes them outside any Pallas kernel.

A flax module sows its auxiliary loss into an ``intermediates``
collection; an ``nn.Module`` keeps its last values instead: every
:class:`MoESwiGLU` holds the Switch load-balancing loss
(``last_aux_loss``, with its graph) and the dropped fraction
(``last_dropped_fraction``) of its last forward, and
:func:`collect_aux_losses` averages the losses over a model.

Expert parallelism (``parallel/sharding.py``): a layer sharded over the
``model`` axis (``tp``) holds experts ``expert_offset`` to
``expert_offset + local_experts - 1``; the router stays whole, each rank
runs its own experts' slice of the dense dispatch, and the combined
outputs are summed over the axis (one all-reduce). Under autograd the
expert path's input and the combine weights pass ``copy_to`` before they
are sliced (their gradients sum the ranks' experts' parts), and the sum
passes its gradient through; the router and the auxiliary loss are
replicated and need nothing.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yoho_tpu_torch.core.device import full_fp32
from yoho_tpu_torch.parallel.mesh import AXIS_MODEL, copy_to, sum_over


def moe_dispatch(gates: torch.Tensor, top_k: int, capacity: int,
                 normalize_topk: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape top-k dispatch and combine tensors for router
    probabilities ``gates`` (..., T, E) (rows sum to 1; leading axes are
    independent samples).

    Returns ``(dispatch, combine, aux_loss, kept)``: ``dispatch`` (..., T,
    E, C) 0/1, token t in slot c of expert e; ``combine`` the same weighted
    by the (renormalized) gates; ``aux_loss`` (...) the Switch loss
    ``E * sum_e(first-choice share_e * mean gate_e)``; ``kept`` (..., T) the
    number of experts that kept each token. Slots go by token order, later
    choices after earlier ones; a token past capacity is dropped by that
    expert only."""
    e = gates.shape[-1]
    gates = gates.float()
    slots = torch.arange(capacity, device=gates.device)
    remaining = gates
    total_kept = torch.zeros(gates.shape, dtype=torch.int64, device=gates.device)
    dispatch = gates.new_zeros((*gates.shape, capacity))
    combine = torch.zeros_like(dispatch)
    denom = gates.new_zeros(gates.shape[:-1])
    first_mask = None
    for _ in range(top_k):
        mask = F.one_hot(remaining.argmax(dim=-1), e)  # (..., T, E) int64
        if first_mask is None:
            first_mask = mask
        # Slot: rank among this round's tokens for the expert, after the
        # expert's occupancy from earlier rounds.
        prior = total_kept.sum(dim=-2, keepdim=True)
        pos = torch.cumsum(mask, dim=-2) - mask + prior
        keep = mask * (pos < capacity)
        gate_k = (gates * mask).sum(dim=-1)
        disp_k = (pos[..., None] == slots).float() * keep[..., None]
        dispatch = dispatch + disp_k
        combine = combine + disp_k * gate_k[..., None, None]
        # Renormalized over every chosen gate, kept or dropped (Mixtral).
        denom = denom + gate_k
        total_kept = total_kept + keep
        remaining = remaining * (1 - mask).float()
    if normalize_topk and top_k > 1:
        combine = combine / torch.clamp_min(denom, 1e-9)[..., None, None]
    frac = first_mask.float().mean(dim=-2)
    mean_gate = gates.mean(dim=-2)
    aux_loss = e * (frac * mean_gate).sum(dim=-1)
    return dispatch, combine, aux_loss, total_kept.sum(dim=-1)


class StackedDense(nn.Module):
    """Bias-free dense layers of ``n`` experts, one (n, in, out) kernel in
    flax's layout and under flax's name (``experts/<name>/kernel``)."""

    def __init__(self, n: int, d_in: int, d_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((n, d_in, d_out), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (n, T, in)
        return torch.matmul(x, self.kernel)


class StackedSwiGLU(nn.Module):
    """``n`` SwiGLU experts applied to their own rows: (n, T, d) -> (n, T, d)."""

    def __init__(self, n: int, d_in: int, hidden_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gate = StackedDense(n, d_in, hidden_dim, **kw)
        self.up = StackedDense(n, d_in, hidden_dim, **kw)
        self.down = StackedDense(n, hidden_dim, d_in, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class MoESwiGLU(nn.Module):
    """Drop-in MoE replacement for ``nn.layers.SwiGLU``: ``n_experts``
    SwiGLU experts with stacked weights, a bias-free f32 router, and a
    per-sample capacity of ``min(ceil(S / E * capacity_factor) * top_k,
    S)`` per expert."""

    def __init__(self, d_in: int, n_experts: int, hidden_dim: int, top_k: int = 2,
                 capacity_factor: float = 2.0, normalize_topk: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor, self.normalize_topk = capacity_factor, normalize_topk
        self.dtype = dtype
        self.router = nn.Linear(d_in, n_experts, bias=False, dtype=torch.float32,
                                device=device)
        self.experts = StackedSwiGLU(n_experts, d_in, hidden_dim, dtype=dtype,
                                     device=device)
        self.last_aux_loss = None
        self.last_dropped_fraction = None

    def capacity(self, s: int) -> int:
        c = max(1, int(math.ceil(s / self.n_experts * self.capacity_factor)))
        return min(c * max(1, self.top_k), s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, S, D)
        b, s, d = x.shape
        e, cap = self.n_experts, self.capacity(s)
        with torch.autocast(x.device.type, enabled=False), full_fp32():
            gates = torch.softmax(self.router(x.float()), dim=-1)  # (B, S, E)
        dispatch, combine, aux, kept = moe_dispatch(gates, self.top_k, cap,
                                                    self.normalize_topk)
        tp = getattr(self, "tp", None)
        if tp is not None:  # expert parallel: this rank's experts only
            lo, e = self.expert_offset, self.local_experts
            x, combine = copy_to(x, tp, AXIS_MODEL), copy_to(combine, tp, AXIS_MODEL)
            dispatch, combine = dispatch[..., lo:lo + e, :], combine[..., lo:lo + e, :]
        # Autocast (training) picks the compute type; otherwise the model's.
        dt = torch.get_autocast_dtype(x.device.type) \
            if torch.is_autocast_enabled(x.device.type) \
            else self.dtype
        expert_in = torch.einsum("bsec,bsd->becd", dispatch.to(dt), x.to(dt))
        expert_in = expert_in.transpose(0, 1).reshape(e, b * cap, d)
        expert_out = self.experts(expert_in).reshape(e, b, cap, d).transpose(0, 1)
        out = torch.einsum("bsec,becd->bsd", combine.to(dt), expert_out.to(dt))
        if tp is not None:  # the ranks' experts' shares summed
            out = sum_over(out, tp, AXIS_MODEL)
        self.last_aux_loss = aux.mean()
        self.last_dropped_fraction = (
            1.0 - kept.float().mean() / max(1, self.top_k)).detach()
        return out


def collect_aux_losses(model: nn.Module) -> torch.Tensor:
    """The mean of the last auxiliary loss of every :class:`MoESwiGLU` in
    ``model`` (0.0 when none has run): safe to add unconditionally."""
    found = [m.last_aux_loss for m in model.modules()
             if isinstance(m, MoESwiGLU) and m.last_aux_loss is not None]
    if not found:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([x.float() for x in found]).mean()


def dropped_fraction(model: nn.Module) -> float:
    """The mean dropped fraction of the last forward's MoE layers (0 with
    none): the JAX package's sown ``moe_dropped_fraction``."""
    found = [float(m.last_dropped_fraction) for m in model.modules()
             if isinstance(m, MoESwiGLU) and m.last_dropped_fraction is not None]
    return sum(found) / len(found) if found else 0.0
