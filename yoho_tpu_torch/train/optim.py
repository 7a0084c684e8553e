"""What ``optax`` gives the whisper trainer, on tensors.

The JAX fine-tuner (``yoho_tpu/train/whisper_finetune.py``) trains with

* ``warmup_cosine_decay_schedule(0, lr, warmup, total, final_lr)``;
* ``adamw(schedule)`` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
  every leaf, biases and LayerNorm scales included) or
  ``adafactor(schedule)`` (factored second moments from dimension 128,
  decay rate 0.8, block-RMS clipping at 1.0, updates scaled by the
  parameter's RMS (at least 1e-3), eps 1e-30, no momentum);
* ``MultiSteps(inner, accumulated_batches)``: the mean of k mini-batch
  gradients feeds one inner update every k-th call; the schedule counts
  updates, not mini-steps;
* ``multi_transform`` that gives the frozen encoder zero updates: here the
  frozen leaves are left out of the optimizer (:func:`trainable`).

Each optimizer works on a dict of float32 tensors keyed by their JAX path,
in the JAX layout (``nn.params.jax_leaves``), and follows optax's
arithmetic step by step in float32. :meth:`MultiSteps.update` returns the
updates to add to the parameters, or None between updates. Its state is a
tree of tensors and ints, marked with :data:`STATE_FORMAT`, that the
checkpoint writes as the port's own ``opt_state``.

Under a mesh (``train/trainer.py``) each rank holds its leaves' local
slices: AdamW is elementwise, so the slices give JAX's numbers as they
are; Adafactor (:meth:`Adafactor.shard`) factors by the global shape and
all-reduces its row and column means and its block RMS over the axis that
cuts a leaf; :class:`MultiSteps` sums the accumulated gradients over the
mesh (``reduce``) once per applied update.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

STATE_FORMAT = "yoho_tpu_torch.train.optim/1"

Tensors = Dict[str, torch.Tensor]
_f32 = np.float32


@functools.lru_cache(maxsize=None)
def _cosf():
    """The C library's single-precision cosine. optax evaluates the cosine
    in float32; the correctly rounded double cosine rounded to float32 can
    differ from it by an ulp, which the decay's small values at the end of
    the schedule turn into a relative error of 1e-6, while ``cosf`` gives
    optax's float32 values on the CPU."""
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable[[int], float]:
    """optax's schedule of the same name, in its float32 arithmetic: a
    linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` at
    ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)
    if not cos_steps > 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")

    def linear(count: int):
        if warmup_steps <= 0:
            return _f32(init_value)
        frac = _f32(1) - _f32(min(max(count, 0), warmup_steps)) / _f32(warmup_steps)
        return _f32(init_value - peak_value) * frac + _f32(peak_value)

    def cosine(count: int):
        c = _f32(min(float(count), cos_steps))
        arg = _f32(math.pi) * c / _f32(cos_steps)
        decay = _f32(0.5) * (_f32(1) + _f32(_cosf()(float(arg))))
        decayed = _f32(1 - alpha) * decay ** _f32(exponent) + _f32(alpha)
        return _f32(peak_value) * decayed

    def schedule(count: int) -> float:
        count = int(count)
        return float(linear(count) if count < warmup_steps else cosine(count - warmup_steps))

    return schedule


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=like.dtype, device=like.device)


class AdamW:
    """``optax.adamw``: Adam moments with bias correction, plus ``weight_decay
    * param``, times ``-learning_rate(count)``."""

    def __init__(self, learning_rate: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: Tensors) -> dict:
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for k, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors) -> Tensors:
        count = state["count"] + 1
        bc1 = _f32(1) - _f32(self.b1) ** _f32(count)
        bc2 = _f32(1) - _f32(self.b2) ** _f32(count)
        step = -_f32(self.learning_rate(state["count"]))
        out = {}
        for k, g in grads.items():
            mu, nu, p = state["mu"][k], state["nu"][k], params[k]
            mu.mul_(_f32(self.b1)).add_(g * _f32(1 - self.b1))
            nu.mul_(_f32(self.b2)).add_(g * g * _f32(1 - self.b2))
            u = (mu / _scalar(bc1, mu)) / (torch.sqrt(nu / _scalar(bc2, nu)) + _f32(self.eps))
            out[k] = (u + p * _f32(self.weight_decay)) * _f32(step)
        state["count"] = count
        return out

    def state_specs(self, state: dict, specs: dict) -> dict:
        """The partition spec of every tensor of ``state`` (a moment is cut
        as its parameter)."""
        return {"mu": {k: specs.get(k) for k in state["mu"]},
                "nu": {k: specs.get(k) for k in state["nu"]}}


def _factored_dims(shape, min_dim: int):
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest), or None when the second largest is under ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor:
    """``optax.adafactor`` with its defaults: factored RMS scaling, block-RMS
    clipping, the learning rate, the parameter's block RMS, then -1.

    On sharded leaves (:meth:`shard`: each leaf's partition spec and the
    mesh) the factored dimensions come from the leaf's global shape, and
    every mean over a dimension the mesh cuts, and the block RMS of a cut
    leaf, is summed over that axis (one counted all-reduce each), so each
    rank computes its slice of JAX's update."""

    _specs: Dict[str, tuple] = {}
    _mesh = None

    def __init__(self, learning_rate: Callable[[int], float], min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                 min_param_scale: float = 1e-3, eps: float = 1e-30):
        self.learning_rate = learning_rate
        self.min_dim = min_dim_size_to_factor
        self.decay_rate = decay_rate
        self.clipping_threshold = clipping_threshold
        self.min_param_scale = min_param_scale
        self.eps = eps

    def shard(self, specs: Dict[str, tuple], mesh) -> None:
        """Leaves cut over ``mesh`` by ``specs`` (path -> one axis name or
        None per dimension; a missing path is whole)."""
        self._specs, self._mesh = dict(specs), mesh

    def _cut(self, k: str, p: torch.Tensor) -> list:
        """The mesh axis cutting each dimension of leaf ``k`` (None: whole)."""
        spec = tuple(self._specs.get(k, ())) if self._mesh is not None else ()
        return [spec[i] if i < len(spec) and spec[i] in getattr(self._mesh, "shape", {})
                else None for i in range(p.ndim)]

    def _dims(self, k: str, p: torch.Tensor):
        shape = tuple(n * (self._mesh.shape[a] if a else 1)
                      for n, a in zip(p.shape, self._cut(k, p)))
        return _factored_dims(shape, self.min_dim)

    def _mean(self, x: torch.Tensor, dim: int, axis, keepdim: bool = False) -> torch.Tensor:
        """The mean over ``dim`` of the global leaf: its local mean averaged
        over ``axis`` when the axis cuts the dimension."""
        m = torch.mean(x, dim=dim, keepdim=keepdim)
        if axis is None:
            return m
        from yoho_tpu_torch.parallel.mesh import all_reduce

        return all_reduce(m.contiguous(), self._mesh, axis) / _f32(self._mesh.shape[axis])

    def _block_rms(self, x: torch.Tensor, cut: list) -> torch.Tensor:
        """The RMS of the whole (global) leaf."""
        axes = [a for a in cut if a]
        if not axes:
            return _rms(x)
        from yoho_tpu_torch.parallel.mesh import all_reduce

        ss = torch.sum(x * x).reshape(1)
        for a in axes:
            ss = all_reduce(ss, self._mesh, a)
        n = x.numel() * math.prod(self._mesh.shape[a] for a in axes)
        return torch.sqrt(ss[0] / _f32(n))

    def state_specs(self, state: dict, specs: dict) -> dict:
        """The partition spec of every tensor of ``state``: ``v`` as its
        parameter, the row and column statistics with the factored
        dimension taken out."""
        def drop(k, which):
            spec = tuple(specs.get(k) or ())
            d = self._factored[k][which]
            return tuple(a for i, a in enumerate(spec) if i != d) or None

        return {"v": {k: specs.get(k) for k in state["v"]},
                "v_row": {k: drop(k, 1) for k in state["v_row"]},
                "v_col": {k: drop(k, 0) for k in state["v_col"]}}

    def init(self, params: Tensors) -> dict:
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        self._factored = {}
        for k, p in params.items():
            dims = self._dims(k, p)
            if dims is not None:
                self._factored[k] = dims
            shape = list(p.shape)
            if dims is None:
                state["v"][k] = torch.zeros(shape, dtype=p.dtype, device=p.device)
            else:
                d1, d0 = dims
                state["v_row"][k] = torch.zeros(shape[:d0] + shape[d0 + 1:],
                                                dtype=p.dtype, device=p.device)
                state["v_col"][k] = torch.zeros(shape[:d1] + shape[d1 + 1:],
                                                dtype=p.dtype, device=p.device)
        return state

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors) -> Tensors:
        count = state["count"]
        rate = _f32(1) - _f32(count + 1) ** _f32(-self.decay_rate)
        keep, new = _f32(rate), _f32(_f32(1) - rate)
        lr = _f32(self.learning_rate(count))
        out = {}
        for k, g in grads.items():
            p = params[k]
            cut = self._cut(k, p)
            sq = g * g + _f32(self.eps)
            dims = self._dims(k, p)
            if dims is None:
                v = state["v"][k]
                v.copy_(v * keep + sq * new)
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                vr, vc = state["v_row"][k], state["v_col"][k]
                vr.copy_(vr * keep + self._mean(sq, d0, cut[d0]) * new)
                vc.copy_(vc * keep + self._mean(sq, d1, cut[d1]) * new)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row = (vr / self._mean(vr, reduced_d1, cut[d1], keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
            u = u / torch.clamp_min(self._block_rms(u, cut) / _f32(self.clipping_threshold),
                                    1.0)
            u = u * lr
            prms = self._block_rms(p, cut)
            u = u * torch.where(prms <= self.min_param_scale,
                                _scalar(self.min_param_scale, prms), prms)
            out[k] = -u
        state["count"] = count + 1
        return out


class MultiSteps:
    """``optax.MultiSteps(inner, every_k)``: the running mean of the
    mini-batch gradients, one inner update every ``every_k``-th call.
    ``reduce`` (set by a trainer over a mesh) sums the accumulated mean
    over the mesh in place just before the inner update: by linearity the
    mean of the summed mini-step gradients, with one reduction an update
    instead of one a mini-step."""

    def __init__(self, inner, every_k: int, reduce=None):
        if every_k < 1:
            raise ValueError(f"accumulated_batches must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.reduce = reduce

    def init(self, params: Tensors) -> dict:
        return {"format": STATE_FORMAT, "mini_step": 0, "gradient_step": 0,
                "acc_grads": {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                              for k, p in params.items()},
                "inner": self.inner.init(params)}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors) -> Optional[Tensors]:
        n = state["mini_step"]
        for k, g in grads.items():
            acc = state["acc_grads"][k]
            acc.add_((g - acc) / _f32(n + 1))
        if n < self.every_k - 1:
            state["mini_step"] = n + 1
            return None
        if self.reduce is not None:
            self.reduce(state["acc_grads"])
        updates = self.inner.update(state["acc_grads"], state["inner"], params)
        for acc in state["acc_grads"].values():
            acc.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return updates


    def state_specs(self, state: dict, specs: dict) -> dict:
        """The partition spec of every tensor of ``state``, from the
        parameters' (``specs``: path -> spec; a missing path is whole)."""
        return {"acc_grads": {k: specs.get(k) for k in state["acc_grads"]},
                "inner": self.inner.state_specs(state["inner"], specs)}


def trainable(params: Tensors, frozen: Callable[[str], bool]) -> Tensors:
    """The leaves that train: the ``multi_transform`` freeze (the frozen
    leaves get no optimizer state and no update)."""
    return {k: p for k, p in params.items() if not frozen(k)}


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``optax.apply_updates`` in place: p + u."""
    for k, u in updates.items():
        params[k].add_(u)


def load_state(state: dict, saved: dict, specs=None, mesh=None) -> dict:
    """The state tree ``saved`` (numpy arrays from a checkpoint) copied into
    ``state`` (same keys, tensors on their devices); ints taken as saved.
    Under a mesh the saved tensors are whole and ``specs`` (the tree of
    :meth:`MultiSteps.state_specs`) cuts this rank's slices out of them."""
    from yoho_tpu_torch.parallel.sharding import local_slice

    for k, v in state.items():
        spec = specs.get(k) if isinstance(specs, dict) else None
        if isinstance(v, dict):
            load_state(v, saved[k], spec, mesh)
        elif isinstance(v, torch.Tensor):
            src = saved[k]
            src = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.array(src))
            v.copy_(local_slice(src, spec, mesh) if mesh is not None else src)
        else:
            state[k] = type(v)(saved[k])
    return state
