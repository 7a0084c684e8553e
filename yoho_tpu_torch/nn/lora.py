"""Low-rank adaptation (LoRA) — parameter-efficient fine-tuning.

The port's counterpart of the JAX package's ``nn/lora.py``: rank-``r``
factors per targeted kernel, ``W' = W + (alpha/r) * A @ B`` with ``A:
(d_in, r)`` gaussian and ``B: (r, d_out)`` zero-initialized, so the merged
model equals the base at step 0 and the frozen base stays bit-identical.

Adapter trees are flat ``{"<module/path>": {"a": A, "b": B}}`` dicts keyed
by the JAX package's module paths (``decoder/blocks_0/attn/q_proj``) in its
layouts (a kernel is (in, out)), so ``DEFAULT_TARGETS`` keeps its meaning
and the adapter files are the same. The merge happens on the fly inside
the train step, as in the JAX package: :func:`attach_lora` registers each
adapter as a parametrization of its ``nn.Linear`` weight (``weight + scale
* (A @ B).T``, in float32 outside autocast), so every forward, the
checkpointed recompute of a remat block included, reads the merged weight
and gradients flow into A and B only. :func:`merge_lora` is the same merge
on a host tree (adapter application at load time).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from yoho_tpu_torch.nn import params as nn_params
from yoho_tpu_torch.train import msgpack

# Standard LoRA recipe: query/value projections of every attention
# (self + cross). Matched with re.search against the '/'-joined module
# path (the dict path WITHOUT the trailing 'kernel' leaf name).
DEFAULT_TARGETS = r"(attn|cross_attn)/(q_proj|v_proj)$"

ADAPTER_FILE = "lora_adapter.msgpack"
ADAPTER_META_FILE = "lora_adapter.meta.json"


def _kernel_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """Module path -> kernel shape (JAX layout), from a flax-style tree or
    a module."""
    if isinstance(params, nn.Module):
        return {k[:-len("/kernel")]: tuple(t.shape) for k, t in nn_params.jax_leaves(params).items()
                if k.endswith("/kernel")}
    out = {}

    def walk(node, path):
        if not isinstance(node, Mapping):
            return
        kernel = node.get("kernel")
        if kernel is not None and not isinstance(kernel, Mapping):
            out["/".join(path)] = tuple(kernel.shape)
        for key in node:
            walk(node[key], path + (key,))

    walk(params, ())
    return out


def select_lora_targets(params, targets: str = DEFAULT_TARGETS) -> List[str]:
    """'/'-joined paths of modules whose ``kernel`` gets an adapter: the
    path matches ``targets`` and the kernel has ndim >= 2. ``params`` is a
    flax-style tree or a port module (its JAX names)."""
    found = sorted(path for path, shape in _kernel_shapes(params).items()
                   if len(shape) >= 2 and re.search(targets, path))
    if not found:
        raise ValueError(
            f"lora targets regex {targets!r} matched no kernel-bearing "
            "module in the param tree — check the pattern against the "
            "module paths (nn.params.jax_leaves)")
    return found


def init_lora(generator: torch.Generator, params, rank: int,
              targets: str = DEFAULT_TARGETS) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fresh adapter tree on ``generator``'s device: A ~ N(0, 1/d_in) from
    ``generator``, B = 0 (Hu et al. §4.1): the merged model equals the base
    at step 0."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    shapes = _kernel_shapes(params)
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    for path in select_lora_targets(params, targets):
        shape = shapes[path]
        d_in, d_out = shape[0], int(np.prod(shape[1:]))
        if rank > min(d_in, d_out):
            raise ValueError(
                f"lora rank {rank} exceeds min dim {min(d_in, d_out)} of "
                f"{path} kernel {shape} — a full-rank adapter defeats the "
                "point; lower the rank")
        dev = generator.device
        lora[path] = {"a": torch.randn((d_in, rank), generator=generator, dtype=torch.float32,
                                       device=dev) / np.sqrt(d_in),
                      "b": torch.zeros((rank, d_out), dtype=torch.float32, device=dev)}
    return lora


def lora_scale(rank: int, alpha: Optional[float] = None) -> float:
    """``alpha/rank``; default alpha = 2*rank (scale 2.0, the common
    peft recipe) — pass ``alpha=rank`` for a 1.0 scale."""
    return float(alpha if alpha is not None else 2 * rank) / float(rank)


def _node(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, Mapping) else tree


def merge_lora(params, lora, scale: float):
    """Base tree + scaled low-rank deltas on the targeted kernels, on host
    numpy trees (adapter application at load time); other leaves pass
    through untouched. In a module the merge is :func:`attach_lora`'s."""
    merged = _copy_tree(params)
    for path, ab in lora.items():
        node = _node(merged, path)
        kernel = node["kernel"]
        delta = (np.asarray(ab["a"], np.float32) @ np.asarray(ab["b"], np.float32))
        node["kernel"] = kernel + np.float32(scale) * delta.reshape(kernel.shape).astype(
            kernel.dtype)
    return merged


def count_lora_params(lora) -> int:
    return int(sum(int(np.prod(ab[k].shape)) for ab in lora.values() for k in ("a", "b")))


# ---------------------------------------------------------------------------
# Merge on the fly in a module: a parametrization of each targeted weight.
# ---------------------------------------------------------------------------

class LoRADelta(nn.Module):
    """The parametrization ``weight + scale * (A @ B).T`` of an ``nn.Linear``
    weight (out, in); A (in, r) and B (r, out) are its trainable
    parameters. The merge runs in float32 outside autocast, as the JAX
    package merges the float32 kernels before the model casts them.

    On a layer cut over the ``model`` axis (``split``, the layer's
    ``tp_split``: kind, first unit, units) the adapters stay whole, as
    JAX replicates them: a column-parallel weight takes B's local output
    columns, a row-parallel one A's local input rows (before the layer's
    ``model_sum``). Their gradients are then this rank's part, summed over
    the axis with the data axis (:func:`sharded_adapter`)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, scale: float, split=None):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)
        self.scale = float(scale)
        self.split = split

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        a, b = self.a, self.b
        if self.split is not None:
            kind, lo, k = self.split
            if kind == "column":
                b = b[:, lo:lo + k]
            else:
                a = a[lo:lo + k]
        with torch.autocast(weight.device.type, enabled=False):
            return weight + self.scale * (a @ b).T.to(weight.dtype)


def _module(model: nn.Module, path: str) -> nn.Module:
    mod = model
    for part in path.split("/"):
        m = re.fullmatch(r"blocks_(\d+)", part)
        mod = mod.blocks[int(m.group(1))] if m else getattr(mod, part)
    return mod


def _f32_copy(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
    return t.detach().to(device, torch.float32).clone()


def attach_lora(model: nn.Module, lora: Mapping, scale: float) -> Dict[str, torch.Tensor]:
    """Register each adapter of ``lora`` on its ``nn.Linear`` of ``model``
    (a :class:`LoRADelta` parametrization) and freeze every base parameter.
    Returns the trainable adapter leaves, keyed ``<path>/a`` and
    ``<path>/b``."""
    for p in model.parameters():
        p.requires_grad_(False)
    leaves = {}
    for path, ab in lora.items():
        mod = _module(model, path)
        if not isinstance(mod, nn.Linear):
            raise TypeError(f"lora target {path} is {type(mod).__name__}, not nn.Linear")
        dev = mod.weight.device
        delta = LoRADelta(_f32_copy(ab["a"], dev), _f32_copy(ab["b"], dev), scale,
                          getattr(mod, "tp_split", None))
        parametrize.register_parametrization(mod, "weight", delta)
        leaves[f"{path}/a"], leaves[f"{path}/b"] = delta.a, delta.b
    return leaves


def sharded_adapter(model: nn.Module, leaf: str) -> bool:
    """True when the adapter leaf ``<path>/a`` or ``<path>/b`` sits on a
    layer cut over the ``model`` axis (its gradient is a part)."""
    mod = _module(model, leaf.rsplit("/", 1)[0])
    return getattr(mod, "tp_split", None) is not None


def adapters_of(model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The adapter tree of a model with :func:`attach_lora` adapters."""
    out = {}
    for mname, mod in model.named_modules():
        if parametrize.is_parametrized(mod, "weight"):
            for p in mod.parametrizations.weight:
                if isinstance(p, LoRADelta):
                    path = re.sub(r"(^|\.)blocks\.(\d+)", r"\1blocks_\2", mname).replace(".", "/")
                    out[path] = {"a": p.a, "b": p.b}
    return out


def detach_lora(model: nn.Module, merge: bool = False) -> None:
    """Remove the adapters: ``merge=True`` leaves the merged weights, else
    the base weights as they were."""
    for mod in list(model.modules()):
        if parametrize.is_parametrized(mod, "weight"):
            parametrize.remove_parametrizations(mod, "weight", leave_parametrized=merge)


# ---------------------------------------------------------------------------
# Adapter artifact: msgpack weights + json meta (the JAX package's files).
# ---------------------------------------------------------------------------

def _host(lora) -> dict:
    return {path: {k: (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v, np.float32)) for k, v in ab.items()}
            for path, ab in lora.items()}


def save_adapter(out_dir, lora, *, rank: int, alpha: Optional[float],
                 targets: str, extra_meta: Optional[dict] = None) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    host = _host(lora)
    (out_dir / ADAPTER_FILE).write_bytes(msgpack.dumps(host))
    meta = {"rank": int(rank),
            "alpha": float(alpha if alpha is not None else 2 * rank),
            "scale": lora_scale(rank, alpha),
            "targets": targets,
            "n_params": count_lora_params(host)}
    meta.update(extra_meta or {})
    (out_dir / ADAPTER_META_FILE).write_text(json.dumps(meta, indent=1))
    return out_dir / ADAPTER_FILE


def load_adapter(path) -> Tuple[dict, dict]:
    """-> (lora tree of numpy f32, meta dict). ``path`` may be the
    adapter file or a directory containing it."""
    path = Path(path)
    if path.is_dir():
        path = path / ADAPTER_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"no LoRA adapter at {path} (expected {ADAPTER_FILE} written "
            "by a LoRA fine-tune)")
    lora = msgpack.loads(path.read_bytes())
    meta_path = path.with_name(ADAPTER_META_FILE)
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return lora, meta


def apply_adapter(params, path, *, scale: Optional[float] = None):
    """Merge a saved adapter into a (host) param tree at load time; raises
    when an adapter path is absent, its shape differs, or the scale is
    unknown (no meta file and no ``scale=``)."""
    lora, meta = load_adapter(path)
    if scale is None:
        if "scale" not in meta:
            raise ValueError(
                f"adapter at {path} has no {ADAPTER_META_FILE} (or it "
                "lacks 'scale') — the merge scale alpha/rank is unknown "
                "and a guessed value would quietly mis-scale the trained "
                "delta; restore the meta file written next to the "
                "adapter, or pass scale= explicitly")
        scale = float(meta["scale"])
    missing = []
    for mod_path in lora:
        try:
            node = _node(params, mod_path)
        except KeyError:
            missing.append(mod_path)
            continue
        kernel = node.get("kernel")
        want = lora[mod_path]["a"].shape[0], lora[mod_path]["b"].shape[1]
        have = (None if kernel is None else
                (kernel.shape[0], int(np.prod(kernel.shape[1:]))))
        if have != want:
            raise ValueError(
                f"adapter {mod_path} was trained for a kernel of "
                f"(d_in, d_out)={want}, checkpoint has {have} — the "
                "adapter belongs to a different architecture")
    if missing:
        raise ValueError(
            f"adapter modules absent from this checkpoint: {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''} — the adapter belongs "
            "to a different architecture")
    return merge_lora(params, lora, scale)
