"""Weights carried across from the JAX package, or random weights from a
seed.

A flax ``params`` tree (nested dicts of numpy arrays, as
``train/checkpoint.py::load_params`` returns it after ``jax.device_get``)
maps onto the PyTorch modules by name: ``blocks_3`` -> ``blocks.3`` (the
VAE's ``dec_blocks_0`` -> ``dec_blocks.0``), and the
leaves by kind:

* a ``Dense`` kernel is (in, out); ``nn.Linear.weight`` is (out, in);
* a ``Conv`` kernel is (k, in, out); ``nn.Conv1d.weight`` is (out, in, k);
* a ``LayerNorm`` has ``scale`` where PyTorch has ``weight``; the port's
  ``RMSNorm`` keeps flax's ``scale``;
* a ``DenseGeneral`` kernel (the GQA projections) is (in, H, D); the
  port's ``DenseGeneral`` is an ``nn.Linear`` with weight (H*D, in), and
  an int8 one's ``kernel_q`` (in, H, D) / ``kernel_scale`` (1, H, D) become
  ``weight_q`` (H*D, in) / ``weight_scale`` (H*D,);
* an ``Embed`` table is ``embedding``; the tied logits read the same table;
* ``positional_embedding`` is a bare parameter and keeps its name, as do
  the MoE experts' stacked (E, in, out) ``kernel`` leaves
  (``mlp/experts/gate/kernel``), which keep flax's layout; the MoE
  ``router`` is a bias-free ``Dense``;
* the int8 lanes' leaves (``nn/quantize.py``): ``kernel_q`` (in, out) int8
  becomes the buffer ``weight_q`` (out, in), ``kernel_scale`` (1, out)
  ``weight_scale`` (out,), ``embedding_q`` (V, D) ``weight_q`` and
  ``embedding_scale`` (V, 1) ``weight_scale`` (V,).

:func:`to_jax_params` is the inverse: the module's parameters and stored
buffers as a flax tree of numpy arrays, in the JAX names and layouts (what
checkpoints, LoRA adapters and the HF export write). :func:`jax_leaves`
gives the same leaves as views of the module's own tensors, keyed by their
'/'-joined JAX path: the trainer's optimizer steps them in place, in the
JAX layout (Adafactor's factoring depends on it).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        elif isinstance(val, torch.Tensor):  # e.g. a bf16 leaf of train.checkpoint
            val = val.detach().cpu()
            out[prefix + (key,)] = (val.float() if val.is_floating_point() else val).numpy()
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _torch_name(path: tuple) -> str:
    *mods, leaf = path
    mods = [re.sub(r"^((?:dec_)?blocks)_(\d+)$", r"\1.\2", m) for m in mods]
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "kernel_q": "weight_q", "kernel_scale": "weight_scale",
            "embedding_q": "weight_q",
            "embedding_scale": "weight_scale"}.get(leaf, leaf)
    return ".".join(mods + [leaf])


def _state_name(path: tuple, state: Mapping) -> str:
    """The port's name of a flax leaf; a leaf whose port tensor keeps
    flax's own name (the RMSNorm ``scale``) keeps it."""
    name = _torch_name(path)
    if name in state:
        return name
    return ".".join(name.split(".")[:-1] + [path[-1]])


def _torch_layout(leaf: str, arr: np.ndarray, ndim: int) -> np.ndarray:
    """``arr`` in the layout of a port tensor of ``ndim`` dimensions."""
    if leaf in ("kernel", "kernel_q") and arr.ndim == 2:  # (in, out) -> (out, in)
        return arr.T
    if leaf in ("kernel", "kernel_q") and arr.ndim == 3 and ndim == 2:
        return arr.reshape(arr.shape[0], -1).T  # DenseGeneral (in, H, D)
    if leaf == "kernel" and arr.ndim == 3:   # Conv (k, in, out) -> (out, in, k)
        return arr.transpose(2, 1, 0)
    if leaf in ("kernel_scale", "embedding_scale"):  # (1, out) / (V, 1) -> 1-D
        return arr.reshape(-1)
    return arr


def _jax_module_path(name: str) -> Tuple[str, ...]:
    """``encoder.blocks.3.attn`` -> ('encoder', 'blocks_3', 'attn'); the
    VAE's ``dec_blocks.0`` -> 'dec_blocks_0'."""
    return tuple(re.sub(r"(^|\.)((?:dec_)?blocks)\.(\d+)", r"\1\2_\3", name).split(".")) \
        if name else ()


def _jax_leaf(mod: nn.Module, pname: str):
    """The JAX leaf name of ``mod.<pname>`` and the function that views a
    tensor of its shape in the JAX layout."""
    from yoho_tpu_torch.nn.layers import (
        DenseGeneral,
        QuantizedDenseGeneral,
        QuantizedEmbed,
        _Int8Weights,
    )

    same = lambda t: t  # noqa: E731
    if isinstance(mod, DenseGeneral) and pname == "weight":
        return "kernel", lambda t: t.T.unflatten(1, mod.features)
    if isinstance(mod, QuantizedDenseGeneral) and pname in ("weight_q", "weight_scale"):
        return (("kernel_q", lambda t: t.T.unflatten(1, mod.features))
                if pname == "weight_q"
                else ("kernel_scale", lambda t: t.reshape(1, *mod.features)))
    if isinstance(mod, nn.Linear) and pname == "weight":
        return "kernel", lambda t: t.T
    if isinstance(mod, nn.Conv1d) and pname == "weight":
        return "kernel", lambda t: t.permute(2, 1, 0)
    if isinstance(mod, nn.LayerNorm) and pname == "weight":
        return "scale", same
    if isinstance(mod, nn.Embedding) and pname == "weight":
        return "embedding", same
    if isinstance(mod, _Int8Weights) and pname in ("weight_q", "weight_scale"):
        return (("kernel_q", lambda t: t.T) if pname == "weight_q"
                else ("kernel_scale", lambda t: t.reshape(1, -1)))
    if isinstance(mod, QuantizedEmbed) and pname in ("weight_q", "weight_scale"):
        return (("embedding_q", same) if pname == "weight_q"
                else ("embedding_scale", lambda t: t.reshape(-1, 1)))
    return pname, same


def jax_parameters(model: nn.Module) -> Dict[str, Tuple[torch.Tensor, object]]:
    """'/'-joined JAX path -> (the module's tensor, its JAX-layout view
    function), for every parameter and stored buffer. A parametrized weight
    (LoRA while training) gives its parametrized value, a new tensor."""
    from torch.nn.utils import parametrize

    out: Dict[str, Tuple[torch.Tensor, object]] = {}
    for mname, mod in model.named_modules():
        if ".parametrizations" in f".{mname}":
            continue
        tensors = [(n, t) for n, t in mod._parameters.items() if t is not None]
        tensors += [(n, t) for n, t in mod._buffers.items()
                    if t is not None and n not in mod._non_persistent_buffers_set]
        if parametrize.is_parametrized(mod):
            tensors += [(n, getattr(mod, n)) for n in mod.parametrizations]
        for pname, t in tensors:
            leaf, view = _jax_leaf(mod, pname)
            out["/".join(_jax_module_path(mname) + (leaf,))] = (t, view)
    return out


def jax_leaves(model: nn.Module) -> Dict[str, torch.Tensor]:
    """'/'-joined JAX path -> the parameter or stored buffer viewed in the
    JAX layout (``kernel`` of a Linear is its weight transposed)."""
    return {k: view(t) for k, (t, view) in jax_parameters(model).items()}


@torch.no_grad()
def to_jax_params(model: nn.Module) -> Dict:
    """The module as a flax params tree (nested dicts of numpy arrays): the
    inverse of :func:`load_jax_params`. Floats are float32 (flax's
    parameter type), int8 codes stay int8."""
    tree: Dict = {}
    for path, t in jax_leaves(model).items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        t = t.detach()
        node[leaf] = (t.float() if t.is_floating_point() else t).cpu().numpy().copy()
    return tree


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``model`` from a flax params tree; every parameter and stored
    buffer of the module must be matched by exactly one leaf of the tree
    and vice versa. Float values are cast to each tensor's own type (flax
    keeps float32 params and casts them to the compute type at use); int8
    codes must arrive as int8 and keep their type."""
    state = model.state_dict(keep_vars=True)
    flat = _flatten(params)
    names = {_state_name(p, state): p for p in flat}
    missing = sorted(set(state) - set(names))
    unexpected = sorted(set(names) - set(state))
    if missing or unexpected:
        raise KeyError(f"params do not match the module: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, path in names.items():
        dst = state[name]
        # A port tensor under flax's own leaf name (an RMSNorm ``scale``,
        # the stacked experts' ``kernel``) keeps flax's layout.
        arr = flat[path] if name.rsplit(".", 1)[-1] == path[-1] else \
            _torch_layout(path[-1], flat[path], dst.ndim)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} -> {name} "
                             f"{tuple(dst.shape)}")
        if dst.is_floating_point():
            # "W": a read-only array (a JAX leaf, a mapped file) is copied
            # first; torch.from_numpy warns on one.
            dst.copy_(torch.from_numpy(np.require(arr, np.float32, ("C", "W"))))
        elif arr.dtype == np.int8 and dst.dtype == torch.int8:
            dst.copy_(torch.from_numpy(np.require(arr, None, ("C", "W"))))
        else:
            raise TypeError(f"{'/'.join(path)}: {arr.dtype} -> {name} {dst.dtype}")
    return model


@torch.no_grad()
def init_random(model: nn.Module, seed: int = 0, std: float = 0.02) -> nn.Module:
    """Random weights from a seed, made on the model's device: normal(0,
    std) matrices and embeddings, zero biases, unit LayerNorm and RMSNorm
    scales. The
    int8 lanes' buffers are left alone: a random int8 model is a random
    float model put through ``nn/quantize.py``."""
    from yoho_tpu_torch.nn.layers import RMSNorm

    gen = None
    for _, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            if pname == "bias":
                p.zero_()
            elif isinstance(mod, (nn.LayerNorm, RMSNorm)):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=torch.float32) * std)
    return model
