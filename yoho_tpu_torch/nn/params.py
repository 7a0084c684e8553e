"""Weights carried across from the JAX package, or random weights from a
seed.

A flax ``params`` tree (nested dicts of numpy arrays, as
``train/checkpoint.py::load_params`` returns it after ``jax.device_get``)
maps onto the PyTorch modules by name: ``blocks_3`` -> ``blocks.3``, and the
leaves by kind:

* a ``Dense`` kernel is (in, out); ``nn.Linear.weight`` is (out, in);
* a ``Conv`` kernel is (k, in, out); ``nn.Conv1d.weight`` is (out, in, k);
* a ``LayerNorm`` has ``scale`` where PyTorch has ``weight``;
* an ``Embed`` table is ``embedding``; the tied logits read the same table;
* ``positional_embedding`` is a bare parameter and keeps its name;
* the int8 lanes' leaves (``nn/quantize.py``): ``kernel_q`` (in, out) int8
  becomes the buffer ``weight_q`` (out, in), ``kernel_scale`` (1, out)
  ``weight_scale`` (out,), ``embedding_q`` (V, D) ``weight_q`` and
  ``embedding_scale`` (V, 1) ``weight_scale`` (V,).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _torch_name(path: tuple) -> str:
    *mods, leaf = path
    mods = [re.sub(r"^blocks_(\d+)$", r"blocks.\1", m) for m in mods]
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "kernel_q": "weight_q", "kernel_scale": "weight_scale",
            "embedding_q": "weight_q",
            "embedding_scale": "weight_scale"}.get(leaf, leaf)
    return ".".join(mods + [leaf])


def _torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf in ("kernel", "kernel_q") and arr.ndim == 2:  # (in, out) -> (out, in)
        return arr.T
    if leaf == "kernel" and arr.ndim == 3:   # Conv (k, in, out) -> (out, in, k)
        return arr.transpose(2, 1, 0)
    if leaf in ("kernel_scale", "embedding_scale"):  # (1, out) / (V, 1) -> 1-D
        return arr.reshape(-1)
    return arr


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``model`` from a flax params tree; every parameter and stored
    buffer of the module must be matched by exactly one leaf of the tree
    and vice versa. Float values are cast to each tensor's own type (flax
    keeps float32 params and casts them to the compute type at use); int8
    codes must arrive as int8 and keep their type."""
    state = model.state_dict(keep_vars=True)
    flat = _flatten(params)
    names = {_torch_name(p): p for p in flat}
    missing = sorted(set(state) - set(names))
    unexpected = sorted(set(names) - set(state))
    if missing or unexpected:
        raise KeyError(f"params do not match the module: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, path in names.items():
        arr = _torch_layout(path[-1], flat[path])
        dst = state[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} -> {name} "
                             f"{tuple(dst.shape)}")
        if dst.is_floating_point():
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
        elif arr.dtype == np.int8 and dst.dtype == torch.int8:
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        else:
            raise TypeError(f"{'/'.join(path)}: {arr.dtype} -> {name} {dst.dtype}")
    return model


@torch.no_grad()
def init_random(model: nn.Module, seed: int = 0, std: float = 0.02) -> nn.Module:
    """Random weights from a seed, made on the model's device: normal(0,
    std) matrices and embeddings, zero biases, unit LayerNorm scales. The
    int8 lanes' buffers are left alone: a random int8 model is a random
    float model put through ``nn/quantize.py``."""
    gen = None
    for _, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            if pname == "bias":
                p.zero_()
            elif isinstance(mod, nn.LayerNorm):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=torch.float32) * std)
    return model
