"""Sharded checkpoints on ``torch.distributed.checkpoint`` (DCP).

The JAX package's ``train/sharded_checkpoint.py`` (orbax) with its
contract: every rank writes only its own shards of a (step, params,
opt_state) checkpoint directory, and a restore lays the arrays out as the
given templates are laid out (another mesh's layout included: DCP
reshards). The msgpack path (``train/checkpoint.py``) gathers every leaf
to the coordinator; this one never gathers.

Write-then-swap: the new checkpoint lands in a sibling ``.new`` directory
first, and only the coordinator swaps it into place after every rank has
written (barriers ``staging``, ``written`` and ``swapped``); deleting the
old checkpoint first would leave a window with none, and a rank removing
a directory its peers are still walking races them. A restore falls back
to the ``.old`` sibling when a crash landed between the two renames of
the swap; it returns None when neither exists.

Trees are nested dicts of tensors (and ints or strings) by name; ``specs``
trees give each tensor's partition spec (``parallel/sharding.py``; a
missing entry is whole). Each tensor goes to DCP as a ``DTensor`` built
from this rank's local shard over the mesh's device mesh: plain local
tensors under one key would be taken as replicated, and one rank's shard
would be written for all.

Opt-in, as in JAX: the trainers keep the msgpack checkpoint; call these
from a launch script (every rank, in the same order).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from yoho_tpu_torch.parallel.mesh import barrier, is_coordinator


def _flat(tree, prefix: tuple, out: dict, specs=None, spec_out: Optional[dict] = None) -> dict:
    """Leaves by their DCP key ('/'-joined path) -> (path tuple, leaf)."""
    for k, v in tree.items():
        path = prefix + (str(k),)
        sub = specs.get(k) if isinstance(specs, dict) else None
        if isinstance(v, dict):
            _flat(v, path, out, sub, spec_out)
        else:
            out["/".join(path)] = (path, v)
            if spec_out is not None:
                spec_out["/".join(path)] = sub
    return out


def _nest(flat: dict, paths: dict, top: str) -> dict:
    """The tree under ``top`` rebuilt from its leaves' path tuples (a key
    may itself hold '/', as a flat JAX path does)."""
    tree: dict = {}
    for key, v in flat.items():
        path = paths.get(key)
        if path is None or path[0] != top:
            continue
        node = tree
        for m in path[1:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = v
    return tree


def _placements(spec, mesh, ndim: int):
    from torch.distributed.tensor import Replicate, Shard

    spec = tuple(spec or ())
    out = []
    for axis in mesh.axis_names:
        dims = [d for d in range(min(len(spec), ndim)) if spec[d] == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _state_dict(step: int, params, opt_state, mesh, specs, opt_specs) -> tuple:
    """One flat state dict (every tensor a DTensor of this rank's shard)
    and each key's path in the trees."""
    from torch.distributed.tensor import DTensor

    flat, flat_specs = {}, {}
    _flat(params, ("params",), flat, specs, flat_specs)
    _flat(opt_state, ("opt_state",), flat, opt_specs, flat_specs)
    sd = {"step": torch.tensor(int(step), dtype=torch.int64)}
    for key, (_path, v) in flat.items():
        if isinstance(v, torch.Tensor):
            v = DTensor.from_local(v.detach(), mesh.device_mesh,
                                   _placements(flat_specs[key], mesh, v.ndim),
                                   run_check=False)
        sd[key] = v
    return sd, {key: path for key, (path, _v) in flat.items()}


def save_checkpoint_sharded(path, step: int, params, opt_state, mesh,
                            specs=None, opt_specs=None) -> None:
    """Write a DCP checkpoint directory at ``path``: ``params`` and
    ``opt_state`` hold this rank's local shards, ``specs`` / ``opt_specs``
    their partition specs on ``mesh``. Every rank calls it."""
    import torch.distributed.checkpoint as dcp

    path = Path(path).absolute()
    staging = path.with_name(path.name + ".new")
    if staging.exists() and is_coordinator():
        shutil.rmtree(staging)  # a leftover of a crashed save
    barrier("staging")
    dcp.save(_state_dict(step, params, opt_state, mesh, specs, opt_specs)[0],
             checkpoint_id=str(staging))
    barrier("written")
    if is_coordinator():
        old = path.with_name(path.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        if path.exists():
            path.rename(old)
        staging.rename(path)
        if old.exists():
            shutil.rmtree(old)
    barrier("swapped")


def load_checkpoint_sharded(path, params_template, opt_state_template, mesh,
                            specs=None, opt_specs=None) -> Optional[Tuple[int, Any, Any]]:
    """Restore (step, params, opt_state) into the templates' layout (local
    shards on ``mesh`` by ``specs`` / ``opt_specs``; the saved mesh may
    differ); None when absent. The templates' tensors are filled in place
    and returned in trees of local tensors; ints and strings come back as
    saved. Falls back to the ``.old`` sibling when ``path`` itself is
    missing (a crash inside the swap). Every rank calls it."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    path = Path(path).absolute()
    if not path.exists():
        old = path.with_name(path.name + ".old")
        if not old.exists():
            return None
        path = old
    sd, paths = _state_dict(0, params_template, opt_state_template, mesh, specs, opt_specs)
    dcp.load(sd, checkpoint_id=str(path))
    flat = {k: (v.to_local() if isinstance(v, DTensor) else v) for k, v in sd.items()}
    return (int(flat["step"]), _nest(flat, paths, "params"),
            _nest(flat, paths, "opt_state"))
