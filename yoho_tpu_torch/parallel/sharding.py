"""Parameter partitioning: path rules -> partition specs, and the tensor
parallel layout of a port model over the ``model`` axis of a mesh.

The JAX package's ``parallel/sharding.py``: the same rules over the same
"/"-joined flax paths (``nn/params.py`` gives every port parameter its
flax path), the same rank fit and the same mesh fallback (:func:`_mesh_fit`:
replicate when the mesh lacks the axis or the axis does not divide the
leaf). :func:`partition_specs` gives the table; :func:`shard_params` cuts
each rank's shards out of a model in place.

Where the JAX package leaves the layout of every intermediate to GSPMD,
the port decides per layer, from the specs of its kernels:

* attention (``MultiHeadAttention``, ``GroupedQueryAttention``): q/k/v
  column-parallel by whole heads, out row-parallel, when every one of the
  four kernels is sharded and the heads divide the axis; else the layer
  stays whole. So a GQA layer whose KV heads do not divide the axis
  (YOHO's 3 on a model axis of 2) is whole: with q sharded and K/V whole,
  rank r's local query head h would no longer read KV head
  ``h // groups``, which the decode kernel's ``groups`` assumes; and a
  layer of fewer heads than the axis (whisper-tiny's 6 on 4, whose width
  384 divides) is whole rather than cut inside a head;
* MLP / SwiGLU: fc1 (gate, up) column-parallel, fc2 (down) row-parallel;
* MoE: the stacked experts split on the expert axis, the router whole;
* token embedding: vocabulary rows (a masked lookup summed over the axis,
  the tied logits gathered); whisper's 51,865 rows divide no even axis
  and stay whole.

A row-parallel layer's bias rides model rank 0's partial sum, so it is
added once; a model axis of 1 computes the unsharded layer's arithmetic.
The int8 lanes' leaves (``kernel_q``, ``embedding_q``) match no sharding
rule, in the JAX package as here: every int8 layer stays whole, and the
W8A8 kernel quantizes whole activation rows, bit-exact as unsharded. A
bias whose kernel stays whole stays whole with it (the table may shard
it; the layer computes the same function).
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch
from torch import nn

from yoho_tpu_torch.parallel.mesh import AXIS_MODEL


class P(tuple):
    """A partition spec: one mesh axis name (or None) per array dimension;
    ``P()`` replicates (``jax.sharding.PartitionSpec``'s meaning)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):
        return (P, tuple(self))


PartitionRules = Sequence[Tuple[str, P]]

_COMMON_RULES: PartitionRules = (
    (r".*(q_proj|k_proj|v_proj)/kernel$", P(None, AXIS_MODEL)),
    (r".*(q_proj|k_proj|v_proj)/bias$", P(AXIS_MODEL)),
    (r".*out_proj/kernel$", P(AXIS_MODEL, None)),
    (r".*out_proj/bias$", P()),
    (r".*mlp/experts/.*$", P(AXIS_MODEL)),
    (r".*mlp/router/.*$", P()),
    (r".*mlp/(fc1|gate|up)/kernel$", P(None, AXIS_MODEL)),
    (r".*mlp/(fc1|gate|up)/bias$", P(AXIS_MODEL)),
    (r".*mlp/(fc2|down)/kernel$", P(AXIS_MODEL, None)),
    (r".*mlp/(fc2|down)/bias$", P()),
    (r".*token_embedding/embedding$", P(AXIS_MODEL, None)),
    (r".*voiceprint_head/.*/kernel$", P(None, AXIS_MODEL)),
    (r".*", P()),
)

WHISPER_RULES: PartitionRules = _COMMON_RULES
YOHO_RULES: PartitionRules = _COMMON_RULES


def _fit(spec: P, shape) -> P:
    """Rank fit: sharded axes past the leaf's rank dropped."""
    out = [ax if i < len(shape) else None for i, ax in enumerate(spec)][: len(shape)]
    return P(*out) if out else P()


def _mesh_fit(spec: P, shape, mesh) -> P:
    """The one mesh fallback: replicate when the spec names an axis the
    mesh lacks or one that does not divide the leaf's shape."""
    for i, ax in enumerate(spec):
        if ax is not None and (ax not in mesh.shape or shape[i] % mesh.shape[ax] != 0):
            return P()
    return spec


def spec_of(path: str, shape, rules: PartitionRules = _COMMON_RULES, mesh=None) -> P:
    """The spec of one leaf: the first rule matching its path, rank-fitted,
    and mesh-fitted when ``mesh`` (anything with a ``shape`` dict) is
    given."""
    for pat, spec in rules:
        if re.match(pat, path):
            fitted = _fit(spec, shape)
            return _mesh_fit(fitted, shape, mesh) if mesh is not None else fitted
    return P()


def partition_specs(params, rules: PartitionRules = _COMMON_RULES, mesh=None):
    """A flax params tree (nested dicts of arrays) -> the same tree of
    specs (the JAX package's ``partition_specs``)."""

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        return spec_of("/".join(prefix), tuple(getattr(node, "shape", ())), rules, mesh)

    return walk(params, ())


def model_specs(model: nn.Module, mesh, rules: PartitionRules = _COMMON_RULES) -> dict:
    """'/'-joined flax path -> mesh-fitted spec for every leaf of a port
    model (its JAX-layout shape)."""
    from yoho_tpu_torch.nn import params as nn_params

    return {path: spec_of(path, tuple(view(t).shape), rules, mesh)
            for path, (t, view) in nn_params.jax_parameters(model).items()}


# ---------------------------------------------------------------------------
# The tensor-parallel layout of a model
# ---------------------------------------------------------------------------

def _set(mod: nn.Module, name: str, value: torch.Tensor) -> None:
    old = getattr(mod, name)
    setattr(mod, name, nn.Parameter(value.contiguous().clone(),
                                    requires_grad=old.requires_grad))


def _column(lin: nn.Linear, m: int, r: int) -> None:
    """Output units split: rank r keeps rows [r*k, (r+1)*k) of the (out,
    in) weight and of the bias."""
    k = lin.out_features // m
    _set(lin, "weight", lin.weight.data[r * k:(r + 1) * k])
    if lin.bias is not None:
        _set(lin, "bias", lin.bias.data[r * k:(r + 1) * k])
    lin.out_features = k
    lin.tp_split = ("column", r * k, k)
    if hasattr(lin, "features"):  # DenseGeneral: (heads, head_dim)
        lin.features = (lin.features[0] // m, lin.features[1])


def _row(lin: nn.Linear, m: int, r: int) -> None:
    """Input units split; the bias stays on model rank 0 only, so the
    all-reduce of the partial outputs adds it once."""
    k = lin.in_features // m
    _set(lin, "weight", lin.weight.data[:, r * k:(r + 1) * k])
    lin.in_features = k
    lin.tp_split = ("row", r * k, k)
    if lin.bias is not None and r != 0:
        lin.bias = None


def _sharded(specs: dict, *paths: str) -> bool:
    return all(AXIS_MODEL in specs.get(p, P()) for p in paths)


def shard_params(model: nn.Module, mesh, rules: PartitionRules = _COMMON_RULES) -> nn.Module:
    """Cut this rank's shards out of ``model`` in place (see the module
    doc) and give each tensor-parallel layer the mesh (``tp``); returns the
    model. Layers the rules leave whole keep every weight. A mesh without
    a ``model`` axis shards nothing. The model remembers its mesh
    (``tp_mesh``): sharding it again over the same mesh does nothing, over
    another raises. ``model.tp_specs`` keeps the layout it got: each
    leaf's spec (of the global shape) where its layer was cut; a leaf not
    listed stayed whole."""
    from yoho_tpu_torch.nn.layers import GroupedQueryAttention, MLP, MultiHeadAttention, SwiGLU
    from yoho_tpu_torch.nn.moe import MoESwiGLU
    from yoho_tpu_torch.nn import params as nn_params

    done = getattr(model, "tp_mesh", None)
    if done is not None:
        if done is mesh:
            return model
        raise ValueError(f"the model is already sharded over {done}")
    model.tp_mesh = mesh
    model.tp_specs = {}
    if AXIS_MODEL not in mesh.shape:
        return model
    m, r = mesh.shape[AXIS_MODEL], mesh.index(AXIS_MODEL)
    specs = model_specs(model, mesh, rules)
    cut = []
    with torch.no_grad():
        for name, mod in list(model.named_modules()):
            pre = "/".join(nn_params._jax_module_path(name))
            if isinstance(mod, (MultiHeadAttention, GroupedQueryAttention)):
                heads = ((mod.n_head,) if isinstance(mod, MultiHeadAttention)
                         else (mod.q_heads, mod.kv_heads))
                if any(h % m for h in heads) or not _sharded(
                        specs, *(f"{pre}/{p}/kernel" for p in
                                 ("q_proj", "k_proj", "v_proj", "out_proj"))):
                    continue
                for p in ("q_proj", "k_proj", "v_proj"):
                    _column(getattr(mod, p), m, r)
                _row(mod.out_proj, m, r)
                if isinstance(mod, MultiHeadAttention):
                    mod.n_head //= m
                else:
                    mod.q_heads //= m
                    mod.kv_heads //= m
                mod.tp = mesh
            elif isinstance(mod, (MLP, SwiGLU)):
                up, down = (("fc1",), "fc2") if isinstance(mod, MLP) else (("gate", "up"), "down")
                if not _sharded(specs, *(f"{pre}/{p}/kernel" for p in up + (down,))):
                    continue
                for p in up:
                    _column(getattr(mod, p), m, r)
                _row(getattr(mod, down), m, r)
                mod.tp = mesh
            elif isinstance(mod, MoESwiGLU):
                names = ("gate", "up", "down")
                if not _sharded(specs, *(f"{pre}/experts/{p}/kernel" for p in names)):
                    continue
                k = mod.n_experts // m
                for p in names:
                    dense = getattr(mod.experts, p)
                    _set(dense, "kernel", dense.kernel.data[r * k:(r + 1) * k])
                mod.expert_offset, mod.local_experts = r * k, k
                mod.tp = mesh
            elif isinstance(mod, nn.Embedding) and name.endswith("token_embedding"):
                if not _sharded(specs, f"{pre}/embedding"):
                    continue
                k = mod.num_embeddings // m
                _set(mod, "weight", mod.weight.data[r * k:(r + 1) * k])
                mod.num_embeddings, mod.vocab_start = k, r * k
                mod.tp = mesh
            else:
                continue
            cut.append(pre + "/")
    model.tp_specs = {path: spec for path, spec in specs.items()
                      if AXIS_MODEL in spec and any(path.startswith(c) for c in cut)}
    return model


def layout_of(model: nn.Module) -> dict:
    """'/'-joined JAX path -> the spec of each leaf a mesh cuts in
    ``model`` (:func:`shard_params`); leaves not listed are whole."""
    return dict(getattr(model, "tp_specs", None) or {})


def global_shape(shape, spec, mesh) -> tuple:
    """A local slice's shape -> the whole leaf's."""
    spec = tuple(spec or ())
    return tuple(n * (mesh.shape[spec[i]] if i < len(spec) and spec[i] in mesh.shape else 1)
                 for i, n in enumerate(shape))


def local_slice(x, spec, mesh):
    """This rank's slice of a whole leaf (array or tensor) under ``spec``."""
    for dim, axis in enumerate(tuple(spec or ())):
        if axis is not None and axis in mesh.shape:
            k = x.shape[dim] // mesh.shape[axis]
            i = mesh.index(axis)
            x = x[(slice(None),) * dim + (slice(i * k, (i + 1) * k),)]
    return x

