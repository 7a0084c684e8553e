"""Sequence-parallel long-audio encoding for the YOHO (RoPE) encoder.

The JAX package's ``parallel/long_encoder.py``: audio longer than the
trained window is encoded in one pass with the time axis of the block
stack sharded over a mesh axis (``seq``). The conv stem runs unsharded
(linear in length); every rank takes its slice of the stem's output,
runs the blocks with :func:`ring_attention` in place of the flash kernel
and its global frame offset ``rank * s_local`` as the RoPE base, and the
slices are gathered over the axis. The same checkpoint serves both
constructions, and the result is the function a single-device encode of
the whole sequence computes.

The training half (``make_long_context_train_step``: the ring's backward
is the reverse permutation) is ROADMAP.md Queue 1 item 11, part B.
"""

from __future__ import annotations

import torch

from yoho_tpu_torch.parallel.mesh import all_gather
from yoho_tpu_torch.parallel.ring_attention import ring_attention


def _reject_moe(cfg) -> None:
    # Routing per time shard would change capacity drops (and lose the
    # aux losses): the JAX package refuses, and so does the port.
    if getattr(cfg, "n_experts", 0) > 0:
        raise ValueError(
            "sequence-parallel (ring) encoding does not support MoE "
            f"configs (n_experts={cfg.n_experts}): routing is per time "
            "shard, which changes capacity drops and loses aux losses")


def _ring_block(blk, x: torch.Tensor, pos: int, mesh, axis_name: str) -> torch.Tensor:
    """One encoder block on this rank's slice: its q/k rotated from the
    global offset ``pos``, attention over the whole sequence by the
    ring (pre-scaled q, unexpanded K/V)."""
    from yoho_tpu_torch.nn.layers import _bhsd, model_sum

    a = blk.attn
    h = blk.ln1(x)
    b, s = h.shape[:2]
    q = _bhsd(a._rope(a.q_proj(h), s, pos)) * a.head_dim ** -0.5
    k = _bhsd(a._rope(a.k_proj(h), s, pos)).to(q.dtype)
    v = _bhsd(a.v_proj(h)).to(q.dtype)
    out = ring_attention(q, k, v, mesh, axis_name, scale=1.0)
    x = x + model_sum(a, a.out_proj(out.transpose(1, 2).reshape(b, s, -1)))
    return x + blk.mlp(blk.ln2(x))


@torch.inference_mode()
def yoho_encode_long(model, mel: torch.Tensor, mesh, axis_name: str = "seq") -> torch.Tensor:
    """Encode (B, S_frames, n_mels) with the block stack's time axis
    sharded over ``axis_name`` of ``mesh``; S_frames may exceed the
    trained window. Returns (B, S_frames // 2, dims) on every rank. The
    post-stem length must divide by the axis size."""
    _reject_moe(model.cfg)
    n, i = mesh.shape[axis_name], mesh.index(axis_name)
    enc = model.encoder
    x = enc.stem(mel.to(model.device))
    s2 = x.shape[1]
    if s2 % n:
        raise ValueError(
            f"post-stem length {s2} must divide by the {axis_name} axis ({n}); "
            f"pad the audio to a multiple of {2 * n} frames")
    s_local = s2 // n
    x = x[:, i * s_local:(i + 1) * s_local]
    for blk in enc.blocks:
        x = _ring_block(blk, x, i * s_local, mesh, axis_name)
    return all_gather(x, mesh, axis_name, dim=1)


def make_long_context_loss_fn(model, mesh, axis_name: str = "seq"):
    from yoho_tpu_torch.infer.pipeline import _not_ported

    _not_ported("the long-context (ring attention) loss", 11)


def make_long_context_train_step(model, mesh, axis_name: str = "seq"):
    from yoho_tpu_torch.infer.pipeline import _not_ported

    _not_ported("the long-context (ring attention) train step", 11)
