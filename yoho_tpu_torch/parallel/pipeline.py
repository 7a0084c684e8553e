"""Pipeline parallelism (GPipe) for the YOHO encoder block stack.

The JAX package's ``parallel/pipeline.py``: the homogeneous encoder block
stack splits into P stages over a ``pipe`` mesh axis, stage i holding
blocks ``i * L / P`` to ``(i + 1) * L / P - 1``, and M microbatches stream
through the stages: M + P - 1 ticks, stage i working on microbatch t - i
at tick t, activations sent to the next stage's rank (point to point),
the last stage's outputs broadcast to every stage at the end. Every
microbatch passes through every block in order, so the result is the
sequential stack's. A ``data`` axis in front splits each microbatch's
rows over it (DP x PP), and the rows are gathered at the end.

The train-step halves (``make_pipeline_train_step``,
``make_pipeline_loss_fn``) are ROADMAP.md Queue 1 item 11, part B.
"""

from __future__ import annotations

from typing import Dict

import torch

from yoho_tpu_torch.parallel.mesh import AXIS_DATA, all_gather, broadcast, exchange

AXIS_PIPE = "pipe"


def stack_block_params(encoder_params: dict, n_blocks: int) -> dict:
    """Stack the per-block subtrees ``blocks_0..blocks_{n-1}`` of a flax
    encoder tree into one tree whose leaves lead with the block axis."""
    per_block = [encoder_params[f"blocks_{i}"] for i in range(n_blocks)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([nd[k] for nd in nodes]) for k in nodes[0]}
        if isinstance(nodes[0], torch.Tensor):
            return torch.stack(nodes)
        import numpy as np

        return np.stack(nodes)

    return stack(per_block)


def unstack_block_params(stacked: dict, n_blocks: int) -> dict:
    """Inverse of :func:`stack_block_params`."""

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    return {f"blocks_{i}": take(stacked, i) for i in range(n_blocks)}


def _check_homogeneous(cfg) -> None:
    # One stacked tree per stage needs one block structure: all dense, or
    # all MoE (moe_every_n == 1).
    if getattr(cfg, "n_experts", 0) > 0 and cfg.moe_every_n != 1:
        raise ValueError(
            "pipeline parallelism requires a homogeneous block stack: "
            f"n_experts={cfg.n_experts} with moe_every_n={cfg.moe_every_n} "
            "mixes dense and MoE blocks (set moe_every_n=1 or n_experts=0)")


def _check_stages(cfg, n_stages: int) -> None:
    _check_homogeneous(cfg)
    if cfg.n_audio_blocks % n_stages:
        raise ValueError(
            f"{cfg.n_audio_blocks} encoder blocks do not divide into "
            f"{n_stages} pipeline stages")


@torch.inference_mode()
def pipeline_encode(model, mel: torch.Tensor, mesh, n_microbatches: int = 2,
                    axis_name: str = AXIS_PIPE) -> torch.Tensor:
    """Encode ``mel`` (B, S_frames, n_mels) with the block stack pipelined
    over ``axis_name`` of ``mesh``; returns (B, S_frames // 2, dims) on
    every rank, the function of ``model.encode_audio``. The batch must
    divide into ``n_microbatches`` (and each microbatch over ``data`` when
    the mesh has that axis), the blocks into the stages."""
    cfg = model.cfg
    n_stages, i = mesh.shape[axis_name], mesh.index(axis_name)
    _check_stages(cfg, n_stages)
    enc = model.encoder
    x = enc.stem(mel.to(model.device))
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not divide into {n_microbatches} microbatches")
    x = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    d = mesh.shape.get(AXIS_DATA, 1)
    if x.shape[1] % d:
        raise ValueError(f"microbatch of {x.shape[1]} rows does not divide over the "
                         f"{AXIS_DATA} axis of {d}")
    rows = x.shape[1] // d
    x = x[:, mesh.index(AXIS_DATA) * rows:(mesh.index(AXIS_DATA) + 1) * rows]
    per = cfg.n_audio_blocks // n_stages
    blocks = list(enc.blocks)[i * per:(i + 1) * per]

    outs: Dict[int, torch.Tensor] = {}
    for t in range(n_microbatches + n_stages - 1):
        m = t - i  # this stage's microbatch at tick t
        if not 0 <= m < n_microbatches:
            continue
        if i == 0:
            h = x[m]
        else:
            h = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
            exchange(mesh, axis_name, recvs=[(h, i - 1)])
        for blk in blocks:
            h = blk(h)
        if i < n_stages - 1:
            exchange(mesh, axis_name, sends=[(h, i + 1)])
        else:
            outs[m] = h
    out = (torch.stack([outs[m] for m in range(n_microbatches)]) if outs
           else torch.empty(x.shape, dtype=x.dtype, device=x.device))
    out = broadcast(out.contiguous(), mesh, axis_name, n_stages - 1)
    if AXIS_DATA in mesh.shape:
        out = all_gather(out, mesh, AXIS_DATA, dim=1)
    return out.reshape(b, *out.shape[2:])


def make_pipeline_loss_fn(model, mesh, n_microbatches: int = 2,
                          axis_name: str = AXIS_PIPE):
    from yoho_tpu_torch.infer.pipeline import _not_ported

    _not_ported("the pipelined (GPipe) loss", 11)


def make_pipeline_train_step(model, mesh, n_microbatches: int = 2,
                             axis_name: str = AXIS_PIPE):
    from yoho_tpu_torch.infer.pipeline import _not_ported

    _not_ported("the pipelined (GPipe) train step", 11)

