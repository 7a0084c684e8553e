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

Training (:func:`make_pipeline_train_step`) writes the backward as an
explicit reverse schedule instead of differentiating through the point to
point transfers (whose order in autograd's backward is not controlled and
can deadlock): the forward keeps every microbatch's stage input and
output; the last stage's outputs are broadcast, and every stage runs the
decoder and the loss whole; then M + P - 1 reverse ticks, stage i taking
microbatch m at tick (M - 1 - m) + (P - 1 - i): it receives dOut from the
next stage (the last stage takes its own decoder's gradient of the
broadcast output, once), runs ``torch.autograd.backward`` on the saved
output (with the MoE auxiliary term of its blocks), and sends dIn to the
previous stage; stage 0 carries its dIn into the stem. So the stem's and a
block's gradients live on their stage only (summed over ``pipe`` and
``data``) and the decoder's on every stage (summed over ``data``).
"""

from __future__ import annotations

from typing import Dict

import torch

from yoho_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    all_gather,
    all_reduce,
    broadcast,
    data_shard,
    exchange,
)

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


def _stage(blocks, h: torch.Tensor, remat: bool):
    """This stage's blocks on ``h`` -> (output, the mean MoE auxiliary loss
    of its blocks or None for dense blocks)."""
    from yoho_tpu_torch.nn.moe import MoESwiGLU
    from yoho_tpu_torch.nn.yoho import _run

    for blk in blocks:
        h = _run(blk, remat, h)
    aux = [blk.mlp.last_aux_loss.float() for blk in blocks if isinstance(blk.mlp, MoESwiGLU)]
    return h, (torch.stack(aux).mean() if aux else None)


def _pipelined_loss(model, mesh, mel, tokens, loss_mask, n_micro: int, axis_name: str,
                    backward: bool):
    """The GPipe forward of this rank's rows, the decoder and the loss; with
    ``backward`` the reverse schedule too (see the module doc), leaving the
    gradients in the parameters' ``.grad``. Returns this rank's loss
    share."""
    from yoho_tpu_torch.train.trainer import masked_ce_loss

    cfg = model.cfg
    if axis_name not in mesh.shape or mesh.shape.get(AXIS_MODEL, 1) > 1:
        raise ValueError(f"the pipelined step takes a (data, {axis_name}) mesh, not a model "
                         f"axis: got {mesh}")
    n_stages, i = mesh.shape[axis_name], mesh.index(axis_name)
    _check_stages(cfg, n_stages)
    enc = model.encoder
    mel = mel.to(model.device)
    b = mel.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} microbatches")
    per = cfg.n_audio_blocks // n_stages
    blocks = list(enc.blocks)[i * per:(i + 1) * per]
    with torch.set_grad_enabled(backward and i == 0):
        stem = enc.stem(mel)  # only stage 0 feeds it on; the rest need its shape
    x_in = stem.detach().requires_grad_(backward and i == 0)
    micro = x_in.reshape(n_micro, b // n_micro, *x_in.shape[1:])
    saved, outs = {}, {}
    for t in range(n_micro + n_stages - 1):
        m = t - i  # this stage's microbatch at tick t
        if not 0 <= m < n_micro:
            continue
        if i == 0:
            h = micro[m]
        else:
            h = torch.empty(micro.shape[1:], dtype=micro.dtype, device=micro.device)
            exchange(mesh, axis_name, recvs=[(h, i - 1)])
            h.requires_grad_(backward)
        out, aux = _stage(blocks, h, enc.remat)
        if i < n_stages - 1:
            exchange(mesh, axis_name, sends=[(out.detach(), i + 1)])
        else:
            outs[m] = out
        saved[m] = (h, out, aux)
    last = n_stages - 1
    enc_out = (torch.stack([outs[m] for m in range(n_micro)]).reshape(stem.shape)
               if i == last else torch.empty_like(stem))
    xa = broadcast(enc_out.detach().contiguous(), mesh, axis_name, last).requires_grad_(backward)
    loss = masked_ce_loss(model.decode_text(tokens, xa), tokens, loss_mask, mesh)
    coef = 0.0
    if cfg.n_experts > 0:
        # JAX's mean over (stage, microbatch, data shard) of each stage's
        # mean block auxiliary loss; this stage's terms keep their graph.
        coef = cfg.moe_aux_weight / (n_stages * n_micro * data_shard(mesh)[1])
        local = torch.stack([a for _h, _o, a in saved.values()]).sum()
        total = all_reduce(local.detach().reshape(1).clone(), mesh, axis_name)[0]
        loss = loss + coef * total
    if not backward:
        return loss
    loss.backward()  # the decoder's gradients, and the broadcast output's
    dxa = xa.grad.reshape(micro.shape) if i == last else None
    for t in range(n_micro + n_stages - 1):
        m = n_micro - 1 - (t - (last - i))
        if not 0 <= m < n_micro:
            continue
        h, out, aux = saved.pop(m)
        if i == last:
            d_out = dxa[m]
        else:
            d_out = torch.empty(out.shape, dtype=out.dtype, device=out.device)
            exchange(mesh, axis_name, recvs=[(d_out, i + 1)])
        tensors, grads = [out], [d_out]
        if aux is not None:
            tensors.append(aux)
            grads.append(torch.full_like(aux, coef))
        torch.autograd.backward(tensors, grads)
        if i > 0:
            exchange(mesh, axis_name, sends=[(h.grad, i - 1)])
    if i == 0:
        torch.autograd.backward(stem, x_in.grad)
    return loss.detach()


def make_pipeline_loss_fn(model, mesh, n_microbatches: int = 2,
                          axis_name: str = AXIS_PIPE):
    """``loss_fn(mel, tokens, loss_mask) -> scalar``: this rank's rows in,
    its share of the loss out (masked CE plus the MoE auxiliary term), the
    encoder block stack pipelined over ``axis_name``. An evaluation: its
    gradient comes from :func:`make_pipeline_train_step`'s reverse
    schedule, not from autograd through the transfers."""
    def loss_fn(mel, tokens, loss_mask):
        with torch.no_grad():
            return _pipelined_loss(model, mesh, mel, tokens, loss_mask, n_microbatches,
                                   axis_name, backward=False)

    return loss_fn


def make_pipeline_train_step(model, mesh, n_microbatches: int = 2,
                             axis_name: str = AXIS_PIPE, optimizer=None):
    """The training step with the encoder pipelined (GPipe; the JAX
    package's ``make_pipeline_train_step``): ``step(mel, tokens, loss_mask)
    -> (loss, grads)`` on the global batch (``long_encoder.train_step``),
    the single-device step's loss and gradients. Each ``data`` rank's rows
    split into ``n_microbatches``; the blocks into the stages."""
    from yoho_tpu_torch.parallel.long_encoder import encoder_axes, train_step, trained_parameters

    def value_and_grad(mel, tokens, loss_mask):
        named = trained_parameters(model)
        for t in named.values():
            t.grad = None
        loss = _pipelined_loss(model, mesh, mel, tokens, loss_mask, n_microbatches,
                               axis_name, backward=True)
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for k, t in named.items()}
        for t in named.values():
            t.grad = None
        return loss, grads

    return train_step(model, mesh, value_and_grad, encoder_axes(axis_name), optimizer)

