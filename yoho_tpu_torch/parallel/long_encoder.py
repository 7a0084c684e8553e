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

Training (:func:`make_long_context_loss_fn`,
:func:`make_long_context_train_step`): the stem runs whole on every
``seq`` rank, the blocks on this rank's slice (the ring's pass is
differentiable, ``mesh.ring_shift``), the slices are gathered (the
backward keeps this rank's slice of the replicated loss's gradient), and
the decoder and the loss run whole on every rank. A ``data`` axis in front
splits the batch rows (DP x SP). So the encoder's gradients are this
rank's part (summed over ``seq`` and ``data``) and the decoder's whole on
every ``seq`` rank (summed over ``data``): the gradients of the
single-device step, as JAX's shard_map transpose gives them. ``remat``
checkpoints each ring block (its recompute runs the ring again).
"""

from __future__ import annotations

import torch

from yoho_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    all_gather,
    data_sum,
    gather_over,
    reduce_gradients,
    shard_batch,
)
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
    """``loss_fn(mel, tokens, loss_mask) -> scalar`` with the encoder's
    attention sequence-parallel over ``axis_name``: this rank's rows of the
    batch in, this rank's share of the masked CE out (the global batch's
    mask count divides; the ranks of ``seq`` hold the same value).
    Differentiable; see the module doc for how its gradients sum."""
    from yoho_tpu_torch.nn.yoho import _run
    from yoho_tpu_torch.train.trainer import masked_ce_loss

    _reject_moe(model.cfg)
    n, i = mesh.shape[axis_name], mesh.index(axis_name)
    enc = model.encoder

    def loss_fn(mel, tokens, loss_mask):
        x = enc.stem(mel.to(model.device))
        s2 = x.shape[1]
        if s2 % n:
            raise ValueError(
                f"post-stem length {s2} must divide by the {axis_name} axis ({n}); "
                f"pad the audio to a multiple of {2 * n} frames")
        s_local = s2 // n
        x = x[:, i * s_local:(i + 1) * s_local]
        for blk in enc.blocks:
            x = _run(lambda h, b=blk: _ring_block(b, h, i * s_local, mesh, axis_name),
                     model.encoder.remat, x)
        xa = gather_over(x, mesh, axis_name, dim=1)
        return masked_ce_loss(model.decode_text(tokens, xa), tokens, loss_mask, mesh)

    return loss_fn


def encoder_axes(axis_name: str):
    """The axes a parameter's gradient sums over in a step whose encoder is
    split over ``axis_name`` and whose decoder runs whole on its ranks."""
    return lambda path: ((AXIS_DATA, axis_name) if path.startswith("encoder/")
                         else (AXIS_DATA,))


def trained_parameters(model) -> dict:
    """JAX path -> every parameter of ``model`` that takes a gradient."""
    from yoho_tpu_torch.nn import params as nn_params

    return {k: t for k, (t, _view) in nn_params.jax_parameters(model).items()
            if isinstance(t, torch.nn.Parameter) and t.requires_grad}


def train_step(model, mesh, loss_fn, axes, optimizer=None):
    """The step both parallel train steps share: ``step(mel, tokens,
    loss_mask) -> (loss, grads)`` on the GLOBAL batch (every rank passes
    the same arrays; each takes its ``data`` rows): the global loss and the
    gradient of every trained parameter by its JAX path in the JAX layout,
    summed over ``axes`` (the single-device step's gradient on every
    rank). With ``optimizer`` (``train/optim.py``; its state in
    ``step.opt_state``) the update is applied to ``model`` in place.
    ``loss_fn(mel, tokens, mask)`` returns (this rank's loss share,
    gradients by path)."""
    from yoho_tpu_torch.nn import params as nn_params
    from yoho_tpu_torch.train.optim import apply_updates

    named = {k: (t, view) for k, (t, view) in nn_params.jax_parameters(model).items()
             if isinstance(t, torch.nn.Parameter) and t.requires_grad}
    leaves = {k: view(t) for k, (t, view) in named.items()}

    def step(mel, tokens, loss_mask):
        mel, tokens, loss_mask = shard_batch(mesh, (mel, tokens, loss_mask))
        loss, grads = loss_fn(mel, tokens, loss_mask)
        grads = {k: named[k][1](g) for k, g in grads.items()}
        reduce_gradients(grads, mesh, axes)
        if optimizer is not None:
            updates = optimizer.update(grads, step.opt_state, leaves)
            if updates is not None:
                apply_updates(leaves, updates)
        return data_sum(loss.detach(), mesh), grads

    step.opt_state = optimizer.init(leaves) if optimizer is not None else None
    return step


def make_long_context_train_step(model, mesh, axis_name: str = "seq", optimizer=None):
    """The training step for clips longer than one device attends alone
    (the JAX package's ``make_long_context_train_step``): ``step(mel,
    tokens, loss_mask) -> (loss, grads)`` on the global batch, as
    :func:`train_step` describes; ``mel``'s post-stem length must divide by
    the ``axis_name`` size. The gradients equal the single-device step's."""
    loss_fn = make_long_context_loss_fn(model, mesh, axis_name)

    def value_and_grad(mel, tokens, loss_mask):
        loss = loss_fn(mel, tokens, loss_mask)
        named = trained_parameters(model)
        got = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                  materialize_grads=True)
        return loss, dict(zip(named, got))

    return train_step(model, mesh, value_and_grad, encoder_axes(axis_name), optimizer)
