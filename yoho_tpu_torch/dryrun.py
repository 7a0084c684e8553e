"""The multi-device dry run: every mesh program of the port, once, at tiny
shapes (the training part of the JAX package's ``__graft_entry__.py::
dryrun_multichip``, and its serving part as far as the port serves over a
mesh).

:func:`dryrun_multichip` runs in the process group of the caller's ranks
(``torchrun --nproc-per-node N``, or a group of one started here without a
launcher), every rank calling it:

* one full training step on a (data, model) mesh (model 2 when the world
  is even): log-mel through the mel kernel, the tensor-parallel forward,
  the trainers' loss (``train/trainer.py::asr_objective``), gradients,
  the gradient reduction and a ``MultiSteps`` AdamW update; its loss and
  the loss after the update equal to the unsharded step's within 1e-5;
* the long-context step with the ring encoder over ``seq`` = every rank;
* the pipelined (GPipe) step on (data, pipe);
* an expert-parallel MoE step on the (data, model) mesh, held to the
  unsharded step in the same way;
* serving: a whisper ``Transcriber`` over the (data, model) mesh, greedy
  and beam 2, token-equal to the unsharded one; then a ``ContinuousBatcher``
  over the sharded transcriber (``chunk_tokens=4``) and the speculative
  slot engine (the JAX dry run's 16-wide draft on 2 heads, gamma 2), both
  over the mesh:
  rank 0 submits, the other ranks follow its schedule, and each gives
  the unsharded greedy tokens.

The long-context and pipelined steps assert a finite loss; the serving
part asserts equal tokens.

    torchrun --nproc-per-node 4 -m yoho_tpu_torch.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def _cfg(**kw):
    from yoho_tpu_torch.core.config import YOHOConfig

    base = dict(n_mel_bands=16, max_audio_len=64, max_text_len=16, dims=64,
                n_audio_heads=4, n_audio_blocks=2, n_text_heads=4, n_text_blocks=2)
    return YOHOConfig(**{**base, **kw})


def _yoho(cfg_kw: dict, vocab: int, device, seed: int):
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.yoho import YOHOModel

    return init_random(YOHOModel(_cfg(**cfg_kw), vocab, voiceprint_dim=32, device=device),
                       seed=seed)


def _finite(name: str, loss) -> float:
    value = float(loss)
    assert math.isfinite(value), f"non-finite {name} loss {value} in the multichip dryrun"
    return value


def _train_once(model, mesh, audio, tokens, mask, accumulated: int) -> tuple:
    """One train step over ``mesh`` (None: unsharded, the whole batch):
    ``accumulated`` mini-steps of this rank's rows through the mel kernel
    and the (sharded) model, the loss share, its gradients and MultiSteps
    AdamW with the gradient reduction over ``data`` (one applied update).
    Returns the mini-steps' mean global loss and the global loss after the
    update."""
    from yoho_tpu_torch.nn import params as nn_params
    from yoho_tpu_torch.ops.mel_kernel import fused_yoho_log_mel
    from yoho_tpu_torch.parallel.mesh import AXIS_DATA, data_sum, reduce_gradients, shard_batch
    from yoho_tpu_torch.parallel.sharding import YOHO_RULES, shard_params
    from yoho_tpu_torch.train.optim import AdamW, MultiSteps, apply_updates
    from yoho_tpu_torch.train.trainer import asr_objective

    if mesh is not None:
        shard_params(model, mesh, YOHO_RULES)
        audio, tokens, mask = shard_batch(mesh, (audio, tokens, mask))
    named = {k: (t, v) for k, (t, v) in nn_params.jax_parameters(model).items()
             if isinstance(t, torch.nn.Parameter)}
    leaves = {k: v(t) for k, (t, v) in named.items()}
    opt = MultiSteps(AdamW(lambda _count: 1e-3), accumulated,
                     reduce=None if mesh is None else
                     lambda g: reduce_gradients(g, mesh, (AXIS_DATA,)))
    state = opt.init(leaves)

    def loss_share():
        with torch.no_grad():
            mel = fused_yoho_log_mel(audio, model.cfg)
        return asr_objective(model(tokens, mel), tokens, mask, model, model.cfg, mesh)

    total = 0.0
    for _ in range(accumulated):
        loss = loss_share()
        grads = torch.autograd.grad(loss, [t for t, _ in named.values()],
                                    allow_unused=True, materialize_grads=True)
        updates = opt.update({k: v(g) for (k, (_t, v)), g in zip(named.items(), grads)},
                             state, leaves)
        if updates is not None:
            apply_updates(leaves, updates)
        total += float(data_sum(loss.detach(), mesh))
    assert state["gradient_step"] == 1
    with torch.no_grad():
        after = float(data_sum(loss_share(), mesh))
    return total / accumulated, after


def _mesh_step(name: str, cfg_kw: dict, vocab: int, dev, seed: int, mesh,
               audio, tokens, mask, accumulated: int = 2) -> float:
    """:func:`_train_once` over ``mesh`` against the unsharded step of the
    same model (the same seed) on the same global batch: the mean loss and
    the loss after the update within 1e-5 (f32). Returns the mean loss."""
    got = _train_once(_yoho(cfg_kw, vocab, dev, seed), mesh, audio, tokens, mask, accumulated)
    want = _train_once(_yoho(cfg_kw, vocab, dev, seed), None, audio, tokens, mask,
                       accumulated)
    _finite(name, got[0])
    assert all(abs(g - w) <= 1e-5 for g, w in zip(got, want)), (
        f"{name} step over the mesh: losses (mean, after the update) {got}, unsharded "
        f"{want}, in the multichip dryrun")
    return got[0]


def dryrun_multichip(world: int, device=None) -> dict:
    """Run every mesh program of the port once over the ``world`` ranks of
    the group (see the module doc); ``device``: CUDA (NCCL) unless
    ``"cpu"`` (gloo). Returns the losses by program (the same on every
    rank)."""
    from yoho_tpu_torch.parallel.mesh import init_distributed, init_mesh, make_mesh, world_size
    from yoho_tpu_torch.parallel.long_encoder import make_long_context_train_step
    from yoho_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from yoho_tpu_torch.train.optim import AdamW

    dev = init_distributed(device)
    if world_size() != world:
        raise ValueError(f"dryrun_multichip({world}) in a group of {world_size()} ranks")
    model_axis = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world // model_axis, model_axis, device=dev)
    vocab = 256 + 64  # divides the model axis: the vocabulary is sharded too
    g = np.random.default_rng(0)
    batch = max(2, world)
    n_samples = _cfg().n_samples
    audio = torch.from_numpy(g.standard_normal((batch, n_samples)).astype(np.float32) * 0.1)
    tokens = torch.from_numpy(g.integers(0, vocab, size=(batch, 16))).long()
    mask = torch.ones((batch, 16), dtype=torch.uint8)
    audio, tokens, mask = (t.to(dev) for t in (audio, tokens, mask))
    losses = {"mesh": _mesh_step("mesh", {}, vocab, dev, 0, mesh, audio, tokens, mask)}

    # Long context: ring attention over every rank, clips of 2 windows.
    seq = init_mesh({"seq": world}, dev)
    long_model = _yoho({}, vocab, dev, 0)
    long_mel = torch.from_numpy(g.standard_normal((1, 128, 16)).astype(np.float32)).to(dev)
    step = make_long_context_train_step(long_model, seq, optimizer=AdamW(lambda _c: 1e-3))
    losses["long_context"] = _finite("long-context", step(long_mel, tokens[:1], mask[:1])[0])

    # GPipe on (data, pipe): two blocks a stage, two microbatches a data rank.
    pipe = model_axis
    pp = init_mesh({"data": world // pipe, "pipe": pipe}, dev)
    pp_model = _yoho({"n_audio_blocks": 2 * pipe}, vocab, dev, 1)
    rows = 2 * (world // pipe)
    pp_mel = torch.from_numpy(g.standard_normal((rows, 64, 16)).astype(np.float32)).to(dev)
    step = make_pipeline_train_step(pp_model, pp, 2, optimizer=AdamW(lambda _c: 1e-3))
    losses["pipeline"] = _finite("pipeline", step(pp_mel, tokens[:1].repeat(rows, 1),
                                                  torch.ones_like(tokens[:1]).repeat(rows, 1))[0])

    # Expert parallelism: the stacked experts split over ``model``.
    moe = dict(n_experts=2 * model_axis, moe_every_n=2, moe_in_decoder=True)
    losses["moe"] = _mesh_step("MoE", moe, vocab, dev, 2, mesh, audio, tokens, mask)

    _serving(mesh, dev, world, model_axis)
    return losses


def _slots_over_mesh(transcriber, wav, chunk_tokens: int = 4):
    """One request through a ``ContinuousBatcher`` over the transcriber's
    mesh: rank 0 submits and gets the result, the other ranks follow
    (None)."""
    from yoho_tpu_torch.infer.continuous import ContinuousBatcher
    from yoho_tpu_torch.parallel.mesh import is_coordinator

    batcher = ContinuousBatcher(transcriber, max_batch=transcriber.batch_size,
                                chunk_tokens=chunk_tokens)
    if not is_coordinator():
        batcher.join()
        return None
    try:
        return batcher.submit(wav)
    finally:
        batcher.close()


def _serving(mesh, dev, world: int, model_axis: int) -> None:
    """Greedy and beam-2 whisper decodes over the mesh, token-equal to the
    unsharded Transcriber's; the slot engine, greedy and speculative, over
    the mesh to the same greedy tokens."""
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    class _IdBackend:
        def decode(self, ids):
            return "".join(f"<{int(i)}>" for i in ids)

        def encode(self, text, add_special_tokens=False):
            return []

    # JAX's dryrun model: 32 wide on 4 heads (head dim 8, padded to the
    # kernels' width 16; int8 cross K/V and cache).
    wcfg = WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=4,
                         n_audio_layer=1, n_vocab=51865, n_text_ctx=24, n_text_state=32,
                         n_text_head=4, n_text_layer=1, chunk_seconds=0.32)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdBackend())
    wav = (0.1 * np.random.default_rng(1).standard_normal(wcfg.n_samples * 2)).astype(np.float32)
    wb = max(2, world // model_axis)
    kw = dict(family="whisper", token_table=table, batch_size=wb, quantized_cross_kv="int8",
              quantized_cache=True, device=dev)
    def tokens(result):
        return [s.tokens for s in result.segments]

    greedy = None
    for beams in (0, 2):
        models = [init_random(Whisper(wcfg, device=dev), seed=3) for _ in range(2)]
        want = Transcriber(models[0], beams=beams, **kw).transcribe(wav)
        sharded = Transcriber(models[1], beams=beams, mesh=mesh, **kw)
        got = sharded.transcribe(wav)
        assert want.segments, "serving dryrun produced no segments"
        assert tokens(want) == tokens(got), (
            f"sharded beams={beams} decode diverged from the unsharded tokens")
        if not beams:
            greedy = tokens(want)
            got_cb = _slots_over_mesh(sharded, wav)
            assert got_cb is None or tokens(got_cb) == greedy, (
                "continuous-batching admit+chunk over the mesh diverged from the "
                "unsharded tokens")

    # The speculative slot engine on the mesh: a smaller draft proposes,
    # the sharded target verifies, each slot commits its own accepted
    # length, and the committed stream is still the greedy tokens.
    dcfg = WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=16, n_audio_head=2,
                         n_audio_layer=1, n_vocab=51865, n_text_ctx=24, n_text_state=16,
                         n_text_head=2, n_text_layer=1, chunk_seconds=0.32)
    spec = Transcriber(init_random(Whisper(wcfg, device=dev), seed=3), mesh=mesh,
                       draft_model=init_random(Whisper(dcfg, device=dev), seed=4),
                       speculative_gamma=2, **kw)
    got_spec = _slots_over_mesh(spec, wav)
    assert got_spec is None or tokens(got_spec) == greedy, (
        "the speculative slot engine over the mesh diverged from the greedy tokens")


def main(argv=None) -> int:
    from yoho_tpu_torch.parallel.mesh import init_distributed, is_coordinator, world_size

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu: gloo on the CPU (default: CUDA)")
    args = parser.parse_args(argv)
    init_distributed(args.device)
    losses = dryrun_multichip(world_size(), args.device)
    if is_coordinator():
        print("dryrun_multichip ok", losses)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
