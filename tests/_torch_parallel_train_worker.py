"""One rank of ``tests/test_torch_parallel_train.py``'s process group.

Started four times (gloo, ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT`` in the environment) with a case directory: reads
``inputs.pkl`` (paths, batches and noise the test wrote), runs every
training scenario of the port over the group, and writes ``out<rank>.pkl``
(each scenario's results, or its traceback). Gradients and parameters are
reported whole (gathered over the mesh) by every rank. Imports torch and
the port only, never JAX.
"""

import contextlib
import io
import os
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)

from yoho_tpu_torch.core.config import WhisperConfig, load_session_config  # noqa: E402
from yoho_tpu_torch.nn.params import init_random, jax_parameters  # noqa: E402
from yoho_tpu_torch.parallel import mesh as pm  # noqa: E402
from yoho_tpu_torch.parallel.sharding import layout_of  # noqa: E402

CPU = "cpu"
RANK = int(os.environ["RANK"])


class WordBackend:
    """tests/test_torch_finetune.py's text backend (words at ids 100+)."""

    def __init__(self, words):
        self.word_ids = {w: 100 + i for i, w in enumerate(words)}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)


def _np(t):
    return t.detach().to("cpu", torch.float32 if t.is_floating_point() else t.dtype,
                         copy=True).numpy()


def _errors(fn, *cases):
    out = []
    for case in cases:
        try:
            fn(*case)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the test reads the type
            out.append((type(e).__name__, str(e)))
    return out


def _full(trainer, grads):
    """Reduced per-leaf gradients (JAX layout) gathered whole."""
    pm.reduce_gradients(grads, trainer.mesh, trainer._grad_axes)
    return pm.fetch_to_host(trainer.mesh, grads, trainer._specs)


def _step(trainer, batch):
    """The global loss and the whole gradients of one mini-step on this
    rank's rows of ``batch`` (the global batch)."""
    local = pm.shard_batch(trainer.mesh, tuple(batch))
    loss = trainer._batch_loss(*trainer._place(local))
    grads = trainer.gradients(loss)
    grads = {k: view(g) for (k, (_t, view)), g in zip(trainer._train.items(), grads)}
    return float(pm.data_sum(loss.detach(), trainer.mesh)), _full(trainer, grads)


def _record(trainer):
    """Keep every mini-step's local batch (host copies) in ``trainer.seen``."""
    trainer.seen = []
    inner = trainer._train_step

    def step(*batch):
        trainer.seen.append([_np(x) for x in batch])
        return inner(*batch)

    trainer._train_step = step


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kw)


# ------------------------------------------------------------------ scenarios

def collectives(inp):
    """Each differentiable collective against one-process autograd on the
    whole tensors; the gradient buckets."""
    mesh = pm.make_mesh(2, 2, device=CPU)
    m, d = mesh.index("model"), mesh.index("data")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g)
    w1, w2 = torch.randn(8, 6, generator=g), torch.randn(6, 8, generator=g)
    err = {}

    # Megatron's pair: copy_to before the column half, sum_over after the row half.
    ref = [t.clone().requires_grad_() for t in (x, w1, w2)]
    torch.autograd.backward((torch.tanh(torch.relu(ref[0] @ ref[1]) @ ref[2]) ** 2).sum())
    loc = [x.clone().requires_grad_(), w1[:, 3 * m:3 * m + 3].clone().requires_grad_(),
           w2[3 * m:3 * m + 3].clone().requires_grad_()]
    h = torch.relu(pm.copy_to(loc[0], mesh) @ loc[1]) @ loc[2]
    torch.autograd.backward((torch.tanh(pm.sum_over(h, mesh)) ** 2).sum())
    err["megatron"] = max(float((loc[0].grad - ref[0].grad).abs().max()),
                          float((loc[1].grad - ref[1].grad[:, 3 * m:3 * m + 3]).abs().max()),
                          float((loc[2].grad - ref[2].grad[3 * m:3 * m + 3]).abs().max()))

    # all_gather over model, the loss replicated: the slice of the gradient.
    z = torch.randn(3, 4, generator=g)
    ref = z.clone().requires_grad_()
    (torch.sin(ref) * torch.arange(4.0)).sum().backward()
    loc = z[:, 2 * m:2 * m + 2].clone().requires_grad_()
    (torch.sin(pm.gather_over(loc, mesh, "model", dim=1)) * torch.arange(4.0)).sum().backward()
    err["gather_slice"] = float((loc.grad - ref.grad[:, 2 * m:2 * m + 2]).abs().max())

    # all_gather over data, each rank's loss its rows' share: the sum.
    e = torch.randn(4, 5, generator=g)
    ref = e.clone().requires_grad_()
    (ref @ ref.T).logsumexp(1).sum().backward()
    loc = e[2 * d:2 * d + 2].clone().requires_grad_()
    whole = pm.gather_over(loc, mesh, "data", 0, grad="sum")
    (loc @ whole.T).logsumexp(1).sum().backward()
    err["gather_sum"] = float((loc.grad - ref.grad[2 * d:2 * d + 2]).abs().max())

    # broadcast from model rank 1: the source takes the gradient once.
    b = torch.randn(5, generator=g) * (m + 1)
    loc = b.clone().requires_grad_()
    (pm.broadcast_from(loc, mesh, "model", 1) ** 3).sum().backward()
    want = 3 * (b * 2 / (m + 1)) ** 2 if m == 1 else torch.zeros(5)
    err["broadcast"] = float((loc.grad - want).abs().max())

    # ring over a 4-rank seq axis: the gradient comes back the reverse way.
    seq = pm.init_mesh({"seq": 4}, CPU)
    i = seq.index("seq")
    v = torch.randn(4, 3, generator=g)
    w = torch.randn(4, 3, generator=g)
    loc = v[i].clone().requires_grad_()
    (pm.ring_shift(seq, "seq", loc)[0] * w[i]).sum().backward()
    err["ring"] = float((loc.grad - w[(i + 1) % 4]).abs().max())

    # reduce_gradients: buckets of 7 elements, per-leaf axes.
    leaves = {"a": torch.full((3, 2), float(RANK)), "b": torch.full((5,), 1.0 + RANK),
              "c": torch.full((2, 2), 2.0)}
    pm.reduce_gradients(leaves, mesh, lambda k: ("data", "model") if k == "c" else ("data",),
                        bucket_elements=7)
    err["buckets"] = max(float((leaves["a"] - (2 * m + 2)).abs().max()),
                         float((leaves["b"] - (2 * m + 4)).abs().max()),
                         float((leaves["c"] - 8.0).abs().max()))
    return err


def asr(inp):
    """ASRTrainer at data 2 x model 2: the loaders' shards, one mini-step's
    loss and gradients, two updates (validation and a checkpoint at each),
    the coordinator's files, a resume, the export."""
    from yoho_tpu_torch.train.trainer import ASRTrainer

    cfg = load_session_config("s", inp["root"])
    trainer = ASRTrainer(cfg, mesh="2x2", device=CPU)
    init = trainer._full_params(trainer.model)
    loss, grads = _step(trainer, inp["batch"])
    out = dict(init=init, loss=loss, grads=grads, mesh=dict(trainer.mesh.shape),
               shard=trainer.train_dataloader.shard, local=trainer.train_dataloader.batch_size,
               table=trainer.train_dataloader.index_table.tolist(),
               writer=trainer.metrics is not None, specs=dict(trainer._specs))
    _record(trainer)
    _quiet(trainer.run, max_updates=2)
    out.update(seen=trainer.seen, update_losses=trainer.update_losses,
               final=trainer._full_params(trainer.model))
    resumed = ASRTrainer(cfg, mesh="2x2", device=CPU)
    for dl in (resumed.train_dataloader, resumed.val_dataloader):
        dl.terminate()
    out.update(resumed_step=resumed.step, resumed_count=resumed.opt_state["inner"]["count"],
               resumed_equal=all(torch.equal(a, b) for a, b in
                                 zip(resumed._leaves.values(), trainer._leaves.values())))
    return out


def moe(inp):
    """The MoE session's experts split over model 2: one mini-step."""
    from yoho_tpu_torch.nn.moe import MoESwiGLU
    from yoho_tpu_torch.train.trainer import ASRTrainer

    trainer = ASRTrainer(load_session_config("moe", inp["root"]), mesh="2x2", device=CPU)
    for dl in (trainer.train_dataloader, trainer.val_dataloader):
        dl.terminate()
    loss, grads = _step(trainer, inp["batch"])
    experts = [m.local_experts for m in trainer.model.modules() if isinstance(m, MoESwiGLU)]
    return dict(init=trainer._full_params(trainer.model), loss=loss, grads=grads,
                experts=experts)


def _session_model(root):
    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer

    cfg = load_session_config("s", root)
    vocab = YOHOTokenizer.load(cfg.weights.tokenizer).vocab_size
    return init_random(YOHOModel(cfg.yoho, vocab, device=CPU), seed=0)


def _step_out(step, inp):
    loss, grads = step(*(torch.from_numpy(np.asarray(x)) for x in inp["mel_batch"]))
    return dict(loss=float(loss), grads={k: _np(g) for k, g in grads.items()})


def long_context(inp):
    """The ring train step at seq 4 and data 2 x seq 2 on the step batch;
    ASRTrainer(long_context_factor=2) over the group's (data, seq) mesh."""
    from dataclasses import replace

    from yoho_tpu_torch.parallel.long_encoder import make_long_context_train_step
    from yoho_tpu_torch.train.trainer import ASRTrainer, masked_ce_loss

    out = {}
    for name, shape in (("seq4", {"seq": 4}), ("data2_seq2", {"data": 2, "seq": 2})):
        model = _session_model(inp["root"])
        out[name] = _step_out(make_long_context_train_step(model, pm.init_mesh(shape, CPU)),
                              inp)
    cfg = load_session_config("lc", inp["root"])
    trainer = ASRTrainer(cfg, device=CPU)
    audio, tokens, mask = trainer.train_dataloader.get_prepared_batch()
    for dl in (trainer.train_dataloader, trainer.val_dataloader):
        dl.terminate()
    placed = trainer._place((audio, tokens, mask))
    with torch.no_grad():
        ring = float(trainer._batch_loss(*placed))
        plain = float(masked_ce_loss(trainer.model(placed[1], trainer._mel(placed[0])),
                                     placed[1], placed[2]))
    moe_cfg = replace(cfg, yoho=replace(cfg.yoho, n_experts=2))
    out["trainer"] = dict(
        mesh=dict(trainer.mesh.shape), audio=audio.shape, tokens=tokens.shape, ring=ring,
        plain=plain, frames=trainer.data_config.yoho.max_audio_len,
        errors=_errors(lambda c: ASRTrainer(c, device=CPU), (moe_cfg,)))
    return out


def pipeline(inp):
    """The GPipe train step at pipe 2 (two replicas) and data 2 x pipe 2;
    its guards."""
    from dataclasses import replace

    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.parallel.pipeline import make_pipeline_train_step

    out = {}
    for name, shape in (("pipe2", {"replica": 2, "pipe": 2}), ("data2_pipe2",
                                                                {"data": 2, "pipe": 2})):
        model = _session_model(inp["root"])
        out[name] = _step_out(make_pipeline_train_step(model, pm.init_mesh(shape, CPU), 2), inp)
    model = _session_model(inp["root"])
    mel, tokens, mask = (torch.from_numpy(np.asarray(x)) for x in inp["mel_batch"])
    mixed = YOHOModel(replace(model.cfg, n_experts=2, moe_every_n=2), model.vocab_size,
                      device=CPU)
    out["errors"] = _errors(
        lambda mesh, mdl, rows: make_pipeline_train_step(mdl, mesh, 2)(
            mel[:rows], tokens[:rows], mask[:rows]),
        (pm.init_mesh({"pipe": 4}, CPU), model, 4),
        (pm.init_mesh({"replica": 2, "pipe": 2}, CPU), model, 3),
        (pm.init_mesh({"replica": 2, "pipe": 2}, CPU), mixed, 4),
        (pm.make_mesh(2, 2, CPU), model, 4))
    return out


def stage2(inp):
    """The VAE at data 4 with the test's global noise; the trainer's own
    noise is the global batch's, this rank's rows."""
    from yoho_tpu_torch.train.stages.stage2_reconstruction import ReconstructionTrainer

    trainer = ReconstructionTrainer(load_session_config("s", inp["root"]), mesh="4x1",
                                    device=CPU)
    own = _np(trainer._noise((1, 3, 2)))
    i = pm.data_shard(trainer.mesh)[0]
    eps = torch.from_numpy(inp["eps"])
    trainer._noise = lambda shape: eps[i * shape[0]:(i + 1) * shape[0]]
    loss, grads = _step(trainer, inp["batch"])
    trainer.train_dataloader.terminate()
    return dict(init=trainer._full_params(trainer.model), loss=loss, grads=grads, noise=own,
                shard=trainer.train_dataloader.shard)


def stage3(inp):
    """NT-Xent at data 2 x model 2: each anchor's positive lives on the
    other data rank."""
    from yoho_tpu_torch.train.stages.stage3_voiceprint import VoiceprintTrainer

    trainer = VoiceprintTrainer(load_session_config("s", inp["root"]), mesh="2x2", device=CPU)
    trainer.train_dataloader.terminate()
    loss, grads = _step(trainer, inp["batch"])
    return dict(init=trainer._full_params(trainer.model), loss=loss, grads=grads)


def stage4(inp):
    """Joint fine-tuning at data 2 x model 2, the valid spans all on data
    rank 1; the teacher stays whole and frozen."""
    from yoho_tpu_torch.train.stages.stage4_joint_finetune import JointTrainer

    trainer = JointTrainer(load_session_config("s", inp["root"]), mesh="2x2", device=CPU)
    for dl in (trainer.train_dataloader, trainer.val_dataloader):
        dl.terminate()
    loss, grads = _step(trainer, inp["batch"])
    return dict(init=trainer._full_params(trainer.model), loss=loss, grads=grads,
                teacher_frozen=not any(p.requires_grad for p in trainer.teacher.parameters()),
                teacher_whole=getattr(trainer.teacher, "tp_mesh", None) is None)


def _whisper(cfg, seed):
    from yoho_tpu_torch.nn.whisper import Whisper

    return init_random(Whisper(cfg, device=CPU), seed=seed)


def whisper(inp):
    """WhisperFinetuner at data 2 x model 2 with LoRA (AdamW; adapters on
    column- and row-parallel layers) and with
    Adafactor, the distiller at data 2 x model 2 (its teacher frozen and
    whole), two updates each; the sharded Adafactor's factored statistics
    against the unsharded optimizer."""
    from yoho_tpu_torch.nn import lora as lora_mod
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
    from yoho_tpu_torch.train.distill import WhisperDistiller
    from yoho_tpu_torch.train.optim import Adafactor
    from yoho_tpu_torch.train.whisper_finetune import WhisperFinetuner

    table = WhisperTokenTable(multilingual=True, text_backend=WordBackend(inp["words"]))
    kw = dict(batch_size=4, timestamps=False, augment=False, language_whitelist=["en"],
              validation_frequency=0, seed=0, learning_rate=3e-3, warmup_updates=1, updates=2,
              accumulated_batches=2, compute_dtype=torch.float32, device=CPU, mesh="2x2")
    cfg = WhisperConfig(**inp["tiny"])
    out = {}
    for name, extra in (("lora", dict(lora_rank=4, lora_targets=inp["lora_targets"])),
                        ("adafactor", dict(optimizer="adafactor"))):
        tuner = WhisperFinetuner(cfg, _whisper(cfg, 0), table, inp["corpus"],
                                 Path(inp["out"]) / name, **kw, **extra)
        init = ({p: {k: _np(v) for k, v in ab.items()}
                 for p, ab in lora_mod.adapters_of(tuner.model).items()} if name == "lora"
                else tuner._full_params(tuner.model))
        _record(tuner)
        _quiet(tuner.run)
        out[name] = dict(init=init, seen=tuner.seen, update_losses=tuner.update_losses,
                         scale=tuner.lora_scale, specs=dict(tuner._specs))
        if name == "lora":
            out[name]["final"] = {p: {k: _np(v) for k, v in ab.items()}
                                  for p, ab in lora_mod.adapters_of(tuner.model).items()}
            out[name]["sharded"] = sorted(k for k in tuner._leaves
                                          if tuner._grad_axes(k) == ("data", "model"))
        else:
            out[name]["final"] = tuner._full_params(tuner.model)
    dist = WhisperDistiller(cfg, _whisper(cfg, 1), cfg, _whisper(cfg, 0), table, inp["corpus"],
                            Path(inp["out"]) / "distill", alpha=0.5, tau=2.0, **kw)
    _record(dist)
    _quiet(dist.run)
    out["distill"] = dict(seen=dist.seen, update_losses=dist.update_losses,
                          final=dist._full_params(dist.model),
                          frozen=not any(p.requires_grad for p in dist.teacher.parameters()),
                          teacher_leaves=sum(1 for k in dist._leaves if "teacher" in k))

    # Adafactor with factored statistics on a (16, 24) leaf cut over model
    # and a (24, 16) leaf cut over its other dimension, against the
    # unsharded optimizer (min_dim_size_to_factor 8).
    mesh = pm.make_mesh(2, 2, device=CPU)
    m = mesh.index("model")
    gen = torch.Generator().manual_seed(3)
    params = {"p": torch.randn(16, 24, generator=gen), "q": torch.randn(24, 16, generator=gen)}
    grads = [{k: torch.randn(v.shape, generator=gen) for k, v in params.items()} for _ in range(2)]
    specs = {"p": (None, "model"), "q": ("model", None)}
    cut = {"p": lambda t: t[:, 12 * m:12 * m + 12], "q": lambda t: t[12 * m:12 * m + 12]}
    whole, part = Adafactor(lambda _c: 1e-2, min_dim_size_to_factor=8), \
        Adafactor(lambda _c: 1e-2, min_dim_size_to_factor=8)
    part.shard(specs, mesh)
    sw, sp = whole.init(params), part.init({k: cut[k](v) for k, v in params.items()})
    worst = 0.0
    for g in grads:
        uw = whole.update(g, sw, params)
        up = part.update({k: cut[k](v) for k, v in g.items()}, sp,
                         {k: cut[k](v) for k, v in params.items()})
        worst = max(worst, *(float((up[k] - cut[k](uw[k])).abs().max() / uw[k].abs().max())
                             for k in params))
    out["adafactor_sharded"] = dict(err=worst, factored=sorted(part._factored))
    return out


def sharded_checkpoint(inp):
    """save/load_checkpoint_sharded at data 2 x model 2: every rank's shard
    written, an exact round trip, a leftover ``.new``, the ``.old``
    fallback, None when absent, and a restore into data 4 x model 1."""
    from yoho_tpu_torch.parallel.sharding import (
        YOHO_RULES,
        global_shape,
        local_slice,
        shard_params,
    )
    from yoho_tpu_torch.train.optim import AdamW, MultiSteps
    from yoho_tpu_torch.train.sharded_checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )

    def state(mesh):
        model = shard_params(_session_model(inp["root"]), mesh, YOHO_RULES)
        leaves = {k: v(t) for k, (t, v) in jax_parameters(model).items()}
        opt = MultiSteps(AdamW(lambda _c: 1e-3), 2)
        specs = layout_of(model)
        return model, leaves, opt, opt.init(leaves), specs

    mesh = pm.make_mesh(2, 2, device=CPU)
    _model, leaves, opt, st, specs = state(mesh)
    g = torch.Generator().manual_seed(0)  # whole gradients, each rank its slices
    for _ in range(2):
        opt.update({k: local_slice(torch.randn(global_shape(v.shape, specs.get(k), mesh),
                                               generator=g), specs.get(k), mesh)
                    for k, v in leaves.items()}, st, leaves)
    ospecs = opt.state_specs(st, specs)
    path = Path(inp["dir"]) / "ckpt"
    out = {"absent": load_checkpoint_sharded(path, leaves, st, mesh, specs, ospecs) is None}
    if pm.is_coordinator():
        (path.with_name("ckpt.new")).mkdir(parents=True)
        (path.with_name("ckpt.new") / "junk").write_text("a crashed save")
    pm.barrier("test-new")
    save_checkpoint_sharded(path, 7, leaves, st, mesh, specs, ospecs)
    out["files"] = sorted(p.name for p in path.iterdir())
    out["new_gone"] = not path.with_name("ckpt.new").exists()

    def zeros_like(tree):
        return {k: zeros_like(v) if isinstance(v, dict) else
                (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0)
                for k, v in tree.items()}

    def equal(a, b):
        if isinstance(a, dict):
            return all(equal(a[k], b[k]) for k in a)
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    step, p2, o2 = load_checkpoint_sharded(path, zeros_like(leaves), zeros_like(st), mesh,
                                           specs, ospecs)
    out["round_trip"] = step == 7 and equal(leaves, p2) and equal(st, o2)
    pm.barrier("test-old")
    if pm.is_coordinator():
        path.rename(path.with_name("ckpt.old"))
    pm.barrier("test-renamed")
    got = load_checkpoint_sharded(path, zeros_like(leaves), zeros_like(st), mesh, specs, ospecs)
    out["old_fallback"] = got is not None and got[0] == 7 and equal(leaves, got[1])
    # Into data 4 x model 1: whole leaves, equal to the 2x2 state gathered.
    whole = pm.fetch_to_host(mesh, leaves, specs)
    wmesh = pm.make_mesh(4, 1, device=CPU)
    _m4, leaves4, opt4, st4, specs4 = state(wmesh)
    got = load_checkpoint_sharded(path, zeros_like(leaves4), zeros_like(st4), wmesh, specs4,
                                  opt4.state_specs(st4, specs4))
    out["resharded"] = got is not None and all(
        np.array_equal(_np(got[1][k]), whole[k]) for k in whole)
    return out


def cli(inp):
    """run-session 1 and finetune as commands inside the group (each joins
    it first); rank 0 alone prints and writes."""
    from yoho_tpu_torch.cli.__main__ import main

    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        out["run_session"] = main(["run-session", "cli", "1", "--root", inp["root"],
                                   "--max-updates", "1", "--no-workers", "--device", CPU])
    out["run_session_printed"] = "Loaded config" in buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        out["finetune"] = main(["finetune", "--hf", inp["hf"], "--data", inp["corpus"],
                                "--out", inp["out"], "--batch", "4", "--updates", "1",
                                "--warmup", "1", "--no-augment", "--no-timestamps",
                                "--language", "en", "--val-every", "0", "--f32",
                                "--device", CPU])
    out["finetune_printed"] = "exported" in buf.getvalue()
    return out


def dryrun(inp):
    from yoho_tpu_torch.dryrun import dryrun_multichip

    return dryrun_multichip(4, CPU)


SCENARIOS = (collectives, asr, moe, long_context, pipeline, stage2, stage3, stage4, whisper,
             sharded_checkpoint, cli, dryrun)


def main() -> None:
    case = Path(sys.argv[1])
    inp = pickle.loads((case / "inputs.pkl").read_bytes())
    pm.init_distributed(CPU)
    out = {}
    for fn in SCENARIOS:
        print(f"rank {RANK}: {fn.__name__}", flush=True)
        try:
            out[fn.__name__] = fn(inp.get(fn.__name__))
        except Exception:  # noqa: BLE001 - the test reports it
            out[fn.__name__] = {"error": traceback.format_exc()}
        pm.barrier(fn.__name__)
    (case / f"out{RANK}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
