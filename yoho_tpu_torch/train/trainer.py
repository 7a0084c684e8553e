"""The YOHO stage-1/4 ASR trainer on one GPU, the loop every trainer of
the port shares, and the pieces the whisper trainers share with it: the
masked next-token loss and the restore of a train state from a
checkpoint. The JAX package's ``train/trainer.py``.

:class:`ASRTrainer` keeps the JAX recipe: batches from
``TranscriptionDataloader`` (numpy, made on the host, the same for a
seed in both packages), log-mel features through the mel kernel on the
device (``fused_yoho_log_mel``), the teacher-forced forward under
``torch.autocast`` at ``compute_dtype`` with float32 parameters (the
attention through the flash kernel, its gradient through the plain
recompute), the masked CE loss plus ``moe_aux_weight`` x the MoE layers'
auxiliary loss when ``n_experts > 0``, warmup-cosine AdamW under
``MultiSteps`` over ``accumulated_batches`` with the schedule indexed by
applied updates, ``metrics.csv`` per update, validation (the loss of a
validation batch and greedy decodes from SOT through the decode-attention
kernel, written to ``validations.jsonl``) with a checkpoint at each one
and at exit, resume, and the stage's weights artifact (``weights.asr``
for stage 1, ``weights.yoho`` for stage 4) in the JAX params format,
written only when ``run()`` completes. As the port's whisper fine-tuner
does, a resumed run continues the training batches where the checkpoint
left them (the JAX package starts them again).

:class:`SessionTrainer` is what the session stages 1-4 share (the stage
directory, metrics, the optimizer from the stage's hyperparameters, the
train state and its checkpoint, the weights slot); stages 2 and 3
(``train/stages/``) train without validation and checkpoint every
``validation_frequency`` updates, as JAX's do.

Over a mesh (``parallel/mesh.py``; one process per rank, NCCL on the
card, gloo on the CPU) every trainer computes what the JAX package's
GSPMD program computes on the global batch. The mesh is the caller's
(a ``Mesh`` or a ``"DxM"`` spec), else under a launcher ``make_mesh`` of
the session's ``[mesh]`` (:func:`resolve_mesh`); without either the
trainers run in one process with no group. Under a mesh:

* the model is cut over ``model`` (``shard_params``) before the optimizer
  state is made, and its layers run the differentiable collectives;
* the loaders read this rank's ``data`` shard (``data_shard``), the
  global batch divided over ``data``: ranks that differ only in
  ``model`` or ``seq`` train on the same rows;
* a rank's loss is its share of the global loss (the CE's mask count is
  summed over ``data``, :func:`masked_ce_loss`; mean losses divide by the
  ``data`` size), so the gradients sum over ``data``: ``MultiSteps`` sums
  the accumulated mean once per applied update (``reduce_gradients``;
  frozen leaves are not in it), and each update's logged loss is summed
  once;
* ``metrics.csv``, the checkpoint and the export are written by the
  coordinator only; the checkpoint gathers every cut leaf (the optimizer
  state by its parameter's spec) and a resume loads the whole tree and
  cuts this rank's slices; validation is collective (the loss summed
  over ``data``, each rank decoding its rows, the results gathered
  before the coordinator's host reads them);
* ``long_context_factor > 1`` trains on a (data, seq) mesh through the
  ring encoder (``parallel/long_encoder.py``), as JAX's does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yoho_tpu_torch.core.config import SessionConfig, TrainingHP
from yoho_tpu_torch.core.device import resolve_device
from yoho_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    data_shard,
    data_sum,
    fetch_to_host,
    is_coordinator,
    local_batch_size,
)
from yoho_tpu_torch.train.checkpoint import load_checkpoint
from yoho_tpu_torch.train.optim import load_state


def masked_ce_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   loss_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token CE, masked: position i's logits predict token i + 1, the
    mask of token i + 1 weighs it, and the sum is divided by
    ``max(sum(mask), 1)``; float32. Under a mesh the sum is this rank's
    rows' and the mask count the global batch's (summed over ``data``):
    this rank's share of the global loss."""
    logits = logits[:, :-1].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1).long(), reduction="none")
    mask = loss_mask[:, 1:].reshape(-1).float()
    return torch.sum(ce * mask) / torch.clamp_min(data_sum(torch.sum(mask), mesh), 1.0)


def data_size(mesh) -> int:
    """The ``data`` axis's size (1 without a mesh): a mean loss's divisor."""
    return data_shard(mesh)[1]


def asr_objective(logits: torch.Tensor, tokens: torch.Tensor, loss_mask: torch.Tensor,
                  model: nn.Module, cfg, mesh=None) -> torch.Tensor:
    """The transcription loss of ``model``'s forward that gave ``logits``:
    masked CE, plus ``cfg.moe_aux_weight`` x the mean MoE auxiliary loss of
    that forward with experts (a per-row mean, so each ``data`` rank's
    share is divided by the axis size); this rank's share under a mesh."""
    from yoho_tpu_torch.nn.moe import collect_aux_losses

    loss = masked_ce_loss(logits, tokens, loss_mask, mesh)
    if cfg.n_experts > 0:
        aux = collect_aux_losses(model).to(loss.device)
        loss = loss + cfg.moe_aux_weight * aux / data_size(mesh)
    return loss


def resolve_mesh(mesh, device, data: int = -1, model: int = 1):
    """A trainer's mesh: the caller's (a ``Mesh``, or a ``"DxM"`` spec on
    ``device``; anything else raises ``TypeError``), else under a launcher
    ``make_mesh(data, model)``, else None (one process, no group)."""
    from yoho_tpu_torch.parallel.mesh import as_mesh, launched, make_mesh

    if mesh is not None:
        return as_mesh(mesh, device)
    if launched():
        return make_mesh(data, model, device)
    return None


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> '/'-joined paths."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Mapping[str, object]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


@torch.no_grad()
def restore_train_state(leaves: Dict[str, torch.Tensor], opt_state: dict,
                        checkpoint_path, nest=unflatten_tree, mesh=None,
                        specs: Optional[dict] = None,
                        state_specs: Optional[dict] = None) -> Optional[int]:
    """Restore a checkpoint into the live train state: ``leaves`` (the
    checkpointed tensors by '/'-joined JAX path, in the JAX layout, updated
    in place; ``nest`` builds the saved tree from such a dict) and
    ``opt_state`` (the optimizer's state, updated in place, each tensor on
    its own device). Returns the checkpoint's step (mini-steps), or None
    when there is no checkpoint (nothing changes). Under a mesh the file
    holds whole leaves (JAX's ``restore_train_state(..., mesh, rules)``):
    every rank loads them and keeps its slice of each, ``specs`` (path ->
    spec) cutting the leaves and ``state_specs`` the optimizer state."""
    from yoho_tpu_torch.parallel.sharding import global_shape, local_slice

    specs = specs or {}
    shape = ((lambda k, t: global_shape(tuple(t.shape), specs.get(k), mesh))
             if mesh is not None else (lambda k, t: tuple(t.shape)))
    template = nest({k: np.empty(shape(k, t), np.float32) for k, t in leaves.items()})
    restored = load_checkpoint(checkpoint_path, template)
    if restored is None:
        return None
    step, params, saved_opt = restored
    for k, v in flatten_tree(params).items():
        src = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        leaves[k].copy_(local_slice(src, specs.get(k), mesh) if mesh is not None else src)
    load_state(opt_state, saved_opt, state_specs, mesh)
    return step


class TrainLoop:
    """The mini-step loop the port's trainers share (``WhisperFinetuner``,
    ``WhisperDistiller`` and the session trainers). A subclass sets
    ``device``, ``compute_dtype``, ``optimizer`` and ``opt_state``,
    ``_train`` (JAX path -> (trained tensor, JAX-layout view)) and
    ``_leaves`` (those views), ``step`` (mini-steps), ``train_dataloader``,
    ``val_dataloader`` (None: no validation), ``metrics``, ``lr_schedule``
    and ``checkpoint_path``, the types of its batch's arrays on the device
    (``_batch_types``), and implements ``_batch_loss`` (one argument per
    array), ``_validate`` and ``_save_checkpoint``. Over a mesh it also sets
    ``mesh`` and calls :meth:`_prepare_optimizer` with the layout of the
    cut leaves before the optimizer state is made; ``metrics`` is None
    except on the coordinator."""

    _batch_types = (torch.float32, torch.long, torch.uint8)  # audio, tokens, mask
    val_dataloader = None
    mesh = None
    _specs: dict = {}

    def _grad_axes(self, key: str) -> tuple:
        """The mesh axes over which trained leaf ``key``'s gradient sums:
        ``data`` (a rank's loss is its share of the global batch's)."""
        return (AXIS_DATA,)

    def _prepare_optimizer(self, specs: dict) -> None:
        """Over a mesh: the gradient reduction once per update, and the
        layout of the cut leaves (path -> spec) for the optimizer's
        statistics and the checkpoint."""
        self._specs = dict(specs)
        if self.mesh is None:
            return
        from functools import partial

        from yoho_tpu_torch.parallel.mesh import reduce_gradients

        self.optimizer.reduce = partial(reduce_gradients, mesh=self.mesh, axes=self._grad_axes)
        if hasattr(self.optimizer.inner, "shard"):
            self.optimizer.inner.shard(self._specs, self.mesh)

    def _state_specs(self):
        return (self.optimizer.state_specs(self.opt_state, self._specs)
                if self.mesh is not None else None)

    def _restore(self, leaves: Dict[str, torch.Tensor], nest=unflatten_tree) -> int:
        """Resume from ``checkpoint_path`` (0 without one)."""
        return restore_train_state(leaves, self.opt_state, self.checkpoint_path, nest,
                                   self.mesh, self._specs, self._state_specs()) or 0

    def _host_state(self, leaves: Dict[str, torch.Tensor]):
        """(checkpoint leaves, optimizer state) for the checkpoint: as they
        are without a mesh; over it gathered whole (every rank calls) and
        copied to the host on the coordinator only ((None, None) elsewhere)."""
        if self.mesh is None:
            return leaves, self.opt_state
        here = is_coordinator()
        return (fetch_to_host(self.mesh, leaves, self._specs, to_host=here),
                fetch_to_host(self.mesh, self.opt_state, self._state_specs(), to_host=here))

    def _full_params(self, model: nn.Module) -> Optional[Dict]:
        """``model`` as a flax params tree, its cut leaves gathered whole
        over the mesh (every rank calls; None but on the coordinator)."""
        from yoho_tpu_torch.nn import params as nn_params

        if self.mesh is None:
            return nn_params.to_jax_params(model)
        from yoho_tpu_torch.parallel.sharding import layout_of

        leaves = fetch_to_host(self.mesh, nn_params.jax_leaves(model), layout_of(model),
                               to_host=is_coordinator())
        return None if leaves is None else unflatten_tree(leaves)

    def _decode_rows(self, fn, *arrays):
        """``fn`` of this rank's rows on the device, as a numpy array; over a
        mesh each ``data`` rank runs its own rows and the results are
        gathered over ``data`` before the host reads them (the
        coordinator's rows first)."""
        out = fn(*arrays)
        if self.mesh is not None:
            from yoho_tpu_torch.parallel.mesh import gather_batch

            out = gather_batch(self.mesh, out.contiguous())
        return out.cpu().numpy()

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32)

    def _place(self, batch):
        """The batch's first ``len(_batch_types)`` arrays on the device, each
        in its type."""
        return tuple(torch.from_numpy(np.asarray(x)).to(self.device, t, non_blocking=True)
                     for x, t in zip(batch, self._batch_types))

    def gradients(self, loss: torch.Tensor):
        """d loss / d every trained tensor; zeros for a tensor the loss does
        not reach (the YOHO voiceprint head in stage 1), as JAX's gradient
        has them."""
        return torch.autograd.grad(loss, [t for t, _ in self._train.values()],
                                   allow_unused=True, materialize_grads=True)

    def _train_step(self, *batch) -> torch.Tensor:
        """One mini-step: loss, gradient, MultiSteps update. Returns the
        loss (a device scalar, not read here)."""
        from yoho_tpu_torch.train.optim import apply_updates

        loss = self._batch_loss(*batch)
        grads = self.gradients(loss)
        grads = {k: view(g) for (k, (_, view)), g in zip(self._train.items(), grads)}
        updates = self.optimizer.update(grads, self.opt_state, self._leaves)
        if updates is not None:
            apply_updates(self._leaves, updates)
        self.step += 1
        return loss.detach()

    def _run_updates(self, updates: int, accumulated: int, validation_frequency: int,
                     progress: bool, export) -> None:
        """Mini-steps until ``updates`` applied updates; per update the mean
        loss (kept in ``update_losses``, one host sync), a checkpoint every
        ``validation_frequency``-th (<= 0: never) after a validation where
        there is a ``val_dataloader``, a ``metrics.csv`` row with the
        schedule's value at the applied update.
        A checkpoint at exit (over a mesh only when the loop completed);
        ``export()`` only when the loop completed, so a crashed re-run never
        overwrites a good artifact."""
        from yoho_tpu_torch.train.checkpoint import AsyncCheckpointer

        target_steps = updates * accumulated
        ckpt = (AsyncCheckpointer(self.checkpoint_path, install_sigterm=True)
                if is_coordinator() else None)
        pbar = None
        if progress and is_coordinator():
            from tqdm import tqdm

            pbar = tqdm(initial=self.step // accumulated, total=updates)
        self.update_losses: List[float] = []
        acc_loss, seen = None, 0
        completed = False
        try:
            while self.step < target_steps:
                step = self.step
                batch = self._place(self.train_dataloader.get_prepared_batch())
                loss = self._train_step(*batch).double()
                acc_loss = loss if acc_loss is None else acc_loss + loss
                seen += 1
                if step % accumulated == accumulated - 1:
                    update = (step + 1) // accumulated
                    # One sync per update (the sum of the ranks' shares).
                    batch_loss = float(data_sum(acc_loss, self.mesh)) / max(seen, 1)
                    self.update_losses.append(batch_loss)
                    acc_loss, seen = None, 0
                    if pbar is not None:
                        pbar.update()
                        pbar.set_postfix_str(f"loss {batch_loss:.4e}")
                    val_loss = None
                    if validation_frequency > 0 and update % validation_frequency == 0:
                        if self.val_dataloader is not None:
                            val_loss = self._validate(update)
                        self._save_checkpoint(ckpt)
                    if self.metrics is not None:
                        self.metrics.log(update, self.lr_schedule(update), batch_loss,
                                         val_loss)
            completed = True
        finally:
            # Over a mesh the save is collective: a rank that raised would
            # leave the others waiting in its gathers, so it saves only a
            # completed loop.
            if completed or self.mesh is None:
                self._save_checkpoint(ckpt)
            if ckpt is not None:
                ckpt.close()
            self.train_dataloader.terminate()
            if self.val_dataloader is not None:
                self.val_dataloader.terminate()
            if completed:
                export()
            if pbar is not None:
                pbar.close()


class SessionTrainer(TrainLoop):
    """What the YOHO session stages share: ``_setup`` (the stage directory,
    the mesh, ``metrics.csv`` on the coordinator, AdamW on the stage's
    warmup-cosine schedule under ``MultiSteps``), ``_init_state`` (the
    model cut over the mesh, the trained leaves of ``self.model``, the
    optimizer state, a resume from the checkpoint), the mel kernel, the
    checkpoint, ``run`` and the export of ``self.model`` to the stage's
    weights slot (``weights_path``) when the run completes.
    ``device``: CUDA unless ``"cpu"`` (a mesh's device when there is one);
    ``compute_dtype``: the autocast type (float32 turns autocast off)."""

    long_context_factor = 1

    def _setup(self, config: SessionConfig, stage: int, hp: TrainingHP, mesh, device,
               compute_dtype, validations: bool = False,
               checkpoint_name: str = "checkpoint.msgpack") -> None:
        from yoho_tpu_torch.train.metrics import MetricsWriter
        from yoho_tpu_torch.train.optim import AdamW, MultiSteps, warmup_cosine_decay_schedule
        from yoho_tpu_torch.train.session import stage_dir

        self.config, self.stage, self.hp = config, stage, hp
        self.long_context_factor = int(getattr(hp, "long_context_factor", 1) or 1)
        self.data_config = config
        if self.long_context_factor > 1:
            self.mesh = self._long_context_mesh(config, mesh, device)
        else:
            self.mesh = resolve_mesh(mesh, device, config.mesh.data, config.mesh.model)
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        self.compute_dtype = compute_dtype
        self.stage_path = stage_dir(config, stage)
        self.checkpoint_path = self.stage_path / checkpoint_name
        # Writers on the coordinator only (every rank sees the same paths).
        self.metrics = (MetricsWriter(self.stage_path / "metrics.csv",
                                      self.stage_path / "validations.jsonl" if validations
                                      else None)
                        if is_coordinator() else None)
        # Horizons in applied updates: the inner optimizer and its schedule
        # step once per update, not per accumulated mini-step.
        warmup = hp.warmup_updates
        self.lr_schedule = warmup_cosine_decay_schedule(
            0.0, hp.learning_rate, warmup, max(hp.updates, warmup + 1),
            hp.final_learning_rate)
        self.optimizer = MultiSteps(AdamW(self.lr_schedule), hp.accumulated_batches)

    def _long_context_mesh(self, config: SessionConfig, mesh, device):
        """Long-context training (``long_context_factor`` N > 1): clips of N
        windows (``data_config``) on a (data, seq) mesh, the caller's or
        JAX's ``_make_long_context_mesh``: ``[mesh] seq`` sizes the ring
        axis (-1: what ``data`` leaves; both -1: every rank), ``data`` the
        rest. The post-stem length must divide by ``seq``."""
        from dataclasses import replace

        from yoho_tpu_torch.parallel.mesh import Mesh, init_mesh, world_size

        f = self.long_context_factor
        self.data_config = replace(config, yoho=replace(
            config.yoho, max_audio_len=config.yoho.max_audio_len * f,
            max_text_len=config.yoho.max_text_len * f))
        if mesh is not None:
            if not isinstance(mesh, Mesh) or "seq" not in mesh.shape:
                raise TypeError("long_context_factor > 1 trains on a (data, seq) mesh "
                                "(parallel.mesh.init_mesh({'data': d, 'seq': s})), got "
                                f"{mesh!r}")
        else:
            n = world_size()
            seq = config.mesh.seq
            if seq == -1:
                seq = n // config.mesh.data if config.mesh.data != -1 else n
            if seq < 1 or n % seq:
                raise ValueError(f"seq axis size {seq} does not divide device count {n}")
            data = n // seq
            if config.mesh.data not in (-1, data):
                raise ValueError(f"mesh {config.mesh.data}x{seq} != {n} devices")
            mesh = init_mesh({AXIS_DATA: data, "seq": seq}, device)
        frames = self.data_config.yoho.max_audio_len // 2  # post-stem
        if frames % mesh.shape["seq"]:
            raise ValueError(
                f"long-context post-stem length {frames} must divide by the seq axis "
                f"({mesh.shape['seq']}); adjust max_audio_len, long_context_factor, "
                "or [mesh] seq")
        return mesh

    def _loader_shard(self) -> dict:
        """The loaders' share of the global batch: this rank's ``data``
        shard and local batch."""
        return dict(batch_size=local_batch_size(self.hp.batch_size, self.mesh),
                    shard=data_shard(self.mesh))

    def _init_state(self) -> None:
        from yoho_tpu_torch.nn import params as nn_params
        from yoho_tpu_torch.parallel.sharding import YOHO_RULES, layout_of, shard_params

        if self.mesh is not None:
            shard_params(self.model, self.mesh, YOHO_RULES)
        self._train = {k: (t, view) for k, (t, view)
                       in nn_params.jax_parameters(self.model).items()
                       if isinstance(t, nn.Parameter)}
        for t, _view in self._train.values():
            t.requires_grad_(True)
        self._leaves = {k: view(t) for k, (t, view) in self._train.items()}
        self._prepare_optimizer(layout_of(self.model))
        self.opt_state = self.optimizer.init(self._leaves)
        self.step = self._restore(dict(self._leaves))
        self.train_dataloader.skip(self.step)

    def _mel(self, audio: torch.Tensor) -> torch.Tensor:
        from yoho_tpu_torch.ops.mel_kernel import fused_yoho_log_mel

        return fused_yoho_log_mel(audio.float(), self.config.yoho)

    def run(self, max_updates: Optional[int] = None, progress: bool = False) -> None:
        """Train to ``max_updates`` (default ``hp.updates``) applied updates;
        ``update_losses`` keeps each update's mean mini-step loss."""
        self._run_updates(max_updates or self.hp.updates, self.hp.accumulated_batches,
                          self.hp.validation_frequency, progress, self._export_weights)

    def _save_checkpoint(self, ckpt) -> None:
        params, opt_state = self._host_state(dict(self._leaves))
        if ckpt is not None:
            ckpt.save(self.step, unflatten_tree(params), opt_state)

    def _export_weights(self) -> None:
        """``self.model`` as a flax params tree in ``weights_path``."""
        from yoho_tpu_torch.train.checkpoint import save_params

        tree = self._full_params(self.model)
        if is_coordinator():
            save_params(self.weights_path, tree)


class ASRTrainer(SessionTrainer):
    """Transcription (pre)training of a YOHO session. ``stage=1`` trains
    without voiceprint supervision (``weights.asr``); ``stage=4`` reuses the
    loop for ``weights.yoho``. ``model``: the ``YOHOModel`` to train
    (default: one at the session's widths, float32 on ``device``);
    ``init_params``: a flax params tree to start from (default:
    ``init_random`` with seed 0). ``mesh``: see the module doc."""

    def __init__(self, config: SessionConfig, tokenizer=None, stage: int = 1,
                 hp: Optional[TrainingHP] = None, mesh=None,
                 use_multiprocessing: bool = False,
                 checkpoint_name: str = "checkpoint.msgpack", model=None, init_params=None,
                 dataloader_kwargs: Optional[dict] = None,
                 compute_dtype=torch.float32, device=None):
        from yoho_tpu_torch.nn import params as nn_params
        from yoho_tpu_torch.nn.yoho import YOHOModel
        from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
        from yoho_tpu_torch.train.dataloader import TranscriptionDataloader

        hp = hp or (config.hyperparameters.transcribe_pretrain if stage == 1
                    else config.hyperparameters.transcribe_finetune)
        self._setup(config, stage, hp, mesh, device, compute_dtype, validations=True,
                    checkpoint_name=checkpoint_name)
        self.weights_path = config.weights.asr if stage == 1 else config.weights.yoho
        self.tokenizer = tokenizer or YOHOTokenizer.load(config.weights.tokenizer)

        self.model = model or YOHOModel(config.yoho, self.tokenizer.vocab_size,
                                        dtype=torch.float32, device=self.device,
                                        remat=self.hp.remat)
        if init_params is None:
            nn_params.init_random(self.model, seed=0)
        else:
            nn_params.load_jax_params(self.model, init_params)
        self._long_loss = None
        if self.long_context_factor > 1:
            from yoho_tpu_torch.parallel.long_encoder import make_long_context_loss_fn

            if config.yoho.n_experts > 0:
                raise ValueError(
                    "long_context_factor > 1 with n_experts > 0 is not supported: the "
                    "ring encoder does not collect MoE aux losses (train MoE models with "
                    "the standard step)")
            self._long_loss = make_long_context_loss_fn(self.model, self.mesh)

        dl_kwargs = dict(
            config=self.data_config, tokenizer=self.tokenizer,
            # Each stage's own ratio (stage 4 has its own field).
            speechless_ratio=getattr(self.hp, "speechless_sample_ratio", 0.0),
            shuffle=True, use_multiprocessing=use_multiprocessing, disable_warnings=True,
            warmup_queue=False, **self._loader_shard(), **(dataloader_kwargs or {}))
        self.train_dataloader = TranscriptionDataloader((0.0, 0.9), seed=0, **dl_kwargs)
        try:
            self.val_dataloader = TranscriptionDataloader((0.9, 1.0), seed=1, **dl_kwargs)
        except FileNotFoundError:
            # Tiny corpora: a reshuffled train slice.
            self.val_dataloader = TranscriptionDataloader((0.0, 1.0), seed=1, **dl_kwargs)
        self._init_state()

    def _grad_axes(self, key: str) -> tuple:
        # Long context: the stem and blocks compute a disjoint part of the
        # encoder on each seq rank; the decoder runs whole on every one.
        if self.long_context_factor > 1 and key.startswith("encoder/"):
            return (AXIS_DATA, "seq")
        return (AXIS_DATA,)

    def _asr_loss(self, audio, tokens, mask) -> torch.Tensor:
        """Masked CE, plus ``moe_aux_weight`` x the mean MoE auxiliary loss
        with experts: stage 1's training loss and every stage's validation
        loss (JAX's ``_val_loss``); this rank's share under a mesh."""
        with torch.no_grad():
            mel = self._mel(audio)
        if self._long_loss is not None:
            with self._autocast():
                return self._long_loss(mel, tokens, mask)
        with self._autocast():
            logits = self.model(tokens, mel)
        return asr_objective(logits, tokens, mask, self.model, self.config.yoho, self.mesh)

    def _batch_loss(self, audio, tokens, mask) -> torch.Tensor:
        """The loss whose gradient a train step takes."""
        return self._asr_loss(audio, tokens, mask)

    @torch.no_grad()
    def _decode_samples(self, audio, prompt):
        from yoho_tpu_torch.infer.decode import greedy_decode, make_yoho_step_fn

        model, cfg = self.model, self.config.yoho
        with self._autocast():
            xa = model.encode_audio(self._mel(audio))
            ckv = model.cross_kvs(xa)
            caches = model.init_caches(prompt.shape[0], torch.float32)
            step = make_yoho_step_fn(model, ckv)
            return greedy_decode(step, caches, prompt, cfg.max_text_len,
                                 self.tokenizer.eot_id)

    def _validate(self, update: int) -> float:
        n = self.hp.validation_samples
        val_batch = self.val_dataloader.get_prepared_batch()
        train_batch = self.train_dataloader.get_prepared_batch()
        n = min(n, len(val_batch[0]), len(train_batch[0]))
        audio = np.concatenate([val_batch[0][:n], train_batch[0][:n]])
        tokens = np.concatenate([val_batch[1][:n], train_batch[1][:n]])
        masks = np.concatenate([val_batch[2][:n], train_batch[2][:n]])
        with torch.no_grad():
            val_loss = float(data_sum(self._asr_loss(*self._place(val_batch)[:3]), self.mesh))
        prompt = torch.full((2 * n, 1), self.tokenizer.sot_id, dtype=torch.long,
                            device=self.device)
        decoded = self._decode_rows(lambda a, p: self._decode_samples(a, p)[0],
                                    torch.from_numpy(audio).to(self.device), prompt)
        if self.metrics is None:
            return val_loss
        decoded = decoded[:2 * n]  # the coordinator's rows

        def _true_len(mask):
            nz = np.nonzero(mask)[0]
            return int(nz[-1]) + 1 if len(nz) else 0

        correct = [self.tokenizer.decode(row[: _true_len(m)]) for row, m in zip(tokens, masks)]
        predicted = [self.tokenizer.decode(row) for row in decoded]
        self.metrics.write_validation(correct[:n], predicted[:n], correct[n:], predicted[n:])
        return val_loss
