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

A device mesh and ``long_context_factor > 1`` (ring attention, a
multi-device program) are ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yoho_tpu_torch.core.config import SessionConfig, TrainingHP
from yoho_tpu_torch.core.device import resolve_device
from yoho_tpu_torch.train.checkpoint import load_checkpoint
from yoho_tpu_torch.train.optim import load_state


def masked_ce_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   loss_mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE, masked: position i's logits predict token i + 1, the
    mask of token i + 1 weighs it, and the sum is divided by
    ``max(sum(mask), 1)``; float32."""
    logits = logits[:, :-1].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1).long(), reduction="none")
    mask = loss_mask[:, 1:].reshape(-1).float()
    return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)


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
                        checkpoint_path, nest=unflatten_tree) -> Optional[int]:
    """Restore a checkpoint into the live train state: ``leaves`` (the
    checkpointed tensors by '/'-joined JAX path, in the JAX layout, updated
    in place; ``nest`` builds the saved tree from such a dict) and
    ``opt_state`` (the optimizer's state, updated in place, each tensor on
    its own device). Returns the checkpoint's step (mini-steps), or None
    when there is no checkpoint (nothing changes)."""
    template = nest({k: np.empty(tuple(t.shape), np.float32) for k, t in leaves.items()})
    restored = load_checkpoint(checkpoint_path, template)
    if restored is None:
        return None
    step, params, saved_opt = restored
    for k, v in flatten_tree(params).items():
        src = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        leaves[k].copy_(src)
    load_state(opt_state, saved_opt)
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
    array), ``_validate`` and ``_save_checkpoint``."""

    _batch_types = (torch.float32, torch.long, torch.uint8)  # audio, tokens, mask
    val_dataloader = None

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
        A checkpoint at exit; ``export()`` only when the loop completed, so
        a crashed re-run never overwrites a good artifact."""
        from yoho_tpu_torch.train.checkpoint import AsyncCheckpointer

        target_steps = updates * accumulated
        ckpt = AsyncCheckpointer(self.checkpoint_path, install_sigterm=True)
        pbar = None
        if progress:
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
                    batch_loss = float(acc_loss) / max(seen, 1)  # one sync per update
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
                    self.metrics.log(update, self.lr_schedule(update), batch_loss, val_loss)
            completed = True
        finally:
            self._save_checkpoint(ckpt)
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
    ``metrics.csv``, AdamW on the stage's warmup-cosine schedule under
    ``MultiSteps``), ``_init_state`` (the trained leaves of ``self.model``,
    the optimizer state, a resume from the checkpoint), the mel kernel,
    the checkpoint, ``run`` and the export of ``self.model`` to the stage's
    weights slot (``weights_path``) when the run completes.
    ``device``: CUDA unless ``"cpu"``; ``compute_dtype``: the autocast type
    (float32 turns autocast off)."""

    def _setup(self, config: SessionConfig, stage: int, hp: TrainingHP, mesh, device,
               compute_dtype, validations: bool = False,
               checkpoint_name: str = "checkpoint.msgpack") -> None:
        from yoho_tpu_torch.infer.pipeline import _not_ported
        from yoho_tpu_torch.train.metrics import MetricsWriter
        from yoho_tpu_torch.train.optim import AdamW, MultiSteps, warmup_cosine_decay_schedule
        from yoho_tpu_torch.train.session import stage_dir

        if mesh is not None:
            _not_ported("multi-device data parallelism (mesh)", 11)
        if int(getattr(hp, "long_context_factor", 1) or 1) > 1:
            _not_ported("long-context training (long_context_factor > 1: "
                        "ring attention over a device mesh)", 11)
        self.config, self.stage, self.hp = config, stage, hp
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.stage_path = stage_dir(config, stage)
        self.checkpoint_path = self.stage_path / checkpoint_name
        self.metrics = MetricsWriter(self.stage_path / "metrics.csv",
                                     self.stage_path / "validations.jsonl" if validations
                                     else None)
        # Horizons in applied updates: the inner optimizer and its schedule
        # step once per update, not per accumulated mini-step.
        warmup = hp.warmup_updates
        self.lr_schedule = warmup_cosine_decay_schedule(
            0.0, hp.learning_rate, warmup, max(hp.updates, warmup + 1),
            hp.final_learning_rate)
        self.optimizer = MultiSteps(AdamW(self.lr_schedule), hp.accumulated_batches)

    def _init_state(self) -> None:
        from yoho_tpu_torch.nn import params as nn_params

        self._train = {k: (t, view) for k, (t, view)
                       in nn_params.jax_parameters(self.model).items()
                       if isinstance(t, nn.Parameter)}
        for t, _view in self._train.values():
            t.requires_grad_(True)
        self._leaves = {k: view(t) for k, (t, view) in self._train.items()}
        self.opt_state = self.optimizer.init(self._leaves)
        self.step = restore_train_state(dict(self._leaves), self.opt_state,
                                        self.checkpoint_path) or 0
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
        ckpt.save(self.step, unflatten_tree(dict(self._leaves)), self.opt_state)

    def _export_weights(self) -> None:
        """``self.model`` as a flax params tree in ``weights_path``."""
        from yoho_tpu_torch.nn import params as nn_params
        from yoho_tpu_torch.train.checkpoint import save_params

        save_params(self.weights_path, nn_params.to_jax_params(self.model))


class ASRTrainer(SessionTrainer):
    """Transcription (pre)training of a YOHO session. ``stage=1`` trains
    without voiceprint supervision (``weights.asr``); ``stage=4`` reuses the
    loop for ``weights.yoho``. ``model``: the ``YOHOModel`` to train
    (default: one at the session's widths, float32 on ``device``);
    ``init_params``: a flax params tree to start from (default:
    ``init_random`` with seed 0)."""

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

        dl_kwargs = dict(
            config=config, tokenizer=self.tokenizer,
            # Each stage's own ratio (stage 4 has its own field).
            speechless_ratio=getattr(self.hp, "speechless_sample_ratio", 0.0),
            batch_size=self.hp.batch_size, shuffle=True,
            use_multiprocessing=use_multiprocessing, disable_warnings=True,
            warmup_queue=False, **(dataloader_kwargs or {}))
        self.train_dataloader = TranscriptionDataloader((0.0, 0.9), seed=0, **dl_kwargs)
        try:
            self.val_dataloader = TranscriptionDataloader((0.9, 1.0), seed=1, **dl_kwargs)
        except FileNotFoundError:
            # Tiny corpora: a reshuffled train slice.
            self.val_dataloader = TranscriptionDataloader((0.0, 1.0), seed=1, **dl_kwargs)
        self._init_state()

    def _asr_loss(self, audio, tokens, mask) -> torch.Tensor:
        """Masked CE, plus ``moe_aux_weight`` x the mean MoE auxiliary loss
        with experts: stage 1's training loss and every stage's validation
        loss (JAX's ``_val_loss``)."""
        from yoho_tpu_torch.nn.moe import collect_aux_losses

        cfg = self.config.yoho
        with torch.no_grad():
            mel = self._mel(audio)
        with self._autocast():
            logits = self.model(tokens, mel)
        loss = masked_ce_loss(logits, tokens, mask)
        if cfg.n_experts > 0:
            loss = loss + cfg.moe_aux_weight * collect_aux_losses(self.model).to(loss.device)
        return loss

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
            val_loss = float(self._asr_loss(*self._place(val_batch)[:3]))
        prompt = torch.full((2 * n, 1), self.tokenizer.sot_id, dtype=torch.long,
                            device=self.device)
        decoded, _lengths = self._decode_samples(
            torch.from_numpy(audio).to(self.device), prompt)
        decoded = decoded.cpu().numpy()

        def _true_len(mask):
            nz = np.nonzero(mask)[0]
            return int(nz[-1]) + 1 if len(nz) else 0

        correct = [self.tokenizer.decode(row[: _true_len(m)]) for row, m in zip(tokens, masks)]
        predicted = [self.tokenizer.decode(row) for row in decoded]
        self.metrics.write_validation(correct[:n], predicted[:n], correct[n:], predicted[n:])
        return val_loss
