"""Whisper fine-tuning on an SRT corpus, on the GPU.

The port's counterpart of the JAX package's ``train/whisper_finetune.py``,
with the same arguments (``mesh`` becomes ``device``; ``compute_dtype`` is
a torch dtype) and the same recipe:

* batches from :class:`WhisperFinetuneDataloader` (numpy, made on the host:
  corpus indexing, utterance packing, context randomization, augmentation,
  whisper targets ``<|sot|><|lang|><|task|>[<|ts|>] text [<|ts|>] ...
  <|eot|>`` with 0.02 s timestamp tokens, loss-masked after the prompt);
* one step per mini-batch: log-mel features through the mel kernel (no
  gradient flows into the audio), the teacher-forced forward under
  ``torch.autocast`` at ``compute_dtype`` (float32 parameters; flash
  attention forward through its kernel and backward through its
  recompute), the masked CE loss and its gradient;
* the optimizer of ``train/optim.py`` (warmup-cosine AdamW or Adafactor,
  ``MultiSteps`` over ``accumulated_batches``), stepping the parameters in
  place in the JAX layout;
* ``freeze_encoder``: the encoder's parameters take no gradient (the JAX
  package's ``stop_gradient``) and no optimizer state;
* ``lora_rank > 0``: the base is frozen and rank-r adapters train, merged
  on the fly inside the step (``nn/lora.py``);
* ``remat``: every block checkpointed (``Whisper(remat=True)``);
* validation: the loss of a validation batch and greedy decodes of its
  first samples (the decode attention kernel reads the int8 cross K/V and
  int8 self cache, the serving lane), written by ``MetricsWriter``;
* checkpoints on a background thread (``AsyncCheckpointer``), resume with
  the provenance guard, and an HF-layout export at the end of ``run()``. A
  resumed run continues the training batches where the checkpoint left
  them (the JAX package starts them again), so it ends where an
  uninterrupted run ends.

Over a mesh (``mesh=``: a ``Mesh`` or a ``"DxM"`` spec; under a launcher
JAX's default ``make_mesh(-1, 1)``) the fine-tuner follows
``train/trainer.py``'s rules: the model cut over ``model``
(``WHISPER_RULES``), this rank's ``data`` shard of every batch, the loss
its share of the global batch's, the gradients summed over ``data`` once
an update, Adafactor's statistics over the whole leaves, collective
validation, and the checkpoint, metrics and export on the coordinator.
LoRA adapters stay whole (JAX replicates them); on a cut layer they act
on its slice (``nn/lora.py``) and their gradients sum over ``model`` too.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from dataclasses import asdict
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from yoho_tpu_torch.core.config import (
    DatasetConfig,
    SessionConfig,
    WhisperConfig,
    YOHOConfig,
)
from yoho_tpu_torch.core.device import resolve_device
from yoho_tpu_torch.infer.decode import greedy_decode, make_whisper_step_fn
from yoho_tpu_torch.nn import lora as lora_mod
from yoho_tpu_torch.nn import params as nn_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
from yoho_tpu_torch.train.checkpoint import AsyncCheckpointer
from yoho_tpu_torch.train.dataloader import TranscriptionDataloader
from yoho_tpu_torch.train.metrics import MetricsWriter
from yoho_tpu_torch.train.optim import (
    Adafactor,
    AdamW,
    MultiSteps,
    trainable,
    warmup_cosine_decay_schedule,
)
from yoho_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    barrier,
    data_shard,
    data_sum,
    is_coordinator,
    local_batch_size,
)
from yoho_tpu_torch.parallel.sharding import WHISPER_RULES, layout_of, shard_params
from yoho_tpu_torch.train.trainer import (
    TrainLoop,
    masked_ce_loss,
    resolve_mesh,
    unflatten_tree,
)


def _shim_session(data_dir, cfg: WhisperConfig,
                  language_whitelist: Optional[List[str]],
                  max_target_len: int, ambient_dir=None) -> SessionConfig:
    """SessionConfig whose ``yoho`` block carries Whisper's window numbers,
    so TranscriptionDataloader's sample recipe cuts Whisper-sized clips
    (the nearest smaller length that the sample-count identity allows;
    ``get_batch`` zero-pads to the exact window). Without ``ambient_dir``
    the speechless negatives come from a (normally absent) ``ambient``
    subdir of the corpus, so they fall back to synthesized low noise."""
    frames = max(1, (cfg.n_samples - cfg.n_fft) // cfg.hop_length + 1)
    shim = YOHOConfig(sample_rate=cfg.sample_rate, n_mel_bands=cfg.n_mels,
                      n_fft=cfg.n_fft, stft_hop=cfg.hop_length,
                      max_audio_len=frames, max_text_len=max_target_len)
    return SessionConfig(
        name="whisper_finetune",
        yoho=shim,
        dataset=DatasetConfig(
            noisy=Path(data_dir),
            ambient=Path(ambient_dir) if ambient_dir is not None
            else Path(data_dir) / "ambient"),
        language_whitelist=list(language_whitelist or []),
    )


class WhisperFinetuneDataloader(TranscriptionDataloader):
    """SRT+audio corpus -> (audio, whisper tokens, loss_mask) batches."""

    def __init__(self, data_slice: Tuple[float, float], data_dir,
                 cfg: WhisperConfig, table: WhisperTokenTable,
                 batch_size: int, task: str = "transcribe",
                 timestamps: bool = True,
                 max_target_len: Optional[int] = None,
                 language_whitelist: Optional[List[str]] = None,
                 speechless_ratio: float = 0.0, ambient_dir=None, **kwargs):
        if table.text_backend is None:
            raise RuntimeError(
                "fine-tuning needs a text backend to ENCODE transcripts: pass "
                "WhisperTokenTable(text_backend=...) with encode and decode")
        self.table = table
        self.task = task
        self.timestamps = timestamps
        self.max_target_len = int(max_target_len or cfg.n_text_ctx)
        prompt_len = len(table.sot_sequence("en" if table.multilingual
                                            else table.languages[0],
                                            task, timestamps=timestamps))
        if self.max_target_len < prompt_len + 3:
            raise ValueError(
                f"max_target_len={self.max_target_len} leaves no room for "
                f"targets after the {prompt_len}-token prompt — every loss "
                "mask would be empty and training a silent no-op")
        self.n_samples_out = cfg.n_samples
        session = _shim_session(data_dir, cfg, language_whitelist,
                                self.max_target_len, ambient_dir=ambient_dir)
        super().__init__(data_slice, session, tokenizer=None,
                         batch_size=batch_size,
                         speechless_ratio=speechless_ratio, **kwargs)

    def _ts_token(self, seconds: float) -> int:
        tick = int(round(seconds / 0.02))
        return self.table.timestamp_begin + min(
            max(tick, 0), self.table.num_timestamps - 1)

    def _target_ids(self, utts, lang: str) -> Tuple[List[int], int]:
        """-> (ids, prompt_len): the sot sequence (no loss), then per
        utterance ``[<|ts_start|>] text [<|ts_end|>]``, then EOT."""
        table = self.table
        if lang not in table.languages:
            lang = table.languages[0]
        prompt = table.sot_sequence(lang, self.task, timestamps=self.timestamps)
        ids = list(prompt)
        sr = self.config.yoho.sample_rate
        for start, end, text in utts:
            text = text.strip()
            if self.timestamps:
                ids.append(self._ts_token(start / sr))
            if text:
                # Leading space: GPT-2 byte-BPE merges are trained on
                # space-prefixed words.
                ids.extend(table.encode_text(" " + text))
            if self.timestamps:
                ids.append(self._ts_token(end / sr))
        ids.append(table.eot)
        T = self.max_target_len
        if len(ids) > T:
            ids = ids[:T - 1] + [table.eot]
        return ids, len(prompt)

    def get_batch(self, idx: int):
        cfg = self.config.yoho
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        i = idx * self.batch_size

        samples = []
        fallback_lang = (self.config.language_whitelist[0]
                         if self.config.language_whitelist else "en")
        for k in range(self.batch_size):
            if self.speechless_ratio > 0 and rng.uniform() < self.speechless_ratio:
                audio, utts = self._speechless_sample(rng)
                samples.append((audio, utts, fallback_lang))
                continue
            sample_idx = int(self.index_table[(i + k) % len(self.index_table)])
            for _attempt in range(int(self.sizes[-1])):
                audio, utts = self._load_sample(rng, sample_idx)
                if audio is not None:
                    break
                sample_idx = int((sample_idx + 1) % self.sizes[-1])
            else:
                raise RuntimeError(
                    "every sample in the corpus exceeded n_samples after "
                    "augmentation — clips are too long for "
                    f"max_input_seconds={cfg.max_input_seconds:.1f}s")
            lang = self.langs[bisect.bisect_right(self.sizes, sample_idx)]
            samples.append((audio, utts, lang))

        audio_batch = np.stack([s[0] for s in samples])
        pad = self.n_samples_out - audio_batch.shape[1]
        if pad > 0:  # shim identity undershoot (see _shim_session)
            audio_batch = np.pad(audio_batch, ((0, 0), (0, pad)))

        T = self.max_target_len
        tokens = np.full((self.batch_size, T), self.table.eot, np.int32)
        loss_mask = np.zeros((self.batch_size, T), np.uint8)
        for r, (_audio, utts, lang) in enumerate(samples):
            ids, prompt_len = self._target_ids(utts, lang)
            tokens[r, :len(ids)] = ids
            loss_mask[r, prompt_len:len(ids)] = 1
        return audio_batch.astype(np.float32), tokens, loss_mask


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree, np.float32)


class WhisperFinetuner(TrainLoop):
    """Fine-tune a Whisper model on an SRT corpus. ``params`` is a flax
    params tree (the JAX package's layout, e.g. ``train.checkpoint.
    load_params``) or a port ``Whisper`` module, which is trained in place
    (moved to ``device`` in float32)."""

    def __init__(self, cfg: WhisperConfig, params, table: WhisperTokenTable,
                 data_dir, out_dir, *,
                 batch_size: int = 8, updates: int = 1000,
                 warmup_updates: int = 50, learning_rate: float = 1e-5,
                 final_learning_rate: float = 1e-7,
                 accumulated_batches: int = 1,
                 freeze_encoder: bool = False,
                 task: str = "transcribe", timestamps: bool = True,
                 language_whitelist: Optional[List[str]] = None,
                 speechless_ratio: float = 0.0, augment: bool = True,
                 device=None, compute_dtype=torch.bfloat16,
                 validation_frequency: int = 100,
                 validation_samples: int = 4,
                 max_target_len: Optional[int] = None,
                 use_multiprocessing: bool = False,
                 src_dir=None, ambient_dir=None, seed: int = 0,
                 remat: bool = False, optimizer: str = "adamw",
                 lora_rank: int = 0, lora_alpha: Optional[float] = None,
                 lora_targets: Optional[str] = None, mesh=None):
        self.mesh = resolve_mesh(mesh, device)
        self.cfg = cfg
        self.table = table
        self.out_dir = Path(out_dir)
        self.src_dir = src_dir
        self.updates = updates
        self.accumulated_batches = accumulated_batches
        # <= 0 means "never validate".
        self.validation_frequency = validation_frequency
        self.validation_samples = validation_samples
        self.freeze_encoder = freeze_encoder
        self.lora_rank = int(lora_rank)
        self.lora_alpha = lora_alpha
        self.lora_targets = lora_targets or lora_mod.DEFAULT_TARGETS
        self.lora_scale = (lora_mod.lora_scale(self.lora_rank, lora_alpha)
                           if self.lora_rank else 0.0)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_path = self.out_dir / "finetune_checkpoint.msgpack"
        self.metrics = (MetricsWriter(self.out_dir / "metrics.csv",
                                      self.out_dir / "validations.jsonl")
                        if is_coordinator() else None)
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        self.compute_dtype = compute_dtype
        if optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"unknown optimizer {optimizer!r} (adamw | adafactor)")

        if isinstance(params, nn.Module):
            self.model = params.to(self.device, torch.float32)
            for mod in (self.model, self.model.encoder, self.model.decoder):
                mod.dtype = torch.float32
            self.model.remat = remat
        else:
            self.model = nn_params.load_jax_params(
                Whisper(cfg, torch.float32, device=self.device, remat=remat),
                _f32_tree(params))

        dl_kwargs = dict(
            data_dir=data_dir, cfg=cfg, table=table,
            batch_size=local_batch_size(batch_size, self.mesh), shard=data_shard(self.mesh),
            task=task, timestamps=timestamps, max_target_len=max_target_len,
            language_whitelist=language_whitelist,
            speechless_ratio=speechless_ratio, ambient_dir=ambient_dir,
            augment=augment, shuffle=True,
            use_multiprocessing=use_multiprocessing,
            disable_warnings=True, warmup_queue=False,
        )
        try:
            self.train_dataloader = WhisperFinetuneDataloader(
                (0.0, 0.9), seed=seed, **dl_kwargs)
        except FileNotFoundError:
            # Single-file corpora: int(0.9 * 1) == 0 files in the train slice.
            self.train_dataloader = WhisperFinetuneDataloader(
                (0.0, 1.0), seed=seed, **dl_kwargs)
        try:
            self.val_dataloader = WhisperFinetuneDataloader(
                (0.9, 1.0), seed=seed + 1, **dl_kwargs)
        except FileNotFoundError:
            # Tiny corpora: fall back to a reshuffled train slice.
            self.val_dataloader = WhisperFinetuneDataloader(
                (0.0, 1.0), seed=seed + 1, **dl_kwargs)

        warmup = min(warmup_updates, max(updates - 1, 0))
        total = max(updates, warmup + 1)
        self.lr_schedule = warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup, total, final_learning_rate)
        inner = (AdamW(self.lr_schedule) if optimizer == "adamw"
                 else Adafactor(self.lr_schedule))
        self.optimizer = MultiSteps(inner, accumulated_batches)
        self._init_state()

    # ------------------------------------------------------------------
    @property
    def _provenance_path(self) -> Path:
        return self.out_dir / "finetune_checkpoint.meta.json"

    def _check_provenance(self) -> None:
        """A checkpoint in ``out_dir`` written by a run from a DIFFERENT
        source or architecture would silently override the weights given
        here: refuse on mismatch."""
        meta = {"src": str(self.src_dir) if self.src_dir else None,
                "cfg": asdict(self.cfg),
                "lora": ({"rank": self.lora_rank, "alpha": self.lora_alpha,
                          "targets": self.lora_targets}
                         if self.lora_rank else None)}
        if self.checkpoint_path.exists() and self._provenance_path.exists():
            prev = json.loads(self._provenance_path.read_text())
            if prev != meta:
                raise ValueError(
                    f"{self.checkpoint_path} was written by a different "
                    f"fine-tune run (source {prev.get('src')!r}, now "
                    f"{meta['src']!r}) — resuming would silently ignore "
                    "the weights given now. Delete the checkpoint (or pick "
                    "a fresh out_dir) to start over.")
        if self.mesh is not None:
            barrier("provenance")  # every rank has read it before it is rewritten
        if is_coordinator():
            self._provenance_path.write_text(json.dumps(meta))

    def _init_state(self) -> None:
        """The trained leaves (JAX path -> (tensor, layout view)), the
        optimizer state, and a resume from ``checkpoint_path``."""
        self._check_provenance()
        if self.lora_rank:
            # Frozen base + a small trainable adapter tree: the optimizer
            # and the checkpoint hold only the adapters.
            gen = torch.Generator(device=self.device).manual_seed(0x10_4A)
            adapters = lora_mod.init_lora(gen, self.model, self.lora_rank,
                                          self.lora_targets)
            self._shard()  # the adapters take the whole layers' shapes first
            if self.freeze_encoder:
                adapters = {k: v for k, v in adapters.items()
                            if not k.startswith("encoder/")}
                if not adapters:
                    raise ValueError(
                        "freeze_encoder left no LoRA targets (the targets "
                        f"regex {self.lora_targets!r} only matched encoder "
                        "modules)")
            leaves = lora_mod.attach_lora(self.model, adapters, self.lora_scale)
            self._train = {k: (p, lambda t: t) for k, p in leaves.items()}
        else:
            self._shard()
            frozen = (lambda k: k.startswith("encoder/")) if self.freeze_encoder \
                else (lambda k: False)
            named = {k: (t, view) for k, (t, view) in nn_params.jax_parameters(self.model).items()
                     if isinstance(t, nn.Parameter)}
            for k, (t, _) in named.items():
                t.requires_grad_(not frozen(k))
            self._train = trainable(named, frozen)
        for t, _view in self._train.values():
            t.requires_grad_(True)
        self._leaves = {k: view(t) for k, (t, view) in self._train.items()}
        self._prepare_optimizer(layout_of(self.model))
        self.opt_state = self.optimizer.init(self._leaves)
        self.step = self._restore(self._checkpoint_leaves(), self._nest)
        # A resumed run continues the batch stream where the checkpoint
        # left it (the JAX package restarts it), so it ends where an
        # uninterrupted run would.
        self.train_dataloader.skip(self.step)

    def _shard(self) -> None:
        if self.mesh is not None:
            shard_params(self.model, self.mesh, WHISPER_RULES)

    def _grad_axes(self, key: str) -> tuple:
        # An adapter on a cut layer holds this rank's part of its gradient.
        if self.lora_rank and lora_mod.sharded_adapter(self.model, key):
            return (AXIS_DATA, AXIS_MODEL)
        return (AXIS_DATA,)

    def _checkpoint_leaves(self):
        """What a checkpoint's ``params`` holds, by '/'-joined path in the JAX
        layout: every parameter (the JAX package's ``state.params``), or
        the adapters under LoRA."""
        if self.lora_rank:
            return dict(self._leaves)
        return {k: view(t) for k, (t, view) in nn_params.jax_parameters(self.model).items()
                if isinstance(t, nn.Parameter)}

    def _nest(self, flat):
        """The JAX tree of checkpoint leaves: nested module dicts, or the
        flat ``{"<module/path>": {"a", "b"}}`` adapter tree under LoRA."""
        if not self.lora_rank:
            return unflatten_tree(flat)
        tree = {}
        for k, v in flat.items():
            path, leaf = k.rsplit("/", 1)
            tree.setdefault(path, {})[leaf] = v
        return tree

    # ------------------------------------------------------------------
    def _mel(self, audio: torch.Tensor) -> torch.Tensor:
        return fused_whisper_log_mel(audio.float(), n_mels=self.cfg.n_mels)

    def _loss(self, model, mel, tokens, mask) -> torch.Tensor:
        with self._autocast():
            logits = model(mel, tokens)
        return masked_ce_loss(logits, tokens, mask, self.mesh)

    def _batch_loss(self, audio, tokens, mask) -> torch.Tensor:
        """The loss whose gradient a train step takes (the distiller
        replaces it)."""
        with torch.no_grad():
            mel = self._mel(audio)
        return self._loss(self.model, mel, tokens, mask)

    def _eval_context(self):
        """Full forwards with the merged weights: under LoRA each merge is
        computed once for the block (``parametrize.cached``)."""
        return parametrize.cached() if self.lora_rank else contextlib.nullcontext()

    @torch.no_grad()
    def _val_loss(self, audio, tokens, mask) -> torch.Tensor:
        with self._eval_context():
            return self._loss(self.model, self._mel(audio), tokens, mask)

    @torch.no_grad()
    def _decode_samples(self, audio, prompt):
        model = self.model
        with self._eval_context(), self._autocast():
            xa = model.encode_audio(self._mel(audio))
            ckv = model.cross_kvs(xa, quantize="int8")
            caches = model.init_caches(prompt.shape[0], quantized=True)
            step = make_whisper_step_fn(model, ckv)
            return greedy_decode(step, caches, prompt,
                                 min(self.cfg.n_text_ctx,
                                     self.train_dataloader.max_target_len),
                                 self.table.eot)

    # ------------------------------------------------------------------
    def _render(self, row, mask=None) -> str:
        ids = [int(t) for t in row]
        if mask is not None:
            nz = np.nonzero(mask)[0]
            ids = ids[:int(nz[-1]) + 1] if len(nz) else []
        if self.table.eot in ids:
            ids = ids[:ids.index(self.table.eot)]
        return self.table.decode_text(ids)

    def _validate(self, update: int) -> float:
        val_batch = self.val_dataloader.get_prepared_batch()
        # Kept so subclasses (the distiller's agreement) report on the SAME
        # batch as the validation loss.
        self._last_val_batch = val_batch
        placed = self._place(val_batch)
        val_loss = float(data_sum(self._val_loss(*placed), self.mesh))
        n = min(self.validation_samples, len(val_batch[0]))
        # Each sample decodes under its OWN prompt (sot/language/task as
        # the dataloader built it); the prompt length is constant.
        plen = len(self.table.sot_sequence(
            self.table.languages[0], self.train_dataloader.task,
            timestamps=self.train_dataloader.timestamps))
        decoded = self._decode_rows(lambda a, p: self._decode_samples(a, p)[0],
                                    placed[0][:n], placed[1][:n, :plen])
        if self.metrics is None:
            return val_loss
        decoded = decoded[:n]  # the coordinator's rows
        correct = [self._render(t[plen:], m[plen:])
                   for t, m in zip(val_batch[1][:n], val_batch[2][:n])]
        predicted = [self._render(row[plen:]) for row in decoded]
        self.metrics.write_validation(correct, predicted, [], [])
        return val_loss

    # ------------------------------------------------------------------
    def run(self, progress: bool = False) -> Path:
        """Train ``updates`` applied updates; ``update_losses`` keeps each
        update's mean mini-step loss. Exports at the end."""
        self._run_updates(self.updates, self.accumulated_batches, self.validation_frequency,
                          progress, self.export)
        return self.out_dir

    def _save_checkpoint(self, ckpt: Optional[AsyncCheckpointer]) -> None:
        """A host snapshot of (step, params, optimizer state), written by
        the checkpointer's thread (the coordinator's; every rank gathers)."""
        params, opt_state = self._host_state(self._checkpoint_leaves())
        if ckpt is not None:
            ckpt.save(self.step, self._nest(params), opt_state)

    def export(self) -> Path:
        """The tuned weights as an HF checkpoint dir (``nn/export.py``).
        Under LoRA, also the bare adapter (``lora_adapter.msgpack`` + meta),
        re-applicable to the same base."""
        from yoho_tpu_torch.nn.export import export_hf_whisper

        with self._eval_context():
            params = self._full_params(self.model)
        if not is_coordinator():
            return self.out_dir
        if self.lora_rank:
            lora_mod.save_adapter(
                self.out_dir, lora_mod.adapters_of(self.model), rank=self.lora_rank,
                alpha=self.lora_alpha, targets=self.lora_targets,
                extra_meta={"src": str(self.src_dir) if self.src_dir else None})
        return export_hf_whisper(params, self.cfg, self.out_dir, src_dir=self.src_dir)
