"""Training dataloaders: generic multiprocessing prefetch + transcription.

Capability parity with ``train/utils/base_dataloader.py`` (worker pool fed
by per-worker task queues, bounded shared batch queue, round-robin refill,
epoch hook, sync mode) and ``train/utils/dataloaders.py`` (SRT+audio corpus
indexing, greedy utterance packing, randomized context padding,
augmentation, timestamp/voiceprint token injection, loss-mask construction).

Beyond parity: deterministic per-batch RNG seeding (reproducible batches in
and out of worker processes) and an actually-honored
``speechless_sample_ratio`` — the reference declares it but never consumes
it (``train/utils/config.py:33``, SURVEY.md §2.1).

The port's copy of the JAX package's ``train/dataloader.py`` (``Dataloader``
and ``TranscriptionDataloader``): batches are numpy arrays made on the host,
as in the JAX package, and the same seed gives the same batches in both.
``TranscriptionDataloader`` renders the YOHO targets (stage 1, the
``ASRTrainer``); ``train/whisper_finetune.py`` renders its own whisper
targets. ``AudioChunkDataloader`` (stage 2) and ``SpeakerDataloader``
(stage 3) draw from the same per-batch numpy streams as JAX's.
"""

from __future__ import annotations

import bisect
import datetime as dt
import multiprocessing as mp
import os
import re
import warnings
from abc import ABC, abstractmethod
from collections import OrderedDict
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from yoho_tpu_torch.audio.augment import augmenter
from yoho_tpu_torch.audio.io import load_audio_f32
from yoho_tpu_torch.core.config import SessionConfig
from yoho_tpu_torch.text.corpus import iter_transcripts
from yoho_tpu_torch.text.srt import parse_srt
from yoho_tpu_torch.text.standardize import standardize_text
from yoho_tpu_torch.text.tokenizer import EOT, SOT, VOICEPRINT

# Suffix search order = decode-cost order: raw/lossless fast paths first,
# so a `yoho cache-corpus` FLAC sitting next to the original mp3/m4a wins
# automatically (cli/cache_corpus.py).
# Control-token-shaped spans in subtitle text ("<|endoftranscript|>", a
# literal "<|t-5|>"): stripped from the data, so only the tokens the
# targets inject are special.
_SPECIALISH_RE = re.compile(r"<\|[^<>|]*\|>")

AUDIO_SUFFIXES = (".npy", ".flac", ".wav", ".mp3", ".mp4", ".m4a", ".ogg", ".opus")


def list_audio_files(directory: Path) -> List[Path]:
    """Audio files in ``directory``, ONE per stem (preferred suffix wins).

    Every directory-scanning loader must use this instead of a raw
    suffix filter: after ``yoho cache-corpus``, each clip exists as both
    original and .flac — counting both would silently duplicate the
    corpus (the transcript loader's per-stem suffix search is immune)."""
    by_stem: dict = {}
    if not directory.exists():
        return []
    for f in sorted(directory.iterdir()):
        suf = f.suffix.lower()
        if suf not in AUDIO_SUFFIXES:
            continue
        cur = by_stem.get(f.stem)
        if cur is None or (AUDIO_SUFFIXES.index(suf)
                           < AUDIO_SUFFIXES.index(cur.suffix.lower())):
            by_stem[f.stem] = f
    return [by_stem[s] for s in sorted(by_stem)]


class Dataloader(ABC):
    """Prefetching dataloader: subclasses implement ``get_num_batches`` and
    ``get_batch(idx)``; the base runs them in daemon worker processes."""

    def __init__(
        self,
        batch_size: int,
        max_queued_batches: int = 8,
        num_workers: int = 4,
        warmup_queue: bool = True,
        use_multiprocessing: bool = True,
        disable_warnings: bool = False,
    ):
        self.batch_size = batch_size
        self.max_queued_batches = max_queued_batches
        self.num_workers = max(1, num_workers)
        self.warmup_queue = warmup_queue
        self.use_multiprocessing = use_multiprocessing
        self.disable_warnings = disable_warnings
        self.current_batch_idx = 0
        # Epoch counter rides with every task so spawned workers (which
        # hold a pickled-at-spawn copy of self) can re-derive the epoch's
        # shuffle — on_epoch() must be a pure function of _epoch.
        self._epoch = getattr(self, "_epoch", 0)

        if self.use_multiprocessing:
            # spawn, not fork: PyTorch is multithreaded and fork() can deadlock.
            self._mp = mp.get_context("spawn")
            self._batch_queue: mp.Queue = self._mp.Queue(self.max_queued_batches)
            self._task_queues = [self._mp.Queue() for _ in range(self.num_workers)]
            self._start_workers()

    # ------------------------------------------------------------------
    @abstractmethod
    def get_num_batches(self) -> int: ...

    @abstractmethod
    def get_batch(self, idx: int) -> Any: ...

    def on_epoch(self) -> None:
        """Called when the batch index wraps."""

    def _cached_audio(self, path: Path, sample_rate: int) -> np.ndarray:
        """Per-process LRU over decoded corpus files: consecutive samples
        overwhelmingly come from the same file (indices pack per-file
        ranges), and a full re-decode per SAMPLE was most of the batch
        cost for long files."""
        cache = getattr(self, "_audio_cache", None)
        if cache is None:
            cache = self._audio_cache = OrderedDict()
        hit = cache.get(path)
        if hit is not None:
            cache.move_to_end(path)
            return hit
        audio = load_audio_f32(path, sample_rate)
        cache[path] = audio
        while len(cache) > 2:  # ~2 hour-files ≈ 0.5 GB ceiling
            cache.popitem(last=False)
        return audio

    @property
    def num_batches(self) -> int:
        return self.get_num_batches()

    @property
    def num_prepared_batches(self) -> int:
        return self._batch_queue.qsize()

    # ------------------------------------------------------------------
    def __getstate__(self):
        # Workers (spawn) pickle self through the Process target; strip the
        # sibling Process handles — children only need the queues + dataset.
        # The decoded-audio cache is per-process scratch (possibly hundreds
        # of MB) and must not ride the spawn pickle.
        state = dict(self.__dict__)
        state.pop("_workers", None)
        state.pop("_audio_cache", None)
        return state

    def _worker(self, idx: int) -> None:
        task_queue = self._task_queues[idx]
        while True:
            task = task_queue.get()
            if task is None:
                return
            epoch, batch_idx = task
            if epoch != self._epoch:
                # Catch up to the task's epoch (on_epoch is a pure
                # function of _epoch, so skipped epochs don't matter).
                self._epoch = epoch
                self.on_epoch()
            try:
                batch = self.get_batch(batch_idx)
            except Exception as e:  # noqa: BLE001 — surface, don't hang
                self._batch_queue.put(
                    {"__dataloader_error__": f"{type(e).__name__}: {e}"})
                raise
            self._batch_queue.put(batch)

    def _start_workers(self) -> None:
        for _ in range(self.max_queued_batches):
            self._enqueue_next_task()
        self._workers = [
            self._mp.Process(target=self._worker, args=(i,), daemon=True)
            for i in range(self.num_workers)
        ]
        for w in self._workers:
            w.start()
        import time as _time

        # Bounded warmup: prefill is an optimization, never a correctness
        # requirement — an unbounded busy-wait here hangs __init__ whenever
        # the queue can never fill AND the workers look alive (observed
        # in-suite: spawned workers stuck >10 min booting in a long-lived
        # parent; faulthandler dump pointed exactly at this loop). Any
        # worker error still surfaces on the first get_prepared_batch.
        deadline = _time.monotonic() + float(
            os.environ.get("YOHO_DATALOADER_WARMUP_TIMEOUT", "120"))
        while self.warmup_queue and not self._batch_queue.full():
            # ANY dead worker ends warmup: its remaining queued tasks are
            # lost, so the queue may never reach full — waiting on it would
            # hang __init__. Its error sentinel (if it raised) surfaces on
            # the first get_prepared_batch.
            if any(not w.is_alive() for w in self._workers):
                break
            if _time.monotonic() > deadline:
                if not self.disable_warnings:
                    warnings.warn(
                        "dataloader warmup did not fill the batch queue "
                        "within the warmup timeout; continuing without a "
                        "full prefetch buffer (workers may be slow to "
                        "boot — YOHO_DATALOADER_WARMUP_TIMEOUT overrides)")
                break
            _time.sleep(0.02)

    def _enqueue_next_task(self) -> None:
        widx = self.current_batch_idx % self.num_workers
        # Don't feed tasks to a dead worker's queue (they would be lost and
        # starve the pipeline); reroute to a surviving worker. Before
        # _start_workers there are no Process handles yet — keep round-robin.
        workers = getattr(self, "_workers", None)
        if workers and not workers[widx].is_alive():
            alive = [i for i, w in enumerate(workers) if w.is_alive()]
            if alive:
                widx = alive[self.current_batch_idx % len(alive)]
        self._task_queues[widx].put((self._epoch, self.current_batch_idx))
        self.current_batch_idx = int((self.current_batch_idx + 1) % self.num_batches)
        if self.current_batch_idx == 0:
            self._epoch += 1
            self.on_epoch()

    def get_prepared_batch(self):
        if not self.use_multiprocessing:
            batch = self.get_batch(self.current_batch_idx)
            self.current_batch_idx = int((self.current_batch_idx + 1) % self.num_batches)
            if self.current_batch_idx == 0:
                self._epoch += 1
                self.on_epoch()
            return batch

        if not self.disable_warnings and self.num_prepared_batches == 0:
            warnings.warn(
                f"Batches aren't preparing fast enough; consider optimizing "
                f"{type(self).__name__}.get_batch"
            )
        import queue as _queue

        while True:
            try:
                batch = self._batch_queue.get(timeout=60)
                break
            except _queue.Empty:
                dead = sum(1 for w in self._workers if not w.is_alive())
                if dead:
                    # A worker killed without an error sentinel (e.g.
                    # OOM-kill) lost its in-flight tasks; with the queue
                    # empty past the timeout the pipeline is starved —
                    # fail loudly instead of retrying forever.
                    raise RuntimeError(
                        f"{dead}/{self.num_workers} dataloader workers died "
                        "without reporting an error (killed? check worker "
                        "stderr / dmesg for OOM) and the batch queue is "
                        "empty — aborting instead of hanging") from None
        if isinstance(batch, dict) and "__dataloader_error__" in batch:
            raise RuntimeError(
                f"dataloader worker failed: {batch['__dataloader_error__']}")
        self._enqueue_next_task()
        return batch

    def skip(self, n: int) -> None:
        """Advance the batch stream by ``n`` batches: in-process by moving
        the index (the batches are a pure function of it), with workers by
        taking them. A trainer resumed at step n then sees the batches an
        uninterrupted run would."""
        if self.use_multiprocessing:
            for _ in range(n):
                self.get_prepared_batch()
            return
        for _ in range(n):
            self.current_batch_idx = int((self.current_batch_idx + 1) % self.num_batches)
            if self.current_batch_idx == 0:
                self._epoch += 1
                self.on_epoch()

    def terminate(self) -> None:
        if not self.use_multiprocessing:
            return
        import queue as _queue
        import time as _time

        for q in self._task_queues:
            q.put(None)
        # Workers blocked in _batch_queue.put() can't reach their None
        # sentinel until the queue has room — keep DRAINING while they wind
        # down (a one-shot drain races: a worker can refill the queue right
        # after it looks empty, then block again forever).
        deadline = _time.monotonic() + 10.0
        while (any(w.is_alive() for w in self._workers)
               and _time.monotonic() < deadline):
            try:
                self._batch_queue.get(timeout=0.1)
            except _queue.Empty:
                pass
        for w in self._workers:
            w.join(timeout=1)
            if w.is_alive():
                # Still stuck (e.g. mid-decode of a huge file): hard-stop.
                # Safe: workers hold no artifact locks, only scratch caches.
                w.terminate()
        for w in self._workers:
            w.join(timeout=5)


# ---------------------------------------------------------------------------
class TranscriptionDataloader(Dataloader):
    """SRT+audio corpus -> (audio, tokens, loss_mask) batches.

    Sample recipe (parity with ``dataloaders.py:77-218``): locate utterance
    by global index, greedily append following utterances while they fit
    ``max_input_seconds``, randomize leading/trailing context padding within
    neighbor bounds, slice + augment audio, reject-and-advance when the
    augmented clip exceeds ``n_samples``, zero-pad. Targets wrap each
    utterance in frame-resolution timestamp tokens and a voiceprint slot;
    the loss mask zeroes padding and voiceprint positions.
    """

    def __init__(
        self,
        data_slice: Tuple[float, float],
        config: SessionConfig,
        tokenizer,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        speechless_ratio: Optional[float] = None,
        augment: bool = True,
        return_spans: bool = False,
        max_utterances: int = 8,
        shard: Tuple[int, int] = (0, 1),
        **kwargs,
    ):
        self.return_spans = return_spans
        self.max_utterances = max_utterances
        # Multi-host: ``shard=(process_index, process_count)`` strides the
        # epoch permutation so each process draws a DISJOINT slice of
        # every epoch (together the shards cover the corpus exactly once).
        self.shard = shard
        self.config = config
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.speechless_ratio = (
            config.hyperparameters.transcribe_pretrain.speechless_sample_ratio
            if speechless_ratio is None
            else speechless_ratio
        )
        self._epoch = 0

        transcripts_dir = Path(config.dataset.noisy) / "transcripts"
        all_paths = sorted(transcripts_dir.iterdir()) if transcripts_dir.exists() else []
        i = int(data_slice[0] * len(all_paths))
        j = int(data_slice[1] * len(all_paths))
        all_paths = all_paths[i:j]

        sizes: List[int] = []
        paths: List[Tuple[Path, Path]] = []
        langs: List[str] = []
        audio_dir = Path(config.dataset.noisy) / "audio"
        for path, lang, subs in iter_transcripts(all_paths,
                                                 config.language_whitelist):
            audio_path = None
            for suf in AUDIO_SUFFIXES:
                cand = audio_dir / path.with_suffix(suf).name
                if cand.exists():
                    audio_path = cand
                    break
            if audio_path is None:
                continue
            sizes.append(len(subs))
            paths.append((path, audio_path))
            langs.append(lang)

        if not paths:
            raise FileNotFoundError(
                f"No usable (transcript, audio) pairs under {config.dataset.noisy}"
            )

        self.sizes = np.cumsum(np.asarray(sizes, np.int64))
        self.paths = paths
        self.langs = langs
        self.index_table = self._epoch_table(0)
        if len(self.index_table) == 0:
            raise ValueError(
                f"corpus has {int(self.sizes[-1])} utterances — fewer than "
                f"the {self.shard[1]} processes sharding it")

        super().__init__(batch_size, **kwargs)

    def _epoch_table(self, epoch: int) -> np.ndarray:
        """Sample order for ``epoch`` — a PURE function of (seed, epoch)
        so spawned workers reconstruct it from the task's epoch tag even
        if they never saw the intermediate epochs. Under multi-host
        ``shard``-ing, this process keeps every ``count``-th entry of the
        (seed-identical) global order — disjoint across processes."""
        if not self.shuffle:
            table = np.arange(self.sizes[-1], dtype=np.int64)
        else:
            table = np.random.default_rng(
                (self.seed, epoch)).permutation(int(self.sizes[-1]))
        idx, count = self.shard
        if count > 1:
            # Truncate to a multiple of count FIRST so every process sees
            # the same number of entries (and so the same batches/epoch).
            # Uneven shards would advance processes' epoch counters at
            # different rates, putting them on DIFFERENT epoch
            # permutations — strides of different permutations are not
            # disjoint, silently breaking the cover-once contract.
            table = table[: (len(table) // count) * count]
            return table[idx::count]
        return table

    # ------------------------------------------------------------------
    def get_num_batches(self) -> int:
        # At least one batch: sample indices wrap via the index table, so a
        # corpus smaller than one batch still yields full batches.
        return max(1, int(len(self.index_table) // self.batch_size))

    def on_epoch(self) -> None:
        # The base increments _epoch (parent: on wrap; workers: from the
        # task's epoch tag); the table is recomputed, never incrementally
        # shuffled — see _epoch_table.
        self.index_table = self._epoch_table(self._epoch)

    # ------------------------------------------------------------------
    def _randomize_padding(self, rng, start_time, end_time, speech_start, speech_end):
        """Random context around the speech span, bounded by neighbors and
        the model's input capacity (parity: ``dataloaders.py:77-90``)."""
        max_s = self.config.yoho.max_input_seconds
        duration = (speech_end - speech_start).total_seconds()
        pad_left = (speech_start - start_time).total_seconds()
        pad_left = rng.uniform(0, max(0.0, min(pad_left, max_s - duration)))
        start_time = speech_start - dt.timedelta(seconds=pad_left)
        duration = (speech_end - start_time).total_seconds()
        pad_right = (end_time - speech_end).total_seconds()
        pad_right = rng.uniform(0, max(0.0, min(pad_right, max_s - duration)))
        return start_time, speech_end + dt.timedelta(seconds=pad_right)

    def _load_sample(self, rng, sample_idx: int):
        """-> (audio [n_samples] f32, [(start_sample, end_sample, text)]) or
        (None, None) when the clip doesn't fit after augmentation."""
        cfg = self.config.yoho
        asset = bisect.bisect_right(self.sizes, sample_idx)
        transcript_path, audio_path = self.paths[asset]
        lang = self.langs[asset]
        subs = list(parse_srt(transcript_path.read_text(encoding="utf-8")))
        audio = self._cached_audio(audio_path, cfg.sample_rate)

        rel = int(sample_idx - (0 if asset == 0 else self.sizes[asset - 1]))
        rel = min(rel, len(subs) - 1)

        utterances = [subs[rel]]
        start_time = dt.timedelta() if rel == 0 else subs[rel - 1].end
        speech_start = subs[rel].start
        si = rel
        while si < len(subs) - 1:
            if (subs[si + 1].end - speech_start).total_seconds() >= cfg.max_input_seconds:
                break
            si += 1
            utterances.append(subs[si])
        speech_end = subs[si].end
        end_time = (
            dt.timedelta(seconds=len(audio) / cfg.sample_rate)
            if si >= len(subs) - 1
            else subs[si + 1].start
        )

        start_time, end_time = self._randomize_padding(
            rng, start_time, end_time, speech_start, speech_end
        )
        a = int(np.ceil(start_time.total_seconds() * cfg.sample_rate))
        b = int(np.floor(end_time.total_seconds() * cfg.sample_rate))
        clip = audio[max(a, 0) : max(b, 0)]

        if self.augment:
            clip = augmenter(clip, cfg.sample_rate, rng)
        if len(clip) > cfg.n_samples:
            return None, None
        clip = np.pad(clip, (0, cfg.n_samples - len(clip)))

        rel_utts = [
            (
                int(np.floor((u.start - start_time).total_seconds() * cfg.sample_rate)),
                int(np.ceil((u.end - start_time).total_seconds() * cfg.sample_rate)),
                standardize_text(u.content, lang=lang),
            )
            for u in utterances
        ]
        return clip.astype(np.float32), rel_utts

    def _speechless_sample(self, rng):
        """Negative sample: ambient noise (or synthesized low noise) with an
        empty transcript — implements the reserved speechless_sample_ratio."""
        cfg = self.config.yoho
        # The ambient dir is immutable per run: list it once (lazily, so
        # each spawn worker builds its own copy) and decode through the
        # shared LRU instead of re-scanning + re-decoding per sample.
        files = getattr(self, "_ambient_files", None)
        if files is None:
            files = list_audio_files(Path(self.config.dataset.ambient) / "audio")
            self._ambient_files = files
        if files:
            audio = self._cached_audio(files[int(rng.integers(len(files)))],
                                       cfg.sample_rate)
            if len(audio) > cfg.n_samples:
                off = int(rng.integers(0, len(audio) - cfg.n_samples))
                audio = audio[off : off + cfg.n_samples]
        else:
            audio = (rng.standard_normal(cfg.n_samples) * 1e-3).astype(np.float32)
        if self.augment:
            audio = augmenter(audio, cfg.sample_rate, rng)
        audio = np.pad(audio, (0, max(0, cfg.n_samples - len(audio))))[: cfg.n_samples]
        return audio.astype(np.float32), []

    # ------------------------------------------------------------------
    def get_batch(self, idx: int):
        """-> (audio (B, n_samples) f32, tokens (B, max_text_len) int32,
        loss_mask (B, max_text_len) uint8), and with ``return_spans`` the
        per-utterance sample spans (B, U, 2) int32 and their validity (B, U)
        uint8, U = ``max_utterances``. Each utterance is rendered as
        ``<|t-s|>text<|t-e|><|voiceprint|>`` after SOT (frames ``sample //
        stft_hop``, clipped to the last frame), then EOT; targets are cut at
        ``max_text_len``, and the mask zeroes padding and voiceprint slots."""
        cfg = self.config.yoho
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        i = idx * self.batch_size

        samples = []
        for k in range(self.batch_size):
            if self.speechless_ratio > 0 and rng.uniform() < self.speechless_ratio:
                samples.append(self._speechless_sample(rng))
                continue
            sample_idx = int(self.index_table[(i + k) % len(self.index_table)])
            # Reject-and-advance, bounded by one wrap of the corpus.
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
            samples.append((audio, utts))

        audio_batch = np.stack([s[0] for s in samples])
        tokens_batch = []
        for _audio, utts in samples:
            transcript = SOT
            for start, end, content in utts:
                sf = int(min(start // cfg.stft_hop, cfg.max_audio_len - 1))
                ef = int(min(end // cfg.stft_hop, cfg.max_audio_len - 1))
                content = _SPECIALISH_RE.sub("", content)
                transcript += f"<|t-{sf}|>{content}<|t-{ef}|>{VOICEPRINT}"
            transcript += EOT
            tokens_batch.append(self.tokenizer.encode(transcript))

        T = cfg.max_text_len
        lengths = np.asarray([len(t) for t in tokens_batch])
        tokens = np.zeros((self.batch_size, T), np.int32)
        for r, t in enumerate(tokens_batch):
            tokens[r, : min(len(t), T)] = t[:T]

        loss_mask = np.zeros((self.batch_size, T), np.uint8)
        vp_id = self.tokenizer.voiceprint_id
        for r, L in enumerate(lengths):
            loss_mask[r, : min(int(L), T)] = 1
            loss_mask[r][tokens[r] == vp_id] = 0  # voiceprint slots carry no CE loss

        if not self.return_spans:
            return audio_batch, tokens, loss_mask

        # Spans in the order of the voiceprint tokens: stage 4 pairs span u
        # with the u-th <|voiceprint|> slot.
        U = self.max_utterances
        spans = np.zeros((self.batch_size, U, 2), np.int32)
        span_valid = np.zeros((self.batch_size, U), np.uint8)
        for r, (_audio, utts) in enumerate(samples):
            for u, (start, end, _text) in enumerate(utts[:U]):
                spans[r, u] = (max(0, start), min(cfg.n_samples, max(0, end)))
                span_valid[r, u] = 1
        return audio_batch, tokens, loss_mask, spans, span_valid


# ---------------------------------------------------------------------------
class AudioChunkDataloader(Dataloader):
    """Audio-only fixed-length chunks from the noisy+clean corpora (stage 2
    reconstruction pretraining needs no transcripts)."""

    def __init__(self, config: SessionConfig, batch_size: int, seed: int = 0,
                 augment: bool = False, dirs: Optional[Sequence[Path]] = None,
                 shard: Tuple[int, int] = (0, 1), **kwargs):
        self.config = config
        self.seed = seed
        self.augment = augment
        self.shard = shard
        cfg = config.yoho

        files: List[Path] = []
        for d in (dirs or [config.dataset.noisy, config.dataset.clean]):
            files += list_audio_files(Path(d) / "audio")
        if not files:
            raise FileNotFoundError(
                f"No audio files under {[str(d) for d in (dirs or [])] or 'noisy/clean'}"
            )

        self.files = files
        # Chunk index: (file_idx, chunk_idx) pairs, computed from durations
        # (cached decode: get_batch re-reads the same files immediately).
        self.chunks: List[Tuple[int, int]] = []
        for fi, f in enumerate(files):
            audio = self._cached_audio(f, cfg.sample_rate)
            n = max(1, len(audio) // cfg.n_samples)
            self.chunks += [(fi, ci) for ci in range(n)]
        if shard[1] > 1:
            # Multi-host: disjoint chunk stride per process.
            sharded = self.chunks[shard[0]::shard[1]]
            if not sharded:
                raise ValueError(
                    f"{len(self.chunks)} chunks — fewer than the "
                    f"{shard[1]} processes sharding them")
            self.chunks = sharded
        super().__init__(batch_size, **kwargs)

    def get_num_batches(self) -> int:
        return max(1, len(self.chunks) // self.batch_size)

    def get_batch(self, idx: int):
        cfg = self.config.yoho
        # Fold the epoch so augmentation noise differs across epochs
        # (chunks themselves are deterministic slices).
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        out = np.zeros((self.batch_size, cfg.n_samples), np.float32)
        for k in range(self.batch_size):
            fi, ci = self.chunks[(idx * self.batch_size + k) % len(self.chunks)]
            audio = self._cached_audio(self.files[fi], cfg.sample_rate)
            start = ci * cfg.n_samples
            clip = audio[start : start + cfg.n_samples]
            if self.augment:
                clip = augmenter(clip, cfg.sample_rate, rng)[: cfg.n_samples]
            out[k, : len(clip)] = clip
        return (out,)


class SpeakerDataloader(Dataloader):
    """Speaker-labeled clips for contrastive training (stage 3).

    Dataset layout: ``dataset.speakers/<speaker_name>/*.wav``. Each batch
    holds ``batch_size // clips_per_speaker`` distinct speakers with
    ``clips_per_speaker`` (augmented) clips each -> in-batch positives.
    Returns (audio (B, n_samples) f32, speaker_ids (B,) int32).
    """

    def __init__(self, config: SessionConfig, batch_size: int,
                 clips_per_speaker: int = 2, seed: int = 0, augment: bool = True,
                 shard: Tuple[int, int] = (0, 1), **kwargs):
        if batch_size % clips_per_speaker:
            raise ValueError(
                f"per-process batch size {batch_size} must be divisible "
                f"by clips_per_speaker={clips_per_speaker} (on a cluster "
                "the global batch_size is divided by process_count first, "
                "so batch_size/process_count must divide it)")
        self.config = config
        self.clips_per_speaker = clips_per_speaker
        self.seed = seed
        self.augment = augment
        # Sampling (not permutation) based: decorrelate processes by
        # folding the shard index into every batch's RNG stream.
        self.shard = shard
        cfg = config.yoho

        root = Path(config.dataset.speakers)
        self.speakers: List[Tuple[str, List[Path]]] = []
        if root.exists():
            for spk_dir in sorted(p for p in root.iterdir() if p.is_dir()):
                files = list_audio_files(spk_dir)
                if files:
                    self.speakers.append((spk_dir.name, files))
        if len(self.speakers) < 2:
            raise FileNotFoundError(
                f"Need >=2 speaker dirs with audio under {root} "
                "(layout: speakers/<name>/*.wav)"
            )
        super().__init__(batch_size, **kwargs)

    def get_num_batches(self) -> int:
        total_clips = sum(len(f) for _n, f in self.speakers)
        return max(1, total_clips // self.batch_size)

    def get_batch(self, idx: int):
        cfg = self.config.yoho
        # Sampling-based loader: without the epoch in the stream, every
        # epoch would replay epoch 1's speaker/clip/augment draws exactly.
        rng = np.random.default_rng((self.seed, self.shard[0],
                                     self._epoch, idx))
        n_spk = self.batch_size // self.clips_per_speaker
        chosen = rng.choice(len(self.speakers), size=n_spk,
                            replace=len(self.speakers) < n_spk)
        audio = np.zeros((self.batch_size, cfg.n_samples), np.float32)
        ids = np.zeros((self.batch_size,), np.int32)
        row = 0
        for spk_idx in chosen:
            _name, files = self.speakers[int(spk_idx)]
            for _c in range(self.clips_per_speaker):
                f = files[int(rng.integers(len(files)))]
                clip = load_audio_f32(f, cfg.sample_rate)
                if len(clip) > cfg.n_samples:
                    off = int(rng.integers(0, len(clip) - cfg.n_samples + 1))
                    clip = clip[off : off + cfg.n_samples]
                if self.augment:
                    clip = augmenter(clip, cfg.sample_rate, rng)[: cfg.n_samples]
                audio[row, : len(clip)] = clip
                ids[row] = int(spk_idx)
                row += 1
        return audio, ids
