"""Continuous batching for greedy serving: the request-level batcher.

The JAX package's ``infer/continuous.py``. Requests' windows are admitted
into freed decode slots between K-token chunks instead of waiting for a
whole batch to finish. The slot machinery lives in
``infer/slot_engine.py`` (the engine and its :class:`EngineSpec` program
interface), the speculative programs in ``infer/continuous_spec.py``; this
module owns the threading: request queueing, windowing, admission between
chunks, cancellation, fallback retries and assembly.

One worker thread owns the engine, the model and every CUDA call: it also
assembles a finished request (the fallback ladder's re-decodes and the
word-timestamp pass run on the device), where the JAX package assembles
on the submitting thread. The submitting threads only block and read the
result, and touch no device tensor.

Greedy parity: a window decoded through slots gives the same tokens and
quality signals as ``greedy_decode`` (``tests/test_torch_continuous.py``).
Whisper family; slot decodes are greedy (no beams); speculative
draft-verify and the temperature fallback ladder both compose (rungs > 0
re-decode in the assemble step).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

from yoho_tpu_torch.infer.slot_engine import ContinuousWhisperDecoder, _Window


@dataclass(eq=False)
class _Request:
    audio: Any
    sample_rate: Optional[int]
    language: Optional[str]
    vad: Optional[bool] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    windows: List[_Window] = field(default_factory=list)
    starts: List[int] = field(default_factory=list)
    vmap: Any = None
    original: Any = None
    lang: Optional[str] = None
    lang_prob: Optional[float] = None  # softmax prob when auto-detected
    remaining: int = 0
    cancelled: bool = False


class ContinuousBatcher:
    """Drop-in for :class:`yoho_tpu_torch.infer.batching.MicroBatcher`
    backed by the slot engine: requests' windows are admitted into freed
    decode slots between K-token chunks instead of waiting for whole-batch
    completion. Callers block in :meth:`submit`; one worker thread owns the
    engine and every CUDA call."""

    def __init__(self, transcriber, max_batch: Optional[int] = None,
                 max_wait_ms: float = 0.0, chunk_tokens: int = 16,
                 max_pending: Optional[int] = None):
        del max_wait_ms  # admission happens between chunks; no wait knob
        self.t = transcriber
        self.engine = ContinuousWhisperDecoder(
            transcriber, slots=max_batch, chunk_tokens=chunk_tokens)
        self.max_pending = max_pending
        self._queue: List[_Request] = []  # requests awaiting windowing
        self._window_queue: List[_Window] = []
        self._cv = threading.Condition()
        self._closed = False
        self.requests_served = 0
        self.requests_failed = 0
        self.requests_rejected = 0
        self.requests_cancelled = 0
        self.inflight = 0
        self.batches_dispatched = 0  # chunk count (statz compatibility)
        self._latencies = deque(maxlen=512)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, audio, sample_rate: Optional[int] = None,
               language: Optional[str] = None,
               vad: Optional[bool] = None,
               prompt: Optional[str] = None,
               temperature: Optional[float] = None,
               cancelled: Optional[Callable[[], bool]] = None):
        """``language``/``vad``/``cancelled`` are per-request overrides
        (same contract as :meth:`MicroBatcher.submit`). A cancelled
        request's queued windows are dropped and its occupied slots are
        RELEASED at the next chunk boundary — the big win over the
        micro-batcher, where a dispatched batch runs to completion.

        ``prompt``/``temperature`` are NOT supported here: the slot
        engine's two programs fix the prompt length and the temperature
        ladder; use the micro-batching engine for those."""
        from yoho_tpu_torch.infer.batching import RequestCancelled, ServerOverloaded

        if prompt is not None or temperature is not None:
            raise ValueError(
                "per-request prompt/temperature need the micro-batching "
                "engine (drop --continuous): the slot engine's programs "
                "fix the prompt shape and temperature ladder")

        req = _Request(audio, sample_rate, language, vad)
        t0 = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            if (self.max_pending is not None
                    and self.inflight >= self.max_pending):
                self.requests_rejected += 1
                raise ServerOverloaded(
                    f"{self.inflight} requests in flight >= max_pending "
                    f"{self.max_pending}")
            self.inflight += 1
            self._queue.append(req)
            self._cv.notify()
        if cancelled is None:
            req.done.wait()
        else:
            while not req.done.wait(timeout=0.25):
                if cancelled():
                    with self._cv:
                        req.cancelled = True
                        self._cv.notify()  # worker frees queued work/slots
                    raise RequestCancelled("client went away")
        if req.error is not None:
            raise req.error
        self._latencies.append(time.monotonic() - t0)
        return req.result

    def stats(self) -> dict:
        from yoho_tpu_torch.infer.batching import _percentiles

        with self._cv:
            d = {
                "requests_served": self.requests_served,
                "requests_failed": self.requests_failed,
                "requests_rejected": self.requests_rejected,
                "requests_cancelled": self.requests_cancelled,
                "batches_dispatched": self.batches_dispatched,
                "inflight": self.inflight,
                "queue_depth": len(self._queue) + len(self._window_queue),
                "active_slots": self.engine.slots - self.engine.free_slots,
            }
            d.update(_percentiles(list(self._latencies)))
        return d

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=10)

    # ------------------------------------------------------------------
    def _prepare(self, req: _Request) -> None:
        """Host-side request prep: resample, VAD, language, windowing."""
        from yoho_tpu_torch.infer.longform import chunk_audio

        t = self.t
        audio = t._prepare_audio(req.audio, req.sample_rate)
        req.original = audio
        audio, req.vmap = t._apply_vad(audio, req.vad)
        if len(audio) == 0:
            req.lang = req.language or t.language
            req.remaining = 0
            return
        if req.language is not None:
            req.lang = req.language
        elif t.language is not None:
            req.lang = t.language
        else:
            (req.lang,), (req.lang_prob,) = t.detect_language_many(
                [audio], return_probs=True)
        prompt = np.asarray(t._prompt_ids(req.lang), np.int32)
        windows, starts = chunk_audio(audio, t.chunk_samples,
                                      t.stride_samples)
        req.starts = list(starts)
        req.windows = [_Window(w, prompt, req=req) for w in windows]
        req.remaining = len(req.windows)

    def _assemble(self, req: _Request) -> None:
        """All windows decoded -> TranscriptionResult. Per-window parsing
        and quality here; the request-level tail (stitch, remap, the
        hallucination filter, text) is Transcriber._finalize_request,
        SHARED with transcribe_many so the two paths cannot drift."""
        t = self.t
        per_window = []
        n = len(req.windows)
        if n:
            lengths = np.asarray([w.length for w in req.windows])
            aux = {
                "sum_logprob": np.asarray([w.sum_logprob
                                           for w in req.windows]),
                "no_speech_prob": np.asarray([w.no_speech_prob
                                              for w in req.windows]),
                "used_temperature": np.zeros(n, np.float32),
            }
            # One mel computation per S-window group, shared between the
            # fallback ladder and the teacher-forced post-passes (both
            # group windows identically; keyed by group start index).
            mel_cache: dict = {}
            if len(t.temperatures) > 1:
                lengths = self._fallback_retry(req, lengths, aux, mel_cache)
            silent = t._silent_mask(lengths, aux)
            segs = [[] if silent[j] else
                    t._tokens_to_segments(req.windows[j].tokens,
                                          int(lengths[j]))
                    for j in range(n)]
            t._attach_quality(segs, lengths, aux)
            if t.word_timestamps and t.token_table.text_backend is not None:
                self._post_pass(req, lambda mel, tok, sl: t._attach_words(
                    mel, tok, lengths[sl], segs[sl]), mel_cache)
            per_window = segs
        req.result = t._finalize_request(per_window, req.starts, req.vmap,
                                         req.original, req.lang,
                                         language_probability=req.lang_prob)

    def _group_mel(self, group, start: int, mel_cache: dict):
        """Features for one pad-to-slot-count window group, computed at
        most once per request (``mel_cache`` is keyed by the group's
        start index and shared by the fallback ladder and post-passes)."""
        if start in mel_cache:
            return mel_cache[start]
        t = self.t
        windows = np.zeros((self.engine.slots, t.chunk_samples), np.float32)
        for j, w in enumerate(group):
            windows[j] = w.window
        mel = t._features(windows)
        mel_cache[start] = mel
        return mel

    def _post_pass(self, req: _Request, fn, mel_cache: dict) -> None:
        """Run a teacher-forced post-pass (the word-timestamp alignment;
        the batched path does it inside transcribe_many, here windows
        arrive from slots) over the request's windows in groups PADDED to
        the slot count, so one batch shape serves every request size.
        ``fn(mel, tokens, slice)`` receives the padded (S, ...) device
        batch and the request-relative window slice it covers."""
        S = self.engine.slots
        n = len(req.windows)
        for i in range(0, n, S):
            group = req.windows[i : i + S]
            tokens = np.full((S, self.engine.max_len), self.engine.eot,
                             np.int32)
            for j, w in enumerate(group):
                tokens[j] = w.tokens
            mel = self._group_mel(group, i, mel_cache)
            fn(mel, tokens, slice(i, i + len(group)))

    def _fallback_retry(self, req: _Request, lengths: np.ndarray, aux,
                        mel_cache: dict):
        """Whisper temperature-ladder parity: slot decodes ARE rung 0
        (greedy); windows failing the quality thresholds re-decode at
        rungs > 0 through the SAME `_run_fallback_ladder` the batched
        path uses, over groups padded to the slot count. Runs on the
        worker thread, so that handler threads touch no CUDA tensor; every
        slot waits while a window re-decodes. Returns the (possibly updated) lengths array; tokens and aux are
        updated in place (windows' `.tokens` included)."""
        t = self.t
        S = self.engine.slots
        n = len(req.windows)
        for i in range(0, n, S):
            group = req.windows[i : i + S]
            k = len(group)
            tokens = np.full((S, self.engine.max_len), self.engine.eot,
                             np.int32)
            # Padding rows carry length == prompt_len: zero generated
            # tokens, avg logprob 0, empty text — never retried.
            lens = np.full((S,), group[0].prompt.shape[0], np.int32)
            gaux = {
                "sum_logprob": np.zeros((S,), np.float32),
                "no_speech_prob": np.zeros((S,), np.float32),
                "used_temperature": np.zeros((S,), np.float32),
            }
            prompt = np.zeros((S, group[0].prompt.shape[0]), np.int32)
            for j, w in enumerate(group):
                tokens[j] = w.tokens
                lens[j] = lengths[i + j]
                prompt[j] = w.prompt
                for key in ("sum_logprob", "no_speech_prob"):
                    gaux[key][j] = aux[key][i + j]

            def make_mel(ws=group, start=i):
                # Lazy (only computed when a window actually re-decodes)
                # and cached for the post-passes that follow.
                return self._group_mel(ws, start, mel_cache)

            t._run_fallback_ladder(S, make_mel, prompt, tokens, lens, gaux)

            for j, w in enumerate(group):
                w.tokens = tokens[j]
                lengths[i + j] = lens[j]
                for key in ("sum_logprob", "no_speech_prob",
                            "used_temperature"):
                    aux[key][i + j] = gaux[key][j]
        return lengths

    def _complete(self, req: _Request) -> None:
        """Assemble a request whose windows are all decoded, on the worker
        thread (its post-passes run on the device), and wake the
        submitter with the result or the error."""
        try:
            self._assemble(req)
        except BaseException as e:  # noqa: BLE001 - deliver to the caller
            self._finish(req, e)
            return
        self._finish(req)

    def _finish(self, req: _Request, error: Optional[BaseException] = None,
                cancelled: bool = False):
        """Mark the request done and wake the submitter."""
        if req.done.is_set():
            return  # e.g. cancelled while its last window also completed
        req.error = error
        with self._cv:
            self.inflight -= 1
            # req.cancelled covers the race where the client vanished
            # during the very chunk that completed its last window: the
            # worker reaches the normal completion path before
            # _sweep_cancelled runs, but nobody received the result, so
            # it must not count as served.
            if cancelled or req.cancelled:
                self.requests_cancelled += 1
            elif error is not None:
                # An errored request is not served (same contract as the
                # micro-batcher's requests_failed).
                self.requests_failed += 1
            else:
                self.requests_served += 1
        req.done.set()

    def _sweep_cancelled(self) -> None:
        """Drop cancelled requests' queued windows and free their decode
        slots (they stop costing chunk work at the next boundary). Runs
        on the worker thread between device calls."""
        gone = [w.req for w in self._window_queue
                if w.req is not None and w.req.cancelled]
        gone += [w.req for w in self.engine._occupied
                 if w is not None and w.req is not None and w.req.cancelled]
        if not gone:
            return
        self._window_queue = [w for w in self._window_queue
                              if not (w.req is not None and w.req.cancelled)]
        self.engine.release(lambda w: w.req is not None and w.req.cancelled)
        from yoho_tpu_torch.infer.batching import RequestCancelled

        for req in {id(r): r for r in gone}.values():
            self._finish(req, RequestCancelled("client went away"),
                         cancelled=True)

    def _fail_inflight(self, error: BaseException) -> None:
        """Deliver ``error`` to every request with device work in flight
        and reset the engine's slot bookkeeping (the next admissions
        rewrite per-slot device state from scratch)."""
        reqs = {id(w.req): w.req for w in self._window_queue if w.req}
        for w in self.engine._occupied:
            if w is not None and w.req is not None:
                reqs[id(w.req)] = w.req
        self._window_queue.clear()
        self.engine.reset()
        for req in reqs.values():
            self._finish(req, error)

    def _run(self) -> None:
        engine = self.engine
        while True:
            with self._cv:
                while (not self._queue and not self._window_queue
                       and not engine.busy and not self._closed):
                    self._cv.wait()
                if (self._closed and not self._queue
                        and not self._window_queue and not engine.busy):
                    return
                incoming, self._queue = self._queue, []

            for req in incoming:
                if req.cancelled:
                    self._finish(req, None, cancelled=True)
                    continue
                try:
                    self._prepare(req)
                except BaseException as e:  # noqa: BLE001
                    self._finish(req, e)
                    continue
                if req.remaining == 0:
                    self._complete(req)
                else:
                    self._window_queue.extend(req.windows)

            self._sweep_cancelled()

            # Device work is guarded: an engine exception (device OOM, a
            # kernel error, ...) must fail the in-flight requests loudly,
            # never kill the worker and hang every submitter.
            try:
                done: List[_Window] = []
                # Admit queued windows into free slots — ONE batched
                # device call regardless of how many slots freed.
                if self._window_queue and engine.free_slots:
                    n_took = engine.admit_many(self._window_queue)
                    del self._window_queue[:n_took]
                    # Windows silent at admission (first token == EOT)
                    # finish without waiting a whole chunk.
                    done += engine.reap()
                if engine.busy:
                    self.batches_dispatched += 1
                    done += engine.step()
            except BaseException as e:  # noqa: BLE001 — fail in-flight reqs
                self._fail_inflight(e)
                continue
            for win in done:
                req = win.req
                req.remaining -= 1
                if req.remaining == 0:
                    self._complete(req)
