"""Request micro-batching for serving.

The JAX package's ``infer/batching.py``: concurrent requests are collected
for up to ``max_wait_ms`` (or until ``max_batch`` requests are waiting)
and pushed through ONE pooled ``Transcriber.transcribe_many`` call, so
their 30 s windows share decode batches instead of each paying a padded
batch alone. The decode batch has a fixed size: filling it is free
throughput, serializing requests wastes it.

Threading model: callers block in :meth:`submit`; a single worker thread
owns the model and every CUDA call, so no lock is needed around the
Transcriber, and the handler threads touch no device tensor.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional


class ServerOverloaded(RuntimeError):
    """Backpressure: the batcher's in-flight request cap is reached.

    Raised by ``submit`` BEFORE enqueueing, so the caller can shed load
    (the HTTP layer maps it to 503 + Retry-After) instead of stacking
    unbounded blocked threads behind a saturated chip."""


class RequestCancelled(RuntimeError):
    """The submitter abandoned the request (client disconnect): queued
    work is dropped; work already in a dispatched batch finishes and is
    discarded (a running batch decode is not interrupted)."""


def _percentiles(samples) -> dict:
    if not samples:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    s = sorted(samples)

    def pick(q):
        return round(s[min(len(s) - 1, int(q * len(s)))] * 1e3, 1)

    return {"p50_ms": pick(0.50), "p95_ms": pick(0.95), "p99_ms": pick(0.99)}


@dataclass(eq=False)
class _Pending:
    audio: Any
    sample_rate: Optional[int]
    language: Optional[str] = None
    vad: Optional[bool] = None
    prompt: Optional[str] = None
    temperature: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    cancelled: bool = False


class MicroBatcher:
    """Blocking submit() front-end over a batching worker thread."""

    def __init__(self, transcriber, max_batch: int = 8,
                 max_wait_ms: float = 25.0,
                 max_pending: Optional[int] = None):
        self.transcriber = transcriber
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max_wait_ms / 1e3
        self.max_pending = max_pending
        self._queue: List[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self.batches_dispatched = 0
        self.requests_served = 0
        self.requests_failed = 0
        self.requests_rejected = 0
        self.requests_cancelled = 0
        self.inflight = 0
        self._latencies: deque = deque(maxlen=512)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, audio, sample_rate: Optional[int] = None,
               language: Optional[str] = None,
               vad: Optional[bool] = None,
               prompt: Optional[str] = None,
               temperature: Optional[float] = None,
               cancelled: Optional[Callable[[], bool]] = None):
        """Enqueue one request and block until its result is ready.

        ``language`` is a per-request override: language changes only the
        decode prompt's content, not its length, so requests in different
        languages still share one batch and one decode program.
        ``vad`` overrides the configured vad_filter for this request
        (the streaming path submits pre-gated windows with ``False``).
        ``prompt``/``temperature`` are per-request decode overrides
        (``Transcriber.transcribe_many(prompts=, temperatures=)`` pools
        them by decode-program key internally).
        ``cancelled`` is polled while blocked (the HTTP layer passes a
        socket-liveness probe); when it turns true the queued request is
        dropped and :class:`RequestCancelled` raised."""
        req = _Pending(audio, sample_rate, language, vad, prompt,
                       temperature)
        t0 = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if (self.max_pending is not None
                    and self.inflight >= self.max_pending):
                self.requests_rejected += 1
                raise ServerOverloaded(
                    f"{self.inflight} requests in flight >= max_pending "
                    f"{self.max_pending}")
            self.inflight += 1
            self._queue.append(req)
            self._cv.notify()
        try:
            if cancelled is None:
                req.done.wait()
            else:
                while not req.done.wait(timeout=0.25):
                    if cancelled():
                        with self._cv:
                            req.cancelled = True
                            # Identity, not ==: _Pending is a dataclass
                            # whose generated __eq__ would compare audio
                            # arrays.
                            still_queued = any(r is req for r in self._queue)
                            if still_queued:
                                self._queue = [r for r in self._queue
                                               if r is not req]
                                self.requests_cancelled += 1
                                self.inflight -= 1
                                req = None  # dropped before dispatch
                        if req is None:
                            raise RequestCancelled("client went away")
                        # Already dispatched into a running batch: the
                        # program runs to completion; abandon the result.
                        raise RequestCancelled(
                            "client went away (batch in flight)")
        finally:
            if req is not None and req.done.is_set():
                self._latencies.append(time.monotonic() - t0)
        if req.error is not None:
            raise req.error
        return req.result

    def stats(self) -> dict:
        with self._cv:
            d = {
                "requests_served": self.requests_served,
                "requests_failed": self.requests_failed,
                "requests_rejected": self.requests_rejected,
                "requests_cancelled": self.requests_cancelled,
                "batches_dispatched": self.batches_dispatched,
                "inflight": self.inflight,
                "queue_depth": len(self._queue),
            }
            d.update(_percentiles(list(self._latencies)))
        return d

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)

    # ------------------------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return []
            deadline = time.monotonic() + self.max_wait
            while (len(self._queue) < self.max_batch and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch, self._queue = (self._queue[: self.max_batch],
                                  self._queue[self.max_batch:])
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return  # closed and drained
            # Mixed sample rates can't share one transcribe_many call;
            # group by rate (nearly always a single group).
            by_rate: dict = {}
            for req in batch:
                by_rate.setdefault(req.sample_rate, []).append(req)
            for rate, reqs in by_rate.items():
                try:
                    # Only pass languages= when a request set one, so
                    # plain transcribe_many(audios, rate) implementations
                    # (tests, custom backends) keep working unchanged.
                    kwargs = {}
                    if any(r.language is not None for r in reqs):
                        kwargs["languages"] = [r.language for r in reqs]
                    if any(r.vad is not None for r in reqs):
                        kwargs["vad"] = [r.vad for r in reqs]
                    if any(r.prompt is not None for r in reqs):
                        kwargs["prompts"] = [r.prompt for r in reqs]
                    if any(r.temperature is not None for r in reqs):
                        kwargs["temperatures"] = [r.temperature
                                                  for r in reqs]
                    results = self.transcriber.transcribe_many(
                        [r.audio for r in reqs], rate, **kwargs
                    )
                    # strict: a transcribe_many contract bug must fail loudly,
                    # not complete requests with result=None.
                    for req, res in zip(reqs, results, strict=True):
                        req.result = res
                except BaseException as e:  # noqa: BLE001 — deliver to callers
                    for req in reqs:
                        req.error = e
                finally:
                    with self._cv:
                        self.batches_dispatched += 1
                        # A request abandoned mid-batch (client gone,
                        # program ran to completion) counts as cancelled,
                        # not served — nobody received its result; a
                        # batch that ERRORED counts as failed, not
                        # served (a dashboard showing 100% served while
                        # every request raised hides the outage).
                        n_gone = sum(1 for r in reqs if r.cancelled)
                        n_err = sum(1 for r in reqs
                                    if r.error is not None and not r.cancelled)
                        self.requests_served += len(reqs) - n_gone - n_err
                        self.requests_failed += n_err
                        self.requests_cancelled += n_gone
                        self.inflight -= len(reqs)
                    for req in reqs:
                        req.done.set()
