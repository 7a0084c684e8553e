"""Minimal HTTP serving daemon for batched transcription.

The JAX package's ``cli/serve.py``, stdlib-only:

* ``POST /transcribe`` with a WAV (or raw f32 PCM) body -> JSON segments
  (``?language=`` per request).
* ``POST /v1/audio/transcriptions`` (and ``/v1/audio/translations`` for a
  transcriber with ``task="translate"``): the OpenAI-compatible multipart
  endpoint, ``response_format`` json | text | verbose_json | srt | vtt,
  ``stream=true`` as Server-Sent Events (``cli/serve_openai.py``).
  ``prompt`` and ``temperature`` are honored per request under the
  micro-batching engine (prompts at one padded length, temperatures
  snapped to 0.2-wide rungs); under ``continuous=True`` nonzero overrides
  get a 400.
* ``GET /stream``: WebSocket real-time transcription (RFC 6455,
  ``cli/serve_ws.py`` over ``utils/websocket.py``): little-endian float32
  PCM frames in, finalized segments and revisable partials out,
  ``{"op": "flush"}`` / ``{"op": "end"}``.
* ``GET /healthz``, ``GET /statz`` (the batcher's counters as JSON),
  ``GET /metrics`` (the same in Prometheus text format), ``GET
  /v1/models``.

Concurrent requests are MICRO-BATCHED (``infer/batching.py``): their 30 s
windows share the fixed-batch decode programs. ``continuous=True`` runs
the slot engine instead (``infer/continuous.py``): freed decode slots are
refilled between token chunks, so a request waits at most
``chunk_tokens`` steps instead of a whole batch decode (greedy; composes
with a draft model's per-slot speculative decoding, the temperature
fallback ladder and word timestamps). One worker thread runs every CUDA
call; the handler threads parse, wait and answer.

Serving from Python: ``server = serve(transcriber, port, continuous=True)``,
``warmup(server)``, ``server.serve_forever()``, and ``drain(server)`` to
stop. The command line (``main``) needs a checkpoint loader, which the
port does not have yet (ROADMAP.md, Queue 1 item 14).
"""

from __future__ import annotations

import json
import socket
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from yoho_tpu_torch.cli.serve_openai import (
    OpenAIEndpointsMixin,
    _decode_wav_bytes,
    _validate_language,
)
from yoho_tpu_torch.cli.serve_ws import StreamEndpointMixin
from yoho_tpu_torch.infer.batching import RequestCancelled, ServerOverloaded


_PROM_COUNTERS = ("requests_served", "requests_failed",
                  "requests_rejected", "requests_cancelled",
                  "batches_dispatched")
_PROM_GAUGES = ("inflight", "queue_depth", "active_slots")


def _prometheus_text(stats: dict) -> str:
    """Render the batcher's stats() dict in Prometheus text exposition
    format (``GET /metrics``) — the same numbers ``/statz`` serves as
    JSON, so dashboards can scrape without an adapter."""
    lines = []
    for k in _PROM_COUNTERS:
        if k in stats:
            lines += [f"# TYPE yoho_{k}_total counter",
                      f"yoho_{k}_total {stats[k]}"]
    for k in _PROM_GAUGES:
        if k in stats:
            lines += [f"# TYPE yoho_{k} gauge", f"yoho_{k} {stats[k]}"]
    quantiles = (("0.5", "p50_ms"), ("0.95", "p95_ms"), ("0.99", "p99_ms"))
    if any(stats.get(name) is not None for _, name in quantiles):
        lines.append("# TYPE yoho_request_latency_seconds summary")
        for q, name in quantiles:
            v = stats.get(name)
            if v is not None:
                lines.append(
                    f'yoho_request_latency_seconds{{quantile="{q}"}} '
                    f"{v / 1000.0:.6f}")
    return "\n".join(lines) + "\n"


def make_handler(transcriber, batcher, continuous: bool = False,
                 partial_interval=None):
    import inspect

    try:
        _supports_cancel = ("cancelled"
                            in inspect.signature(batcher.submit).parameters)
    except (TypeError, ValueError):
        _supports_cancel = False

    class Handler(OpenAIEndpointsMixin, StreamEndpointMixin,
                  BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload, extra_headers=None) -> None:
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (extra_headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/stream":
                self._stream()
            elif path == "/healthz":
                self._json(200, {"status": "ok"})
            elif path in ("/v1/models", "/v1/models/whisper-1"):
                # OpenAI SDK clients commonly list models before first
                # use; this server loads exactly one checkpoint, exposed
                # under the alias OpenAI's audio API uses.
                entry = {"id": "whisper-1", "object": "model",
                         "created": 0, "owned_by": "yoho-tpu"}
                self._json(200, entry if path.endswith("whisper-1")
                           else {"object": "list", "data": [entry]})
            elif path in ("/statz", "/metrics"):
                # stats() adds backpressure/cancellation counters, queue
                # depth and latency percentiles; duck-typed batchers in
                # tests may only carry the two counters. /metrics is the
                # same dict in Prometheus text format.
                if hasattr(batcher, "stats"):
                    stats = batcher.stats()
                else:
                    stats = {
                        "requests_served": batcher.requests_served,
                        "batches_dispatched": batcher.batches_dispatched,
                    }
                if path == "/metrics":
                    self._send(200, "text/plain; version=0.0.4",
                               _prometheus_text(stats).encode())
                else:
                    self._json(200, stats)
            else:
                self._json(404, {"error": "not found"})

        def _client_gone(self) -> bool:
            """Liveness probe polled while blocked in the batcher: a
            readable socket returning b'' means the client closed (the
            request body was already read in full, so pending bytes can
            only be a pipelined request — still alive).

            Known tradeoff: a FIN is also what a legal HTTP/1.1
            half-close (``shutdown(SHUT_WR)`` while still reading the
            response) looks like — indistinguishable from a full close
            at this layer. Like mainstream servers we treat FIN as
            disconnect: real clients that half-close are vanishingly
            rare, and missing the common full-close disconnect would
            defeat cancellation entirely."""
            try:
                return self.connection.recv(
                    1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
            except (BlockingIOError, InterruptedError):
                return False
            except OSError:
                return True

        def _submit(self, audio, language=None, **kw):
            if _supports_cancel:
                return batcher.submit(audio, language=language,
                                      cancelled=self._client_gone, **kw)
            # Duck-typed batcher without the `cancelled` knob (tests,
            # custom backends).
            return batcher.submit(audio, language=language, **kw)

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)


        def do_POST(self):
            from urllib.parse import parse_qs, urlsplit

            split = urlsplit(self.path)
            query = parse_qs(split.query)
            path = split.path.rstrip("/")
            if path == "/v1/audio/transcriptions":
                self._openai_audio("transcribe")
                return
            if path == "/v1/audio/translations":
                self._openai_audio("translate")
                return
            if path != "/transcribe":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if "audio/wav" in ctype or body[:4] == b"RIFF":
                    audio = _decode_wav_bytes(body, transcriber.sample_rate)
                elif "application/octet-stream" in ctype:
                    audio = np.frombuffer(body, dtype=np.float32)
                else:
                    self._json(415, {"error": f"unsupported content type {ctype!r}"})
                    return
                language = (query.get("language", [None])[0] or None)
                err = _validate_language(transcriber, language)
                if err:
                    self._json(400, {"error": err})
                    return
                result = self._submit(audio, language=language)
                self._json(200, {
                    "text": result.text,
                    "language": result.language,
                    "language_probability": result.language_probability,
                    "segments": [
                        {"start": s.start, "end": s.end, "text": s.text,
                         **s.quality_payload(),
                         "speaker": s.speaker,
                         "speaker_name": s.speaker_name,
                         **({"words": [{"word": w.word, "start": w.start,
                                        "end": w.end,
                                        "probability": w.probability}
                                       for w in s.words]}
                            if s.words else {}),
                         "voiceprint": (s.voiceprint.tolist()
                                        if s.voiceprint is not None else None)}
                        for s in result.segments
                    ],
                })
            except ServerOverloaded as e:
                self._json(503, {"error": str(e)},
                           extra_headers={"Retry-After": "1"})
            except RequestCancelled:
                self.close_connection = True  # client is gone; no reply
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})


    # The endpoint mixins (cli/serve_openai.py, cli/serve_ws.py) reach the
    # serving objects through these class attributes; the base methods
    # below keep using the closure directly.
    Handler.transcriber = transcriber
    Handler.batcher = batcher
    Handler.continuous = continuous
    Handler.partial_interval = partial_interval

    return Handler


def serve(transcriber, port: int = 8000, host: str = "127.0.0.1",
          max_wait_ms: float = 25.0, continuous: bool = False,
          chunk_tokens: int = 16, max_pending=None,
          partial_interval=None):
    """``continuous=True`` swaps the collect-then-batch MicroBatcher for
    the slot engine (``infer/continuous.py``): freed decode slots are
    refilled between ``chunk_tokens``-token chunks, so a new request
    waits at most one chunk instead of a full batch decode and finished
    slots never idle behind a slow stream. Slot decodes are greedy (no
    beams) and compose with speculative draft-verify decoding (each
    slot advances by its own accepted length); the temperature ladder
    and word timestamps run in the batcher's assemble step.

    ``max_pending`` bounds in-flight requests (backpressure): past it,
    submissions fail fast with 503 + Retry-After instead of queueing
    unboundedly behind a saturated card. Client disconnects cancel their
    request — queued work is dropped, and in continuous mode occupied
    slots are freed at the next chunk boundary."""
    if partial_interval is not None and partial_interval < 0.1:
        # Fail at startup, not per-connection: an invalid value would
        # otherwise bind the port, pay the warmup, report healthy — and
        # then error every /stream client at handshake.
        raise ValueError("--partial-interval must be >= 0.1 seconds, "
                         f"got {partial_interval}")
    if continuous:
        from yoho_tpu_torch.infer.continuous import ContinuousBatcher

        batcher = ContinuousBatcher(transcriber,
                                    max_batch=transcriber.batch_size,
                                    chunk_tokens=chunk_tokens,
                                    max_pending=max_pending)
    else:
        from yoho_tpu_torch.infer.batching import MicroBatcher

        batcher = MicroBatcher(transcriber, max_batch=transcriber.batch_size,
                               max_wait_ms=max_wait_ms,
                               max_pending=max_pending)
    server = ThreadingHTTPServer((host, port),
                                 make_handler(transcriber, batcher,
                                              continuous=continuous,
                                              partial_interval=partial_interval))
    server.batcher = batcher  # so callers/tests can read counters / close
    server.transcriber = transcriber  # for warmup()/introspection
    server.stream_conns = set()  # live websocket sockets, for drain()
    return server


def warmup(server) -> None:
    """Warm the serving path BEFORE traffic: submit one silent window
    through the batcher, exactly the path real requests take, so the CUDA
    kernels are built and loaded and the allocator holds the decode
    batch's memory before the first user's request (the first build of
    the kernels takes about a minute). The socket is already bound, so
    requests arriving during warmup queue and are answered as soon as
    ``serve_forever`` starts."""
    t = getattr(server, "transcriber", None)
    batcher = getattr(server, "batcher", None)
    if t is None or batcher is None:
        return  # duck-typed server (tests / custom backends): nothing to warm
    # Snapshot counters: warmup runs before serve_forever, so nothing
    # else dispatches concurrently and restoring the snapshots exactly
    # un-counts the synthetic request (the continuous engine counts
    # batches per CHUNK — a fixed "-1" would leave phantom batches).
    served = getattr(batcher, "requests_served", 0)
    batches = getattr(batcher, "batches_dispatched", 0)
    # vad=False: with vad_filter the all-zeros window would be collapsed
    # to empty audio and NOTHING would run on the card; the per-request
    # override forces the window through the decode programs real speech
    # uses (the VAD itself runs on the host).
    batcher.submit(np.zeros(t.chunk_samples, np.float32), vad=False)
    # The synthetic request must not pollute /statz: its latency holds
    # the kernels' first build and would sit in the p99 percentiles until
    # 512 real requests evict it.
    batcher.requests_served = served
    batcher.batches_dispatched = batches
    lat = getattr(batcher, "_latencies", None)
    if lat is not None:
        lat.clear()


def drain(server, timeout_s: float = 30.0) -> None:
    """Gracefully stop ``server``: stop accepting, give in-flight
    handlers a bounded grace period, then close the batcher (which
    drains queued + dispatched device work).

    ``ThreadingHTTPServer.server_close`` joins every handler thread
    UNBOUNDED — a connected websocket stream (whose read has no timeout)
    or a client stalled mid-request-body would hang shutdown forever,
    exactly the ungraceful exit this path exists to prevent. So: close
    live stream sockets first (unblocks their reads), then join with a
    deadline, then hand any still-stuck daemon threads to process exit
    instead of waiting on them."""
    server.shutdown()
    for conn in list(getattr(server, "stream_conns", ())):
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already closed
    threads = list(getattr(server, "_threads", None) or ())
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    # Replace the thread registry so server_close()'s unconditional
    # join skips threads that outlived the grace period (they are
    # daemonic; process exit reaps them).
    import socketserver

    server._threads = socketserver._NoThreads()
    server.server_close()
    server.batcher.close()


def main(argv=None):
    """The serving command line of the JAX package (``--hf`` / ``--session``
    checkpoints) needs a checkpoint loader, which the port does not have
    yet."""
    from yoho_tpu_torch.infer.pipeline import _not_ported

    _not_ported("the serve command line (a checkpoint loader)", 14)


if __name__ == "__main__":
    raise SystemExit(main())
