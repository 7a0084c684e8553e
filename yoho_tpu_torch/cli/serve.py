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
stop. The command line (``main``, ``yoho-torch serve --hf DIR`` or
``--session NAME``) builds the transcriber from a local checkpoint
directory or a trained YOHO session (``cli/transcribe.py``) and does the
same. Websocket streams track speakers across the stream.

``--mesh DxM`` serves over a (data, model) mesh of processes, one per
GPU: ``torchrun --nproc-per-node N -m yoho_tpu_torch.cli serve --mesh DxM
...`` (``parallel/mesh.py``; ``--mesh 1x1`` runs in one process without a
launcher). Rank 0 binds the socket, warms up, prints and serves; its
batcher broadcasts the schedule (``infer/batching.py``,
``infer/continuous.py``). The other ranks bind and print nothing: they
build the same batcher and follow it (:func:`follow`) until rank 0 closes
it, through SIGTERM and Ctrl-C (rank 0 drains, then every rank exits 0).
From Python: ``serve`` on rank 0, ``follow(transcriber, ...).join()`` on
the others, with the same engine settings.
"""

from __future__ import annotations

import json
import socket
import threading
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
    from yoho_tpu_torch.parallel.mesh import is_coordinator

    if getattr(transcriber, "mesh", None) is not None and not is_coordinator():
        raise RuntimeError("over a mesh rank 0 serves; the other ranks call follow()")
    batcher = _batcher(transcriber, continuous, chunk_tokens, max_wait_ms, max_pending)
    server = ThreadingHTTPServer((host, port),
                                 make_handler(transcriber, batcher,
                                              continuous=continuous,
                                              partial_interval=partial_interval))
    server.batcher = batcher  # so callers/tests can read counters / close
    # The schedule failing over a mesh ends the batcher on every rank: stop
    # serving too (serve_forever returns; main exits non-zero).
    batcher.on_fatal = lambda _e: threading.Thread(target=server.shutdown,
                                                   daemon=True).start()
    server.transcriber = transcriber  # for warmup()/introspection
    server.stream_conns = set()  # live websocket sockets, for drain()
    return server


def _batcher(transcriber, continuous: bool, chunk_tokens: int, max_wait_ms: float,
             max_pending=None):
    if continuous:
        from yoho_tpu_torch.infer.continuous import ContinuousBatcher

        return ContinuousBatcher(transcriber, max_batch=transcriber.batch_size,
                                 chunk_tokens=chunk_tokens, max_pending=max_pending)
    from yoho_tpu_torch.infer.batching import MicroBatcher

    return MicroBatcher(transcriber, max_batch=transcriber.batch_size,
                        max_wait_ms=max_wait_ms, max_pending=max_pending)


def follow(transcriber, continuous: bool = False, chunk_tokens: int = 16,
           max_wait_ms: float = 25.0):
    """A rank other than 0 of a server over a mesh: the batcher rank 0's
    ``serve`` builds (the same engine settings), following rank 0's
    schedule on its worker thread. Call ``join()`` on it: it returns when
    rank 0 has closed its batcher (``drain``)."""
    from yoho_tpu_torch.parallel.mesh import is_coordinator

    if getattr(transcriber, "mesh", None) is None or is_coordinator():
        raise RuntimeError("follow() is for the ranks other than 0 of a mesh")
    return _batcher(transcriber, continuous, chunk_tokens, max_wait_ms)


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
    """The serving command line: build the transcriber from an HF
    checkpoint directory (``cli/transcribe.py``), warm it up, serve until
    SIGTERM or Ctrl-C, then drain."""
    import argparse
    import sys

    from yoho_tpu_torch.cli.transcribe import (
        batch_size_arg,
        build_whisper_transcriber,
        build_yoho_transcriber,
        load_speakers_arg,
        load_voiceprint_encoder,
    )
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(description="Transcription HTTP server")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", type=str, help="HF Whisper checkpoint directory")
    src.add_argument("--session", type=str, help="YOHO training session name")
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--batch", type=batch_size_arg, default=8,
                        help="decode batch size (micro-batch cap / "
                             "continuous slots), or 'auto' to size it "
                             "from the device-memory capacity model")
    parser.add_argument("--continuous", action="store_true",
                        help="slot-engine continuous batching: refill "
                             "freed decode slots between token chunks "
                             "(greedy; composes with --draft-hf for "
                             "per-slot speculative decoding; lowest "
                             "queue latency)")
    parser.add_argument("--chunk-tokens", type=int, default=16,
                        help="tokens decoded between admission checks "
                             "(--continuous)")
    parser.add_argument("--partial-interval", type=float, default=None,
                        metavar="SECONDS",
                        help="websocket streams: decode the INCOMPLETE "
                             "tail window every this-many seconds of new "
                             "audio and push it as a revisable partial; "
                             "finals are unchanged (costs one extra decode "
                             "per interval per stream)")
    parser.add_argument("--max-wait-ms", type=float, default=25.0,
                        help="micro-batching window for concurrent requests")
    parser.add_argument("--max-pending", type=int, default=256,
                        help="backpressure: max in-flight requests before "
                             "submissions get 503 + Retry-After (0 = "
                             "unlimited)")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the startup warmup decode (by default "
                             "one silent window is transcribed before "
                             "accepting traffic, so the first real "
                             "request doesn't pay the kernel build)")
    parser.add_argument("--drain-timeout", type=float, default=30.0,
                        help="seconds to wait for in-flight requests on "
                             "SIGTERM/Ctrl-C before exiting anyway")
    parser.add_argument("--beams", type=int, default=0)
    parser.add_argument("--mesh", type=str, default=None, metavar="DxM",
                        help="serving mesh, DATAxMODEL (e.g. 1x4: 4-way "
                             "tensor parallel); run one process per GPU "
                             "under torchrun (rank 0 serves), or 1x1 in "
                             "one process")
    parser.add_argument("--language", type=str, default="en")
    parser.add_argument("--task", type=str, default="transcribe",
                        choices=("transcribe", "translate"),
                        help="whisper task (translate also enables the "
                             "OpenAI /v1/audio/translations endpoint)")
    parser.add_argument("--int8-kv", action="store_true",
                        help="int8 KV caches (argmax-identical)")
    parser.add_argument("--int8-weights", action="store_true",
                        help="weight-only int8 decoder (near-lossless)")
    parser.add_argument("--int8-encoder", action="store_true",
                        help="W8A8 int8 encoder MLPs (near-lossless; "
                             "implies the tanh GELU)")
    parser.add_argument("--fast-gelu", action="store_true",
                        help="tanh-GELU in encoder MLPs (near-lossless)")
    parser.add_argument("--vad", action="store_true",
                        help="collapse silence on the host before decoding")
    parser.add_argument("--word-timestamps", action="store_true",
                        help="attach word-level timings (cross-attention "
                             "DTW); surfaces as 'words' in verbose_json")
    parser.add_argument("--temperature-fallback", action="store_true",
                        help="retry low-quality windows at higher "
                             "temperatures (whisper quality ladder; works "
                             "with --continuous too)")
    parser.add_argument("--best-of", type=int, default=1,
                        help="sampled candidates per window at fallback "
                             "temperatures > 0 (also applies to "
                             "per-request temperature>0 decodes); the "
                             "highest-mean-logprob candidate wins")
    parser.add_argument("--diarize-session", type=str, default=None,
                        metavar="NAME",
                        help="whisper-family diarization: embed segment "
                             "spans with this session's trained voiceprint "
                             "encoder and cluster")
    parser.add_argument("--speaker-threshold", type=float, default=0.75,
                        help="cosine floor for diarization clustering and "
                             "enrolled-name matching")
    parser.add_argument("--speakers", type=str, default=None, metavar="NPZ",
                        help="speaker recognition: match diarized clusters "
                             "against this 'enroll' file (needs voiceprints: "
                             "a yoho session, or --diarize-session with the "
                             "encoder used for enrollment)")
    parser.add_argument("--draft-hf", type=str, default=None, metavar="PATH",
                        help="speculative decoding via a small same-vocab "
                             "draft checkpoint (greedy-identical; a "
                             "single-stream latency feature — pair with "
                             "--batch 1)")
    parser.add_argument("--gamma", type=int, default=4,
                        help="draft tokens per verify step (--draft-hf)")
    parser.add_argument("--lora", type=str, default=None, metavar="PATH",
                        help="merge a LoRA adapter (finetune --lora "
                             "output) into the --hf base weights at load")
    parser.add_argument("--hotwords", type=str, default=None,
                        metavar="PHRASES",
                        help="comma-separated phrases whose tokens get a "
                             "logit boost in every decode (fixed per "
                             "server)")
    parser.add_argument("--hotword-boost", type=float, default=4.0)
    parser.add_argument("--hallucination-silence-threshold", type=float,
                        default=None, metavar="SECONDS",
                        help="drop segments that sit speech-free inside a "
                             "silence run at least this long (VAD-informed "
                             "hallucination filter)")
    parser.add_argument("--length-penalty", type=float, default=1.0,
                        help="GNMT length normalization exponent for beam "
                             "scores (--beams)")
    parser.add_argument("--repetition-penalty", type=float, default=None,
                        help="CTRL-style penalty (>1 damps) on re-emitting "
                             "already-generated text tokens")
    parser.add_argument("--no-repeat-ngram", type=int, default=0,
                        metavar="N",
                        help="hard-ban completing any text n-gram already "
                             "generated in the window (0 = off)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = cli_device(args)
    mesh = None
    if args.mesh:
        from yoho_tpu_torch.parallel.mesh import parse_mesh

        mesh = parse_mesh(args.mesh, args.device)
        device = mesh.device
    if args.lora and not args.hf:
        parser.error("--lora adapts an --hf whisper checkpoint")
    if args.best_of < 1:
        parser.error("--best-of must be >= 1")
    if args.best_of > 1 and not args.hf:
        parser.error("--best-of is a whisper-family option (--hf); the "
                     "temperature quality ladder does not run on --session "
                     "models")
    if args.draft_hf and not args.hf:
        parser.error("--draft-hf requires --hf (whisper family)")
    if args.max_pending < 0:
        parser.error("--max-pending must be >= 0")
    if args.draft_hf and args.beams:
        parser.error("--draft-hf is greedy-only; drop --beams")
    if args.draft_hf and args.gamma < 1:
        parser.error("--gamma must be >= 1")

    temps = ((0.0, 0.2, 0.4, 0.6, 0.8, 1.0) if args.temperature_fallback
             else (0.0,))
    enrolled = load_speakers_arg(args.speakers, args.hf, args.diarize_session,
                                 parser.error)
    if args.session:
        for flag, on, why in (
                ("--diarize-session", args.diarize_session,
                 "the yoho family emits voiceprints in the decode forward "
                 "pass and diarizes natively"),
                ("--int8-encoder", args.int8_encoder,
                 "W8A8 encoder serving is whisper-family only"),
                ("--fast-gelu", args.fast_gelu,
                 "the yoho family uses SwiGLU, not GELU")):
            if on:
                print(f"warning: {flag} is ignored with --session ({why})",
                      file=sys.stderr)
        t = build_yoho_transcriber(
            args.session, args.root, args.beams, args.batch,
            vad_filter=args.vad, enrolled_speakers=enrolled,
            speaker_threshold=args.speaker_threshold,
            word_timestamps=args.word_timestamps, hotwords=args.hotwords,
            hotword_boost=args.hotword_boost,
            repetition_penalty=args.repetition_penalty,
            no_repeat_ngram_size=args.no_repeat_ngram,
            length_penalty=args.length_penalty,
            hallucination_silence_threshold=args.hallucination_silence_threshold,
            device=device, mesh=mesh)
        return _serve_main(t, args)
    diarize = (load_voiceprint_encoder(args.diarize_session, args.root, device)
               if args.diarize_session else None)
    t = build_whisper_transcriber(args.hf, args.beams, args.batch,
                                  None if args.language == "auto" else args.language,
                                  True,
                                  quantized=args.int8_kv,
                                  int8_weights=args.int8_weights,
                                  int8_encoder=args.int8_encoder,
                                  fast_gelu=args.fast_gelu,
                                  task=args.task,
                                  word_timestamps=args.word_timestamps,
                                  temperatures=temps,
                                  best_of=args.best_of,
                                  vad_filter=args.vad,
                                  draft_hf=args.draft_hf,
                                  speculative_gamma=args.gamma,
                                  lora=args.lora, hotwords=args.hotwords,
                                  hotword_boost=args.hotword_boost,
                                  repetition_penalty=args.repetition_penalty,
                                  no_repeat_ngram_size=args.no_repeat_ngram,
                                  length_penalty=args.length_penalty,
                                  hallucination_silence_threshold=(
                                      args.hallucination_silence_threshold),
                                  diarize=diarize, enrolled_speakers=enrolled,
                                  speaker_threshold=args.speaker_threshold,
                                  device=device, mesh=mesh)
    return _serve_main(t, args)


def _follow_main(t, args) -> int:
    """A rank other than 0 under ``--mesh``: follow rank 0's schedule until
    it closes. SIGTERM and Ctrl-C (which a launcher sends every rank) do
    not end the follower: rank 0 drains on them, and its last tick ends
    this one."""
    import signal

    batcher = follow(t, continuous=args.continuous, chunk_tokens=args.chunk_tokens,
                     max_wait_ms=args.max_wait_ms)
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, lambda _signum, _frame: None)
        except ValueError:
            pass  # not the main thread (embedded use)
    try:
        batcher.join()
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    return 0


def _serve_main(t, args) -> int:
    """Serve ``t`` as ``main`` was asked: warm up, print the bound address,
    serve until SIGTERM or Ctrl-C, drain. Over a mesh rank 0 does that and
    the other ranks follow (:func:`_follow_main`)."""
    import sys

    from yoho_tpu_torch.parallel.mesh import is_coordinator

    if getattr(t, "mesh", None) is not None and not is_coordinator():
        return _follow_main(t, args)
    server = serve(t, args.port, args.host, args.max_wait_ms,
                   continuous=args.continuous,
                   chunk_tokens=args.chunk_tokens,
                   max_pending=args.max_pending or None,
                   partial_interval=args.partial_interval)
    if not args.no_warmup:
        # Build and load the kernels and size the allocator now, not on
        # the first user's request. The socket is already bound: early
        # requests queue and get served the moment the loop starts.
        print("warming up...", file=sys.stderr)
        t0 = time.monotonic()
        warmup(server)
        print(f"warm in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /transcribe, GET /healthz)",
          flush=True)

    # Graceful drain: SIGTERM (the orchestrator's stop signal) behaves
    # like Ctrl-C — stop accepting, finish in-flight decodes, exit 0.
    import signal

    def _term(_signum, _frame):
        raise KeyboardInterrupt

    prev_term = None
    try:
        prev_term = signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread (embedded use)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if prev_term is not None:
            # Restore the caller's handler: embedded runs (tests, library
            # use) must not keep a global SIGTERM->KeyboardInterrupt hook
            # after this server exits.
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass
        drain(server, timeout_s=args.drain_timeout)
        print("drained; bye", file=sys.stderr)
    if getattr(server.batcher, "fatal", None) is not None:
        print(f"the serving schedule failed: {server.batcher.fatal!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
