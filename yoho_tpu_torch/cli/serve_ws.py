"""WebSocket real-time transcription endpoint (``GET /stream``).

The JAX package's ``cli/serve_ws.py``: RFC 6455 streaming over the stdlib
framing in ``yoho_tpu_torch/utils/websocket.py``: binary little-endian
float32 PCM frames in, finalized-segment JSON messages (+ revisable
``partial`` captions) out, with flush/end ops, as a mixin over the HTTP
Handler base (which provides ``_json``/``_submit``/``_client_gone`` and the
``transcriber``/``batcher`` class attributes). The JAX server tracks
speakers across a stream; the port has no speaker tracking yet (ROADMAP.md,
Queue 1 item 12), and its segments carry no speaker, as the JAX tracker
leaves a segment without a voiceprint.
"""

from __future__ import annotations

import json
import time

import numpy as np

from yoho_tpu_torch.cli.serve_openai import _segment_payload
from yoho_tpu_torch.infer.batching import RequestCancelled, ServerOverloaded


class StreamEndpointMixin:
    """``GET /stream`` websocket handler."""

    def _stream(self) -> None:
        """WebSocket real-time transcription (RFC 6455, stdlib).

        Client sends BINARY frames of little-endian float32 mono PCM
        at the server's sample rate; the server replies with a TEXT
        JSON message whenever segments finalize. A TEXT frame
        ``{"op": "flush"}`` forces everything buffered out as FINAL
        segments and the session continues (the next window plan
        starts at the flush point); ``{"op": "end"}`` (or closing)
        flushes and ends the session with ``{"final": true, ...}``.

        ``GET /stream?language=xx`` pins the decode language for the
        whole stream; otherwise the server's ``--language`` applies
        (default ``en``). Streams never auto-detect per window — a
        noisy window flipping the language mid-stream would be worse
        than a wrong pinned default."""
        from urllib.parse import parse_qs, urlparse

        from yoho_tpu_torch.infer.streaming import StreamingTranscriber
        from yoho_tpu_torch.utils import websocket as ws

        query = parse_qs(urlparse(self.path).query)
        stream_lang = (query.get("language", [None])[0]
                       or self.transcriber.language)
        if stream_lang is None and self.transcriber.family == "whisper":
            stream_lang = "en"  # the built-in B=1 path's default prompt

        if not ws.perform_handshake(self):
            self._json(400, {"error": "expected a websocket upgrade"})
            return
        # The socket has switched protocols; it can never carry HTTP
        # again. Without this, returning into BaseHTTPRequestHandler's
        # keep-alive loop parses trailing client frames as HTTP
        # (spurious 400s on half-open clients).
        self.close_connection = True
        # Register with the drain registry: the websocket read has no
        # timeout, so graceful shutdown must be able to find and close
        # this socket to unblock the handler thread (see drain()).
        registry = getattr(self.server, "stream_conns", None)
        if registry is not None:
            registry.add(self.connection)

        def _decode_shared(window_audio):
            # Route each stream window through the SHARED batcher:
            # concurrent streams pool into one batch / slot set
            # instead of each paying a lone B=1 decode. The language
            # is pinned per stream (never per-window auto-detect) and
            # vad=False because the streaming gate already vetted the
            # window — collapsing it again would decode condensed
            # audio and break parity with the built-in path.
            while True:
                try:
                    res = self._submit(window_audio,
                                       language=stream_lang, vad=False)
                    break
                except ServerOverloaded:
                    # A stream holds session state its client cannot
                    # reconstruct by retrying — wait out transient
                    # overload instead of shedding the whole stream
                    # (one-shot HTTP requests get the retryable 503).
                    if self._client_gone():
                        raise ConnectionError(
                            "client left during overload wait")
                    time.sleep(0.25)
            return res.segments

        stream = StreamingTranscriber(
            self.transcriber, window_decoder=_decode_shared,
            partial_interval_seconds=getattr(self, "partial_interval",
                                             None))

        def emit(segments, final: bool) -> None:
            if not segments and not final:
                return
            payload = {
                "segments": [_segment_payload(s, i)
                             for i, s in enumerate(segments)],
            }
            if final:
                payload["final"] = True
                payload["text"] = stream.text()
            ws.send_text(self.wfile, json.dumps(payload,
                                                ensure_ascii=False))

        try:
            while True:
                msg = ws.read_message(self.rfile, self.wfile)
                if msg is None:  # peer closed without "end"
                    return
                opcode, payload = msg
                if opcode == ws.OP_BINARY:
                    if len(payload) % 4:
                        ws.send_text(self.wfile, json.dumps({
                            "error": "binary frames must contain whole "
                                     "little-endian float32 samples"}))
                        continue
                    audio = np.frombuffer(payload, dtype="<f4")
                    decodes_before = stream._last_decode_at
                    emit(stream.push(audio), final=False)
                    # Live-caption partials: the still-revisable last
                    # window's hypotheses (+ the provisional tail decode
                    # under --partial-interval). Clients REPLACE their
                    # partial display with each message (a later
                    # window may revise these; finals are additive).
                    # Only re-sent when this push actually ran a decode
                    # (full window OR provisional) — small frames
                    # between decode points would otherwise re-send
                    # identical partials at the client's frame rate.
                    if stream._last_decode_at != decodes_before:
                        partials = stream.partial_segments()
                        # Under --partial-interval an EMPTY partial is
                        # still a signal (clear the caption line); the
                        # default mode keeps the quieter no-empty-sends
                        # behavior.
                        if partials or (getattr(self, "partial_interval",
                                                None) is not None):
                            ws.send_text(self.wfile, json.dumps({
                                "partial": True,
                                "segments": [_segment_payload(s, i)
                                             for i, s in enumerate(partials)],
                            }, ensure_ascii=False))
                    continue
                try:
                    op = json.loads(payload.decode() or "{}").get("op")
                except ValueError:
                    op = None
                if op == "flush":
                    # NON-terminal: the session continues — the
                    # terminal flush() would make the next audio
                    # frame raise and kill the connection.
                    emit(stream.soft_flush(), final=False)
                elif op == "end":
                    emit(stream.flush(), final=True)
                    ws.send_close(self.wfile)
                    return
                else:
                    ws.send_text(self.wfile, json.dumps(
                        {"error": f"unknown op {op!r}"}))
        except (ConnectionError, OSError, RequestCancelled):
            return  # peer went away; nothing to answer
        except Exception as e:  # noqa: BLE001 — protocol violation /
            # decode failure: report + close instead of a bare
            # traceback and a dropped connection.
            try:
                ws.send_text(self.wfile, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}))
                ws.send_close(self.wfile)
            except OSError:
                pass
            return
        finally:
            if registry is not None:
                registry.discard(self.connection)
