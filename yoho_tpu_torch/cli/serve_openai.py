"""OpenAI-compatible shim for the serving daemon.

The JAX package's ``cli/serve_openai.py``: request validation (language
codes, per-request prompt/temperature snapping), multipart/WAV upload
parsing, the OpenAI audio response formats (json | text | verbose_json |
srt | vtt + SSE streaming), and the ``/v1/audio/*`` endpoint handlers as
a mixin over the HTTP Handler. The handler base in ``cli/serve.py``
provides ``_json``/``_send``/``_submit``/``_client_gone`` and the
``transcriber``/``batcher``/``continuous`` class attributes.
"""

from __future__ import annotations

import io
import json
import time
import wave
from email.parser import BytesParser
from email.policy import HTTP as _HTTP_POLICY

import numpy as np

from yoho_tpu_torch.infer.batching import RequestCancelled, ServerOverloaded

# Per-request temperatures snap to these rungs. Each DISTINCT temperature
# value builds, and keeps forever, one more decode program per batch shape
# (``Transcriber._decode_fn`` keys on the float), so an open-ended float
# surface would let clients grow that table without bound and split the
# shared batches. Snapping bounds the program count at 11 and matches the
# documented "pooled per ladder rung" behavior exactly.
_TEMPERATURE_RUNGS = tuple(round(0.2 * i, 1) for i in range(11))  # 0.0..2.0


def _snap_temperature(temperature):
    """Nearest rung; 0.0 -> None (= the server's default decode).

    Mapping 0.0 to "no override" is what the OpenAI SDK's default
    ``temperature=0`` means — greedy, the behavior every engine already
    has — so beam/continuous servers keep accepting it instead of
    rejecting the SDK default with a 400."""
    if temperature is None:
        return None
    snapped = min(_TEMPERATURE_RUNGS, key=lambda r: abs(r - temperature))
    return None if snapped == 0.0 else snapped


def _validate_overrides(transcriber, continuous: bool, prompt,
                        temperature) -> str:
    """'' when OK; an error message when per-request prompt/temperature
    can't be honored by THIS server's engine/model — silently ignoring
    them (the pre-feature behavior) risks wrong transcripts."""
    if prompt is None and temperature is None:
        return ""
    if continuous:
        return ("per-request prompt/temperature need the micro-batching "
                "engine; this server runs --continuous")
    if temperature is not None and getattr(transcriber, "beams", 0) > 1:
        return "per-request temperature is greedy-only; this server beams"
    if prompt is not None:
        if getattr(transcriber, "family", "") != "whisper":
            return ("prompt conditioning is a whisper-family feature "
                    "(<|startofprev|> tokens)")
        table = getattr(transcriber, "token_table", None)
        if table is None or getattr(table, "text_backend", None) is None:
            return ("this server cannot tokenize 'prompt': the checkpoint "
                    "dir lacks vocab.json+merges.txt / tokenizer.json")
    return ""


def _validate_language(transcriber, language) -> str:
    """'' when OK; an error message for an unknown whisper language code.

    yoho-family and English-only models accept (and ignore) the field —
    matching OpenAI's lenient handling — but a multilingual whisper
    server rejects unknown codes instead of silently transcribing in the
    wrong language."""
    if language is None or transcriber.family != "whisper":
        return ""
    table = transcriber.token_table
    if language in table.languages:
        return ""
    if not table.multilingual:
        return ""  # English-only model: field is advisory
    return (f"unknown language {language!r}; expected an ISO 639-1 code "
            "the model was trained on (e.g. 'en', 'de', 'ja')")


def _decode_wav_bytes(body: bytes, target_sr: int) -> np.ndarray:
    from yoho_tpu_torch.audio.io import resample

    with wave.open(io.BytesIO(body), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        raw = w.readframes(w.getnframes())
    data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return resample(data, sr, target_sr)


def _parse_multipart(body: bytes, content_type: str):
    """multipart/form-data -> {field: (filename | None, bytes)} (stdlib).

    Repeated fields keep the LAST value (HTML-form convention) except
    array fields (OpenAI's ``timestamp_granularities[]``), whose every
    value is appended under the bracketed name as a list of bytes."""
    try:
        msg = BytesParser(policy=_HTTP_POLICY).parsebytes(
            b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
        if not msg.is_multipart():
            raise ValueError("expected multipart/form-data")
        fields = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if not name:
                continue
            payload = part.get_payload(decode=True)
            if payload is None:
                # Nested-multipart / structured parts carry no decodable
                # body; treat as empty rather than poisoning downstream
                # byte handling with None.
                payload = b""
            if name.endswith("[]"):
                fields.setdefault(name, []).append(payload)
            else:
                fields[name] = (part.get_filename(), payload)
        return fields
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 — email parser internals can
        # raise assorted exceptions on adversarial bytes; a malformed
        # BODY is the client's fault, so normalize everything to the
        # ValueError the endpoint maps to 400 (fuzz: never a 500/hang).
        raise ValueError(f"malformed multipart body: {type(e).__name__}: {e}")


def _audio_from_upload(filename, data: bytes, target_sr: int) -> np.ndarray:
    """Decode an uploaded audio file body. WAV natively; other containers
    via the ffmpeg-backed loader when available."""
    if data[:4] == b"RIFF":
        return _decode_wav_bytes(data, target_sr)
    import tempfile
    from pathlib import Path

    from yoho_tpu_torch.audio.io import load_audio_f32

    suffix = Path(filename or "upload.bin").suffix or ".bin"
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        f.write(data)
        f.flush()
        return load_audio_f32(f.name, target_sr)


def _segment_payload(s, index: int) -> dict:
    payload = {
        "id": index,
        "seek": 0,
        "start": s.start,
        "end": s.end,
        "text": s.text,
        "tokens": list(map(int, s.tokens)),
        **s.quality_payload(),
    }
    if s.speaker is not None:
        payload["speaker"] = s.speaker
    if s.speaker_name is not None:
        payload["speaker_name"] = s.speaker_name
    if s.words:
        payload["words"] = [
            {"word": w.word, "start": w.start, "end": w.end,
             "probability": w.probability} for w in s.words
        ]
    return payload


def _render_openai(result, response_format: str, duration: float, task: str,
                   granularities=("segment",)):
    """-> (content_type, bytes) per the OpenAI audio API response formats.

    ``granularities`` mirrors ``timestamp_granularities[]`` and shapes
    only ``verbose_json``: "segment" includes the segments array,
    "word" includes the flattened words array; either may be omitted."""
    if response_format == "text":
        return "text/plain; charset=utf-8", (result.text + "\n").encode()
    if response_format in ("srt", "vtt"):
        from yoho_tpu_torch.text.srt import (
            compose_srt,
            compose_vtt,
            segments_to_subtitles,
        )

        subs = segments_to_subtitles(result.segments)
        out = compose_srt(subs) if response_format == "srt" else compose_vtt(subs)
        return "text/plain; charset=utf-8", out.encode()
    if response_format == "verbose_json":
        payload = {
            "task": task,
            "language": result.language,
            "duration": round(duration, 3),
            "text": result.text,
        }
        if "segment" in granularities:
            payload["segments"] = [
                _segment_payload(s, i) for i, s in enumerate(result.segments)
            ]
        if "word" in granularities:
            payload["words"] = [
                {"word": w.word, "start": w.start, "end": w.end,
                 "probability": w.probability}
                for s in result.segments for w in (s.words or [])
            ]
        return ("application/json",
                json.dumps(payload, ensure_ascii=False).encode())
    # default: "json"
    return ("application/json",
            json.dumps({"text": result.text}, ensure_ascii=False).encode())


class OpenAIEndpointsMixin:
    """``/v1/audio/transcriptions`` + ``/v1/audio/translations``."""

    def _openai_audio(self, task: str) -> None:
        server_task = getattr(self.transcriber, "task", "transcribe")
        if task != server_task:
            self._json(400, {"error": {
                "message": (f"this server decodes task={server_task!r}; "
                            f"start it with --task {task} to serve this "
                            "endpoint"),
                "type": "invalid_request_error"}})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if "multipart/form-data" not in ctype:
                self._json(400, {"error": {
                    "message": "expected multipart/form-data with a "
                               "'file' field",
                    "type": "invalid_request_error"}})
                return
            try:
                fields = _parse_multipart(body, ctype)
            except ValueError as e:
                self._json(400, {"error": {
                    "message": str(e), "type": "invalid_request_error"}})
                return
            if "file" not in fields:
                self._json(400, {"error": {
                    "message": "missing required field 'file'",
                    "type": "invalid_request_error"}})
                return
            filename, data = fields["file"]
            try:
                audio = _audio_from_upload(filename, data,
                                           self.transcriber.sample_rate)
            except Exception as e:  # noqa: BLE001 — codec failure
                self._json(415, {"error": {
                    "message": f"could not decode {filename!r}: {e}",
                    "type": "invalid_request_error"}})
                return
            fmt = (fields.get("response_format", (None, b"json"))[1]
                   .decode().strip() or "json")
            if fmt not in ("json", "text", "verbose_json", "srt", "vtt"):
                self._json(400, {"error": {
                    "message": f"unsupported response_format {fmt!r}",
                    "type": "invalid_request_error"}})
                return
            granularities = tuple(
                v.decode().strip().lower()
                for v in fields.get("timestamp_granularities[]", [])
                if v.strip()) or ("segment",)
            if unknown := set(granularities) - {"segment", "word"}:
                self._json(400, {"error": {
                    "message": "unknown timestamp_granularities "
                               f"{sorted(unknown)} (use 'segment' "
                               "and/or 'word')",
                    "type": "invalid_request_error"}})
                return
            if granularities != ("segment",) and fmt != "verbose_json":
                self._json(400, {"error": {
                    "message": "timestamp_granularities requires "
                               "response_format=verbose_json",
                    "type": "invalid_request_error"}})
                return
            if ("word" in granularities
                    and not getattr(self.transcriber, "word_timestamps",
                                    False)):
                self._json(400, {"error": {
                    "message": "word timestamp_granularities need the "
                               "cross-attention alignment pass; start "
                               "the server with --word-timestamps",
                    "type": "invalid_request_error"}})
                return
            language = (fields.get("language", (None, b""))[1]
                        .decode().strip().lower() or None)
            err = _validate_language(self.transcriber, language)
            if err:
                self._json(400, {"error": {
                    "message": err, "type": "invalid_request_error"}})
                return
            prompt = (fields.get("prompt", (None, b""))[1]
                      .decode("utf-8", "replace").strip() or None)
            temp_raw = (fields.get("temperature", (None, b""))[1]
                        .decode().strip())
            temperature = None
            if temp_raw:
                try:
                    temperature = float(temp_raw)
                except ValueError:
                    self._json(400, {"error": {
                        "message": f"temperature {temp_raw!r} is not "
                                   "a number",
                        "type": "invalid_request_error"}})
                    return
                if not 0.0 <= temperature <= 2.0:
                    self._json(400, {"error": {
                        "message": f"temperature {temperature} outside "
                                   "[0, 2]",
                        "type": "invalid_request_error"}})
                    return
                temperature = _snap_temperature(temperature)
            err = _validate_overrides(self.transcriber, self.continuous,
                                      prompt, temperature)
            if err:
                self._json(400, {"error": {
                    "message": err, "type": "invalid_request_error"}})
                return
            stream_flag = (fields.get("stream", (None, b""))[1]
                           .decode().strip().lower() in ("true", "1"))
            if stream_flag:
                self._openai_audio_sse(audio, language,
                                       prompt=prompt,
                                       temperature=temperature)
                return
            kw = {}
            if prompt is not None:
                kw["prompt"] = prompt
            if temperature is not None:
                kw["temperature"] = temperature
            result = self._submit(audio, language=language, **kw)
            duration = len(audio) / self.transcriber.sample_rate
            ctype_out, out = _render_openai(result, fmt, duration, task,
                                            granularities=granularities)
            self._send(200, ctype_out, out)
        except ServerOverloaded as e:
            self._json(503, {"error": {
                "message": str(e), "type": "server_error"}},
                extra_headers={"Retry-After": "1"})
        except RequestCancelled:
            self.close_connection = True  # client is gone; no reply
        except Exception as e:  # noqa: BLE001 — report, keep serving
            self._json(500, {"error": {
                "message": f"{type(e).__name__}: {e}",
                "type": "server_error"}})

    def _openai_audio_sse(self, audio, language, prompt=None,
                          temperature=None) -> None:
        """OpenAI ``stream=true``: Server-Sent Events over the upload.

        The audio is fed window-by-window through a
        :class:`StreamingTranscriber` whose decoder is the SHARED
        batcher (streamed requests pool with everything else); every
        batch of finalized segments becomes a
        ``transcript.text.delta`` event, and the final
        ``transcript.text.done`` carries the assembled text (deltas
        concatenate to it exactly)."""
        from yoho_tpu_torch.infer.streaming import StreamingTranscriber

        lang = language or self.transcriber.language
        if lang is None and getattr(self.transcriber, "family", "") == "whisper":
            lang = "en"  # match /stream: never per-window auto-detect

        kw = {}
        if prompt is not None:
            kw["prompt"] = prompt  # conditions every window
        if temperature is not None:
            kw["temperature"] = temperature

        def _decode_shared(window_audio):
            # Same overload policy as /stream: a started SSE response
            # cannot be retried by the client, so wait out transient
            # overload instead of shedding mid-stream.
            while True:
                try:
                    return self._submit(window_audio, language=lang,
                                        vad=False, **kw).segments
                except ServerOverloaded:
                    if self._client_gone():
                        raise ConnectionError(
                            "client left during overload wait")
                    time.sleep(0.25)

        stream = StreamingTranscriber(self.transcriber,
                                      window_decoder=_decode_shared)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        # No Content-Length: the body ends when the socket closes.
        self.close_connection = True

        def _event(etype: str, payload: dict) -> None:
            data = json.dumps(payload, ensure_ascii=False)
            self.wfile.write(f"event: {etype}\ndata: {data}\n\n".encode())
            self.wfile.flush()

        sent_any = False

        def _delta(segments) -> None:
            nonlocal sent_any
            text = " ".join(s.text for s in segments if s.text).strip()
            if not text:
                return
            delta = text if not sent_any else " " + text
            sent_any = True
            _event("transcript.text.delta",
                   {"type": "transcript.text.delta", "delta": delta})

        try:
            step = getattr(self.transcriber, "chunk_samples", 0) or len(audio)
            for off in range(0, max(len(audio), 1), step):
                _delta(stream.push(audio[off:off + step]))
            _delta(stream.flush())
            _event("transcript.text.done",
                   {"type": "transcript.text.done", "text": stream.text()})
        except (ConnectionError, OSError, RequestCancelled):
            pass  # client went away mid-stream; nothing to answer
        except Exception as e:  # noqa: BLE001 — headers are out; report
            # in-band (an HTTP error status is no longer possible).
            try:
                _event("error", {"type": "error",
                                 "message": f"{type(e).__name__}: {e}"})
            except OSError:
                pass
