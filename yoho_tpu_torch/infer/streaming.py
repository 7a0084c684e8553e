"""Streaming transcription: push audio incrementally, pull finalized segments.

The JAX package's ``infer/streaming.py``: a stateful wrapper over the
batched Transcriber that decodes each fixed window as soon as enough audio
has arrived, through the same decode programs.
Segments are finalized once they can no longer be revised by a later
overlapping window (their midpoint falls in territory owned by an already-
decoded window — the same ownership rule as offline stitching, so a
streamed session yields exactly the segments of an offline transcribe over
the same audio, modulo the unavoidable final partial window).
"""

from __future__ import annotations

from typing import List

import numpy as np

from yoho_tpu_torch.infer.longform import Segment, window_ownership_bounds


class StreamingTranscriber:
    def __init__(self, transcriber, window_decoder=None,
                 track_speakers: bool = False,
                 partial_interval_seconds=None):
        """``window_decoder(window_audio) -> List[Segment]`` (window-
        relative, quality attached) optionally replaces the built-in B=1
        decode — the server passes its shared request batcher here so
        CONCURRENT streams' windows pool into shared batches/slots
        instead of each paying a lone B=1 decode.

        ``track_speakers=True`` (the JAX package's online speaker tracker
        over finalized segments) is not in the port yet: it raises,
        naming its ROADMAP.md item.

        ``partial_interval_seconds`` (opt-in, live captions): without it
        the first hypothesis appears only once a FULL window of audio has
        arrived (chunk_seconds of fill — ~30 s for whisper — dominates
        first-partial latency).
        With it, whenever at least this much new audio has accumulated
        since the last decode, the current *incomplete* window is decoded
        zero-padded and exposed through :meth:`partial_segments` as a
        provisional hypothesis. Finalized output is BIT-IDENTICAL with or
        without it (provisional decodes never enter finalization — pinned
        in the JAX package's tests/test_streaming.py); the cost is one
        extra B=1 decode per interval through the same decode program (the
        window is padded to chunk_samples either way)."""
        if track_speakers:
            from yoho_tpu_torch.infer.pipeline import _not_ported

            _not_ported("track_speakers (the online speaker tracker)", 12)
        self.t = transcriber
        self._window_decoder = window_decoder
        if partial_interval_seconds is not None:
            if partial_interval_seconds < 0.1:
                # A sub-frame interval (e.g. a 0.00005 typo for 0.5)
                # would pass a bare > 0 check, floor to 0 samples, and
                # trigger one full B=1 device decode per pushed frame,
                # saturating the card for a single stream. Captions
                # faster than 10/s are meaningless anyway.
                raise ValueError("partial_interval_seconds must be >= 0.1 "
                                 f"seconds, got {partial_interval_seconds}")
            self._partial_interval = int(
                partial_interval_seconds * transcriber.sample_rate)
        else:
            self._partial_interval = None
        self._provisional = None  # (window_start, [Segment]) | None
        self._last_decode_at = 0  # absolute samples at last decode
        self._buffer = np.zeros((0,), np.float32)
        self._next_window_start = 0  # absolute sample index
        self._emitted: List[Segment] = []
        self._pending: List[tuple] = []  # (window_start, [Segment])
        self._consumed = 0  # absolute samples consumed into buffer
        self._flushed = False

    # ------------------------------------------------------------------
    def _decode_window(self, window_start: int, audio: np.ndarray):
        segs = self._decode_segments(audio)
        self._pending.append((window_start, segs))
        # A full-window decode supersedes any provisional hypothesis and
        # resets the partial cadence (the freshest hypothesis is now this
        # window's — an immediate partial re-decode would add nothing).
        self._provisional = None
        self._last_decode_at = self._consumed

    def _decode_segments(self, audio: np.ndarray) -> List[Segment]:
        """Decode one (possibly partial) window -> window-relative
        segments. Shared by full-window decodes and provisional partial
        decodes so both run the identical path (VAD gate included)."""
        t = self.t
        if getattr(t, "vad_filter", False):
            # Streaming VAD gate: a window with no detected speech never
            # touches the device (live streams are mostly silence). Unlike
            # offline vad_filter this only *skips* windows — it never
            # collapses time, so the stream's timeline is untouched.
            from yoho_tpu_torch.audio.vad import detect_speech

            if not detect_speech(audio, t.sample_rate, t.vad_options):
                return []
        if self._window_decoder is not None:
            return self._window_decoder(audio)
        batch = np.zeros((1, t.chunk_samples), np.float32)
        n = min(len(audio), t.chunk_samples)
        batch[0, :n] = audio[:n]
        mel = t._features(batch)
        # The decode program returns host arrays.
        tokens, lengths, aux = t._decode_with_fallback(1, mel)
        silent = t._silent_mask(lengths, aux)
        segs = ([] if silent[0]
                else t._tokens_to_segments(tokens[0], int(lengths[0])))
        t._attach_quality([segs], lengths, aux)
        t._attach_words(mel[:1], tokens[:1], lengths[:1], [segs])
        # shifted(0) quantizes times to the same 1 ms grid the hook path's
        # segments already carry (stitch_segments rounds inside
        # _finalize_request) — midpoint ownership in _finalize and the
        # final timestamps are then bit-identical across both paths.
        return [s.shifted(0) for s in segs]

    def _finalize(self, final: bool) -> List[Segment]:
        """Apply the midpoint-ownership rule across pending windows."""
        t = self.t
        sr = t.sample_rate
        chunk_s = t.chunk_samples / sr
        stride_s = t.stride_samples / sr
        out: List[Segment] = []
        n = len(self._pending)
        for w, (start, segs) in enumerate(self._pending):
            off = start / sr
            lo, hi = window_ownership_bounds(
                off, chunk_s, stride_s, is_first=(start == 0),
                is_last=(final and w == n - 1))
            if not final and w == n - 1:
                # The last pending window may still be revised — hold it.
                continue
            for seg in segs:
                mid = off + (seg.start + seg.end) / 2
                if lo <= mid < hi:
                    out.append(seg.shifted(off))
        # Drop finalized windows; keep the last (still revisable) one.
        if not final and self._pending:
            self._pending = self._pending[-1:]
        elif final:
            self._pending = []
        out.sort(key=lambda s: (s.start, s.end))
        self._emitted.extend(out)
        return out

    # ------------------------------------------------------------------
    def push(self, audio: np.ndarray) -> List[Segment]:
        """Feed more audio; returns newly finalized segments."""
        if self._flushed:
            # flush() decoded the final partial window and discarded the
            # buffer; pushing afterwards would silently decode corrupted
            # windows (the dropped tail cannot be reconstructed).
            raise RuntimeError(
                "stream already flushed — create a new StreamingTranscriber "
                "for a new session")
        t = self.t
        audio = np.asarray(audio, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, audio])
        self._consumed += len(audio)

        new: List[Segment] = []
        while self._consumed - self._next_window_start >= t.chunk_samples:
            rel = self._next_window_start - (self._consumed - len(self._buffer))
            window = self._buffer[rel : rel + t.chunk_samples]
            self._decode_window(self._next_window_start, window)
            self._next_window_start += t.stride_samples
            new.extend(self._finalize(final=False))
        # Trim buffer to what future windows still need.
        keep_from = self._next_window_start - (self._consumed - len(self._buffer))
        if keep_from > 0:
            self._buffer = self._buffer[keep_from:]
        if (self._partial_interval is not None
                and self._consumed > self._next_window_start
                and self._consumed - self._last_decode_at
                >= self._partial_interval):
            # Provisional decode of the incomplete tail window (zero-
            # padded by the decode path): live captions get a hypothesis
            # every partial_interval instead of waiting out the window
            # fill. Never enters finalization.
            rel = self._next_window_start - (self._consumed
                                             - len(self._buffer))
            tail = self._buffer[max(rel, 0):]
            if len(tail) > 0:
                self._provisional = (self._next_window_start,
                                     self._decode_segments(tail))
                self._last_decode_at = self._consumed
        return new

    def flush(self) -> List[Segment]:
        """End of stream: decode the remaining partial window, finalize
        all. TERMINAL: subsequent push() raises (idempotent re-flush is
        allowed and returns nothing new)."""
        if self._flushed:
            return []
        self._flushed = True
        t = self.t
        # Decode the tail only when the OFFLINE window plan would: for
        # (padded) length m, offline starts are range(0, m - chunk +
        # stride, stride) (longform.plan_windows). A stream ending
        # exactly on decoded coverage must not decode one more
        # overlap-window — its final-window ownership extends to
        # infinity, so any hallucinated segment in the re-decoded
        # overlap would be KEPT, breaking streamed == offline parity
        # (observed: a micro model duplicating the tail sentence).
        m = max(self._consumed, t.chunk_samples)
        if (self._next_window_start
                < m - t.chunk_samples + t.stride_samples):
            rel = self._next_window_start - (self._consumed - len(self._buffer))
            tail = self._buffer[max(rel, 0):]
            if len(tail) > 0:
                self._decode_window(self._next_window_start, tail)
        out = self._finalize(final=True)
        self._buffer = np.zeros((0,), np.float32)
        self._provisional = None  # the tail is now decoded for real
        return out

    def soft_flush(self) -> List[Segment]:
        """Mid-stream flush: finalize EVERYTHING buffered so far
        (including the partial tail window) and keep the stream USABLE —
        the next push() starts a fresh window plan at the current
        position. Finals stay never-revised; the cost is a window-plan
        boundary at the flush point (decode context does not span it) —
        exactly the semantics of a live "force captions out now" op.
        The websocket ``{"op": "flush"}`` handler uses this; the
        terminal :meth:`flush` would kill the session on the next
        audio frame."""
        if self._flushed:
            return []
        out = self.flush()
        # Re-arm: continue from the current absolute position with an
        # empty buffer (everything before it is finalized and emitted).
        self._flushed = False
        self._buffer = np.zeros((0,), np.float32)
        self._pending = []
        self._next_window_start = self._consumed
        return out

    @property
    def segments(self) -> List[Segment]:
        """All segments finalized so far."""
        return list(self._emitted)

    def partial_segments(self) -> List[Segment]:
        """Current UNFINALIZED hypotheses: segments of the last decoded,
        still-revisable window — plus, with ``partial_interval_seconds``,
        the provisional decode of the still-incomplete tail window — on
        the absolute timeline. Live captions show these immediately; a
        later overlapping window may revise them, so they must be
        replaced (not appended) by the next partial or final batch."""
        sr = self.t.sample_rate
        out = [seg.shifted(start / sr)
               for start, segs in self._pending for seg in segs]
        if self._provisional is not None:
            start, segs = self._provisional
            # The provisional tail window overlaps the last pending
            # window by (chunk - stride): hypotheses there are already
            # shown by the pending window, and emitting both would
            # duplicate the overlap-region captions in every partial
            # message. Keep only the provisional segments whose midpoint
            # lies in audio the pending windows do not cover.
            covered = max((s + self.t.chunk_samples
                           for s, _ in self._pending), default=0) / sr
            for seg in segs:
                abs_seg = seg.shifted(start / sr)
                if (abs_seg.start + abs_seg.end) / 2 >= covered:
                    out.append(abs_seg)
        return out

    def text(self) -> str:
        return " ".join(s.text for s in self._emitted if s.text).strip()
