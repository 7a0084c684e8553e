"""Token-stream rendering for :class:`Transcriber` (whisper family):
timestamped segments, text, word timings and forced alignment.

The whisper half of the JAX package's ``infer/rendering.py``: segment
parsing, word timestamps by DTW over the teacher-forced cross-attention
map (``_attach_words``), forced alignment of a known transcript
(``align``, ``align_many``), the map of VAD-condensed times back to the
source audio (``_remap_segments``) and the silence-hallucination filter
(``_drop_silence_hallucinations``).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from yoho_tpu_torch.audio.vad import detect_speech
from yoho_tpu_torch.infer.longform import Segment
from yoho_tpu_torch.infer.word_timestamps import (
    WordTiming,
    token_frame_alignment,
    words_from_alignment,
)


class RenderingMixin:
    """Segment parsing / rendering half of the Transcriber."""

    def _decode_piece(self, tid: int) -> str:
        tb = self.token_table.text_backend
        piece = tb.convert_ids_to_tokens([int(tid)])[0]
        return self._space_piece(piece)

    def _space_piece(self, piece: str) -> str:
        return piece.replace("Ġ", " ")

    def _is_text_token(self, t: int) -> bool:
        """Plain text ids only (no specials or timestamps)."""
        return t < self.token_table.eot

    def _words(self, text_ids: Sequence[int], frames: np.ndarray, probs: np.ndarray,
               max_duration: float) -> List[WordTiming]:
        """Timed words of aligned text tokens (one encoder position is two
        mel frames)."""
        return words_from_alignment(
            text_ids, frames, 2 * self.hop / self.sample_rate,
            lambda ii: "".join(self._decode_piece(t) for t in ii),
            max_duration=max_duration, decode_group=self._render, probs=probs)

    def _attach_words(self, mel: torch.Tensor, tokens: np.ndarray,
                      lengths: np.ndarray, per_window,
                      n_prompt: Optional[int] = None) -> None:
        """Word timestamps: DTW over the teacher-forced cross-attention map
        of the whole padded batch (rows without segments are skipped).
        ``n_prompt`` keeps prompt positions out of the words: a prompted
        request's prompt holds text tokens."""
        if not self.word_timestamps or self.token_table.text_backend is None:
            return
        skip = n_prompt if n_prompt is not None else len(self._prompt_ids())
        b = tokens.shape[0]
        pad = np.full((b, self.max_len), self.eot, np.int64)
        pad[:, : tokens.shape[1]] = tokens[:, : self.max_len]
        amap, probs = self._align_fn(mel, pad)
        for j, segs in enumerate(per_window):
            n = int(lengths[j])
            ids = [int(t) for t in tokens[j, :n]]
            text_pos = [i for i, t in enumerate(ids)
                        if i >= skip and self._is_text_token(t)]
            if not text_pos or not segs:
                continue
            frames = token_frame_alignment(amap[j, :n])
            words = self._words([ids[i] for i in text_pos], frames[text_pos],
                                probs[j][text_pos],
                                self.chunk_samples / self.sample_rate)
            # Words go to the segment holding their midpoint (with a float
            # epsilon for a word ending on the boundary).
            for seg in segs:
                seg.words = [w for w in words
                             if seg.start - 1e-6 <= (w.start + w.end) / 2
                             <= seg.end + 1e-6]

    def _align_ids(self, text: str):
        """(prompt_ids, text_ids) for a teacher-forced alignment pass; an
        auto-detecting transcriber aligns against English (forced alignment
        is language-insensitive up to the tokenizer's text)."""
        tt = self.token_table
        return (tt.sot_sequence(self.language or "en", "transcribe",
                                timestamps=False),
                [int(t) for t in tt.encode_text(" " + text.strip())])

    def align(self, audio, text: str,
              sample_rate: Optional[int] = None) -> List[WordTiming]:
        """Forced alignment: word timings for a known transcript of one
        window of audio (30 s for whisper; an array or a file path). Teacher-forces the text through
        the decoder and runs the word-timestamp DTW on its cross-attention
        map."""
        return self._align_pairs([(audio, text)], sample_rate, 1)[0]

    def align_many(self, pairs: Sequence[tuple], sample_rate: Optional[int] = None
                   ) -> List[List[WordTiming]]:
        """Batched forced alignment: [(audio, text), ...] -> [[WordTiming]],
        one window per pair, pooled into padded batches of ``batch_size``."""
        return self._align_pairs(pairs, sample_rate, self.batch_size)

    def _align_pairs(self, pairs: Sequence[tuple], sample_rate: Optional[int],
                     b: int) -> List[List[WordTiming]]:
        prepped = []
        for audio, text in pairs:
            audio = self._prepare_audio(audio, sample_rate)
            if len(audio) > self.chunk_samples:
                raise ValueError(
                    f"alignment takes one window (<= "
                    f"{self.chunk_samples / self.sample_rate:.0f} s) per pair; "
                    "split longer audio at utterance boundaries first")
            sot, text_ids = self._align_ids(text)
            ids = sot + text_ids + [self.eot]
            if len(ids) > self.max_len:
                raise ValueError(f"text too long ({len(ids)} tokens > {self.max_len})")
            prepped.append((audio, text_ids, ids, len(sot)))

        results: List[List[WordTiming]] = []
        for i in range(0, len(prepped), b):
            group = prepped[i: i + b]
            window = np.zeros((b, self.chunk_samples), np.float32)
            pad = np.full((b, self.max_len), self.eot, np.int64)
            for j, (audio, _text_ids, ids, _n_sot) in enumerate(group):
                window[j, : len(audio)] = audio
                pad[j, : len(ids)] = ids
            amap, probs = self._align_fn(self._features(window), pad)
            for j, (audio, text_ids, ids, n_sot) in enumerate(group):
                frames = token_frame_alignment(amap[j, : len(ids)])
                text_pos = list(range(n_sot, n_sot + len(text_ids)))
                results.append(self._words(text_ids, frames[text_pos],
                                           probs[j][text_pos],
                                           len(audio) / self.sample_rate))
        return results

    def _tokens_to_segments(self, tokens: np.ndarray, length: int,
                            n_prompt: Optional[int] = None) -> List[Segment]:
        """Parse one stream's tokens into timestamped segments, skipping the
        first ``n_prompt`` positions (default: the configured prompt)."""
        if n_prompt is None:
            n_prompt = len(self._prompt_ids())
        toks = [int(t) for t in tokens[n_prompt:length]]
        segs: List[Segment] = []

        def close(start, end, cur):
            segs.append(Segment(start, end, self._render(cur), cur))

        def open_segment(new_start, cur, prev_end):
            """Text between a closing and the next opening timestamp becomes
            its own segment over the gap [prev_end, new_start]."""
            if cur:
                close(prev_end, new_start, cur)
            return new_start

        tt = self.token_table
        cur: List[int] = []
        start: Optional[float] = None
        prev_end = 0.0
        for t in toks:
            if tt.is_timestamp(t):
                ts = tt.timestamp_seconds(t)
                if start is None:
                    start = open_segment(ts, cur, prev_end)
                    cur = []
                else:
                    close(start, ts, cur)
                    cur, start, prev_end = [], None, ts
            elif t >= tt.eot:
                continue  # specials
            else:
                cur.append(t)
        if cur:
            # Truncated tail (no closing timestamp): close at the window
            # end, clamped — the opening timestamp may exceed the window.
            end = max(self.chunk_samples / self.sample_rate,
                      start if start is not None else prev_end)
            close(start if start is not None else prev_end, end, cur)
        return segs

    def _render(self, ids: Sequence[int]) -> str:
        try:
            return self.token_table.decode_text(ids).strip()
        except RuntimeError:
            # No BPE vocab: results carry token ids with empty text. Warn
            # once, loudly.
            if not getattr(self, "_warned_no_text_backend", False):
                self._warned_no_text_backend = True
                warnings.warn(
                    "Transcriber has no text backend: whisper token ids "
                    "cannot be rendered as text (results will have text='' "
                    "but populated .tokens). Pass token_table.text_backend.",
                    stacklevel=2)
            return ""

    def _drop_silence_hallucinations(self, segments: List[Segment],
                                     audio) -> List[Segment]:
        """faster-whisper's ``hallucination_silence_threshold`` as a
        post-pass: drop a segment whose audio span is essentially
        speech-free (<10% speech by the energy VAD) AND sits inside a
        silence run at least ``threshold`` seconds long. Windows decode in
        parallel batches, so the filter runs on the stitched result instead
        of steering the decoder. Runs on the source timeline (after the VAD
        remap), so it composes with ``vad_filter``."""
        thr = self.hallucination_silence_threshold
        if thr is None or not segments or audio is None:
            return segments
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 1 or len(audio) == 0:
            return segments
        sr = self.sample_rate
        spans = detect_speech(audio, sr, self.vad_options)

        def speech_seconds(a: int, b: int) -> float:
            return sum(max(0, min(e, b) - max(s, a)) for s, e in spans) / sr

        def silence_run(a: int, b: int) -> float:
            """Length of the speech-free run containing the segment
            midpoint (0 when speech covers it)."""
            mid = (a + b) // 2
            lo, hi = 0, len(audio)
            for s, e in spans:
                if e <= mid:
                    lo = max(lo, e)
                elif s >= mid:
                    hi = min(hi, s)
                else:
                    return 0.0
            return (hi - lo) / sr

        kept = []
        for seg in segments:
            a = int(seg.start * sr)
            b = max(int(seg.end * sr), a + 1)
            dur = (b - a) / sr
            if (speech_seconds(a, b) < 0.1 * dur
                    and silence_run(a, b) >= thr):
                continue
            kept.append(seg)
        return kept

    @staticmethod
    def _remap_segments(segments: List[Segment], vmap) -> List[Segment]:
        """Map condensed-timeline times (``vad_filter``) back to the source
        audio."""
        if vmap is None:
            return segments
        for seg in segments:
            seg.start = vmap.to_original(seg.start)
            seg.end = vmap.to_original(seg.end, end=True)
            for w in seg.words or []:
                w.start = vmap.to_original(w.start)
                w.end = vmap.to_original(w.end, end=True)
        return segments
