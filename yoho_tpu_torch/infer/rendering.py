"""Token-stream rendering for :class:`Transcriber` (whisper family):
timestamped segments, text, word timings and forced alignment.

The whisper half of the JAX package's ``infer/rendering.py``: segment
parsing, word timestamps by DTW over the teacher-forced cross-attention
map (``_attach_words``), and forced alignment of a known transcript
(``align``, ``align_many``) on audio arrays.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

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

    def align(self, audio: np.ndarray, text: str,
              sample_rate: Optional[int] = None) -> List[WordTiming]:
        """Forced alignment: word timings for a known transcript of one
        window of audio (30 s for whisper). Teacher-forces the text through
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
