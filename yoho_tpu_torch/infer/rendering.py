"""Token-stream rendering for :class:`Transcriber` (whisper family):
timestamped segments and text.

The subset of the JAX package's ``infer/rendering.py`` that
``transcribe_many`` uses without word timestamps.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np

from yoho_tpu_torch.infer.longform import Segment


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
