"""Long-form audio: batched fixed-window chunking + deterministic stitching.

The reference truncates everything to one 30 s window at inference
(``whisper.py:251-253``); long audio is only handled offline by the dataset
splitter. Here long-form is a first-class *inference* feature (north star):
audio is cut into fixed windows with overlap, all windows decode **in
parallel** as one padded batch (static shapes), and segments are stitched by
assigning each to the window that owns its midpoint — deterministic, so
repeated runs produce identical transcripts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Segment:
    start: float  # seconds, absolute in the source audio
    end: float
    text: str
    tokens: List[int] = field(default_factory=list)
    voiceprint: Optional[np.ndarray] = None
    speaker: Optional[int] = None  # diarization label (yoho family)
    speaker_name: Optional[str] = None  # recognition vs enrolled voiceprints
    words: Optional[list] = None  # List[WordTiming] when word_timestamps on
    # Decode-quality signals, stamped per source window (whisper family):
    # mean logprob of the window's generated tokens, p(<|nospeech|>) at the
    # transcript start, the temperature-ladder rung the window ended on,
    # and gzip compression ratio of the window text (repetition signal).
    avg_logprob: Optional[float] = None
    no_speech_prob: Optional[float] = None
    temperature: Optional[float] = None
    compression_ratio: Optional[float] = None

    def quality_payload(self) -> dict:
        """The decode-quality fields every JSON surface exposes (CLI
        --json, HTTP /transcribe, OpenAI verbose_json, WebSocket) — one
        source so a new signal propagates to all of them."""
        return {
            "avg_logprob": self.avg_logprob,
            "no_speech_prob": self.no_speech_prob,
            "temperature": self.temperature,
            "compression_ratio": self.compression_ratio,
        }

    def shifted(self, off: float) -> "Segment":
        """Copy with window-relative times rebased by ``off`` seconds
        (segment bounds AND word timings) — the one place the
        field-by-field rebase lives (stitching, streaming finalize,
        streaming partials all use it; a per-site copy silently drops
        newly added fields)."""
        return Segment(
            start=round(off + self.start, 3),
            end=round(off + self.end, 3),
            text=self.text,
            tokens=list(self.tokens),
            voiceprint=self.voiceprint,
            speaker=self.speaker,
            speaker_name=self.speaker_name,
            words=[type(w)(w.word, round(off + w.start, 3),
                           round(off + w.end, 3), w.probability)
                   for w in self.words] if self.words else None,
            avg_logprob=self.avg_logprob,
            no_speech_prob=self.no_speech_prob,
            temperature=self.temperature,
            compression_ratio=self.compression_ratio,
        )


def chunk_audio(
    audio: np.ndarray,
    chunk_samples: int,
    stride_samples: int,
) -> Tuple[np.ndarray, List[int]]:
    """Slice (n,) audio into zero-padded windows.

    Returns (windows (W, chunk_samples) float32, window start offsets).
    A single window covers short audio; stride < chunk gives overlap.
    """
    n = len(audio)
    if n <= chunk_samples:
        out = np.zeros((1, chunk_samples), np.float32)
        out[0, :n] = audio
        return out, [0]
    # The half-open stop guarantees tail coverage: the interval
    # [n - chunk, n - chunk + stride) contains exactly one multiple of
    # stride, so the last window always reaches the end of the audio.
    starts = list(range(0, n - chunk_samples + stride_samples, stride_samples))
    windows = np.zeros((len(starts), chunk_samples), np.float32)
    for i, s in enumerate(starts):
        seg = audio[s : s + chunk_samples]
        windows[i, : len(seg)] = seg
    return windows, starts


def window_ownership_bounds(off: float, chunk_s: float, stride_s: float,
                            is_first: bool, is_last: bool):
    """[lo, hi) absolute-time ownership of a window starting at ``off``
    seconds — THE midpoint rule, shared by offline stitching and the
    streaming finalizer so streamed == offline parity cannot drift."""
    lo = -np.inf if is_first else off + chunk_s / 2 - stride_s / 2
    hi = np.inf if is_last else off + chunk_s / 2 + stride_s / 2
    return lo, hi


def stitch_segments(
    per_window: Sequence[Sequence[Segment]],
    window_starts: Sequence[int],
    sample_rate: int,
    chunk_samples: int,
    stride_samples: int,
) -> List[Segment]:
    """Merge per-window segments into one absolute-time transcript.

    Ownership rule: window w owns absolute time range
    [start_w + L/2 - stride/2, start_w + L/2 + stride/2) (clamped to the
    audio bounds); a segment belongs to the window that owns its midpoint.
    With overlapping windows each instant is owned by exactly one window,
    so overlap duplicates are dropped deterministically.
    """
    out: List[Segment] = []
    n_win = len(window_starts)
    for w, segs in enumerate(per_window):
        off = window_starts[w] / sample_rate
        lo, hi = window_ownership_bounds(
            off, chunk_samples / sample_rate, stride_samples / sample_rate,
            is_first=(w == 0), is_last=(w == n_win - 1))
        for seg in segs:
            mid = off + (seg.start + seg.end) / 2
            if lo <= mid < hi:
                out.append(seg.shifted(off))
    out.sort(key=lambda s: (s.start, s.end))
    return out
