"""Word-level timestamps by DTW over the cross-attention alignment map.

A copy of the JAX package's ``infer/word_timestamps.py`` (which imports no
JAX): after decoding, one teacher-forced pass collects the head-averaged
cross-attention of the upper decoder layers (``cross_attention_map``);
dynamic time warping over that (text token x audio frame) matrix gives a
monotonic token -> frame alignment, and word boundaries come from the
tokenizer's space-marked pieces.

The JAX package runs its DTW in C++ (``native/dtw.cpp``), with a Python
DP as the reference. Here the DP runs as a numpy anti-diagonal wavefront:
every cell of diagonal i + j depends only on the two diagonals before it,
so each diagonal is one vector step. The accumulation is float64 and the
tie rule the Python DP's (diagonal first, then up, then left), so the
trace equals the Python DP's cell for cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class WordTiming:
    word: str
    start: float
    end: float
    # Mean realized-token probability of the word's tokens, from the same
    # teacher-forced pass as the alignment; 1.0 without probabilities.
    probability: float = 1.0


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through an (N, M) cost matrix -> (text_indices,
    time_indices) of the optimal path, with steps (i+1, j), (i, j+1) and
    (i+1, j+1)."""
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for d in range(2, n + m + 1):
        i = np.arange(max(1, d - m), min(n, d - 1) + 1)
        j = d - i
        c0, c1, c2 = acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]
        t = np.where((c0 <= c1) & (c0 <= c2), 0, np.where(c1 <= c2, 1, 2))
        acc[i, j] = np.choose(t, (c0, c1, c2)) + cost[i - 1, j - 1]
        trace[i, j] = t

    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        if i > 0 and j > 0:
            t = trace[i, j]
        elif i > 0:
            t = 1
        else:
            t = 2
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text_idx[::-1]), np.asarray(time_idx[::-1])


def token_frame_alignment(attn: np.ndarray) -> np.ndarray:
    """(S_text, T_audio) averaged attention -> first aligned frame per
    token. The matrix is z-normalized per text position before the DTW
    (whisper's convention), so loud frames do not dominate."""
    a = attn.astype(np.float64)
    std = a.std(axis=-1, keepdims=True)
    a = (a - a.mean(axis=-1, keepdims=True)) / np.where(std > 0, std, 1.0)
    text_idx, time_idx = dtw_path(-a)
    frames = np.zeros(attn.shape[0], dtype=np.int64)
    seen = set()
    for ti, fj in zip(text_idx, time_idx):
        if ti not in seen:
            frames[ti] = fj
            seen.add(ti)
    return frames


def split_words(token_ids: Sequence[int], decode_pieces,
                decode_group=None) -> List[Tuple[str, List[int]]]:
    """Group BPE token ids into words by the leading-space convention.

    ``decode_pieces(ids)`` returns the piece string of the ids (leading
    spaces intact), used only to find boundaries; a word's text is
    ``decode_group(ids)`` of its ids together when given (byte-level pieces
    alone would garble multi-byte characters). Returns [(word, [token
    indices])]."""
    groups: List[List[int]] = []
    cur_idx: List[int] = []
    for pos, tid in enumerate(token_ids):
        piece = decode_pieces([tid])
        if piece.startswith(" ") and cur_idx:
            groups.append(cur_idx)
            cur_idx = []
        cur_idx.append(pos)
    if cur_idx:
        groups.append(cur_idx)

    render = decode_group or decode_pieces
    words: List[Tuple[str, List[int]]] = []
    for idxs in groups:
        text = render([token_ids[i] for i in idxs]).strip()
        if text:
            words.append((text, idxs))
    return words


def words_from_alignment(
    token_ids: Sequence[int],
    frames: np.ndarray,
    seconds_per_frame: float,
    decode_pieces,
    max_duration: Optional[float] = None,
    decode_group=None,
    probs: Optional[np.ndarray] = None,
) -> List[WordTiming]:
    """The token -> frame alignment grouped into timed words. ``probs``
    (len(token_ids),): per-token realized probabilities; a word's
    ``probability`` is the mean over its tokens."""
    words = split_words(token_ids, decode_pieces, decode_group)
    out: List[WordTiming] = []
    n = len(token_ids)
    for word, idxs in words:
        start_f = frames[idxs[0]]
        end_f = frames[idxs[-1] + 1] if idxs[-1] + 1 < n else frames[idxs[-1]] + 1
        start = float(start_f) * seconds_per_frame
        if max_duration is not None:
            # Clamp both ends: DTW can drift trailing tokens into the
            # zero-padded tail.
            start = min(start, max(max_duration - seconds_per_frame, 0.0))
        end = max(float(end_f) * seconds_per_frame, start + seconds_per_frame)
        if max_duration is not None:
            end = min(end, max_duration)
            end = max(end, start)
        p = (1.0 if probs is None
             else float(np.mean([probs[i] for i in idxs])))
        out.append(WordTiming(word=word, start=round(start, 3),
                              end=round(end, 3), probability=round(p, 4)))
    return out
