"""Voice activity detection + silence collapsing (host-side, numpy).

A copy of the JAX package's ``audio/vad.py`` (the port imports nothing of
``yoho_tpu``); the tests hold the two to equal spans and maps.

The reference has no VAD; its long-form story is an *offline* dataset
splitter (``train/tools/split_transcribed_tracks.py``) and a 30 s truncate
demo (``yoho/src/nn/whisper.py:251-253``). For a serving framework this is
a first-class throughput feature: real long-form audio (meetings, calls,
dictation) is often mostly silence, and every silent 30 s window still
costs a full encoder pass + 224 decode steps on the accelerator.
Collapsing silence on the host before windowing means the device only
ever sees speech.

Division of labor: the host does cheap
sequential DSP (energy framing, thresholding, span bookkeeping), the
device keeps its static-shape batched programs — VAD changes *how many*
windows are decoded, never their shape.

Algorithm (energy VAD with adaptive noise floor + hangover smoothing):

1. Frame the signal and compute per-frame RMS energy in dBFS.
2. A frame is speech when its energy clears BOTH an absolute floor
   (``absolute_floor_db``, guards against digital silence) and an
   adaptive threshold (noise-floor percentile + ``margin_db``).
3. Smooth: pad each speech run by ``speech_pad_ms``, merge runs separated
   by less than ``min_silence_ms`` (short pauses stay in the audio so the
   model sees natural prosody), drop runs shorter than ``min_speech_ms``.

``collapse_silence`` concatenates the kept spans and returns a
``SpeechMap`` that maps condensed-timeline seconds back to the original
timeline, so segment and word timestamps stay true to the source audio.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class VadOptions:
    """Tuning knobs for :func:`detect_speech`.

    frame_ms:          analysis frame length.
    hop_ms:            analysis hop.
    margin_db:         how far above the estimated noise floor a frame
                       must rise to count as speech.
    absolute_floor_db: frames below this dBFS are always silence (guards
                       against an "adaptive" threshold chasing digital
                       silence down to -inf).
    speech_ceiling_db: frames above this dBFS are always speech. Caps the
                       adaptive threshold so an ALL-speech signal (where
                       the "noise floor" percentile lands on speech
                       energy) is not rejected wholesale — the failure
                       mode of purely adaptive energy VADs on short
                       windows (e.g. the streaming per-window gate).
    noise_percentile:  percentile of frame energies used as the noise
                       floor estimate.
    min_speech_ms:     drop speech runs shorter than this (clicks).
    min_silence_ms:    silences shorter than this are kept inside a
                       speech region (natural pauses).
    speech_pad_ms:     widen every kept region by this much on each side
                       (protects soft onsets/offsets).
    """

    frame_ms: float = 30.0
    hop_ms: float = 10.0
    margin_db: float = 6.0
    absolute_floor_db: float = -55.0
    speech_ceiling_db: float = -35.0
    noise_percentile: float = 10.0
    min_speech_ms: float = 250.0
    min_silence_ms: float = 1000.0
    speech_pad_ms: float = 300.0


def frame_energies_db(audio: np.ndarray, sample_rate: int,
                      opts: VadOptions) -> Tuple[np.ndarray, int]:
    """Per-frame RMS energy in dBFS. Returns (energies, hop_samples).

    O(n) via a cumulative sum of squares (exact for the rectangular RMS
    window) — a materialized (frames, frame_len) gather costs ~100x more
    memory traffic and made hour-scale VAD slower than the decode it was
    meant to save (measured: 15 s for 16 min of audio; this runs in ms).
    """
    audio = np.asarray(audio, np.float32)
    frame = max(int(sample_rate * opts.frame_ms / 1000.0), 1)
    hop = max(int(sample_rate * opts.hop_ms / 1000.0), 1)
    if len(audio) < frame:
        pad = np.zeros(frame, np.float32)
        pad[: len(audio)] = audio
        audio = pad
    n = 1 + (len(audio) - frame) // hop
    if frame % hop == 0:
        # Frames start at hop multiples, so when frame is a whole number
        # of hop blocks a frame sum is a run of k block sums. Block sums
        # are computed STREAMING over a small reused scratch buffer: no
        # audio-sized temporary is ever allocated (fresh multi-hundred-MB
        # allocations can cost seconds of first-touch page faults on
        # virtualized hosts).
        k = frame // hop
        n_blocks = len(audio) // hop
        bsums = np.empty(n_blocks, np.float64)
        chunk_blocks = max((1 << 22) // hop, 1)
        scratch = np.empty(chunk_blocks * hop, np.float32)
        for b0 in range(0, n_blocks, chunk_blocks):
            b1 = min(b0 + chunk_blocks, n_blocks)
            m = (b1 - b0) * hop
            buf = scratch[:m]
            np.square(audio[b0 * hop : b0 * hop + m], out=buf)
            bsums[b0:b1] = buf.reshape(b1 - b0, hop).sum(axis=1,
                                                         dtype=np.float64)
        csum = np.concatenate(([0.0], np.cumsum(bsums)))
        sums = csum[k : n + k] - csum[:n]
    else:
        csq = np.concatenate(
            ([0.0], np.cumsum(np.square(audio, dtype=np.float64))))
        starts = hop * np.arange(n)
        sums = csq[starts + frame] - csq[starts]
    rms = np.sqrt(sums / frame + 1e-12)
    return 20.0 * np.log10(rms + 1e-12), hop


def detect_speech(audio: np.ndarray, sample_rate: int,
                  opts: VadOptions | None = None) -> List[Tuple[int, int]]:
    """Speech spans as [(start_sample, end_sample), ...], sorted, disjoint."""
    opts = opts or VadOptions()
    audio = np.asarray(audio, np.float32)
    if len(audio) == 0:
        return []
    energies, hop = frame_energies_db(audio, sample_rate, opts)

    noise_floor = float(np.percentile(energies, opts.noise_percentile))
    threshold = max(min(noise_floor + opts.margin_db, opts.speech_ceiling_db),
                    opts.absolute_floor_db)
    active = energies > threshold
    if not active.any():
        return []

    # Frame runs -> raw (unpadded) sample spans.
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], active, [False])).astype(np.int8)))
    starts_f, ends_f = edges[0::2], edges[1::2]
    frame_len = max(int(sample_rate * opts.frame_ms / 1000.0), 1)
    spans = [
        (int(s * hop), min(int((e - 1) * hop) + frame_len, len(audio)))
        for s, e in zip(starts_f, ends_f)
    ]

    # Merge spans separated by < min_silence_ms FIRST (natural pauses
    # stay in), THEN drop still-short runs. Dropping before merging
    # deleted genuine short utterances ("yes", ~200 ms) that sit within
    # merge range of neighboring speech; an isolated click stays short
    # after merging and is still rejected. Both orders run before
    # padding — padding must never promote a click past the threshold.
    min_gap = int(sample_rate * opts.min_silence_ms / 1000.0)
    merged: List[Tuple[int, int]] = []
    for s, e in spans:
        if merged and s - merged[-1][1] < min_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    min_len = int(sample_rate * opts.min_speech_ms / 1000.0)
    merged = [(s, e) for s, e in merged if e - s >= min_len]

    # Pad each kept region (soft onsets/offsets), coalescing any overlap
    # the padding introduces between neighbors.
    pad = int(sample_rate * opts.speech_pad_ms / 1000.0)
    out: List[Tuple[int, int]] = []
    for s, e in merged:
        s, e = max(s - pad, 0), min(e + pad, len(audio))
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


@dataclass
class SpeechMap:
    """Maps the condensed (silence-removed) timeline back to the original.

    ``chunks`` rows are (condensed_start, original_start, length), all in
    samples, ordered by condensed_start.
    """

    chunks: List[Tuple[int, int, int]]
    sample_rate: int
    original_samples: int

    @property
    def condensed_samples(self) -> int:
        return sum(c[2] for c in self.chunks)

    @property
    def speech_seconds(self) -> float:
        return self.condensed_samples / self.sample_rate

    def to_original(self, t: float, end: bool = False) -> float:
        """Condensed-timeline seconds -> original-timeline seconds.

        Monotone piecewise-linear with jumps at chunk boundaries; times
        past the last chunk clamp to its end (segments the decoder closed
        at the padded window edge stay inside the source audio).
        ``end=True`` resolves a time landing EXACTLY on a chunk boundary
        to the PREVIOUS chunk's end — an end-timestamp mapped into the
        next chunk's start would span the removed silence gap.
        """
        if not self.chunks:
            return 0.0
        pos = t * self.sample_rate
        for i, (c_start, o_start, length) in enumerate(
                reversed(self.chunks)):
            at_boundary = pos == c_start and end and i < len(self.chunks) - 1
            if pos >= c_start and not at_boundary:
                return (o_start + min(pos - c_start, length)) / self.sample_rate
        return self.chunks[0][1] / self.sample_rate


def collapse_silence(
    audio: np.ndarray,
    sample_rate: int,
    opts: VadOptions | None = None,
) -> Tuple[np.ndarray, SpeechMap]:
    """Remove silence: concatenated speech spans + the timestamp map back.

    All-silent input returns empty audio and an empty map (callers emit an
    empty transcript without touching the device).
    """
    audio = np.asarray(audio, np.float32)
    spans = detect_speech(audio, sample_rate, opts)
    chunks: List[Tuple[int, int, int]] = []
    pieces: List[np.ndarray] = []
    cursor = 0
    for s, e in spans:
        pieces.append(audio[s:e])
        chunks.append((cursor, s, e - s))
        cursor += e - s
    condensed = (np.concatenate(pieces) if pieces
                 else np.zeros(0, np.float32))
    return condensed, SpeechMap(chunks, sample_rate, len(audio))
