"""Transcription quality metrics: WER / CER with whisper-style text
normalization.

The north-star target is exact-match transcripts vs the CPU reference on
LibriSpeech test-clean (BASELINE.md); this module provides the measurement
machinery (the reference has none): Levenshtein edit distance with
substitution/insertion/deletion counts and the standard English text
normalization (lowercase, punctuation strip, whitespace squeeze) so scores
are comparable to published numbers.

The port's copy of the JAX package's ``eval/wer.py`` (pure Python and
numpy, with scipy's assignment for cpWER).
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

_PUNCT = re.compile(r"[^\w\s']", re.UNICODE)


def normalize_for_wer(text: str) -> str:
    """Basic English normalization: NFKC, lowercase, strip punctuation
    (apostrophes kept), squeeze whitespace."""
    text = unicodedata.normalize("NFKC", text).lower()
    text = _PUNCT.sub(" ", text)
    return re.sub(r"\s+", " ", text).strip()


@dataclass
class EditStats:
    substitutions: int
    insertions: int
    deletions: int
    hits: int

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def ref_len(self) -> int:
        return self.substitutions + self.deletions + self.hits

    @property
    def rate(self) -> float:
        return self.errors / max(self.ref_len, 1)


def edit_distance(ref: Sequence, hyp: Sequence) -> EditStats:
    """Levenshtein alignment with S/I/D/H breakdown.

    Vectorized numpy DP (the insertion recurrence resolves transitively
    via the ``min-accumulate of g[k]-k`` trick) plus an O(n+m)
    traceback. The previous pure-Python tuple DP built 3 tuples per
    cell: two 5k-word concatenated speaker streams cost ~25M cells per
    pair, turning meeting-scale ``cp_wer`` into hours — this runs the
    same pair in well under a second. Traceback ties prefer
    match/substitution, then deletion, then insertion; every optimal
    alignment has the same error count, so ``.rate`` is unaffected.
    """
    n, m = len(ref), len(hyp)
    if m == 0:
        return EditStats(0, 0, n, 0)
    if n == 0:
        return EditStats(0, m, 0, 0)
    hyp_arr = np.asarray(hyp)
    dist = np.empty((n + 1, m + 1), np.uint32)
    dist[0] = np.arange(m + 1)
    idx = np.arange(m + 1, dtype=np.int64)
    g = np.empty(m + 1, np.int64)
    for i in range(1, n + 1):
        mismatch = (hyp_arr != ref[i - 1]).astype(np.uint32)
        g[0] = i
        np.minimum(dist[i - 1, :m] + mismatch,  # diagonal (match/sub)
                   dist[i - 1, 1:] + 1,         # deletion (from ref)
                   out=g[1:])
        # Insertion recurrence f[j] = min(g[j], f[j-1] + 1) transitively:
        # f[j] = j + min_{k<=j}(g[k] - k).
        dist[i] = np.minimum.accumulate(g - idx) + idx
    i, j = n, m
    subs = ins = dels = hits = 0
    while i > 0 and j > 0:
        if ref[i - 1] == hyp[j - 1] and dist[i, j] == dist[i - 1, j - 1]:
            hits += 1
            i -= 1
            j -= 1
        elif ref[i - 1] != hyp[j - 1] and dist[i, j] == dist[i - 1, j - 1] + 1:
            subs += 1
            i -= 1
            j -= 1
        elif dist[i, j] == dist[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    dels += i
    ins += j
    return EditStats(substitutions=subs, insertions=ins, deletions=dels,
                     hits=hits)


def wer(refs: Sequence[str], hyps: Sequence[str],
        normalize: bool = True) -> Tuple[float, EditStats]:
    """Corpus word error rate over paired (reference, hypothesis) texts."""
    assert len(refs) == len(hyps)
    total = EditStats(0, 0, 0, 0)
    for r, h in zip(refs, hyps):
        if normalize:
            r, h = normalize_for_wer(r), normalize_for_wer(h)
        st = edit_distance(r.split(), h.split())
        total.substitutions += st.substitutions
        total.insertions += st.insertions
        total.deletions += st.deletions
        total.hits += st.hits
    return total.rate, total


def cp_wer(ref_by_speaker, hyp_by_speaker,
           normalize: bool = True) -> Tuple[float, EditStats]:
    """Concatenated-minimum-permutation WER — THE metric for joint
    ASR + diarization quality (CHiME-6 style): each speaker's text is
    one concatenated stream, and hypothesis streams are assigned to
    reference streams by the permutation minimizing total word edits.
    Unmatched reference streams count fully as deletions; unmatched
    hypothesis streams fully as insertions (a missed or hallucinated
    speaker is all errors, as it should be).

    Inputs map speaker key -> text (see :func:`texts_by_speaker` for
    turning diarized segments into one). Keys need not align between
    reference and hypothesis — assignment is by content, not by name.
    """
    def streams(d):
        items = list(d.items())
        return ([k for k, _ in items],
                [(normalize_for_wer(t) if normalize else t).split()
                 for _, t in items])

    _, refs = streams(ref_by_speaker)
    _, hyps = streams(hyp_by_speaker)
    total = EditStats(0, 0, 0, 0)
    R, H = len(refs), len(hyps)
    # Square assignment over (R+H) x (H+R): real-real cells cost the pair
    # edit distance; a reference assigned to a dummy column costs its full
    # length (all deletions), a hypothesis assigned to a dummy row its
    # full length (all insertions). Assigning over only the real
    # rectangle would ignore those unmatched penalties and can pick a
    # WORSE total when speaker counts differ (over/under-segmentation —
    # the common diarization failure).
    stats = [[edit_distance(r, h) for h in hyps] for r in refs]
    n = R + H
    cost = np.zeros((n, n))
    if R and H:
        cost[:R, :H] = [[st.errors for st in row] for row in stats]
    cost[:R, H:] = np.array([len(r) for r in refs], float)[:, None]
    cost[R:, :H] = np.array([len(h) for h in hyps], float)[None, :]
    if n:
        rows, cols = linear_sum_assignment(cost)
        for i, j in zip(rows, cols):
            if i < R and j < H:
                st = stats[i][j]
                total.substitutions += st.substitutions
                total.insertions += st.insertions
                total.deletions += st.deletions
                total.hits += st.hits
            elif i < R:
                total.deletions += len(refs[i])
            elif j < H:
                total.insertions += len(hyps[j])
    return total.rate, total


def texts_by_speaker(segments) -> dict:
    """Diarized segments -> {speaker key: concatenated text} for
    :func:`cp_wer`. Prefers enrolled ``speaker_name`` over the cluster
    id; segments with neither pool under a single "unknown" stream."""
    out: dict = {}
    for seg in segments:
        text = (seg.text or "").strip()
        if not text:
            continue
        key = (seg.speaker_name if getattr(seg, "speaker_name", None)
               else seg.speaker if seg.speaker is not None else "unknown")
        out[key] = (out[key] + " " + text) if key in out else text
    return out


def stm_rows(data: str) -> List[tuple]:
    """Parse NIST STM (the standard speaker-labeled reference format:
    ``<file> <channel> <speaker> <t_start> <t_end> [<flags>] transcript``
    per line) into ``(file_id, t_start, t_end, speaker, text)`` rows,
    time-ordered per file. Tolerates ``;;`` comments and malformed rows.
    The optional ``<flags>`` block is a comma-separated list (e.g.
    ``<o,f0,male>``) — the comma is required, so a transcript
    legitimately STARTING with an angle token (``<unk>``) is kept.
    ``ignore_time_segment_in_scoring`` rows are dropped. A leading
    whitespace-free ``<...>`` block is the optional flags label
    (``<o>``, ``<o,f0,male>``) — except ``<unk>``, which is kept as the
    OOV transcript token it conventionally is."""
    rows = []
    for line in data.splitlines():
        line = line.strip()
        if not line or line.startswith(";;"):
            continue
        parts = line.split(None, 5)
        if len(parts) < 6:
            continue
        fid, _ch, speaker, t0, t1, rest = parts
        try:
            start = float(t0)
        except ValueError:
            continue  # stray header / malformed row: tolerate like the rest
        try:
            end = float(t1)
        except ValueError:
            # Keep the row for cpWER (words still count) with a
            # zero-length turn — only the start time gated rows before
            # the stm_rows refactor, and dropping text would silently
            # shrink the reference.
            end = start
        if rest.startswith("<") and ">" in rest:
            # The optional STM flags block sits right after the times:
            # "<o,f0,male>" or the single-element "<o>". A transcript
            # legitimately STARTING with an angle token is almost always
            # "<unk>" (OOV marker) — keep that one; everything else
            # whitespace-free inside <> here is a label per the NIST
            # format.
            head = rest.split(">", 1)[0][1:]
            if head.lower() != "unk" and head and " " not in head:
                rest = rest.split(">", 1)[1].strip()
        if not rest or rest.lower() == "ignore_time_segment_in_scoring":
            continue
        rows.append((fid, start, end, speaker, rest))
    rows.sort(key=lambda r: (r[0], r[1]))
    return rows


def parse_stm(data) -> dict:
    """NIST STM -> {file_id: {speaker: concatenated text}} (per-speaker
    utterances joined in time order) — the cpWER reference shape.
    Accepts the raw STM string or pre-parsed :func:`stm_rows` output
    (so one parse can feed both this and :func:`parse_stm_turns`)."""
    per_file: dict = {}
    rows = data if isinstance(data, list) else stm_rows(data)
    for fid, _t0, _t1, speaker, text in rows:
        spk = per_file.setdefault(fid, {})
        spk[speaker] = (spk[speaker] + " " + text) if speaker in spk else text
    return per_file


def cer(refs: Sequence[str], hyps: Sequence[str],
        normalize: bool = True) -> Tuple[float, EditStats]:
    """Corpus character error rate."""
    assert len(refs) == len(hyps)
    total = EditStats(0, 0, 0, 0)
    for r, h in zip(refs, hyps):
        if normalize:
            r, h = normalize_for_wer(r), normalize_for_wer(h)
        st = edit_distance(list(r), list(h))
        total.substitutions += st.substitutions
        total.insertions += st.insertions
        total.deletions += st.deletions
        total.hits += st.hits
    return total.rate, total
