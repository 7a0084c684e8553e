"""Speaker diarization and verification metrics: DER and EER.

The JAX package's ``eval/diarization.py`` (numpy only), kept as the
port's own copy:

* **DER** (diarization error rate): missed speech + false alarm + speaker
  confusion, over reference speech time — the standard NIST RT metric,
  computed on time segments with an optimal reference<->hypothesis speaker
  mapping (Hungarian assignment over pairwise overlap).
* **EER** (equal error rate): speaker-verification operating point where
  false accepts == false rejects, from cosine scores of embedding pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class SpeakerTurn:
    start: float
    end: float
    speaker: object  # any hashable label

    @property
    def duration(self) -> float:
        return max(self.end - self.start, 0.0)


def _boundaries(turns_a: Sequence[SpeakerTurn],
                turns_b: Sequence[SpeakerTurn]) -> np.ndarray:
    pts = {0.0}
    for t in list(turns_a) + list(turns_b):
        pts.add(float(t.start))
        pts.add(float(t.end))
    return np.asarray(sorted(pts))


def _active(turns: Sequence[SpeakerTurn], lo: float, hi: float) -> set:
    mid = (lo + hi) / 2
    return {t.speaker for t in turns if t.start < hi and t.end > lo
            and t.start <= mid < t.end}


@dataclass
class DERBreakdown:
    missed: float       # reference speech with no hypothesis speaker
    false_alarm: float  # hypothesis speech with no reference speaker
    confusion: float    # speech attributed to the wrong speaker
    total_reference: float

    @property
    def der(self) -> float:
        if self.total_reference == 0:
            return 0.0 if self.false_alarm == 0 else float("inf")
        return (self.missed + self.false_alarm + self.confusion) / self.total_reference


def diarization_error_rate(
    reference: Sequence[SpeakerTurn],
    hypothesis: Sequence[SpeakerTurn],
    collar: float = 0.0,
) -> DERBreakdown:
    """NIST-style DER over segment lists (overlapping speech supported).

    ``collar`` excludes a +/- collar-second zone around every reference
    turn boundary from scoring entirely (NIST md-eval semantics: neither
    misses nor false alarms are counted there; standard value 0.25).
    Speaker labels are arbitrary on both sides; the scorer finds the
    time-overlap-maximal one-to-one mapping (Hungarian assignment).
    """
    no_score: List[Tuple[float, float]] = []
    if collar > 0:
        for t in reference:
            no_score.append((t.start - collar, t.start + collar))
            no_score.append((t.end - collar, t.end + collar))

    ref_speakers = sorted({t.speaker for t in reference}, key=repr)
    hyp_speakers = sorted({t.speaker for t in hypothesis}, key=repr)

    # Pairwise overlap seconds between every (ref spk, hyp spk).
    overlap = np.zeros((len(ref_speakers), len(hyp_speakers)))
    ridx = {s: i for i, s in enumerate(ref_speakers)}
    hidx = {s: i for i, s in enumerate(hyp_speakers)}
    for r in reference:
        for h in hypothesis:
            if r.speaker in ridx and h.speaker in hidx:
                ov = min(r.end, h.end) - max(r.start, h.start)
                if ov > 0:
                    overlap[ridx[r.speaker], hidx[h.speaker]] += ov

    mapping: Dict[object, object] = {}
    if overlap.size:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-overlap)
        mapping = {ref_speakers[i]: hyp_speakers[j]
                   for i, j in zip(rows, cols) if overlap[i, j] > 0}

    # Piecewise-constant scoring over the merged boundary grid. Within a
    # cell the active speaker sets are constant, so error time is
    # max(Nref, Nhyp) - matches, per the NIST definition.
    missed = false_alarm = confusion = total_ref = 0.0
    pts = set(_boundaries(reference, hypothesis).tolist())
    for a, b in no_score:
        pts.update((a, b))
    pts = np.asarray(sorted(pts))
    for lo, hi in zip(pts[:-1], pts[1:]):
        dur = float(hi - lo)
        if dur <= 0:
            continue
        mid = (lo + hi) / 2
        if any(a < mid < b for a, b in no_score):
            continue  # inside a collar zone: excluded from scoring
        ref_set = _active(reference, lo, hi)
        hyp_set = _active(hypothesis, lo, hi)
        n_ref, n_hyp = len(ref_set), len(hyp_set)
        total_ref += n_ref * dur
        matches = sum(1 for s in ref_set if mapping.get(s) in hyp_set)
        missed += max(n_ref - n_hyp, 0) * dur
        false_alarm += max(n_hyp - n_ref, 0) * dur
        confusion += (min(n_ref, n_hyp) - matches) * dur
    return DERBreakdown(missed, false_alarm, confusion, total_ref)


# ---------------------------------------------------------------- RTTM
def parse_stm_turns(data) -> Dict[str, List[SpeakerTurn]]:
    """NIST STM -> {file_id: [SpeakerTurn]}: the same reference file
    that scores cpWER also carries utterance TIMES, so one STM scores
    DER too (``yoho evaluate --stm`` reports both). Accepts the raw STM
    string or pre-parsed ``stm_rows`` output."""
    from yoho_tpu_torch.eval.wer import stm_rows

    per_file: Dict[str, List[SpeakerTurn]] = {}
    rows = data if isinstance(data, list) else stm_rows(data)
    for fid, start, end, speaker, _text in rows:
        per_file.setdefault(fid, []).append(SpeakerTurn(start, end, speaker))
    return per_file


def parse_rttm(data: str) -> Dict[str, List[SpeakerTurn]]:
    """Parse RTTM (the NIST diarization interchange format) into
    per-recording turn lists.

    Only SPEAKER lines are consumed: ``SPEAKER <file> <chan> <tbeg> <tdur>
    <ortho> <stype> <name> <conf> [<slat>]``. Returns {file_id: [turns]}.
    """
    out: Dict[str, List[SpeakerTurn]] = {}
    for lineno, line in enumerate(data.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith((";;", "#")):
            continue
        parts = line.split()
        if parts[0].upper() != "SPEAKER":
            continue
        if len(parts) < 8:
            raise ValueError(f"RTTM line {lineno}: expected >=8 fields")
        file_id, tbeg, tdur, name = parts[1], parts[3], parts[4], parts[7]
        start = float(tbeg)
        out.setdefault(file_id, []).append(
            SpeakerTurn(start, start + float(tdur), name))
    for turns in out.values():
        turns.sort(key=lambda t: (t.start, t.end))
    return out


def compose_rttm(turns: Sequence[SpeakerTurn], file_id: str,
                 channel: int = 1) -> str:
    """Serialize turns as RTTM SPEAKER lines (speaker label via str()).

    RTTM is space-delimited, so whitespace in a label (an enrolled name
    like "Alice Smith") would shift every following column for NIST
    md-eval / :func:`parse_rttm` — labels are sanitized to underscores.
    """
    def label(s) -> str:
        return "_".join(str(s).split()) or "_"

    lines = [
        f"SPEAKER {file_id} {channel} {t.start:.3f} {t.duration:.3f} "
        f"<NA> <NA> {label(t.speaker)} <NA> <NA>"
        for t in sorted(turns, key=lambda t: (t.start, t.end))
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def segments_to_turns(segments) -> List[SpeakerTurn]:
    """Transcriber output -> scoring turns. Enrolled ``speaker_name``
    wins over the anonymous cluster id (an RTTM scored against a
    named reference then matches identities directly); unlabeled
    segments collapse to one speaker."""
    return [SpeakerTurn(s.start, s.end,
                        getattr(s, "speaker_name", None)
                        or (s.speaker if s.speaker is not None else 0))
            for s in segments]


# ----------------------------------------------------------------- EER
def cosine_scores(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity between paired embedding matrices."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
    return num / den


def equal_error_rate(scores: np.ndarray,
                     labels: np.ndarray) -> Tuple[float, float]:
    """EER and its threshold from verification scores.

    ``labels`` is 1 for same-speaker pairs, 0 for different-speaker pairs.
    Returns (eer, threshold) at the crossing of the false-accept and
    false-reject rates (linear interpolation between candidate thresholds).
    """
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    if not labels.any() or labels.all():
        raise ValueError("need both same- and different-speaker pairs")
    order = np.argsort(scores)
    scores_s, labels_s = scores[order], labels[order]
    n_pos, n_neg = int(labels.sum()), int((~labels).sum())
    # Sweep threshold over each score: accept iff score >= threshold.
    # False rejects: positives strictly below; false accepts: negatives at
    # or above.
    fr = np.cumsum(labels_s) / n_pos                 # after i-th score
    fa = 1.0 - np.cumsum(~labels_s) / n_neg
    frr = np.concatenate(([0.0], fr))                # threshold below min .. above max
    far = np.concatenate(([1.0], fa))
    diff = frr - far
    k = int(np.searchsorted(diff > 0, True))
    k = min(max(k, 1), len(diff) - 1)
    # Interpolate between the bracketing operating points.
    d0, d1 = diff[k - 1], diff[k]
    w = 0.0 if d1 == d0 else (0.0 - d0) / (d1 - d0)
    eer = float((1 - w) * (frr[k - 1] + far[k - 1]) / 2
                + w * (frr[k] + far[k]) / 2)
    # Operating point i means "i scores fall below t", i.e. t lies in
    # (s_i, s_{i+1}]; represent it by the midpoint of that gap.
    mids = np.concatenate((
        [scores_s[0] - 0.5],
        (scores_s[:-1] + scores_s[1:]) / 2,
        [scores_s[-1] + 0.5],
    ))
    threshold = float((1 - w) * mids[k - 1] + w * mids[k])
    return eer, threshold


def verification_pairs(
    embeddings: np.ndarray,
    speaker_ids: Sequence,
    rng: np.random.Generator | None = None,
    max_pairs: int = 10000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build a balanced (scores, labels) verification trial set from
    labeled embeddings (all same-speaker pairs up to budget + an equal
    number of random different-speaker pairs)."""
    rng = rng or np.random.default_rng(0)
    embeddings = np.asarray(embeddings)
    ids = list(speaker_ids)
    by_spk: Dict[object, List[int]] = {}
    for i, s in enumerate(ids):
        by_spk.setdefault(s, []).append(i)
    if len(by_spk) < 2:
        raise ValueError("need both same- and different-speaker pairs "
                         "(all embeddings share one speaker label)")
    # Sample same-speaker pair INDICES against the combinatorial count —
    # materializing every pair first is O(n^2) lists (10k embeddings of
    # few speakers => tens of millions of tuples) just to keep 5000.
    groups = list(by_spk.values())
    counts = [len(m) * (len(m) - 1) // 2 for m in groups]
    total_pos = sum(counts)
    budget = max_pairs // 2
    pos: List[Tuple[int, int]] = []
    if total_pos <= budget:
        for members in groups:
            pos += [(a, b) for i, a in enumerate(members)
                    for b in members[i + 1:]]
    else:
        import math

        offsets = np.cumsum([0] + counts)
        for g in rng.choice(total_pos, budget, replace=False):
            s = int(np.searchsorted(offsets, g, side="right")) - 1
            local = int(g - offsets[s])
            members = groups[s]
            k = len(members)
            # Decode combination index `local` -> (i, j), i < j, in the
            # (0,1),(0,2)..,(1,2).. order: pairs with first index < i
            # number F(i) = i*(2k-i-1)/2; invert via isqrt.
            disc = (2 * k - 1) ** 2 - 8 * local
            i = ((2 * k - 1) - math.isqrt(disc)) // 2
            while i * (2 * k - i - 1) // 2 > local:
                i -= 1
            while (i + 1) * (2 * k - i - 2) // 2 <= local:
                i += 1
            j = i + 1 + (local - i * (2 * k - i - 1) // 2)
            pos.append((members[i], members[j]))
    neg: List[Tuple[int, int]] = []
    n = len(ids)
    while len(neg) < len(pos):
        a, b = rng.integers(0, n, 2)
        if ids[a] != ids[b]:
            neg.append((int(a), int(b)))
    pairs = pos + neg
    labels = np.asarray([1] * len(pos) + [0] * len(neg))
    a = embeddings[[p[0] for p in pairs]]
    b = embeddings[[p[1] for p in pairs]]
    return cosine_scores(a, b), labels
