"""Speaker diarization: cluster per-segment voiceprints into speaker labels,
name them against enrolled voiceprints, and track speakers on a stream.

A copy of the JAX package's ``infer/diarize.py``: the clustering, naming,
online tracking and enrollment files are host numpy code, unchanged; the
span embedder of whisper-family diarization and enrollment runs the port's
``VoiceprintEncoder`` on its device over the YOHO log-mel frontend (the
log-mel kernel on the card).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def cluster_voiceprints(
    embeddings: Sequence[Optional[np.ndarray]],
    threshold: float = 0.75,
) -> List[Optional[int]]:
    """Assign speaker ids to (possibly missing) embeddings.

    Centroid-linkage agglomerative clustering: repeatedly merge the two
    clusters whose centroid cosine similarity is highest, while above
    ``threshold``. Returns one id per input (None where the embedding was
    None). Ids are numbered by first appearance.
    """
    idx = [i for i, e in enumerate(embeddings) if e is not None]
    if not idx:
        return [None] * len(embeddings)

    vecs = [np.asarray(embeddings[i], np.float64) for i in idx]
    vecs = [v / max(np.linalg.norm(v), 1e-9) for v in vecs]

    clusters = [[j] for j in range(len(vecs))]  # member indices into vecs
    V = np.stack(vecs)  # (k0, d), rows unit-norm

    def centroid(members):
        c = V[members].mean(axis=0)
        return c / max(np.linalg.norm(c), 1e-9)

    # One (k, d) centroid matrix and a single C @ C.T per round instead of
    # Python-level O(k^2) np.dot calls with full centroid recomputation —
    # meeting-scale inputs (hundreds of segments) cluster in milliseconds.
    cents = np.stack([centroid(c) for c in clusters])
    while len(clusters) > 1:
        sims = cents @ cents.T
        sims[np.tril_indices(len(clusters))] = -np.inf  # (a < b) pairs only
        a, b = np.unravel_index(int(np.argmax(sims)), sims.shape)
        if sims[a, b] < threshold:
            break
        clusters[a] = clusters[a] + clusters[b]
        del clusters[b]
        cents[a] = centroid(clusters[a])
        cents = np.delete(cents, b, axis=0)

    # Order clusters by earliest member for stable speaker numbering.
    clusters.sort(key=lambda c: min(c))
    member_to_cluster = {}
    for cid, members in enumerate(clusters):
        for m in members:
            member_to_cluster[m] = cid

    out: List[Optional[int]] = [None] * len(embeddings)
    for j, i in enumerate(idx):
        out[i] = member_to_cluster[j]
    return out


def identify_speaker(
    embedding: np.ndarray,
    enrolled: dict,
    threshold: float = 0.75,
) -> Optional[str]:
    """Speaker recognition against enrolled voiceprints: returns the best
    matching name above threshold, else None."""
    e = np.asarray(embedding, np.float64)
    e = e / max(np.linalg.norm(e), 1e-9)
    best_name, best_sim = None, threshold
    for name, ref in enrolled.items():
        r = np.asarray(ref, np.float64)
        if r.shape != e.shape:
            raise ValueError(
                f"enrolled speaker {name!r} has embedding shape {r.shape}, "
                f"query has {e.shape} — embeddings from different embedders "
                "cannot be compared; re-enroll with the matching one")
        r = r / max(np.linalg.norm(r), 1e-9)
        sim = float(np.dot(e, r))
        if sim >= best_sim:
            best_name, best_sim = name, sim
    return best_name


def name_speakers(
    segments,
    enrolled: dict,
    threshold: float = 0.75,
) -> None:
    """Map diarized clusters to enrolled speaker names, in place.

    Completes speaker *recognition* (the third headline capability,
    reference ``README.md:5-11``) at the pipeline level: segments carry
    ``voiceprint`` (from the yoho decode forward pass or the whisper
    post-pass) and a ``speaker`` cluster id; this computes one centroid
    per cluster and assigns the best enrolled name above ``threshold``
    via :func:`identify_speaker` to every member's ``speaker_name``.
    Unmatched clusters keep ``speaker_name=None`` (an unknown voice must
    not inherit the nearest enrolled name). Segments with a voiceprint
    but no cluster id are identified individually.

    ``enrolled`` maps name -> embedding, as produced by ``enroll``
    (:mod:`yoho_tpu_torch.cli.enroll`) and :func:`load_enrolled`. Embeddings
    must come from the same embedder that produced the segment
    voiceprints (the same yoho session / VoiceprintEncoder) — cosine
    similarity across embedding spaces is meaningless.
    """
    if not enrolled:
        return
    by_cluster: dict = {}
    for seg in segments:
        if seg.voiceprint is None:
            continue
        if seg.speaker is None:
            seg.speaker_name = identify_speaker(
                seg.voiceprint, enrolled, threshold=threshold)
        else:
            by_cluster.setdefault(seg.speaker, []).append(seg)
    for members in by_cluster.values():
        vecs = np.stack([
            np.asarray(s.voiceprint, np.float64) for s in members])
        vecs /= np.maximum(
            np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-9)
        centroid = vecs.mean(axis=0)
        name = identify_speaker(centroid, enrolled, threshold=threshold)
        for seg in members:
            seg.speaker_name = name


class OnlineSpeakerTracker:
    """Stable speaker ids across a LIVE stream.

    Batch diarization clusters all segments at once — useless for
    streaming, where already-emitted ids must never change. This is the
    online counterpart: each finalized segment's voiceprint joins the
    nearest running centroid above ``threshold`` (updating it as a
    running mean) or opens a new speaker id; ids are assigned in first-
    appearance order and never revised. With ``enrolled`` voiceprints
    (the ``enroll`` command), segments also get ``speaker_name`` matched
    against the speaker's CURRENT centroid — so the name can appear
    once enough evidence accumulates, but an id never flips between
    two names retroactively.

    Greedy online assignment is order-dependent by design (that is the
    price of never revising emitted output); offline transcription
    keeps the globally-clustered batch labels.
    """

    def __init__(self, threshold: float = 0.75, enrolled: Optional[dict] = None):
        self.threshold = float(threshold)
        self.enrolled = dict(enrolled or {})
        # Per speaker: the UNNORMALIZED sum of member unit vectors (the
        # true running mean's direction); unit centroids are derived for
        # comparisons. Rescaling a normalized centroid by the count
        # would over-weight history whenever members disagree
        # (||sum of k unit vectors|| < k).
        self._sums: List[np.ndarray] = []
        self._names: List[Optional[str]] = []

    @property
    def n_speakers(self) -> int:
        return len(self._sums)

    def _centroids(self) -> np.ndarray:
        c = np.stack(self._sums)
        return c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-9)

    def assign(self, segments) -> None:
        """Set ``speaker`` (stable stream-wide id) and ``speaker_name``
        in place. Segments without a voiceprint get ``speaker=None`` —
        the tracker owns the field on streams (per-window batch cluster
        ids are meaningless across windows)."""
        for seg in segments:
            if seg.voiceprint is None:
                seg.speaker = None
                continue
            v = np.asarray(seg.voiceprint, np.float64)
            v = v / max(np.linalg.norm(v), 1e-9)
            k = None
            if self._sums:
                sims = self._centroids() @ v
                best = int(np.argmax(sims))
                if sims[best] >= self.threshold:
                    k = best
                    self._sums[k] = self._sums[k] + v
            if k is None:
                self._sums.append(v)
                self._names.append(None)
                k = len(self._sums) - 1
            if self.enrolled:
                c = self._sums[k] / max(np.linalg.norm(self._sums[k]), 1e-9)
                self._names[k] = identify_speaker(
                    c, self.enrolled, threshold=self.threshold)
            seg.speaker = k
            seg.speaker_name = self._names[k]

    def peek(self, segments) -> None:
        """Tentative labels for REVISABLE hypotheses (live partial
        captions): same nearest-centroid match as :meth:`assign`, but
        read-only — partials must never move the centroids or mint ids
        (they may be revised away by the next overlapping window).
        Unmatched voices get ``speaker=None`` until finalization."""
        for seg in segments:
            seg.speaker = seg.speaker_name = None
            if seg.voiceprint is None or not self._sums:
                continue
            v = np.asarray(seg.voiceprint, np.float64)
            v = v / max(np.linalg.norm(v), 1e-9)
            sims = self._centroids() @ v
            best = int(np.argmax(sims))
            if sims[best] >= self.threshold:
                seg.speaker = best
                seg.speaker_name = self._names[best]


def save_enrolled(path, enrolled: dict) -> None:
    """Write a name -> embedding mapping as ``.npz`` (the ``enroll``
    artifact). Names are npz keys; embeddings are stored as float32."""
    if not enrolled:
        raise ValueError("refusing to write an empty enrollment file")
    np.savez(path, **{name: np.asarray(e, np.float32)
                      for name, e in enrolled.items()})


def load_enrolled(path) -> dict:
    """Load a ``save_enrolled`` file back into {name: embedding}."""
    with np.load(path) as data:
        return {name: np.asarray(data[name]) for name in data.files}


def _span_embedder(encoder, batch_size: int):
    """``embed(spans: List[np.ndarray]) -> List[emb]`` for raw audio spans:
    each span clipped to the encoder window, shorter ones zero-padded with
    a matching frame mask, ``batch_size`` windows per call. Shared by
    segment diarization and speaker enrollment so the two cannot drift."""
    from yoho_tpu_torch.ops.mel_kernel import fused_yoho_log_mel

    cfg = encoder.cfg
    n = cfg.n_samples

    @torch.inference_mode()
    def embed(spans: Sequence[np.ndarray]) -> List[np.ndarray]:
        embs: List[np.ndarray] = []
        for i in range(0, len(spans), batch_size):
            group = spans[i: i + batch_size]
            windows = np.zeros((batch_size, n), np.float32)
            mask = np.zeros((batch_size, cfg.max_audio_len), np.float32)
            for j, span in enumerate(group):
                span = np.asarray(span, np.float32)[:n]
                windows[j, : len(span)] = span
                frames = max(len(span) // cfg.stft_hop, 1)
                mask[j, : min(frames, cfg.max_audio_len)] = 1.0
            dev = encoder.device
            mel = fused_yoho_log_mel(torch.as_tensor(windows, device=dev), cfg)
            out = encoder(mel, torch.as_tensor(mask, device=dev))
            embs.extend(out.float().cpu().numpy()[: len(group)])
        return embs

    return embed


def embed_clip(audio: np.ndarray, encoder, batch_size: int = 16) -> np.ndarray:
    """One L2-normalized voiceprint for a whole clip (speaker enrollment):
    the clip is cut into encoder windows, each is embedded, and the
    unit-normalized mean is returned. Trailing slivers (< 0.5 s, at most
    half a window) are dropped unless they are all there is."""
    audio = np.asarray(audio, np.float32)
    n = encoder.cfg.n_samples
    chunks = [audio[i: i + n] for i in range(0, max(len(audio), 1), n)]
    min_samples = min(encoder.cfg.sample_rate // 2, n // 2)
    kept = [c for c in chunks if len(c) >= min_samples] or chunks[:1]
    embs = _span_embedder(encoder, batch_size)(kept)
    mean = np.mean(np.stack(embs), axis=0)
    return mean / max(np.linalg.norm(mean), 1e-9)


def diarize_segments(segments, audio: np.ndarray, sample_rate: int, encoder,
                     batch_size: int = 16, threshold: float = 0.75) -> None:
    """Speaker labels for whisper-family segments through a
    ``VoiceprintEncoder``: embed each segment's source-audio span, cluster
    with :func:`cluster_voiceprints`, and set ``seg.voiceprint`` and
    ``seg.speaker`` in place."""
    if not segments:
        return
    spans = []
    for seg in segments:
        s = max(int(seg.start * sample_rate), 0)
        e = min(int(seg.end * sample_rate), len(audio))
        spans.append(audio[s:e])
    embs = _span_embedder(encoder, batch_size)(spans)
    labels = cluster_voiceprints(embs, threshold=threshold)
    for seg, emb, label in zip(segments, embs, labels):
        seg.voiceprint = emb
        seg.speaker = label
