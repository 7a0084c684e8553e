"""Shared SRT-corpus scanning: parse + language-tag transcript files.

Single source of truth for the parse -> language-detect -> whitelist
sequence that both stage-0 tokenizer training and the training dataloaders
perform. The reference duplicates this logic between
``train/stages/train_tokenizer.py:12-27`` and
``train/utils/dataloaders.py:34-62``; keeping one helper prevents the two
consumers drifting (e.g. disagreeing on the low-confidence language
fallback, which would train the tokenizer on text verbalized in a
different language than the dataloader later uses).

The port's copy of the JAX package's ``text/corpus.py``, which imports no JAX
(the port imports nothing of ``yoho_tpu``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple, Union

from yoho_tpu_torch.text.langdetect import MIN_SCORE, rank_languages
from yoho_tpu_torch.text.srt import parse_srt

# Below this detector score the detection is noise (very short or
# symbol-heavy text); fall back instead of trusting it.
LANG_SCORE_THRESHOLD = MIN_SCORE

# A whitelisted language within this absolute score margin of the top
# detection is preferred over a non-whitelisted winner: sibling languages
# (cs/sk, id/ms, hr/sr) often near-tie on short transcripts, and in a
# whitelisted corpus the whitelisted sibling is the right call.
WHITELIST_TIE_MARGIN = 0.10


def transcript_language(subs, whitelist: Optional[Sequence[str]]) -> str:
    """Detected language of a parsed transcript, with deterministic
    fallbacks: a near-tie resolves toward the whitelist, and a
    low-confidence (noise) detection in a whitelisted corpus is most
    likely the whitelisted language (else English) — short or hum-only
    transcripts must not be silently dropped."""
    ranked = rank_languages("\n".join(s.content for s in subs))
    if not ranked or ranked[0].score < LANG_SCORE_THRESHOLD:
        return whitelist[0] if whitelist else "en"
    best = ranked[0]
    if whitelist and best.language not in whitelist:
        for det in ranked[1:]:
            if det.score < max(best.score - WHITELIST_TIE_MARGIN, MIN_SCORE):
                break
            if det.language in whitelist:
                return det.language
    return best.language


def iter_transcripts(
    source: Union[str, Path, Sequence[Path]],
    whitelist: Optional[Sequence[str]] = None,
) -> Iterator[Tuple[Path, str, List]]:
    """Yield ``(path, language, subtitles)`` for each usable transcript.

    ``source`` is a transcripts directory (scanned sorted) or an explicit
    sequence of paths (e.g. a train/val slice). Unparseable, unreadable,
    and empty files are skipped; with a ``whitelist``, files detected as
    other languages are skipped too.
    """
    if isinstance(source, (str, Path)):
        src = Path(source)
        paths: Sequence[Path] = sorted(src.iterdir()) if src.exists() else []
    else:
        paths = list(source)
    for p in paths:
        try:
            subs = list(parse_srt(Path(p).read_text(encoding="utf-8")))
        except (ValueError, OSError):
            continue
        if not subs:
            continue
        lang = transcript_language(subs, whitelist)
        if whitelist and lang not in whitelist:
            continue
        yield Path(p), lang, subs
