"""Character n-gram language identification.

The reference whitelists corpus languages with the ``eld`` package
(``train/utils/dataloaders.py:44-50``, ~60 languages). This module owns
that capability without dependencies: each language in
``yoho_tpu_torch.text.lang_corpus`` contributes an L2-normalized character
trigram frequency profile; input text is scored by cosine similarity
against every profile and the best match wins.

Design notes
------------
- Features are character n-grams of order 1-3 over normalized text (NFKC,
  lowercased, digits and punctuation collapsed to single spaces, words
  padded with spaces): trigrams carry the classic Cavnar-Trenkle
  function-word signal (`` th``, ``he ``, ``der``), bigrams generalize to
  short/held-out inputs, and unigrams encode the script (hanzi vs kana vs
  hangul vs Thai separate at order 1).
- Grams are IDF-weighted across the language profiles: a gram shared by
  every language (`` a``, ``e ``) scores ~0 while one unique to a language
  dominates — this is what separates close pairs (id/ms, cs/sk, hr/sr,
  hi/mr) where raw cosine ties.
- Short utterances: even a single word yields grams, so short inputs still
  classify instead of falling to ``und`` — the failure mode of the
  previous stopword scorer. Only text with no letters at all returns
  ``Detection("und", 0.0)``.
- Unknown languages: IDF-weighted cosine against an unrelated profile is
  low; ``detect_language`` returns ``und`` below ``MIN_SCORE``
  (calibrated in tests/test_langdetect.py against gibberish).

The port's copy of the JAX package's ``text/langdetect.py``, which imports no JAX
(the port imports nothing of ``yoho_tpu``).
"""

from __future__ import annotations

import math
import re
import unicodedata
from collections import Counter
from functools import lru_cache
from typing import NamedTuple

from yoho_tpu_torch.text.lang_corpus import CORPUS

# Below this weighted cosine the best match is considered noise.
# Calibrated in tests/test_langdetect.py: Latin-alphabet gibberish peaks
# at ~0.107 against the 67 profiles while genuine 2-4 word utterances in
# covered languages score > 0.18; held-out full sentences score 0.35-0.8.
MIN_SCORE = 0.12

_STRIP = re.compile(r"[\W\d_]+", re.UNICODE)


class Detection(NamedTuple):
    language: str
    score: float  # IDF-weighted cosine vs the winning profile, in [0, 1]


def _normalize(text: str) -> str:
    text = unicodedata.normalize("NFKC", text).lower()
    return (" " + _STRIP.sub(" ", text).strip() + " ") if text.strip() else ""


def _fold(text: str) -> str:
    """Strip combining marks (á→a, č→c); best-effort ASCII folding so that
    diacritic-stripped transcripts still share grams with the profile."""
    decomposed = unicodedata.normalize("NFKD", text)
    return "".join(c for c in decomposed if not unicodedata.combining(c))


def _gram_counts(norm: str, counts: Counter) -> None:
    for n in (1, 2, 3):
        counts.update(norm[i:i + n] for i in range(max(len(norm) - n + 1, 0)))


def _ngrams(text: str) -> Counter:
    norm = _normalize(text)
    counts: Counter = Counter()
    _gram_counts(norm, counts)
    folded = _fold(norm)
    if folded != norm:
        # Feature union with the folded stream: profiles and inputs both
        # carry diacritic-free variants, so ASCII-fied text still routes.
        _gram_counts(folded, counts)
    for blank in (" ", "  ", "   "):
        counts.pop(blank, None)
    return counts


@lru_cache(maxsize=1)
def _model() -> tuple[dict[str, dict[str, float]], dict[str, float], float]:
    """(idf-weighted unit profiles, idf table, default idf for unseen grams)."""
    raw = {lang: _ngrams(text) for lang, text in CORPUS.items()}
    df: Counter = Counter()
    for counts in raw.values():
        df.update(counts.keys())
    n_langs = len(raw)
    idf = {g: math.log(n_langs / d) + 0.05 for g, d in df.items()}
    unseen_idf = math.log(n_langs) + 0.05
    profiles = {}
    for lang, counts in raw.items():
        vec = {g: c * idf[g] for g, c in counts.items()}
        norm = math.sqrt(sum(w * w for w in vec.values()))
        profiles[lang] = {g: w / norm for g, w in vec.items()}
    return profiles, idf, unseen_idf


def supported_languages() -> list[str]:
    """Languages with a built-in profile (extend via lang_corpus.CORPUS)."""
    return sorted(CORPUS)


def rank_languages(text: str) -> list[Detection]:
    """All languages scored against ``text``, best first, unthresholded.

    Use when a caller has prior knowledge (e.g. a corpus whitelist) and
    wants to break near-ties between sibling languages itself; plain
    classification should use :func:`detect_language`.
    """
    counts = _ngrams(text)
    if not counts:
        return []
    profiles, idf, unseen_idf = _model()
    vec = {g: c * idf.get(g, unseen_idf) for g, c in counts.items()}
    norm = math.sqrt(sum(w * w for w in vec.values()))
    vec = {g: w / norm for g, w in vec.items()}
    out = []
    for lang, profile in profiles.items():
        if len(profile) > len(vec):
            score = sum(w * profile.get(g, 0.0) for g, w in vec.items())
        else:
            score = sum(w * vec.get(g, 0.0) for g, w in profile.items())
        out.append(Detection(lang, score))
    out.sort(key=lambda d: d.score, reverse=True)
    return out


def detect_language(text: str) -> Detection:
    """Best-match language for ``text``.

    Returns ``Detection(language, score)`` where score is the IDF-weighted
    cosine similarity in [0, 1] against the winning n-gram profile;
    callers can threshold on it. ``und`` means no letters or nothing
    scored above ``MIN_SCORE`` (e.g. gibberish, or a language outside
    ``supported_languages()``).
    """
    ranked = rank_languages(text)
    if not ranked:
        return Detection("und", 0.0)
    best = ranked[0]
    if best.score < MIN_SCORE:
        return Detection("und", best.score)
    return best
