"""Text standardization for tokenizer/ASR training.

Capability parity with the reference ``train/utils/standardize_text.py``
(strip parenthesized/ bracketed asides, numbers -> words, whitespace/punct
cleanup). The reference delegates numbers to the ``num2words`` package; this
framework owns the capability in ``yoho_tpu_torch.text.numbers`` (built-in
verbalizers for en/de/es/fr/cs — cs being the language the reference's
ISO-code fixups targeted). Other languages fall back to ``num2words`` when
it happens to be installed, passing digits through otherwise.

The port's copy of the JAX package's ``text/standardize.py``, which imports no JAX
(the port imports nothing of ``yoho_tpu``).
"""

from __future__ import annotations

import re
from typing import Optional

from yoho_tpu_torch.text.numbers import _INT_VERBALIZERS, decimal_to_words


def number_to_words(num_str: str, lang: str = "en") -> str:
    """Verbalize ``"124.5"``-style numerals. en/de/es/fr/cs built-in; other
    languages use num2words when importable, else digits pass through."""
    num_str = num_str.replace(",", ".")
    if lang.split("-")[0] not in _INT_VERBALIZERS:
        try:
            from num2words import num2words  # optional; absent in this image

            # num2words doesn't use ISO-639 codes for some languages
            # (parity with reference standardize_text.py:8-14).
            corrections = {"da": "dk", "tgk": "tg"}
            return num2words(num_str, lang=corrections.get(lang, lang))
        except Exception:
            return num_str
    return decimal_to_words(num_str, lang)


def standardize_text(text: str, lang: str = "en") -> Optional[str]:
    """Normalize one utterance (same pipeline shape as the reference):
    drop asides, verbalize numerals, squeeze whitespace, fix punct spacing."""
    text = re.sub(r"\(.*?\)", "", text)
    text = re.sub(r"\[.*?\]", "", text)
    text = re.sub(r"\d+([.,]\d+)?", lambda m: number_to_words(m.group(), lang), text)
    text = re.sub(r"\s+", " ", text).strip()
    text = re.sub(r"\s+([,.;?!])", r"\1", text)
    return text
