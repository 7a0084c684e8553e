"""English text normalization for WER scoring, in the style of OpenAI
Whisper's ``EnglishTextNormalizer``.

Published Whisper WERs are computed after an aggressive English
normalization (lowercase, remove fillers/brackets, expand contractions,
verbalized numbers -> digits, spelled titles, punctuation strip). Scoring
with only the basic normalizer (``yoho_tpu_torch.eval.wer.normalize_for_wer``)
systematically inflates WER on references that write numbers as digits
while the model spells them out (or vice versa). This module implements
the same normalization *shape* so our numbers are comparable:

1. lowercase; drop ``(...)``/``[...]`` asides and hesitation fillers;
2. expand contractions (``won't`` -> ``will not``) and title
   abbreviations (``mr`` -> ``mister``);
3. convert spelled-out numbers to digits (cardinals to the trillions,
   hyphenated tens, ``point`` decimals, ordinals);
4. strip punctuation (word-internal apostrophes kept), squeeze spaces.

Divergences from OpenAI's implementation (documented, deliberate): the
British->American spelling table (their 85k-entry JSON) is not shipped —
no network egress and it is data, not behavior; currency/percent symbol
verbalization is limited to the common cases. Both sides of a WER
comparison go through the SAME function, so scores remain internally
consistent.

The port's copy of the JAX package's ``eval/english_normalizer.py`` (pure
Python; the port imports nothing of ``yoho_tpu``). It turns spelled numbers
into digits, the opposite direction of ``text/numbers.py``, so it keeps
its own parser.
"""

from __future__ import annotations

import re
from typing import List, Optional

_FILLERS = {"hmm", "mm", "mhm", "mmm", "uh", "um", "uhh", "umm", "er", "ah"}

_CONTRACTIONS = {
    "won't": "will not", "can't": "cannot", "shan't": "shall not",
    "ain't": "is not", "let's": "let us", "ma'am": "madam",
    "o'clock": "oclock", "y'all": "you all", "'cause": "because",
    "gonna": "going to", "wanna": "want to", "gotta": "got to",
    "gimme": "give me", "lemme": "let me", "kinda": "kind of",
    "sorta": "sort of", "outta": "out of", "dunno": "do not know",
    "'em": "them",
    # 's is ambiguous (possessive vs "is"); expand only the closed class
    # of pronouns/wh-words where it always means "is".
    "it's": "it is", "that's": "that is", "what's": "what is",
    "there's": "there is", "here's": "here is", "he's": "he is",
    "she's": "she is", "who's": "who is", "where's": "where is",
    "how's": "how is", "when's": "when is", "why's": "why is",
}
# Generic suffixes applied after the irregulars above.
_SUFFIXES = [
    ("n't", " not"), ("'re", " are"), ("'ve", " have"), ("'ll", " will"),
    ("'d", " would"), ("'m", " am"),
]

_TITLES = {
    "mr": "mister", "mrs": "missus", "ms": "miss", "dr": "doctor",
    "st": "saint", "prof": "professor", "capt": "captain", "gov": "governor",
    "gen": "general", "sen": "senator", "rep": "representative",
    "pres": "president", "rev": "reverend", "hon": "honorable",
    "lt": "lieutenant", "col": "colonel", "sgt": "sergeant",
    "jr": "junior", "sr": "senior", "esq": "esquire",
}

_UNITS = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
}
_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
         "seventy": 70, "eighty": 80, "ninety": 90}
_SCALES = {"hundred": 100, "thousand": 10**3, "million": 10**6,
           "billion": 10**9, "trillion": 10**12}

_ORDINAL_UNITS = {
    "first": 1, "second": 2, "third": 3, "fourth": 4, "fifth": 5,
    "sixth": 6, "seventh": 7, "eighth": 8, "ninth": 9, "tenth": 10,
    "eleventh": 11, "twelfth": 12, "thirteenth": 13, "fourteenth": 14,
    "fifteenth": 15, "sixteenth": 16, "seventeenth": 17, "eighteenth": 18,
    "nineteenth": 19, "twentieth": 20, "thirtieth": 30, "fortieth": 40,
    "fiftieth": 50, "sixtieth": 60, "seventieth": 70, "eightieth": 80,
    "ninetieth": 90, "hundredth": 100, "thousandth": 10**3,
    "millionth": 10**6, "billionth": 10**9,
}


def _ordinal_suffix(n: int) -> str:
    if 10 <= n % 100 <= 20:
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")


class _NumberParser:
    """Greedy longest-match parse of a spelled number starting at ``i``.

    Returns (rendered_string, next_index) or None. Grammar: sequences of
    unit/ten/scale words (optionally hyphenated like twenty-three, with
    'and' allowed after a scale word), an optional trailing ordinal word,
    and 'point' followed by spoken digits.
    """

    def parse(self, words: List[str], i: int) -> Optional[tuple]:
        total = 0
        current = 0
        j = i
        consumed_any = False
        ordinal_value: Optional[int] = None
        while j < len(words):
            w = words[j]
            parts = w.split("-") if "-" in w else [w]
            if len(parts) == 2 and parts[0] in _TENS and (
                    parts[1] in _UNITS or parts[1] in _ORDINAL_UNITS):
                if parts[1] in _UNITS:
                    current += _TENS[parts[0]] + _UNITS[parts[1]]
                else:
                    ordinal_value = (total + current + _TENS[parts[0]]
                                     + _ORDINAL_UNITS[parts[1]])
                    j += 1
                    consumed_any = True
                    break
                j += 1
                consumed_any = True
                continue
            if w in _UNITS:
                # "five three" is two numbers, not 8: a unit directly
                # after a unit (teens included — "sixteen five" is
                # "16 5", never 21) ends this number; spoken digit
                # sequences are handled by the caller as separate
                # numbers.
                if current % 10 in range(1, 10) or current % 100 in range(10, 20):
                    break
                if consumed_any and current == 0 and total == 0:
                    # "five zero five" is a digit sequence: a consumed
                    # "zero" ends its number instead of being absorbed.
                    break
                if consumed_any and _UNITS[w] == 0:
                    # "twenty zero" is "20 0": zero never extends a
                    # number, it can only start one.
                    break
                current += _UNITS[w]
                j += 1
                consumed_any = True
                continue
            if w in _TENS:
                # A ten after any sub-hundred residue starts a NEW number
                # ("nineteen eighty" is year-speak "19 80", never 99).
                if current % 100 != 0:
                    break
                current += _TENS[w]
                j += 1
                consumed_any = True
                continue
            if w in _SCALES:
                scale = _SCALES[w]
                if scale == 100:
                    current = max(current, 1) * 100
                else:
                    total += max(current, 1) * scale
                    current = 0
                j += 1
                consumed_any = True
                # allow "and" inside e.g. "one hundred and five"
                if j < len(words) and words[j] == "and" and j + 1 < len(words) \
                        and self._is_number_word(words[j + 1]):
                    j += 1
                continue
            if w in _ORDINAL_UNITS and consumed_any:
                ov = _ORDINAL_UNITS[w]
                if ov >= 100:  # scale ordinals multiply: "two hundredth" = 200th
                    ordinal_value = total + max(current, 1) * ov
                else:
                    ordinal_value = total + current + ov
                j += 1
                break
            break
        if not consumed_any:
            # standalone ordinal word ("first" alone)
            if i < len(words) and words[i] in _ORDINAL_UNITS:
                n = _ORDINAL_UNITS[words[i]]
                return f"{n}{_ordinal_suffix(n)}", i + 1
            return None
        if ordinal_value is not None:
            return (f"{ordinal_value}{_ordinal_suffix(ordinal_value)}", j)
        value = total + current
        # "point" decimals: digits spoken one by one.
        if j < len(words) and words[j] == "point":
            frac = []
            k = j + 1
            while k < len(words) and words[k] in _UNITS and _UNITS[words[k]] < 10:
                frac.append(str(_UNITS[words[k]]))
                k += 1
            if frac:
                return f"{value}.{''.join(frac)}", k
        # Bare "zero" is a plain digit via _UNITS; "oh"-as-zero is
        # context-dependent and handled in _words_to_digits.
        return str(value), j

    @staticmethod
    def _is_number_word(w: str) -> bool:
        head = w.split("-")[0]
        return (head in _UNITS or head in _TENS or head in _SCALES
                or head in _ORDINAL_UNITS)


_PARSER = _NumberParser()


def _words_to_digits(text: str) -> str:
    words = text.split()
    out: List[str] = []
    i = 0
    while i < len(words):
        # "oh" as a zero DIGIT only inside a number context ("nineteen
        # oh five" -> "19 0 5"); the bare interjection ("oh no") stays a
        # word. The context test is: the previous emitted token rendered
        # as a number.
        if (words[i] == "oh" and out
                and out[-1].replace(".", "", 1).isdigit()):
            out.append("0")
            i += 1
            continue
        parsed = _PARSER.parse(words, i)
        if parsed is not None:
            rendered, j = parsed
            out.append(rendered)
            i = j
        else:
            out.append(words[i])
            i += 1
    return " ".join(out)


def normalize_english(text: str) -> str:
    """Whisper-style English normalization (see module docstring)."""
    text = text.lower()
    text = re.sub(r"[<\[][^>\]]*[>\]]", "", text)  # [asides] / <tags>
    text = re.sub(r"\(([^)]+?)\)", "", text)       # (asides)
    # Keep word-internal apostrophes for contraction expansion; unify
    # typographic apostrophes first.
    text = text.replace("’", "'")
    import re as _re
    for src, dst in _CONTRACTIONS.items():
        # (?<!\w)-anchored: a bare str.replace mangles possessives that
        # embed a contraction key ("hamlet's" -> "hamlet us" via
        # "let's"), and a leading \b can never match apostrophe-leading
        # keys ("'cause", "'em") because no word boundary sits between a
        # space and an apostrophe.
        text = _re.sub(rf"(?<!\w){_re.escape(src)}\b", dst, text)
    for suf, repl in _SUFFIXES:
        text = re.sub(rf"(\w){re.escape(suf)}\b", rf"\1{repl}", text)
    # Titles: abbreviations with optional trailing period.
    def _title(m):
        return _TITLES[m.group(1)]
    text = re.sub(rf"\b({'|'.join(_TITLES)})\.?(?=\s|$)", _title, text)
    # Symbols that carry meaning before punctuation strip.
    text = re.sub(r"(\d)%", r"\1 percent", text)
    text = text.replace("&", " and ")
    # Drop remaining punctuation (keep digits, letters, apostrophes inside
    # words, decimal points inside numbers, hyphens inside spelled tens).
    # Keep dots ONLY between digits (decimal points); a sentence-final
    # dot after a digit ("born in 1990.") must go too.
    text = re.sub(r"(?<!\d)\.|\.(?!\d)", " ", text)
    text = re.sub(r"[^\w\s'.\-]", " ", text)
    text = re.sub(r"(?<!\w)'|'(?!\w)", " ", text)
    text = re.sub(r"(?<!\w)-|-(?!\w)", " ", text)
    words = [w for w in text.split() if w not in _FILLERS]
    text = _words_to_digits(" ".join(words))
    return re.sub(r"\s+", " ", text).strip()
