"""Built-in number verbalizers for text standardization.

The reference delegates numeral verbalization to the ``num2words`` package
(``train/utils/standardize_text.py:6-29``, including ISO-code fixups for
Czech/Danish). That package is absent from this image, so the framework
owns the capability: pure-Python verbalizers for the languages the
reference's pipeline visibly cared about (English, Czech — the fixup
languages) plus the other large European ASR corpora languages (German,
Spanish, French). Unknown languages fall back to num2words when it happens
to be importable, else digits pass through unchanged.

Coverage: integers |n| < 10**15 per language (English reaches trillions;
the others reach 10**9 scale words, which covers transcript numerals).

The port's copy of the JAX package's ``text/numbers.py``, which imports no JAX
(the port imports nothing of ``yoho_tpu``).
"""

from __future__ import annotations

# --------------------------------------------------------------------- en
_EN_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty",
            "seventy", "eighty", "ninety"]
_EN_SCALE = [(10**12, "trillion"), (10**9, "billion"), (10**6, "million"),
             (10**3, "thousand")]


def int_to_words_en(n: int) -> str:
    if n < 0:
        return "minus " + int_to_words_en(-n)
    if n < 20:
        return _EN_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _EN_TENS[tens] + (f"-{_EN_ONES[rest]}" if rest else "")
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        out = f"{_EN_ONES[hundreds]} hundred"
        return out + (f" {int_to_words_en(rest)}" if rest else "")
    for value, name in _EN_SCALE:
        if n >= value:
            major, rest = divmod(n, value)
            out = f"{int_to_words_en(major)} {name}"
            return out + (f" {int_to_words_en(rest)}" if rest else "")
    return str(n)  # beyond supported range: pass through


# --------------------------------------------------------------------- de
_DE_ONES = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
    "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
    "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
_DE_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
            "siebzig", "achtzig", "neunzig"]


def _de_below_1000(n: int) -> str:
    """German compounds join without spaces. A terminal 1 is always
    'eins' (einhunderteins); 'ein' appears only as a multiplier prefix
    (einhundert, eintausend) or in 'einund<tens>'."""
    if n == 1:
        return "eins"
    if n < 20:
        return _DE_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        if rest == 0:
            return _DE_TENS[tens]
        unit = "ein" if rest == 1 else _DE_ONES[rest]
        return f"{unit}und{_DE_TENS[tens]}"
    hundreds, rest = divmod(n, 100)
    head = ("ein" if hundreds == 1 else _DE_ONES[hundreds]) + "hundert"
    return head + (_de_below_1000(rest) if rest else "")


def int_to_words_de(n: int) -> str:
    if n < 0:
        return "minus " + int_to_words_de(-n)
    if n < 1000:
        return _de_below_1000(n)
    parts = []
    for value, one, many in ((10**12, "eine Billion", "Billionen"),
                             (10**9, "eine Milliarde", "Milliarden"),
                             (10**6, "eine Million", "Millionen")):
        if n >= value:
            major, n = divmod(n, value)
            parts.append(one if major == 1
                         else f"{_de_below_1000(major)} {many}")
    if n >= 1000:
        major, n = divmod(n, 1000)
        parts.append(("ein" if major == 1
                      else _de_below_1000(major)) + "tausend"
                     + (_de_below_1000(n) if n else ""))
        n = 0
    if n or not parts:
        parts.append(_de_below_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------- es
_ES_ONES = [
    "cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete",
    "ocho", "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
    "dieciséis", "diecisiete", "dieciocho", "diecinueve", "veinte",
    "veintiuno", "veintidós", "veintitrés", "veinticuatro", "veinticinco",
    "veintiséis", "veintisiete", "veintiocho", "veintinueve",
]
_ES_TENS = ["", "", "", "treinta", "cuarenta", "cincuenta", "sesenta",
            "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = ["", "ciento", "doscientos", "trescientos", "cuatrocientos",
                "quinientos", "seiscientos", "setecientos", "ochocientos",
                "novecientos"]


def _es_below_1000(n: int) -> str:
    if n < 30:
        return _ES_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _ES_TENS[tens] + (f" y {_ES_ONES[rest]}" if rest else "")
    if n == 100:
        return "cien"
    hundreds, rest = divmod(n, 100)
    return _ES_HUNDREDS[hundreds] + (f" {_es_below_1000(rest)}" if rest else "")


def _es_apocope(words: str) -> str:
    """'uno' apocopates before a masculine noun/numeral: 'veintiún mil',
    'treinta y un millones' (num2words parity)."""
    if words.endswith("veintiuno"):
        return words[: -len("veintiuno")] + "veintiún"
    if words.endswith("uno"):
        return words[: -len("uno")] + "un"
    return words


def int_to_words_es(n: int) -> str:
    if n < 0:
        return "menos " + int_to_words_es(-n)
    if n < 1000:
        return _es_below_1000(n)
    parts = []
    for value, one, many in ((10**12, "un billón", "billones"),
                             (10**6, "un millón", "millones")):
        if n >= value:
            major, n = divmod(n, value)
            parts.append(one if major == 1
                         else f"{_es_apocope(int_to_words_es(major))} {many}")
    if n >= 1000:
        major, n = divmod(n, 1000)
        parts.append("mil" if major == 1
                     else f"{_es_apocope(_es_below_1000(major))} mil")
    if n or not parts:
        parts.append(_es_below_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------- fr
_FR_ONES = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
    "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
    "dix-sept", "dix-huit", "dix-neuf",
]
_FR_TENS = ["", "", "vingt", "trente", "quarante", "cinquante", "soixante"]


def _fr_below_100(n: int) -> str:
    if n < 20:
        return _FR_ONES[n]
    if n < 70:
        tens, rest = divmod(n, 10)
        if rest == 0:
            return _FR_TENS[tens]
        if rest == 1:
            return f"{_FR_TENS[tens]} et un"
        return f"{_FR_TENS[tens]}-{_FR_ONES[rest]}"
    if n < 80:  # soixante-dix .. soixante-dix-neuf (et onze at 71)
        if n == 71:
            return "soixante et onze"
        return f"soixante-{_FR_ONES[n - 60]}"
    if n == 80:
        return "quatre-vingts"  # final -s only when nothing follows
    if n < 100:
        return f"quatre-vingt-{_FR_ONES[n - 80]}"
    raise ValueError(n)


def _fr_below_1000(n: int) -> str:
    if n < 100:
        return _fr_below_100(n)
    hundreds, rest = divmod(n, 100)
    if hundreds == 1:
        head = "cent"
    elif rest == 0:
        return f"{_FR_ONES[hundreds]} cents"  # exact multiples take -s
    else:
        head = f"{_FR_ONES[hundreds]} cent"
    return head + (f" {_fr_below_100(rest)}" if rest else "")


def int_to_words_fr(n: int) -> str:
    if n < 0:
        return "moins " + int_to_words_fr(-n)
    if n < 1000:
        return _fr_below_1000(n)
    parts = []
    for value, one, many in ((10**12, "un billion", "billions"),
                             (10**9, "un milliard", "milliards"),
                             (10**6, "un million", "millions")):
        if n >= value:
            major, n = divmod(n, value)
            parts.append(one if major == 1
                         else f"{int_to_words_fr(major)} {many}")
    if n >= 1000:
        major, n = divmod(n, 1000)
        # 'mille' is invariant (never 'milles'); 1000 -> 'mille' not 'un
        # mille'. cents/vingts drop their plural -s before the numeral
        # mille ('quatre-vingt mille', 'deux cent mille') — the -s stays
        # before the NOUNS million/milliard.
        head = _fr_below_1000(major)
        if head.endswith(("cents", "vingts")):
            head = head[:-1]
        parts.append("mille" if major == 1 else f"{head} mille")
    if n or not parts:
        parts.append(_fr_below_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------- cs
_CS_ONES = [
    "nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm", "osm",
    "devět", "deset", "jedenáct", "dvanáct", "třináct", "čtrnáct",
    "patnáct", "šestnáct", "sedmnáct", "osmnáct", "devatenáct",
]
_CS_TENS = ["", "", "dvacet", "třicet", "čtyřicet", "padesát", "šedesát",
            "sedmdesát", "osmdesát", "devadesát"]
_CS_HUNDREDS = ["", "sto", "dvě stě", "tři sta", "čtyři sta", "pět set",
                "šest set", "sedm set", "osm set", "devět set"]


def _cs_below_1000(n: int) -> str:
    if n < 20:
        return _CS_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _CS_TENS[tens] + (f" {_CS_ONES[rest]}" if rest else "")
    hundreds, rest = divmod(n, 100)
    return _CS_HUNDREDS[hundreds] + (f" {_cs_below_1000(rest)}" if rest else "")


def _cs_scale(major: int, forms: tuple, feminine: bool = False) -> str:
    """Czech declension: 1 -> sg, 2-4 -> paucal, 5+ -> genitive plural.
    ``feminine``: miliarda takes 'dvě' ('dvě miliardy', not 'dva')."""
    one, few, many = forms
    if major == 1:
        return one
    count = _cs_below_1000(major) if major < 1000 else int_to_words_cs(major)
    if feminine and count.endswith("dva"):
        count = count[:-3] + "dvě"
    last_two = major % 100
    last = major % 10
    if 2 <= last <= 4 and not 12 <= last_two <= 14:
        return f"{count} {few}"
    return f"{count} {many}"


def int_to_words_cs(n: int) -> str:
    if n < 0:
        return "minus " + int_to_words_cs(-n)
    if n < 1000:
        return _cs_below_1000(n)
    parts = []
    for value, forms in ((10**12, ("bilion", "biliony", "bilionů")),
                         (10**9, ("miliarda", "miliardy", "miliard")),
                         (10**6, ("milion", "miliony", "milionů")),
                         (10**3, ("tisíc", "tisíce", "tisíc"))):
        if n >= value:
            major, n = divmod(n, value)
            parts.append(_cs_scale(major, forms, feminine=value == 10**9))
    if n or not parts:
        parts.append(_cs_below_1000(n))
    return " ".join(parts)


# ---------------------------------------------------------------- dispatch
_INT_VERBALIZERS = {
    "en": int_to_words_en,
    "de": int_to_words_de,
    "es": int_to_words_es,
    "fr": int_to_words_fr,
    "cs": int_to_words_cs,
}

# How each language reads the decimal separator.
_DECIMAL_WORD = {"en": "point", "de": "Komma", "es": "coma", "fr": "virgule",
                 "cs": "celá"}

#: Digit names for reading fractional parts digit-by-digit.
_DIGIT_NAMES = {
    "en": _EN_ONES[:10],
    "de": _DE_ONES[:10],
    "es": _ES_ONES[:10],
    "fr": _FR_ONES[:10],
    "cs": _CS_ONES[:10],
}


def supported_languages() -> tuple:
    return tuple(sorted(_INT_VERBALIZERS))


def int_to_words(n: int, lang: str) -> str:
    """Verbalize an integer; raises KeyError for unsupported languages."""
    return _INT_VERBALIZERS[lang.split("-")[0]](n)


_MINUS_WORD = {"en": "minus", "de": "minus", "es": "menos",
               "fr": "moins", "cs": "minus"}


def decimal_to_words(num_str: str, lang: str) -> str:
    """Verbalize ``"12.5"``-style numerals (fraction read digit-by-digit)."""
    base = lang.split("-")[0]
    fn = _INT_VERBALIZERS[base]
    if "." in num_str:
        whole, frac = num_str.split(".", 1)
        words = fn(int(whole)) if whole.lstrip("+-") else fn(0)
        # int("-0") == 0 loses the sign — re-attach the language's minus.
        if num_str.lstrip().startswith("-") and not words.startswith(
                ("minus", "moins", "menos")):
            words = f"{_MINUS_WORD[base]} {words}"
        if frac:
            digits = " ".join(_DIGIT_NAMES[base][int(d)]
                              for d in frac if d.isdigit())
            return f"{words} {_DECIMAL_WORD[base]} {digits}"
        return words
    return fn(int(num_str))
