"""GPT-2 byte-level BPE codec over local HF tokenizer serializations.

The reference renders Whisper transcripts as *text* through tiktoken's
GPT-2 vocab (``yoho/src/nn/whisper.py:268-284``); round 1 required the
``transformers`` tokenizer stack for the same job. This module makes the
framework self-sufficient (the repo owns its text capabilities):
it loads the GPT-2 byte-level BPE from any locally present checkpoint
dir — ``vocab.json`` + ``merges.txt`` or ``tokenizer.json`` — and
implements the published GPT-2 algorithm from first principles:

  * the 256-entry byte<->unicode "printable surrogate" table,
  * the GPT-2 pre-tokenizer
    (``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``)
    as a dependency-free scanner (stdlib ``re`` has no ``\\p`` classes),
  * lowest-rank-first pair merging.

Golden-tested byte-for-byte against ``transformers.GPT2Tokenizer`` built
from the same files, and the scanner is fuzzed against the true pattern
via the ``regex`` module when available (tests/test_gpt2_bpe.py).

Known limitation: letter/number classification rides on the running
Python's unicodedata tables; codepoints assigned to \\p{L}/\\p{N} in a
NEWER Unicode version than the interpreter ships (e.g. recent CJK
extensions, unassigned in 15.0) classify as punctuation here and can
pretokenize differently from a ``regex``-module build with newer tables.
Encoded output remains a valid reversible byte-level encoding either
way; only golden id-parity on those rare codepoints is affected.

The port's copy of the JAX package's ``text/gpt2_bpe.py``. It reads local
files only: a hub id, or a tokenizer the loaders here cannot parse, gives
no backend (``load_text_backend`` returns None), where the JAX package
tries ``transformers``.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence, Tuple


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char table.

    Printable ASCII/latin-1 ranges map to themselves; the remaining 68
    bytes map to 256+i so every byte is a visible character and BPE can
    operate on strings without whitespace/control ambiguity.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


# --------------------------------------------------------------------------
# Pre-tokenizer: a hand-rolled scanner equivalent to GPT-2's regex.
# --------------------------------------------------------------------------

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_space(ch: str) -> bool:
    # regex \s (Unicode White_Space) — Python's str.isspace() ALSO counts
    # the file/group/record/unit separators U+001C-U+001F, which the
    # GPT-2 pattern does not (fuzz-confirmed divergence vs tiktoken/HF).
    return ch.isspace() and ch not in "\x1c\x1d\x1e\x1f"


def _is_number(ch: str) -> bool:
    # \p{N} ~ numeric-but-not-letter: category-L chars with numeric value
    # (e.g. CJK numerals) are claimed by the letter branch first, exactly
    # as the regex alternation order does.
    return ch.isnumeric() and not ch.isalpha()


def _word_at(text: str, i: int, prefix: str) -> Tuple[str, int]:
    """Match one non-whitespace token starting at ``i``; ``prefix`` is the
    already-consumed optional leading space (the pattern's ``' ?'``)."""
    n = len(text)
    ch = text[i]
    if not prefix and ch == "'":
        # Contraction branches have no ' ?' prefix, so they only apply
        # when the match starts at the apostrophe itself.
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                return c, i + len(c)
    if ch.isalpha():
        j = i + 1
        while j < n and text[j].isalpha():
            j += 1
        return prefix + text[i:j], j
    if _is_number(ch):
        j = i + 1
        while j < n and _is_number(text[j]):
            j += 1
        return prefix + text[i:j], j
    # punctuation/symbols: anything neither whitespace nor letter nor number
    j = i + 1
    while j < n and not (
        _is_space(text[j]) or text[j].isalpha() or _is_number(text[j])
    ):
        j += 1
    return prefix + text[i:j], j


def pretokenize(text: str) -> List[str]:
    """Split text exactly as GPT-2's pattern does (match concatenation
    reproduces the input)."""
    toks: List[str] = []
    i, n = 0, len(text)
    while i < n:
        if _is_space(text[i]):
            j = i
            while j < n and _is_space(text[j]):
                j += 1
            if j == n:  # trailing whitespace run: one token
                toks.append(text[i:j])
                break
            # '\s+(?!\S)' takes the run minus its last char; the last
            # char joins the following token iff it is a plain space
            # (the other branches' ' ?'), else stands alone via '\s+'.
            if j - i > 1:
                toks.append(text[i : j - 1])
            last = text[j - 1]
            if last == " ":
                tok, i = _word_at(text, j, prefix=" ")
                toks.append(tok)
            else:
                toks.append(last)
                i = j
            continue
        tok, i = _word_at(text, i, prefix="")
        toks.append(tok)
    return toks


# --------------------------------------------------------------------------


class GPT2BPE:
    """Encoder/decoder for a GPT-2-style byte-level BPE vocabulary.

    Duck-type compatible with the ``text_backend`` protocol of
    :class:`yoho_tpu_torch.text.whisper_tokens.WhisperTokenTable` (HF/tiktoken
    tokenizers): ``encode(text) -> ids`` and ``decode(ids) -> str``.
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.decoder = {i: t for t, i in self.vocab.items()}
        self.ranks: Dict[Tuple[str, str], int] = {
            tuple(m): r for r, m in enumerate(merges)
        }
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = unicode_to_bytes()
        self._cache: Dict[str, List[str]] = {}

    # -- encoding ----------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = {(word[k], word[k + 1]) for k in range(len(word) - 1)}
            bigram = min(
                pairs, key=lambda p: self.ranks.get(p, float("inf"))
            )
            if bigram not in self.ranks:
                break
            first, second = bigram
            out: List[str] = []
            k = 0
            while k < len(word):
                if (
                    k < len(word) - 1
                    and word[k] == first
                    and word[k + 1] == second
                ):
                    out.append(first + second)
                    k += 2
                else:
                    out.append(word[k])
                    k += 1
            word = tuple(out)
        result = list(word)
        if len(self._cache) < 1_000_000:
            self._cache[token] = result
        return result

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Plain-text ids (no specials; the kw mirrors HF's signature so
        callers can pass ``add_special_tokens=False`` blindly)."""
        del add_special_tokens  # this codec never adds specials
        ids: List[int] = []
        for tok in pretokenize(text):
            mapped = "".join(self._byte_enc[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                i = self.vocab.get(piece)
                if i is None:  # corrupt vocab/merges mismatch: byte fallback
                    try:
                        ids.extend(self.vocab[c] for c in piece)
                    except KeyError as e:
                        raise ValueError(
                            f"corrupt tokenizer files: piece {piece!r} is "
                            f"not in vocab.json and neither is its byte "
                            f"{e.args[0]!r} — re-download vocab.json/"
                            "merges.txt together") from None
                else:
                    ids.append(i)
        return ids

    # -- decoding ----------------------------------------------------------
    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        """Raw vocab token strings (byte-unicode alphabet, Ġ = space) —
        HF-compatible surface used by word-timestamp grouping."""
        return [self.decoder.get(int(i), "") for i in ids]

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytes(
            self._byte_dec[c] for c in text if c in self._byte_dec
        )
        return data.decode("utf-8", errors="replace")

    # -- loading -----------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json, merges_txt) -> "GPT2BPE":
        vocab = json.loads(Path(vocab_json).read_text(encoding="utf-8"))
        merges: List[Tuple[str, str]] = []
        for ln in Path(merges_txt).read_text(encoding="utf-8").split("\n"):
            if not ln or ln.startswith("#version"):
                continue
            parts = ln.split(" ")
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    @classmethod
    def from_tokenizer_json(cls, tokenizer_json) -> "GPT2BPE":
        data = json.loads(Path(tokenizer_json).read_text(encoding="utf-8"))
        model = data["model"]
        if model.get("type") not in (None, "BPE"):
            raise ValueError(f"unsupported tokenizer model {model.get('type')!r}")
        merges = [
            tuple(m.split(" ", 1)) if isinstance(m, str) else (m[0], m[1])
            for m in model["merges"]
        ]
        return cls(model["vocab"], merges)

    @classmethod
    def from_dir(cls, path) -> "GPT2BPE":
        """Load from a checkpoint dir: ``vocab.json``+``merges.txt``
        preferred (smallest parse), else ``tokenizer.json``."""
        p = Path(path)
        if (p / "vocab.json").exists() and (p / "merges.txt").exists():
            return cls.from_files(p / "vocab.json", p / "merges.txt")
        if (p / "tokenizer.json").exists():
            return cls.from_tokenizer_json(p / "tokenizer.json")
        raise FileNotFoundError(
            f"no tokenizer files (vocab.json+merges.txt or tokenizer.json) in {p}"
        )


class TiktokenBPE:
    """Text backend over tiktoken's serialization (``*.tiktoken``: one
    ``base64(token_bytes) rank`` per line — the format OpenAI's whisper
    package ships its GPT-2 vocabs in, ``whisper/tokenizer.py`` upstream;
    the reference renders text through it, ``yoho/src/nn/whisper.py:268``).

    Encoding uses tiktoken's own byte-pair-merge: repeatedly join the
    adjacent pair whose CONCATENATION has the lowest vocab rank. For a
    BPE-trained vocab (ranks assigned in merge-creation order) this is
    the same tokenization as applying the merges list — asserted against
    transformers in tests. Duck-type compatible with the
    ``text_backend`` protocol (encode/decode/convert_ids_to_tokens).
    """

    def __init__(self, ranks: Dict[bytes, int]):
        self.ranks = dict(ranks)
        self.decoder = {i: b for b, i in self.ranks.items()}
        self._byte_enc = bytes_to_unicode()
        self._cache: Dict[bytes, List[int]] = {}

    def _merge(self, piece: bytes) -> List[int]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for part in parts:
            r = self.ranks.get(part)
            if r is None:
                # A truncated .tiktoken missing single-byte entries would
                # otherwise DELETE characters from transcripts silently.
                raise ValueError(
                    f"corrupt .tiktoken vocabulary: byte sequence {part!r} "
                    "has no rank — the file is truncated or mismatched")
            out.append(r)
        if len(self._cache) < 1_000_000:
            self._cache[piece] = out
        return out

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        del add_special_tokens  # this codec never adds specials
        ids: List[int] = []
        for tok in pretokenize(text):
            ids.extend(self._merge(tok.encode("utf-8")))
        return ids

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        """Byte-unicode token strings (Ġ = space) — the HF-compatible
        surface word-timestamp grouping reads."""
        enc = self._byte_enc
        return ["".join(enc[b] for b in self.decoder.get(int(i), b""))
                for i in ids]

    def decode(self, ids: Sequence[int]) -> str:
        data = b"".join(self.decoder.get(int(i), b"") for i in ids)
        return data.decode("utf-8", errors="replace")

    @classmethod
    def from_file(cls, path) -> "TiktokenBPE":
        import base64

        ranks: Dict[bytes, int] = {}
        for ln in Path(path).read_bytes().splitlines():
            if not ln:
                continue
            tok, _, rank = ln.partition(b" ")
            ranks[base64.b64decode(tok)] = int(rank)
        if not ranks:
            raise ValueError(f"empty tiktoken file {path}")
        return cls(ranks)


def load_text_backend(model_path: str):
    """Best text backend for a local Whisper checkpoint path, or None.

    Order: GPT-2/HF serializations (``vocab.json`` + ``merges.txt``, then
    ``tokenizer.json``), then tiktoken's (``*.tiktoken``). Local files
    only: where the JAX package falls back to ``transformers`` (a hub id,
    or a tokenizer file its own loaders reject), this returns None and
    the caller warns (``cli/transcribe.py``) or refuses (fine-tuning).
    """
    try:
        return GPT2BPE.from_dir(model_path)
    except (FileNotFoundError, NotADirectoryError, ValueError, KeyError):
        pass
    try:
        p = Path(model_path)
        candidates = ([p] if p.suffix == ".tiktoken" else
                      sorted(p.glob("*.tiktoken")) if p.is_dir() else [])
        # When gpt2.tiktoken (English-only) and multilingual.tiktoken ship
        # together (OpenAI's whisper package caches the pair), pick by the
        # checkpoint's vocab: .en models (vocab 51864) use the gpt2 table —
        # decoding their ids through the multilingual table garbles
        # transcripts silently (every id still resolves to SOME bytes).
        prefer = "multilingual"
        try:
            cfg = json.loads((p / "config.json").read_text(encoding="utf-8"))
            if int(cfg.get("vocab_size", 51865)) == 51864:
                prefer = "gpt2"
        except (OSError, ValueError, TypeError):
            pass
        candidates.sort(key=lambda c: prefer not in c.name)
        if candidates:
            return TiktokenBPE.from_file(candidates[0])
    except (OSError, ValueError):
        pass
    return None
