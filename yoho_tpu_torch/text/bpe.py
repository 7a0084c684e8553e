"""Byte-level BPE tokenizer: trainer + encoder/decoder.

A copy of the JAX package's ``text/bpe.py`` (the port imports nothing of
``yoho_tpu``): a self-contained byte-level BPE with user-defined special
tokens at stable low ids, so the ``<|t-i|>`` timestamp tokens stay
contiguous and the decode-time rules index them arithmetically.

Id layout: ``[specials: 0..K-1][bytes: K..K+255][merges: K+256..vocab-1]``.

Two interchangeable backends share the on-disk model format (``YOHOBPE
v1``) and the exact training/encoding algorithm (ties broken by (count
desc, left id asc, right id asc); merges applied lowest-rank-first,
left-to-right): this pure-Python implementation (always available, the
oracle), and ``native/bpe.cpp`` (built with ``g++`` at first use).
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

MAGIC = "YOHOBPE v1"


class ByteBPE:
    def __init__(
        self,
        specials: Sequence[str],
        merges: Sequence[Tuple[int, int]],
    ):
        self.specials: List[str] = list(specials)
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        self.n_special = len(self.specials)
        self.byte_base = self.n_special
        self.merge_base = self.n_special + 256
        self.special_to_id = {s: i for i, s in enumerate(self.specials)}
        self.rank: Dict[Tuple[int, int], int] = {m: r for r, m in enumerate(self.merges)}
        # Expanded byte strings per id (for decode).
        self._bytes: List[bytes] = [b""] * self.vocab_size
        for b in range(256):
            self._bytes[self.byte_base + b] = bytes([b])
        for r, (a, bb) in enumerate(self.merges):
            self._bytes[self.merge_base + r] = self._bytes[a] + self._bytes[bb]
        self._word_cache: Dict[bytes, Tuple[int, ...]] = {}

    # ------------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self.n_special + 256 + len(self.merges)

    def id_to_bytes(self, i: int) -> bytes:
        return self._bytes[i]

    def id_to_piece(self, i: int) -> str:
        if i < self.n_special:
            return self.specials[i]
        return self._bytes[i].decode("utf-8", errors="replace")

    # ------------------------------------------------------------------
    def _encode_word(self, word: bytes) -> Tuple[int, ...]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        ids = [self.byte_base + b for b in word]
        while len(ids) > 1:
            best_rank, best_pos = None, -1
            for i in range(len(ids) - 1):
                r = self.rank.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pos = r, i
            if best_rank is None:
                break
            pair = (ids[best_pos], ids[best_pos + 1])
            merged_id = self.merge_base + best_rank
            # Replace every occurrence left-to-right.
            out = []
            i = 0
            while i < len(ids):
                if i < len(ids) - 1 and (ids[i], ids[i + 1]) == pair:
                    out.append(merged_id)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        result = tuple(ids)
        if len(self._word_cache) < 1_000_000:
            self._word_cache[word] = result
        return result

    def encode_text(self, text: str) -> List[int]:
        """Encode plain text (no special-token handling — see
        YOHOTokenizer). Every word carries a leading space marker."""
        out: List[int] = []
        for word in _pretokenize(text):
            out.extend(self._encode_word(word))
        return out

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self._bytes[i] for i in ids if i >= self.n_special)

    # ------------------------------------------------------------------
    def dump(self) -> str:
        lines = [MAGIC, f"specials {self.n_special}"]
        lines += self.specials
        lines.append(f"merges {len(self.merges)}")
        lines += [f"{a} {b}" for a, b in self.merges]
        return "\n".join(lines) + "\n"

    def save(self, path) -> None:
        Path(path).write_text(self.dump(), encoding="utf-8")

    @classmethod
    def loads(cls, data: str) -> "ByteBPE":
        lines = data.rstrip("\n").split("\n")
        if lines[0] != MAGIC:
            raise ValueError(f"not a {MAGIC} model")
        assert lines[1].startswith("specials ")
        k = int(lines[1].split()[1])
        specials = lines[2 : 2 + k]
        assert lines[2 + k].startswith("merges ")
        r = int(lines[2 + k].split()[1])
        merges = []
        for ln in lines[3 + k : 3 + k + r]:
            a, b = ln.split()
            merges.append((int(a), int(b)))
        return cls(specials, merges)

    @classmethod
    def load(cls, path) -> "ByteBPE":
        return cls.loads(Path(path).read_text(encoding="utf-8"))


import re as _re

_WS_WORD = _re.compile(r"[^ \t\n\r\f\v]+")


def _pretokenize(text: str) -> List[bytes]:
    """Split text into byte 'words', each prefixed by one space marker.

    Uniform leading-space treatment keeps encoding position-independent;
    decode strips the first space back off. ASCII-whitespace splitting only,
    so the C++ backend (bpe.cpp) tokenizes identically byte-for-byte.
    """
    return [(" " + w).encode("utf-8") for w in _WS_WORD.findall(text)]


def train_bpe(
    corpus: Iterable[str],
    vocab_size: int,
    max_token_length: int = 32,
    specials: Sequence[str] = (),
) -> ByteBPE:
    """Classic BPE training over word-frequency tables.

    Deterministic: ties on pair count break by (left id, right id)
    ascending — the C++ backend implements the identical rule.
    """
    n_special = len(specials)
    target_merges = vocab_size - n_special - 256
    if target_merges < 0:
        raise ValueError(
            f"vocab_size {vocab_size} too small for {n_special} specials + 256 bytes"
        )

    byte_base = n_special
    word_freq: Counter = Counter()
    for line in corpus:
        for w in _pretokenize(line):
            word_freq[w] += 1

    # words as mutable id lists with frequencies
    words: List[List[int]] = []
    freqs: List[int] = []
    for w, f in word_freq.items():
        words.append([byte_base + b for b in w])
        freqs.append(f)

    token_len: Dict[int, int] = {byte_base + b: 1 for b in range(256)}

    merges: List[Tuple[int, int]] = []
    merge_base = n_special + 256

    def count_pairs():
        pc: Counter = Counter()
        for ids, f in zip(words, freqs):
            for i in range(len(ids) - 1):
                pc[(ids[i], ids[i + 1])] += f
        return pc

    pair_counts = count_pairs()
    while len(merges) < target_merges and pair_counts:
        # Best pair: max count, ties by smallest (a, b); skip overlong merges.
        best, best_count = None, 1
        for pair, c in pair_counts.items():
            if token_len[pair[0]] + token_len[pair[1]] > max_token_length:
                continue
            if c > best_count or (c == best_count and best is not None and pair < best):
                best, best_count = pair, c
        if best is None:
            break
        new_id = merge_base + len(merges)
        merges.append(best)
        token_len[new_id] = token_len[best[0]] + token_len[best[1]]

        # Apply the merge in every word, updating pair counts incrementally.
        a, b = best
        for wi, ids in enumerate(words):
            if len(ids) < 2:
                continue
            f = freqs[wi]
            i = 0
            while i < len(ids) - 1:
                if ids[i] == a and ids[i + 1] == b:
                    if i > 0:
                        pair_counts[(ids[i - 1], a)] -= f
                        pair_counts[(ids[i - 1], new_id)] += f
                    if i + 2 < len(ids):
                        nxt = ids[i + 2]
                        pair_counts[(b, nxt)] -= f
                        # counts reflect the current sequence state; the C++
                        # backend implements the identical update order.
                        pair_counts[(new_id, nxt)] += f
                    ids[i : i + 2] = [new_id]
                else:
                    i += 1
        pair_counts.pop(best, None)
        # Drop exhausted entries lazily.
        if len(pair_counts) > 4 * len(words):
            pair_counts = +pair_counts

    return ByteBPE(list(specials), merges)
