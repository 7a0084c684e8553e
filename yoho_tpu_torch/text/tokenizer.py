"""The YOHO session tokenizer: byte-level BPE plus the special tokens.

A copy of the JAX package's ``text/tokenizer.py``: ``<|startoftranscript|>``,
``<|endoftranscript|>``, ``<|voiceprint|>`` and one ``<|t-i|>`` timestamp
token per STFT frame at ids 0..K-1, contiguous, so frame <-> id conversion
is arithmetic. Text between specials goes through byte-level BPE
(``text/bpe.py``, or ``native/bpe.cpp`` where ``g++`` built it).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, List, Sequence

from yoho_tpu_torch.text.bpe import ByteBPE, train_bpe

SOT = "<|startoftranscript|>"
EOT = "<|endoftranscript|>"
VOICEPRINT = "<|voiceprint|>"


def yoho_special_tokens(max_audio_len: int) -> List[str]:
    """The session tokenizer's specials: SOT, EOT, the voiceprint slot, then
    one ``<|t-i|>`` per STFT frame."""
    return [SOT, EOT, VOICEPRINT, *[f"<|t-{i}|>" for i in range(max_audio_len)]]


def _native_encoder(bpe: ByteBPE):
    """The C++ encoder of ``bpe``, or None where the native library cannot
    be built (the Python backend then encodes)."""
    from yoho_tpu_torch.native import NativeBPEEncoder, get_lib

    return NativeBPEEncoder(bpe.dump()) if get_lib() is not None else None


class YOHOTokenizer:
    """Encode/decode with special-token awareness.

    Specials occupy ids 0..K-1 (stable, contiguous timestamps); text spans
    between specials go through byte-level BPE.
    """

    def __init__(self, bpe: ByteBPE, use_native: bool = True):
        self.bpe = bpe
        self._native = None
        self._use_native = use_native
        if use_native:
            self._native = _native_encoder(bpe)
        self._special_re = None
        if bpe.specials:
            pattern = "|".join(re.escape(s) for s in sorted(bpe.specials, key=len,
                                                            reverse=True))
            self._special_re = re.compile(f"({pattern})")
        # Timestamp bookkeeping.
        self.sot_id = bpe.special_to_id.get(SOT)
        self.eot_id = bpe.special_to_id.get(EOT)
        self.voiceprint_id = bpe.special_to_id.get(VOICEPRINT)
        self.timestamp_base = bpe.special_to_id.get("<|t-0|>")
        self.n_timestamps = sum(1 for s in bpe.specials if s.startswith("<|t-"))

    # ------------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self.bpe.vocab_size

    def timestamp_id(self, frame: int) -> int:
        if self.timestamp_base is None:
            raise ValueError("this tokenizer has no timestamp tokens")
        return self.timestamp_base + frame

    def is_timestamp(self, token_id: int) -> bool:
        return (self.timestamp_base is not None
                and self.timestamp_base <= token_id < self.timestamp_base + self.n_timestamps)

    # Spawn-based dataloader workers pickle the tokenizer; the ctypes
    # native handle can't cross the boundary, so drop it and rebuild lazily.
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_native"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        # Honor an explicit use_native=False across the pickle boundary
        # (python-vs-native A/B comparisons run through spawn workers).
        if not getattr(self, "_use_native", True):
            self._native = None
            return
        self._native = _native_encoder(self.bpe)

    def _encode_plain(self, text: str) -> List[int]:
        if self._native is not None:
            return self._native.encode(text).tolist()
        return self.bpe.encode_text(text)

    def encode(self, text: str) -> List[int]:
        if self._special_re is None:
            return self._encode_plain(text)
        out: List[int] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            sid = self.bpe.special_to_id.get(part)
            if sid is not None:
                out.append(sid)
            else:
                out.extend(self._encode_plain(part))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        buf: List[int] = []
        at_boundary = [True]  # start of text or right after a special token

        def flush():
            if buf:
                text = self.bpe.decode_bytes(buf).decode("utf-8", errors="replace")
                # The encoder injects a leading space marker on every word;
                # drop the synthetic one at text/special boundaries.
                if at_boundary[0] and text.startswith(" "):
                    text = text[1:]
                parts.append(text)
                buf.clear()
                at_boundary[0] = False

        for i in ids:
            i = int(i)
            if i < self.bpe.n_special:
                flush()
                parts.append(self.bpe.specials[i])
                at_boundary[0] = True
            else:
                buf.append(i)
        flush()
        return "".join(parts)

    # ------------------------------------------------------------------
    def save(self, path) -> None:
        self.bpe.save(path)

    @classmethod
    def load(cls, path) -> "YOHOTokenizer":
        return cls(ByteBPE.load(path))


def train_tokenizer(
    corpus: Iterable[str],
    vocab_size: int,
    max_token_length: int = 32,
    max_audio_len: int = 1024,
    extra_specials: Sequence[str] = (),
    backend: str = "auto",
) -> YOHOTokenizer:
    """Train the session tokenizer (stage 0 capability).

    ``backend="native"`` uses the C++ trainer (corpus-scale), ``"python"``
    the in-process oracle; ``"auto"`` prefers native when built.
    """
    specials = yoho_special_tokens(max_audio_len) + list(extra_specials)
    if backend in ("auto", "native"):
        from yoho_tpu_torch.native import bpe_train_native

        if backend == "auto" and not isinstance(corpus, (list, tuple)):
            # The native attempt CONSUMES the iterable (it joins the whole
            # corpus before it can discover the library is unavailable);
            # falling back to the Python trainer on the exhausted generator
            # would silently produce a merge-less, bytes-only tokenizer.
            # Materialize once — no extra peak memory vs the native join.
            corpus = list(corpus)
        model_text = bpe_train_native(corpus, vocab_size, max_token_length, specials)
        if model_text is not None:
            return YOHOTokenizer(ByteBPE.loads(model_text))
        if backend == "native":
            raise RuntimeError("native BPE backend unavailable (no toolchain?)")
    bpe = train_bpe(corpus, vocab_size, max_token_length, specials)
    return YOHOTokenizer(bpe)


def load_tokenizer(vocab_path) -> YOHOTokenizer:
    """A session's tokenizer file (``weights/tokenizer.model``)."""
    return YOHOTokenizer.load(Path(vocab_path))
