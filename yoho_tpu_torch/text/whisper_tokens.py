"""OpenAI Whisper special-token id table (multilingual + English-only).

The reference drives greedy decode with tiktoken's ``_special_tokens`` dict
(``yoho/src/nn/whisper.py:268-284``) which requires downloading the GPT-2
vocab. Decoding *token ids* only needs the id table, which is fully
determined by the base vocab size and the published special ordering — so
this module computes it programmatically. Turning ids into text requires a
BPE vocab: pass any tiktoken/HF tokenizer as ``text_backend`` when one is
available locally.
"""

from __future__ import annotations

from typing import List, Sequence

# Whisper's 99 languages in canonical id order (tokenizer.py upstream);
# large-v3 appends "yue".
LANGUAGES: List[str] = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl",
    "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms", "cs", "ro",
    "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la", "mi", "ml", "cy",
    "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn", "et", "mk", "br", "eu",
    "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km",
    "sn", "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi", "lo",
    "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my", "bo", "tl", "mg",
    "as", "tt", "haw", "ln", "ha", "ba", "jw", "su",
]


class WhisperTokenTable:
    """Special-token ids for a Whisper checkpoint family.

    ``multilingual=True, v3=False`` -> vocab 51865 (tiny..large-v2);
    ``v3=True`` -> vocab 51866; ``multilingual=False`` -> vocab 51864 (.en).
    """

    def __init__(self, multilingual: bool = True, v3: bool = False,
                 num_frames: int = 1501, text_backend=None):
        self.multilingual = multilingual
        self.v3 = v3
        self.text_backend = text_backend
        self.languages = LANGUAGES + (["yue"] if v3 else []) if multilingual else ["en"]

        base = 50257 if multilingual else 50256  # GPT-2-style base vocab incl. EOT text id
        self.eot = base  # "<|endoftext|>"
        self.sot = base + 1  # "<|startoftranscript|>"
        n_lang = len(self.languages) if multilingual else 99
        self.language_base = self.sot + 1
        self.translate = self.language_base + n_lang
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1  # "<|0.00|>"
        self.num_timestamps = num_frames
        self.n_vocab = self.timestamp_begin + num_frames

    def language_token(self, lang: str) -> int:
        return self.language_base + self.languages.index(lang)

    def timestamp_token(self, seconds: float) -> int:
        # Timestamps tick every 0.02 s (2 mel frames at 10 ms hop).
        return self.timestamp_begin + int(round(seconds / 0.02))

    def timestamp_seconds(self, token_id: int) -> float:
        return (token_id - self.timestamp_begin) * 0.02

    def is_timestamp(self, token_id) -> bool:
        return token_id >= self.timestamp_begin

    def sot_sequence(self, language: str = "en", task: str = "transcribe",
                     timestamps: bool = True) -> List[int]:
        seq = [self.sot]
        if self.multilingual:
            seq.append(self.language_token(language))
            seq.append(self.transcribe if task == "transcribe" else self.translate)
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    @property
    def non_speech_tokens(self) -> List[int]:
        """EVERY special id in (EOT, timestamp_begin) — sot, language,
        task, sot_prev/lm, no_speech, no_timestamps. Used as the decode
        suppress-list: none of these may ever be GENERATED (the prompt
        supplies them). NB: unrelated to OpenAI's ``non_speech_tokens``
        (a curated punctuation/music-symbol list)."""
        return [t for t in range(self.eot + 1, self.timestamp_begin)]

    def encode_text(self, text: str) -> List[int]:
        """Tokenize plain text (no specials). Needs a text backend; used
        for ``initial_prompt`` conditioning (<|startofprev|> context)."""
        if self.text_backend is None:
            raise RuntimeError(
                "No BPE vocab available to encode text. "
                "Pass text_backend= (a tiktoken Encoding or HF tokenizer)."
            )
        if hasattr(self.text_backend, "encode"):
            try:  # HF tokenizers add specials unless told not to
                return list(self.text_backend.encode(text,
                                                     add_special_tokens=False))
            except TypeError:  # tiktoken Encoding
                return list(self.text_backend.encode(text))
        raise RuntimeError("text backend has no encode()")

    def decode_text(self, ids: Sequence[int]) -> str:
        """Render ids to text. Needs a text backend (HF/tiktoken tokenizer)
        for the BPE part; specials are rendered from the table."""
        if self.text_backend is None:
            raise RuntimeError(
                "No BPE vocab available to render Whisper token ids as text. "
                "Pass text_backend= (a tiktoken Encoding or HF tokenizer)."
            )
        out = []
        chunk: List[int] = []

        def flush():
            if chunk:
                out.append(self.text_backend.decode(chunk))
                chunk.clear()

        for i in ids:
            i = int(i)
            if i >= self.eot:
                flush()
                if self.is_timestamp(i):
                    out.append(f"<|{self.timestamp_seconds(i):.2f}|>")
                # other specials are dropped from rendered text
            else:
                chunk.append(i)
        flush()
        return "".join(out)
