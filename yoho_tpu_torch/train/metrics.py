"""Training observability: metrics CSV + validation transcripts JSONL.

Artifact parity with the reference (SURVEY.md §5): CSV schema
``update,learning_rate,loss,val_loss`` at
``sessions/<name>/stages/<stage>/metrics.csv`` and a validations JSONL with
special tokens humanized to emoji (🚀 start, 🏁 end, 🎙️ voiceprint,
⏱️ timestamps) — but written by a single owner thread-safely instead of
fire-and-forget threads.

The port's copy of the JAX package's ``train/metrics.py``, which imports no JAX
(the port imports nothing of ``yoho_tpu``).
"""

from __future__ import annotations

import json
import re
import threading
from pathlib import Path
from typing import Optional, Sequence

CSV_HEADER = "update,learning_rate,loss,val_loss"


class MetricsWriter:
    def __init__(self, csv_path, validations_path=None):
        self.csv_path = Path(csv_path)
        self.validations_path = Path(validations_path) if validations_path else None
        self._lock = threading.Lock()
        self.csv_path.parent.mkdir(parents=True, exist_ok=True)
        if not self.csv_path.exists():
            self.csv_path.write_text(CSV_HEADER + "\n")

    def log(self, update: int, learning_rate: float, loss: float,
            val_loss: Optional[float] = None) -> None:
        row = f"{update},{learning_rate:.8g},{loss:.8g}," + (
            f"{val_loss:.8g}" if val_loss is not None else ""
        )
        with self._lock, open(self.csv_path, "a") as f:
            f.write(row + "\n")

    # ------------------------------------------------------------------
    @staticmethod
    def humanify(text: str) -> str:
        """Emoji substitution for special tokens (parity:
        ``transcription_pretrain_no_voiceprints.py:144-157``)."""
        end = "<|endoftranscript|>"
        # DOTALL: post-EOT junk can contain newlines; '.*' must eat it all.
        text = re.sub(f"{re.escape(end)}.*", end, text, flags=re.S)
        text = text.replace("<|startoftranscript|>", "🚀")
        text = text.replace("<|endoftranscript|>", "🏁")
        text = text.replace("<|voiceprint|>", "🎙️")
        text = re.sub(r"<\|t-\d*\|>", "⏱️", text)
        return text

    def write_validation(
        self,
        val_correct: Sequence[str],
        val_predicted: Sequence[str],
        train_correct: Sequence[str],
        train_predicted: Sequence[str],
    ) -> None:
        assert self.validations_path is not None
        assert len(val_correct) == len(val_predicted)
        assert len(train_correct) == len(train_predicted)
        # Pad the shorter stream: callers without train-sample decoding
        # (whisper finetune/distill pass empty train lists) must still
        # get their VAL transcripts written — a plain 4-way zip silently
        # dropped every row to the shortest (empty) sequence.
        n = max(len(val_correct), len(train_correct))

        def at(seq, i):
            return self.humanify(seq[i]) if i < len(seq) else None

        dump = [
            {
                "val_correct": at(val_correct, i),
                "val_predicted": at(val_predicted, i),
                "train_correct": at(train_correct, i),
                "train_predicted": at(train_predicted, i),
            }
            for i in range(n)
        ]
        with self._lock, open(self.validations_path, "a") as f:
            f.write(json.dumps(dump, ensure_ascii=False) + "\n")
