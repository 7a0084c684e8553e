"""Structured logging (the reference has no logging module — SURVEY.md §5).

JSON-lines to stderr (machine-parseable, survives tqdm) with a standard
logging.Logger fallback interface (the port's copy of the JAX package's
``utils/logging.py``). Usage::

    from yoho_tpu_torch.utils.logging import get_logger
    log = get_logger("train")
    log.info("update", step=120, loss=2.31, lr=1e-4)
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any


class StructuredLogger:
    _lock = threading.Lock()

    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream or sys.stderr

    def _emit(self, level: str, event: str, **fields: Any) -> None:
        record = {
            "ts": round(time.time(), 3),
            "level": level,
            "logger": self.name,
            "event": event,
            **fields,
        }
        line = json.dumps(record, ensure_ascii=False, default=str)
        with self._lock:
            print(line, file=self.stream, flush=True)

    def info(self, event: str, **fields: Any) -> None:
        self._emit("info", event, **fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit("warning", event, **fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit("error", event, **fields)


_loggers: dict[str, StructuredLogger] = {}


def get_logger(name: str) -> StructuredLogger:
    if name not in _loggers:
        _loggers[name] = StructuredLogger(name)
    return _loggers[name]
