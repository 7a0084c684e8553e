"""Profiling/tracing utilities (the reference has none — SURVEY.md §5).

The port's counterpart of the JAX package's ``utils/profiling.py``:
``trace`` captures a ``torch.profiler`` trace (host and, on a GPU, CUDA
activity) of a region into a Chrome trace file (``transcribe --profile
DIR``). The JAX module's ``annotate`` and ``Timer`` have no caller in the
port and are not copied.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture the region into ``<log_dir>/trace.json`` (Chrome trace
    format; open in Perfetto or chrome://tracing). No-op when None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
