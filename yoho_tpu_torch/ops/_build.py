"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. Builds happen at first use,
never at import, into ``yoho_tpu_torch/_build/`` (listed in
``.gitignore``); a library newer than its sources is reused. Every C entry
point returns ``cudaGetLastError()`` and :meth:`CudaKernel.launch` raises
when it is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -split-compile=0: the optimizer runs on every CPU at once (the decode
# source's 48 instantiations built in 67 s instead of 153 on an 8-core
# H100 host; PERF.md).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ([str(Path(CUDA_HOME) / "bin" / "nvcc")] if CUDA_HOME else []) \
            + [shutil.which("nvcc") or ""]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def _stale(source: str) -> bool:
    out = _lib_path(source)
    if not out.exists():
        return True
    deps = [CSRC / source] + sorted(CSRC.glob("*.cuh"))
    return any(d.stat().st_mtime > out.stat().st_mtime for d in deps)


def build(sources: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the given ``csrc`` sources (default: all) that are stale,
    one ``nvcc`` each, all started together. Returns seconds per source
    built; writes each compiler log (``-Xptxas -v``: registers, shared
    memory, spills) beside its library. Raises on any failure."""
    names = sorted(p.name for p in CSRC.glob("*.cu")) if sources is None \
        else list(sources)
    todo = [s for s in names if _stale(s)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = BUILD_DIR / f"{Path(src).stem}.log"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / src)]
        with open(log, "w") as out:
            procs.append((src, tmp, log, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, text=True)))
    # Each source's own seconds: the processes are polled, not waited for
    # in turn.
    t0 = time.perf_counter()
    seconds: Dict[str, float] = {}
    while len(seconds) < len(procs):
        for src, _, _, proc in procs:
            if src not in seconds and proc.poll() is not None:
                seconds[src] = time.perf_counter() - t0
        time.sleep(0.05)
    failed: List[str] = []
    for src, tmp, log, proc in procs:
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log.read_text()}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(src))  # atomic: readers never see half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source, built first if stale."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_lib_path(source)))
            lib.yoho_error_string.argtypes = [ctypes.c_int]
            lib.yoho_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class CudaKernel:
    """One C entry point of one library, with its launch count.

    ``launches`` counts the calls that launched the kernel and nothing
    else; a measurement resets it to 0 before the run it reads."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            lib = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def launch(self, *args) -> None:
        lib, fn = self._function()
        err = fn(*args)
        if err != 0:
            msg = lib.yoho_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


# Blocks a CUDA grid's y or z axis holds; x holds 2^31 - 1.
GRID_YZ_MAX = 65_535


def row_chunks(rows: int, blocks_per_row: int, limit: int = GRID_YZ_MAX) -> list:
    """``[(start, stop), ...]``: the runs of ``rows`` batch rows, in order,
    that the attention kernels launch one at a time when they put rows x
    ``blocks_per_row`` blocks (batch x heads) on a grid's y or z axis:
    each run as many rows as ``limit`` holds, the last the rest; one run
    when they all fit (the launch is then the whole call's). Raises
    ``ValueError`` when a single row is over the limit."""
    if blocks_per_row < 1 or blocks_per_row > limit:
        raise ValueError(f"{blocks_per_row} blocks a row: a grid axis holds 1 to {limit}")
    step = limit // blocks_per_row
    return [(r, min(r + step, rows)) for r in range(0, rows, step)] or [(0, 0)]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
