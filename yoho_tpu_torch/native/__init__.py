"""Native (C++) host audio decoders, bound via ctypes.

A copy of the JAX package's ``native/__init__.py`` for the audio half of
its sources (the port imports nothing of ``yoho_tpu``):

  * ``wav.cpp``      — WAV/PCM decode (mono-mix + int -> f32).
  * ``flac.cpp``     — FLAC decode and encode.
  * ``avdecode.cpp`` — any other container/codec through the system libav
                       libraries, built as its own library.

These are host decoders, not device kernels. The libraries are compiled
with ``g++`` at first use into ``yoho_tpu_torch/_build/`` (gitignored),
keyed on a hash of the sources and the host CPU. Where ``g++`` or the
libav headers are missing, the reference's documented behaviour holds:
the pure-Python FLAC and WAV decoders (``audio/flac.py``, ``audio/io.py``)
do the work, and libav reports itself unavailable. Each binding returns
None in that case, and the callers in ``audio/io.py`` pick the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

_SRC_DIR = Path(__file__).parent
BUILD_DIR = _SRC_DIR.parent / "_build"
_MAIN_SOURCES = ("wav.cpp", "flac.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False
_AV_LIB: Optional[ctypes.CDLL] = None
_AV_FAILED = False
_AV_LINK = ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]


def _host_tag() -> str:
    """CPU identity component of the build key: the library is built with
    -march=native, so a checkout shared between machines must not load
    another host's binary (dlopen succeeds and the first call dies with
    SIGILL, past every Python fallback)."""
    import platform

    ident = platform.machine()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("flags") or line.startswith("Features"):
                ident += line
                break
    except OSError:
        pass
    return hashlib.sha256(ident.encode()).hexdigest()[:8]


def _compile_into_place(cmd_prefix: list, srcs: list, out: Path) -> None:
    """g++ to a per-PID temp name, then an atomic rename into place, so a
    concurrent process never dlopens a half-written library."""
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [*cmd_prefix, "-o", str(tmp), *map(str, srcs)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        stderr = getattr(e, "stderr", b"")
        raise RuntimeError(
            f"native build failed: {stderr.decode(errors='replace') if stderr else e}"
        ) from e
    finally:
        tmp.unlink(missing_ok=True)


def _built(prefix: str, srcs: list, cmd_prefix: list, link: tuple = ()) -> Path:
    """The library of ``srcs`` in the build directory, compiled when no
    library of the same sources and host exists; older builds of the same
    prefix are removed."""
    tag = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)).hexdigest()[:16]
    out = BUILD_DIR / f"{prefix}_{tag}_{_host_tag()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for old in BUILD_DIR.glob(f"{prefix}_*.so"):
        if old != out and ".tmp" not in old.name:
            old.unlink(missing_ok=True)
    _compile_into_place(cmd_prefix, [*srcs, *link], out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the WAV/FLAC library; None when it cannot
    be built here."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            path = _built("libyoho_audio", [_SRC_DIR / s for s in _MAIN_SOURCES],
                          ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                           "-march=native"])
            lib = ctypes.CDLL(str(path))
            _configure(lib)
            _LIB = lib
        except (RuntimeError, OSError) as e:
            # The Python decoders keep everything working, 15-100x slower:
            # say so instead of eating the compiler error.
            warnings.warn("yoho_tpu_torch native audio library unavailable — "
                          f"using the pure-Python decoders: {e}", stacklevel=2)
            _LIB_FAILED = True
    return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    lib.yoho_wav_decode.restype = ctypes.c_int64
    lib.yoho_wav_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.yoho_free.restype = None
    lib.yoho_free.argtypes = [ctypes.c_void_p]
    lib.yoho_flac_decode.restype = ctypes.c_int64
    lib.yoho_flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.yoho_flac_encode.restype = ctypes.c_int64
    lib.yoho_flac_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]


def _have_libav() -> bool:
    """The system libav headers and shared libraries (an OS package, not a
    dependency of the port)."""
    import glob

    have_hdr = any(Path(d, "libavformat/avformat.h").exists() for d in
                   ("/usr/include", "/usr/include/x86_64-linux-gnu",
                    "/usr/local/include"))
    have_lib = bool(glob.glob("/lib/*/libavformat.so*")
                    or glob.glob("/usr/lib/*/libavformat.so*")
                    or glob.glob("/usr/lib/libavformat.so*"))
    return have_hdr and have_lib


def get_av_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the libav decode library; None when the
    system libav stack is unavailable."""
    global _AV_LIB, _AV_FAILED
    if _AV_LIB is not None or _AV_FAILED:
        return _AV_LIB
    with _LOCK:
        if _AV_LIB is not None or _AV_FAILED:
            return _AV_LIB
        if not _have_libav():
            _AV_FAILED = True
            return None
        try:
            path = _built("libyoho_av", [_SRC_DIR / "avdecode.cpp"],
                          ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"],
                          tuple(_AV_LINK))
            lib = ctypes.CDLL(str(path))
            lib.yoho_av_decode.restype = ctypes.c_int64
            lib.yoho_av_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ]
            lib.yoho_av_free.restype = None
            lib.yoho_av_free.argtypes = [ctypes.c_void_p]
            lib.yoho_av_encode_m4a.restype = ctypes.c_int32
            lib.yoho_av_encode_m4a.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ]
            _AV_LIB = lib
        except (RuntimeError, OSError):
            _AV_FAILED = True
    return _AV_LIB


def av_decode_native(path, sample_rate: int) -> Optional[np.ndarray]:
    """Universal decode (any container/codec the system libav knows) ->
    mono int16 at ``sample_rate``; None when the libav stack is
    unavailable. Raises ValueError on decode failure."""
    lib = get_av_lib()
    if lib is None:
        return None
    ptr = ctypes.POINTER(ctypes.c_int16)()
    n = lib.yoho_av_decode(str(path).encode(), sample_rate, ctypes.byref(ptr))
    if n < 0:
        raise ValueError(f"libav could not decode {path} (code {n})")
    try:
        if n == 0:
            return np.zeros(0, np.int16)
        return np.ctypeslib.as_array(ptr, shape=(int(n),)).copy()
    finally:
        if ptr:
            lib.yoho_av_free(ptr)


def av_encode_m4a_native(path, pcm: np.ndarray, sample_rate: int,
                         bit_rate: int = 16000) -> bool:
    """Encode mono int16 PCM -> AAC/.m4a in-process. False when the libav
    stack is unavailable; raises ValueError on encode failure."""
    lib = get_av_lib()
    if lib is None:
        return False
    pcm = np.ascontiguousarray(pcm, np.int16)
    rc = lib.yoho_av_encode_m4a(
        str(path).encode(), pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(pcm), sample_rate, bit_rate)
    if rc != 0:
        raise ValueError(f"libav could not encode {path} (code {rc})")
    return True


def wav_decode_native(path) -> Optional[tuple[np.ndarray, int]]:
    """C++ WAV decode -> (mono float32 [-1,1], sample_rate); None if the
    native lib is unavailable or the file isn't plain PCM."""
    lib = get_lib()
    if lib is None:
        return None
    data_ptr = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int32(0)
    n = lib.yoho_wav_decode(str(path).encode(), ctypes.byref(data_ptr), ctypes.byref(sr))
    if n < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(data_ptr, shape=(n,)).copy()
    finally:
        lib.yoho_free(data_ptr)
    return arr, int(sr.value)


def flac_decode_native(data: bytes):
    """C++ FLAC decode -> ((n, channels) int32, sample_rate, bps); None if
    the native lib is unavailable. Raises ValueError on a corrupt stream
    (parse or CRC failure)."""
    lib = get_lib()
    if lib is None:
        return None
    pcm_ptr = ctypes.POINTER(ctypes.c_int32)()
    sr = ctypes.c_int32(0)
    nch = ctypes.c_int32(0)
    bps = ctypes.c_int32(0)
    n = lib.yoho_flac_decode(data, len(data), ctypes.byref(pcm_ptr),
                             ctypes.byref(sr), ctypes.byref(nch),
                             ctypes.byref(bps))
    if n < 0:
        raise ValueError("corrupt FLAC stream (parse or CRC failure)")
    try:
        total = int(n) * nch.value
        if total == 0:
            arr = np.zeros((0, max(nch.value, 1)), np.int32)
        else:
            arr = np.ctypeslib.as_array(pcm_ptr, shape=(total,)).copy()
            arr = arr.reshape(int(n), nch.value)
    finally:
        lib.yoho_free(pcm_ptr)
    return arr, int(sr.value), int(bps.value)


def flac_encode_native(pcm: np.ndarray, sample_rate: int, bps: int = 16,
                       block_size: int = 4096) -> Optional[bytes]:
    """C++ FLAC encode of (n, channels) int PCM -> stream bytes; None if
    the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pcm = np.ascontiguousarray(pcm, np.int32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, nch = pcm.shape
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    size = lib.yoho_flac_encode(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, nch,
        sample_rate, bps, block_size, ctypes.byref(ptr))
    if size < 0:
        raise ValueError("FLAC encode failed (bad parameters)")
    try:
        return ctypes.string_at(ptr, int(size))
    finally:
        lib.yoho_free(ptr)
