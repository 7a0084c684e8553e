"""Compressed-audio decode via in-process system codec libraries.

A copy of the JAX package's ``audio/codecs.py`` (the port imports nothing of
``yoho_tpu``); the tests hold the two to equal output.

The reference decodes every compressed container by spawning the ffmpeg
binary (``yoho/src/preprocessing/audio.py:11-18``); its training corpora
are mp3 (``train/utils/dataloaders.py:53``). Here mp3 and ogg/vorbis
decode happens in-process through ctypes bindings to the system codec
libraries (libmpg123, libvorbisfile) — no subprocess per file, no ffmpeg
requirement. Both gracefully report unavailability so ``audio.io`` can
fall back (FLAC and WAV are decoded by this framework's own code:
``yoho_tpu_torch/native/flac.cpp``, ``yoho_tpu_torch/native/wav.cpp``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()

# ---------------------------------------------------------------------------
# mp3 via libmpg123
# ---------------------------------------------------------------------------

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0xD0  # MPG123_ENC_16 | MPG123_ENC_SIGNED | 0x10

_mpg123 = None
_mpg123_failed = False


def _load_mpg123():
    global _mpg123, _mpg123_failed
    if _mpg123 is not None or _mpg123_failed:
        return _mpg123
    with _LOCK:
        if _mpg123 is not None or _mpg123_failed:
            return _mpg123
        name = ctypes.util.find_library("mpg123")
        if name is None:
            _mpg123_failed = True
            return None
        try:
            lib = ctypes.CDLL(name)
            lib.mpg123_init()  # no-op in modern mpg123, required by old
            lib.mpg123_new.restype = ctypes.c_void_p
            lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_open.restype = ctypes.c_int
            lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.mpg123_getformat.restype = ctypes.c_int
            lib.mpg123_getformat.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_format_none.restype = ctypes.c_int
            lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
            lib.mpg123_format.restype = ctypes.c_int
            lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                          ctypes.c_int, ctypes.c_int]
            lib.mpg123_read.restype = ctypes.c_int
            lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_size_t)]
            lib.mpg123_close.argtypes = [ctypes.c_void_p]
            lib.mpg123_delete.argtypes = [ctypes.c_void_p]
            _mpg123 = lib
        except (OSError, AttributeError):
            _mpg123_failed = True
            _mpg123 = None
    return _mpg123


def mp3_available() -> bool:
    return _load_mpg123() is not None


def decode_mp3(path) -> Optional[Tuple[np.ndarray, int]]:
    """Decode an mp3 file -> ((n, channels) int16, sample_rate).

    None when libmpg123 is not on the system; ValueError on decode
    failure."""
    lib = _load_mpg123()
    if lib is None:
        return None
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise ValueError(f"mpg123_new failed (err {err.value})")
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise ValueError(f"cannot open mp3 file {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise ValueError(f"cannot probe mp3 format of {path}")
        # Pin the output to s16 at the stream's native rate/channels so a
        # mid-stream format change can't silently switch encodings.
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate, channels, _MPG123_ENC_SIGNED_16)

        chunks = []
        buf = (ctypes.c_char * 65536)()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                continue  # output stays pinned; keep reading
            if rc != _MPG123_OK:
                raise ValueError(f"mp3 decode error {rc} in {path}")
        pcm = np.frombuffer(b"".join(chunks), "<i2")
        nch = max(channels.value, 1)
        pcm = pcm[: (len(pcm) // nch) * nch].reshape(-1, nch)
        return pcm, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# ---------------------------------------------------------------------------
# ogg/vorbis via libvorbisfile
# ---------------------------------------------------------------------------


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


_vorbisfile = None
_vorbisfile_failed = False


def _load_vorbisfile():
    global _vorbisfile, _vorbisfile_failed
    if _vorbisfile is not None or _vorbisfile_failed:
        return _vorbisfile
    with _LOCK:
        if _vorbisfile is not None or _vorbisfile_failed:
            return _vorbisfile
        name = ctypes.util.find_library("vorbisfile")
        if name is None:
            _vorbisfile_failed = True
            return None
        try:
            lib = ctypes.CDLL(name)
            lib.ov_fopen.restype = ctypes.c_int
            lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
            lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ov_read.restype = ctypes.c_long
            lib.ov_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
            lib.ov_clear.restype = ctypes.c_int
            lib.ov_clear.argtypes = [ctypes.c_void_p]
            _vorbisfile = lib
        except (OSError, AttributeError):
            _vorbisfile_failed = True
            _vorbisfile = None
    return _vorbisfile


def ogg_available() -> bool:
    return _load_vorbisfile() is not None


def decode_ogg(path) -> Optional[Tuple[np.ndarray, int]]:
    """Decode an ogg/vorbis file -> ((n, channels) int16, sample_rate).

    None when libvorbisfile is not on the system; ValueError on decode
    failure."""
    lib = _load_vorbisfile()
    if lib is None:
        return None
    # OggVorbis_File is opaque (~1 KB); over-allocate generously.
    vf = ctypes.create_string_buffer(8192)
    rc = lib.ov_fopen(str(path).encode(), vf)
    if rc != 0:
        raise ValueError(f"cannot open ogg file {path} (rc {rc})")
    try:
        info = lib.ov_info(vf, -1)
        if not info:
            raise ValueError(f"cannot probe ogg stream info of {path}")
        nch = info.contents.channels
        rate = int(info.contents.rate)
        chunks = []
        buf = (ctypes.c_char * 65536)()
        bitstream = ctypes.c_int(0)
        while True:
            n = lib.ov_read(vf, buf, len(buf), 0, 2, 1,
                            ctypes.byref(bitstream))
            if n == 0:
                break
            if n == -3:  # OV_HOLE: recoverable page gap — skip, per the
                continue  # vorbisfile docs (web-scraped oggs hit this)
            if n < 0:
                raise ValueError(f"ogg decode error {n} in {path}")
            chunks.append(bytes(buf[:n]))
        pcm = np.frombuffer(b"".join(chunks), "<i2")
        nch = max(nch, 1)
        pcm = pcm[: (len(pcm) // nch) * nch].reshape(-1, nch)
        return pcm, rate
    finally:
        lib.ov_clear(vf)
