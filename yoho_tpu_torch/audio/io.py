"""Host-side audio I/O: decode, resample, encode.

A copy of the JAX package's ``audio/io.py`` (the port imports nothing of
``yoho_tpu``); the tests hold the two to equal output.

The reference shells out to ffmpeg for everything
(``yoho/src/preprocessing/audio.py:11-29``). Here no decode path requires
ffmpeg:

  * WAV/PCM and FLAC — this framework's own decoders (C++ fast paths in
    ``yoho_tpu_torch/native/wav.cpp`` / ``flac.cpp``, pure-Python fallbacks);
    FLAC is also the native *encode* target (lossless corpus cache,
    ``yoho_tpu_torch.audio.flac``).
  * mp3 and ogg/vorbis — in-process ctypes bindings to the system codec
    libraries (``yoho_tpu_torch.audio.codecs``), no subprocess per file.
  * anything else (m4a/aac/opus/...) — in-process libav decode
    (``yoho_tpu_torch/native/avdecode.cpp``, linking the system
    libavformat/libavcodec/libswresample); an ffmpeg BINARY is only the
    very last resort when even those libraries are absent.

Contract everywhere: mono int16 PCM at the target rate (callers divide by
32768 for float, exactly like the reference ``whisper.py:249``).
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path
from typing import Union

import numpy as np

_FFMPEG = shutil.which("ffmpeg")


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (host, scipy). No-op when rates match."""
    if orig_sr == target_sr:
        return audio
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    out = resample_poly(audio.astype(np.float32), frac.numerator, frac.denominator)
    return out.astype(np.float32)


def _read_wav(path: Path) -> tuple[np.ndarray, int]:
    """Parse a PCM WAV file -> (mono float32 in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def _compressed_fallback(path: Path, sample_rate: int) -> np.ndarray:
    """Last-resort compressed decode: in-process libav (any codec the
    system stack knows — m4a/aac/opus/...) first, ffmpeg binary second."""
    from yoho_tpu_torch.native import av_decode_native

    decoded = av_decode_native(path, sample_rate)  # None if libav absent
    if decoded is not None:
        return decoded
    return _ffmpeg_decode(path, sample_rate)


def _ffmpeg_decode(path: Path, sample_rate: int) -> np.ndarray:
    if _FFMPEG is None:
        raise RuntimeError(
            f"Cannot decode {path.suffix!r}: neither the system libav "
            "libraries nor an ffmpeg binary are available and the file is "
            "not WAV/NPY/FLAC/mp3/ogg. Install libavformat/ffmpeg or "
            "convert to WAV/FLAC."
        )
    cmd = [
        _FFMPEG, "-nostdin", "-i", str(path),
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le",
        "-ar", str(sample_rate), "pipe:1",
    ]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(raw, np.int16)


def load_audio(path: Union[str, Path], sample_rate: int) -> np.ndarray:
    """Decode any supported audio file -> mono int16 at ``sample_rate``.

    Same contract as the reference ``load_audio`` (``audio.py:11-18``):
    raw int16, NOT scaled to [-1, 1].
    """
    path = Path(path)
    if not path.exists():
        # Surface a path typo as FileNotFoundError, not as a cryptic
        # codec error from whatever fallback tries the file last.
        raise FileNotFoundError(f"no such audio file: {path}")
    suffix = path.suffix.lower()
    if suffix == ".npy":
        arr = np.load(path)
        if arr.dtype != np.int16:
            arr = np.clip(arr * 32768.0, -32768, 32767).astype(np.int16)
        return arr
    if suffix == ".flac":
        from yoho_tpu_torch.audio.flac import decode_flac
        from yoho_tpu_torch.native import flac_decode_native

        raw = path.read_bytes()
        try:
            decoded = flac_decode_native(raw)  # C++ fast path; None if unbuilt
        except ValueError:
            # Let the pure-Python decoder adjudicate: it reads anything
            # valid the fast path might reject, and raises its own error
            # on genuine corruption.
            decoded = None
        if decoded is None:
            decoded = decode_flac(raw)
        pcm, sr, bps = decoded
        data = pcm.astype(np.float32) / float(1 << (bps - 1))
        if data.shape[1] > 1:
            data = data.mean(axis=1)
        else:
            data = data[:, 0]
        data = resample(data, sr, sample_rate)
        return np.clip(data * 32768.0, -32768, 32767).astype(np.int16)
    if suffix in (".mp3", ".ogg", ".oga"):
        from yoho_tpu_torch.audio import codecs

        try:
            decoded = (codecs.decode_mp3(path) if suffix == ".mp3"
                       else codecs.decode_ogg(path))
        except Exception:  # noqa: BLE001 — e.g. Ogg-OPUS (not vorbis),
            # streams the dedicated codec rejects: libav below handles them.
            decoded = None
        if decoded is not None:  # else: lib absent/failed -> libav/ffmpeg
            pcm, sr = decoded
            data = pcm.astype(np.float32) / 32768.0
            data = data.mean(axis=1) if pcm.shape[1] > 1 else data[:, 0]
            data = resample(data, sr, sample_rate)
            return np.clip(data * 32768.0, -32768, 32767).astype(np.int16)
    if suffix in (".wav", ".wave"):
        from yoho_tpu_torch.native import wav_decode_native

        decoded = wav_decode_native(path)  # C++ fast path; None if lib unbuilt
        try:
            if decoded is not None:
                data, sr = decoded
            else:
                data, sr = _read_wav(path)
        except Exception:  # noqa: BLE001 — 24-bit/float/mu-law WAVs etc.
            from yoho_tpu_torch.native import get_av_lib

            if get_av_lib() is None and _FFMPEG is None:
                raise  # no decoder can read it; surface the real error
            return _compressed_fallback(path, sample_rate)
        data = resample(data, sr, sample_rate)
        return np.clip(data * 32768.0, -32768, 32767).astype(np.int16)
    return _compressed_fallback(path, sample_rate)


def load_audio_f32(path: Union[str, Path], sample_rate: int) -> np.ndarray:
    """Float32 [-1, 1] convenience wrapper."""
    return load_audio(path, sample_rate).astype(np.float32) / 32768.0


def save_audio(audio: np.ndarray, path: Union[str, Path], sample_rate: int) -> Path:
    """Write mono audio. WAV and FLAC natively; .mp4/.m4a via in-process
    libav AAC encode (ffmpeg binary only as last resort) — parity with
    the reference ``save_audio`` (``audio.py:21-29``), which always
    shells out to ffmpeg for its mp4 target.

    Accepts int16 or float32 [-1, 1]. Returns the actual path written.
    AAC is lossy and carries codec delay: an m4a save->load round trip
    may differ in length by up to ~1 frame (1024 samples) — the codec's
    priming, not framework padding (the encoder emits a short final
    frame, exactly like the ffmpeg binary path).
    """
    path = Path(path)
    if audio.dtype != np.int16:
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)

    if path.suffix.lower() == ".flac":
        from yoho_tpu_torch.audio.flac import encode_flac

        path.write_bytes(encode_flac(audio.reshape(-1, 1).astype(np.int32), sample_rate))
        return path

    if path.suffix.lower() not in ("", ".wav"):
        # Compressed target (.mp4/.m4a, or any non-wav suffix — reference
        # parity: its save_audio always produces mp4 audio).
        target = (path if path.suffix.lower() in (".mp4", ".m4a")
                  else path.with_suffix(".mp4"))
        from yoho_tpu_torch.native import av_encode_m4a_native

        if av_encode_m4a_native(target, audio, sample_rate):
            return target
        if _FFMPEG is not None:
            cmd = [
                _FFMPEG, "-nostdin", "-y",
                "-f", "s16le", "-ac", "1", "-ar", str(sample_rate),
                "-i", "pipe:0", "-f", "mp4", "-b:a", "16k", str(target),
            ]
            subprocess.run(cmd, input=audio.tobytes(), capture_output=True,
                           check=True)
            return target
        # No AAC encoder anywhere: fall back to WAV below.

    path = path.with_suffix(".wav")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.tobytes())
    return path
