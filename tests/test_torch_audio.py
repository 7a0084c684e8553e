"""The port's audio input against the JAX package's: file decoding and
resampling (``audio/io.py``), the FLAC codec (``audio/flac.py``), the
system codec bindings (``audio/codecs.py``), the native decoders
(``native/``), the energy VAD (``audio/vad.py``), and the ``Transcriber``
with file paths, ``vad_filter``, the per-request ``vad`` override and
``hallucination_silence_threshold``.

The same inputs go through both packages (the cases of
``tests/test_audio_io.py``, ``test_codecs.py`` and ``test_vad.py``):
samples, FLAC bytes and speech maps are equal
(``np.testing.assert_array_equal``); transcripts on
``tests/fixtures/whisper_tiny`` in float32 are token-exact, with equal
segment times. Cases that need libmpg123, libvorbisfile or libav skip
when the library is absent, as the JAX tests do.
"""

import json
import os
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yoho_tpu.audio.codecs as jax_codecs
import yoho_tpu.audio.flac as jax_flac
import yoho_tpu.audio.io as jax_io
import yoho_tpu.audio.vad as jax_vad
import yoho_tpu.native as jax_native
import yoho_tpu_torch.audio.codecs as codecs
import yoho_tpu_torch.audio.flac as flac
import yoho_tpu_torch.audio.io as io
import yoho_tpu_torch.audio.vad as vad
import yoho_tpu_torch.native as native
from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.longform import Segment
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

SR = 16000
EQ = np.testing.assert_array_equal
TINY = Path(__file__).parent / "fixtures" / "whisper_tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU: one intra-op thread keeps the eager
    decode loops from oversubscribing it (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_wav(path, data_f32, sr, channels=1):
    pcm = np.clip(data_f32 * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return path


def _both(fn_name, *args, module=("io",)):
    """fn_name of the port's and the JAX package's module on the same args."""
    mods = {"io": (io, jax_io), "flac": (flac, jax_flac), "vad": (vad, jax_vad),
            "codecs": (codecs, jax_codecs), "native": (native, jax_native)}[module[0]]
    return [getattr(m, fn_name)(*args) for m in mods]


# ---------------------------------------------------------------- io


def _noise(n, seed=0, scale=0.3):
    g = np.random.default_rng(seed)
    return np.clip(scale * g.standard_normal(n), -0.99, 0.99).astype(np.float32)


@pytest.mark.parametrize("case", ["mono16k", "stereo44k", "hi32k", "quarter"])
def test_load_audio_matches_jax(tmp_path, case):
    """tests/test_audio_io.py: the int16 contract, resampling, stereo
    mixdown, through ``load_audio`` and ``load_audio_f32`` of both."""
    if case == "mono16k":
        path = _write_wav(tmp_path / "a.wav", _noise(16000), 16000)
    elif case == "stereo44k":
        path = _write_wav(tmp_path / "a.wav", _noise(2 * 44100, 1), 44100, channels=2)
    elif case == "hi32k":
        t = np.arange(32000) / 32000.0
        path = _write_wav(tmp_path / "a.wav", np.sin(2 * np.pi * 440 * t).astype(np.float32),
                          32000)
    else:
        path = _write_wav(tmp_path / "a.wav", np.ones(100, np.float32) * 0.25, 16000)
    for fn in ("load_audio", "load_audio_f32"):
        got, want = _both(fn, path, 16000)
        assert got.dtype == want.dtype
        EQ(got, want)
    got, want = _both("_read_wav", path)
    EQ(got[0], want[0])
    assert got[1] == want[1]


def test_save_audio_wav_and_flac_match_jax(tmp_path):
    wav = _noise(16000)
    for suffix in (".wav", ".flac"):
        (tmp_path / "p").mkdir(exist_ok=True)
        (tmp_path / "j").mkdir(exist_ok=True)
        got = io.save_audio(wav, tmp_path / "p" / f"x{suffix}", 16000)
        want = jax_io.save_audio(wav, tmp_path / "j" / f"x{suffix}", 16000)
        assert got.suffix == want.suffix == suffix
        assert got.read_bytes() == want.read_bytes()
        back = io.load_audio_f32(got, 16000)
        EQ(back, jax_io.load_audio_f32(want, 16000))
        np.testing.assert_allclose(back, wav, atol=2.0 / 32768.0)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_npy_loading_matches_jax(tmp_path, dtype):
    arr = ((np.arange(100) - 50).astype(np.int16) if dtype == "int16"
           else _noise(100))
    np.save(tmp_path / "a.npy", arr)
    got, want = _both("load_audio", tmp_path / "a.npy", 16000)
    EQ(got, want)


@pytest.mark.parametrize("rates", [(16000, 16000), (44100, 16000), (8000, 16000),
                                   (48000, 22050)])
def test_resample_matches_jax(rates):
    x = _noise(4410, 3)
    got, want = _both("resample", x, *rates)
    EQ(got, want)
    if rates[0] == rates[1]:
        assert got is x


def test_native_wav_matches_python_and_jax(tmp_path):
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    path = _write_wav(tmp_path / "n.wav", _noise(12345, 3), 22050)
    (got, sr), (want, jsr) = _both("wav_decode_native", path, module=("native",))
    py, psr = io._read_wav(path)
    assert sr == jsr == psr == 22050
    EQ(got, want)
    np.testing.assert_allclose(got, py, atol=1e-7)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no such audio file"):
        io.load_audio(tmp_path / "nope.wav", 16000)


# ---------------------------------------------------------------- flac


def _sig(n, nch=1, bps=16, seed=0):
    g = np.random.default_rng(seed)
    lim = 1 << (bps - 1)
    t = np.arange(n)[:, None] / 97.0
    x = 0.6 * np.sin(2 * np.pi * t * (1 + np.arange(nch))) + 0.05 * g.standard_normal((n, nch))
    return np.clip(x * (lim - 1), -lim, lim - 1).astype(np.int64)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("bps", [8, 16, 24])
def test_flac_bytes_and_samples_match_jax(nch, bps, use_native):
    """The same stream bytes from both encoders, decoded sample-exact by
    both packages' Python and native decoders."""
    if use_native and native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    x = _sig(10000, nch, bps, seed=bps + nch)
    blob = flac.encode_flac(x, 16000, bps=bps, use_native=use_native)
    assert blob == jax_flac.encode_flac(x, 16000, bps=bps, use_native=use_native)
    for decode in (flac.decode_flac, jax_flac.decode_flac):
        pcm, sr, got_bps = decode(blob)
        assert (sr, got_bps) == (16000, bps)
        EQ(pcm, x)
    if native.get_lib() is not None:
        EQ(native.flac_decode_native(blob)[0], x)


@pytest.mark.parametrize("kind", ["noise", "constant", "one_sample", "32bps"])
def test_flac_edge_streams_match_jax(kind):
    g = np.random.default_rng(7)
    bps = 16
    if kind == "noise":
        x = g.integers(-32768, 32768, size=(5000, 2))
    elif kind == "constant":
        x = np.full((5000, 2), -123)
    elif kind == "one_sample":
        x = np.zeros((1, 1), np.int64)
    else:
        bps = 32
        x = g.integers(-(2**31), 2**31, size=(4096 + 777, 2), dtype=np.int64)
        x[:64] = [[-(2**31), 2**31 - 1]] * 64
    blob = flac.encode_flac(x, 44100, bps=bps)
    assert blob == jax_flac.encode_flac(x, 44100, bps=bps)
    EQ(flac.decode_flac(blob)[0], x)
    if native.get_lib() is not None:
        EQ(native.flac_decode_native(blob)[0], x)


def test_flac_corrupt_rejected_by_both():
    blob = bytearray(flac.encode_flac(_sig(4096), 16000))
    blob[len(blob) // 2] ^= 0xFF  # flip bits inside a frame -> CRC16 fails
    for decode in (flac.decode_flac, jax_flac.decode_flac):
        with pytest.raises(ValueError):
            decode(bytes(blob))
    if native.get_lib() is not None:
        with pytest.raises(ValueError):
            native.flac_decode_native(bytes(blob))


def test_load_audio_flac_matches_jax(tmp_path):
    t = np.arange(32000) / 32000.0
    pcm = np.clip(np.sin(2 * np.pi * 440 * t) * 32000, -32768, 32767).astype(np.int64)[:, None]
    path = tmp_path / "t.flac"
    path.write_bytes(flac.encode_flac(pcm, 32000))
    got, want = _both("load_audio", path, 16000)
    assert got.dtype == np.int16 and abs(len(got) - 16000) <= 2
    EQ(got, want)


# ---------------------------------------------------------------- codecs


def _pygame_data(name):
    pygame = pytest.importorskip("pygame")
    return os.path.join(os.path.dirname(pygame.__file__), "examples", "data", name)


@pytest.mark.parametrize("kind", ["mp3", "ogg"])
def test_codec_bindings_match_jax(kind):
    available = codecs.mp3_available if kind == "mp3" else codecs.ogg_available
    if not available():
        pytest.skip(f"lib{'mpg123' if kind == 'mp3' else 'vorbisfile'} unavailable")
    path = _pygame_data(f"house_lo.{kind}")
    (pcm, sr), (jpcm, jsr) = _both(f"decode_{kind}", path, module=("codecs",))
    assert pcm.dtype == np.int16 and pcm.ndim == 2 and sr == jsr
    EQ(pcm, jpcm)
    got, want = _both("load_audio", path, 16000)
    EQ(got, want)
    assert len(got) > 16000 and np.abs(got.astype(np.int32)).max() > 1000


def test_av_decode_and_m4a_match_jax(tmp_path):
    if native.get_av_lib() is None:
        pytest.skip("system libav unavailable")
    EQ(native.av_decode_native(_pygame_data("house_lo.mp3"), 16000),
       jax_native.av_decode_native(_pygame_data("house_lo.mp3"), 16000))
    bad = tmp_path / "x.m4a"
    bad.write_bytes(b"\x00" * 256)
    with pytest.raises(ValueError):
        native.av_decode_native(bad, 16000)
    t = np.arange(32000) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    p = io.save_audio(sig, tmp_path / "tone.m4a", 16000)
    assert p.suffix == ".m4a" and p.stat().st_size > 1000
    EQ(io.load_audio_f32(p, 16000), jax_io.load_audio_f32(p, 16000))
    # Any other non-wav suffix writes an .mp4 container, as in the JAX package.
    assert io.save_audio(sig, tmp_path / "clip.webm", 16000).suffix == ".mp4"


# ---------------------------------------------------------------- vad


def _tone(seconds, freq=440.0, amp=0.3):
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _silence(seconds):
    return np.zeros(int(seconds * SR), np.float32)


def _near_speech():
    g = np.random.default_rng(0)
    audio = 0.0005 * g.standard_normal(SR * 10).astype(np.float32)
    for t0, dur in ((2.0, 1.0), (3.5, 0.15)):
        s, n = int(t0 * SR), int(dur * SR)
        audio[s:s + n] += (0.3 * g.standard_normal(n)).astype(np.float32)
    return audio


VAD_SIGNALS = {
    "two_bursts": lambda: np.concatenate([_silence(3), _tone(2), _silence(5), _tone(1.5),
                                          _silence(3)]),
    "silent": lambda: _silence(10),
    "noise_floor": lambda: (np.random.default_rng(0).standard_normal(10 * SR) * 1e-4
                            ).astype(np.float32),
    "short_pause": lambda: np.concatenate([_tone(1), _silence(0.4), _tone(1)]),
    "click": lambda: np.concatenate([_silence(2), _tone(0.05), _silence(2)]),
    "all_speech": lambda: _tone(0.335),
    "near_speech": _near_speech,
    "long": lambda: np.concatenate([_silence(10), _tone(2, freq=300), _silence(20),
                                    _tone(3, freq=500), _silence(10)]),
}


@pytest.mark.parametrize("signal", list(VAD_SIGNALS))
def test_vad_spans_and_maps_match_jax(signal):
    """tests/test_vad.py's signals: equal speech spans, frame energies,
    condensed audio and SpeechMaps, and equal times mapped back (both
    boundary conventions)."""
    audio = VAD_SIGNALS[signal]()
    opts = (dict(min_speech_ms=250.0, min_silence_ms=1000.0, speech_pad_ms=100.0)
            if signal == "near_speech" else {})
    port_opts, jax_opts = vad.VadOptions(**opts), jax_vad.VadOptions(**opts)
    assert vad.detect_speech(audio, SR, port_opts) == jax_vad.detect_speech(audio, SR, jax_opts)
    (e, hop), (je, jhop) = (vad.frame_energies_db(audio, SR, port_opts),
                            jax_vad.frame_energies_db(audio, SR, jax_opts))
    EQ(e, je)
    assert hop == jhop
    (cond, smap), (jcond, jmap) = (vad.collapse_silence(audio, SR, port_opts),
                                   jax_vad.collapse_silence(audio, SR, jax_opts))
    EQ(cond, jcond)
    EQ(np.asarray(smap.chunks).reshape(-1, 3), np.asarray(jmap.chunks).reshape(-1, 3))
    assert (smap.sample_rate, smap.original_samples) == (jmap.sample_rate, jmap.original_samples)
    grid = np.linspace(0, len(audio) / SR + 1, 97)
    for end in (False, True):
        EQ([smap.to_original(t, end=end) for t in grid],
           [jmap.to_original(t, end=end) for t in grid])


def test_speech_map_boundaries_match_jax():
    chunks = [(0, 0, 10 * SR), (10 * SR, 100 * SR, 5 * SR)]
    smap = vad.SpeechMap(chunks=chunks, sample_rate=SR, original_samples=110 * SR)
    jmap = jax_vad.SpeechMap(chunks=chunks, sample_rate=SR, original_samples=110 * SR)
    for t in (0.0, 10.0, 12.0, 15.0, 99.0):
        for end in (False, True):
            assert smap.to_original(t, end=end) == jmap.to_original(t, end=end)
    assert smap.to_original(10.0, end=True) == 10.0
    assert smap.speech_seconds == jmap.speech_seconds == 15.0


# ---------------------------------------------------------------- Transcriber


class _WordBackend:
    def __init__(self, word_ids):
        self.word_ids = {k: int(v) for k, v in word_ids.items()}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)

    def convert_ids_to_tokens(self, ids):
        return ["Ġ" + self.id_words.get(int(i), "?") for i in ids]


def _tone_clip(hz: float, n_samples: int) -> np.ndarray:
    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002
             ).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * hz * np.arange(int(0.25 * 16000)) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """whisper_tiny in f32 in both packages, one JAX and one port
    Transcriber with the silence-hallucination filter, and the request
    files: a 16 kHz mono WAV of the three tone clips with 6 s of zeros
    between the second and the third, the same audio as a stereo 44.1 kHz
    WAV and as a 16-bit FLAC, and one clip as .npy."""
    cfg = json.loads((TINY / "config.json").read_text())
    golden = json.loads((TINY / "golden.json").read_text())
    words = json.loads((TINY / "word_vocab.json").read_text())
    jcfg = JaxConfig(**cfg)
    template = jax.eval_shape(
        JaxWhisper(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jcfg.n_frames, jcfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = jax.device_get(load_params(TINY / "params.msgpack", template))
    model = load_jax_params(Whisper(WhisperConfig(**cfg), device="cpu"), params)
    kw = dict(batch_size=2, hallucination_silence_threshold=2.0)
    jt = JaxTranscriber(JaxWhisper(jcfg), {"params": params}, family="whisper",
                        token_table=JaxTable(multilingual=True,
                                             text_backend=_WordBackend(words)), **kw)
    tt = Transcriber(model, token_table=WhisperTokenTable(
        multilingual=True, text_backend=_WordBackend(words)), device="cpu", **kw)
    clips = [_tone_clip(hz, jcfg.n_samples) for hz in golden["tones"]]
    audio = np.concatenate([clips[0], clips[1], _silence(6.0), clips[2]])
    d = tmp_path_factory.mktemp("requests")
    files = {"wav": _write_wav(d / "a.wav", audio, SR),
             "stereo44k": _write_wav(
                 d / "b.wav", np.repeat(io.resample(audio, SR, 44100), 2), 44100, channels=2),
             "flac": d / "c.flac", "npy": d / "d.npy"}
    files["flac"].write_bytes(flac.encode_flac(
        np.clip(audio * 32768.0, -32768, 32767).astype(np.int64)[:, None], SR))
    np.save(files["npy"], clips[0])
    return dict(cfg=jcfg, model=model, params=params, words=words, jt=jt, tt=tt,
                clips=clips, audio=audio, files=files)


def _segs(results):
    return [[(s.start, s.end, s.text, tuple(s.tokens)) for s in r.segments] for r in results]


def test_transcriber_files_with_vad_match_jax(tiny):
    """File requests with the VAD on through the per-request override (one
    request with it off), against the JAX Transcriber: token-exact, equal
    segment times on the source timeline, fewer windows decoded with the
    VAD."""
    jt, tt, files = tiny["jt"], tiny["tt"], tiny["files"]
    paths = [str(files["wav"]), files["stereo44k"], files["flac"], files["npy"],
             files["wav"]]
    vad_on = [True, True, True, None, False]
    got = tt.transcribe_many(paths, vad=vad_on)
    want = jt.transcribe_many(paths, vad=vad_on)
    assert _segs(got) == _segs(want)
    assert [r.text for r in got] == [r.text for r in want]
    assert all(r.text for r in got)
    dur = len(tiny["audio"]) / SR
    for r in got[:3]:  # the requests with the VAD: times on the source timeline
        assert all(0 <= s.start <= s.end <= dur + 1e-3 for s in r.segments)
    # The silence is left out: the condensed requests need fewer windows.
    n = tiny["cfg"].n_samples
    from yoho_tpu_torch.infer.longform import chunk_audio

    plain = len(chunk_audio(tiny["audio"], n, tt.stride_samples)[1])
    condensed, _ = vad.collapse_silence(tiny["audio"], SR)
    assert len(chunk_audio(condensed, n, tt.stride_samples)[1]) < plain
    with pytest.raises(ValueError, match="vad has"):
        tt.transcribe_many(paths[:2], vad=[True])


def test_transcriber_vad_filter_and_sequential_match_jax(tiny):
    """``vad_filter`` on, batched and window by window
    (``condition_on_previous_text``), by file path; all-silent audio
    decodes nothing. Both classes read the two options at call time, so
    they are set on the module's instances (the JAX one keeps its compiled
    programs) and restored after."""
    jt, tt = tiny["jt"], tiny["tt"]
    saved = [(t.vad_filter, t.condition_on_previous_text) for t in (jt, tt)]
    try:
        for sequential in (False, True):
            for t in (jt, tt):
                t.vad_filter, t.condition_on_previous_text = True, sequential
            got = tt.transcribe(tiny["files"]["flac"])
            want = jt.transcribe(tiny["files"]["flac"])
            assert _segs([got]) == _segs([want]) and got.text
        tt._decode_with_fallback = None  # the device must not be touched
        result = tt.transcribe(_silence(5.0))
        assert result.text == "" and result.segments == []
    finally:
        tt.__dict__.pop("_decode_with_fallback", None)
        for t, (v, c) in zip((jt, tt), saved):
            t.vad_filter, t.condition_on_previous_text = v, c


def test_drop_silence_hallucinations_matches_jax(tiny):
    """Segments over a long silence are dropped, segments over speech or
    inside a short pause kept, the same ones in both packages."""
    jt, tt = tiny["jt"], tiny["tt"]
    audio = np.concatenate([_tone(2.0), _silence(5.0), _tone(1.0), _silence(0.5),
                            _tone(1.0)])
    spans = [(0.2, 1.5), (3.0, 5.5), (2.1, 2.4), (7.2, 7.9), (8.05, 8.4), (6.8, 7.3)]

    def segs(cls):
        return [cls(a, b, "x", [1]) for a, b in spans]

    from yoho_tpu.infer.longform import Segment as JaxSegment

    kept = tt._drop_silence_hallucinations(segs(Segment), audio)
    want = jt._drop_silence_hallucinations(segs(JaxSegment), audio)
    assert [(s.start, s.end) for s in kept] == [(s.start, s.end) for s in want]
    assert 0 < len(kept) < len(spans)


def test_detect_language_and_align_by_path_match_jax(tiny):
    """By file path: the single and batched calls of the port against the
    JAX package's batched ones (one compiled program each there)."""
    jt, tt, files = tiny["jt"], tiny["tt"], tiny["files"]
    paths = [files["npy"], files["wav"]]
    want_langs, want_probs = jt.detect_language_many(paths, return_probs=True)
    lang, probs = tt.detect_language(paths[0])
    assert lang == want_langs[0]
    assert probs[lang] == pytest.approx(want_probs[0], abs=1e-3)
    langs, many_probs = tt.detect_language_many(paths, return_probs=True)
    assert langs == want_langs
    np.testing.assert_allclose(many_probs, want_probs, rtol=0, atol=1e-3)
    want = jt.align_many([(paths[0], "hello world")])[0]
    for got in (tt.align(paths[0], "hello world"),
                tt.align_many([(paths[0], "hello world")])[0]):
        assert [w.word for w in got] == [w.word for w in want]
        np.testing.assert_allclose([(w.start, w.end) for w in got],
                                   [(w.start, w.end) for w in want], rtol=0, atol=1e-6)


def test_transcribe_resamples_arrays_like_jax(tiny):
    """An array at 44.1 kHz with ``sample_rate``: resampled on the host."""
    audio = io.resample(np.concatenate(tiny["clips"]), SR, 44100)
    got = tiny["tt"].transcribe(audio, sample_rate=44100)
    want = tiny["jt"].transcribe(audio, sample_rate=44100)
    assert _segs([got]) == _segs([want]) and got.text
