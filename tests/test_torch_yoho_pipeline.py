"""The YOHO family end to end in the port, against the JAX package.

On the trained fixture ``tests/fixtures/sessions/tiny`` (head dim 16):
``load_transcriber(session="tiny", device="cpu")`` reproduces
``golden.json`` with the tokens of the JAX package's
``build_yoho_transcriber`` (bf16, as both build it); in f32 the word
timestamps, forced alignment and voiceprints agree with JAX's (times and
voiceprints within 1e-4; the same cluster labels and enrolled names); the
weight-only int8 decoder's codes are bit-exact with JAX's quantizer; the
slot engine gives the library's tokens; the YOHO frontend matches JAX's
at atol 1e-4; the command lines transcribe, enroll and name speakers; the
whisper-family voiceprint encoder embeds clips and diarizes as JAX's does.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yoho_tpu.native
from yoho_tpu.cli.transcribe import build_yoho_transcriber as jax_build
from yoho_tpu.core.config import load_session_config as jax_session
from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
from yoho_tpu.nn.yoho import YOHOModel as JaxYOHO
from yoho_tpu_torch.cli.transcribe import load_yoho_session
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.load import load_transcriber
from yoho_tpu_torch.train.checkpoint import load_params

ROOT = Path(__file__).parent / "fixtures" / "sessions"
GOLDEN = json.loads((ROOT / "tiny" / "golden.json").read_text())


def _tone_clip(s: int, n_samples: int) -> np.ndarray:
    """tests/test_checkpoint_fixture.py's clips."""
    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * (440, 880, 1320)[s] * np.arange(4000) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


def _tokens(results):
    return [[[int(t) for t in s.tokens] for s in r.segments] for r in results]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bf16():
    """The fixture as both command lines build it (bf16), batch 3."""
    jt = jax_build("tiny", str(ROOT), beams=0, batch=3)
    tt = load_transcriber(session="tiny", root=str(ROOT), batch=3, device="cpu")
    clips = [_tone_clip(s, tt.model.cfg.n_samples) for s in range(3)]
    return jt, tt, clips, tt.transcribe_many(clips), jt.transcribe_many(clips)


@pytest.fixture(scope="module")
def f32():
    """The fixture in float32 in both packages, one transcriber pair per
    keyword set."""
    cfg = jax_session("tiny", str(ROOT))
    params = load_params(cfg.weights.asr)
    tok, model = load_yoho_session("tiny", str(ROOT), torch.device("cpu"),
                                   dtype=torch.float32)
    jtok = jax_build("tiny", str(ROOT), beams=0, batch=1).tokenizer
    jm = JaxYOHO(cfg.yoho, jtok.vocab_size, voiceprint_dim=256, dtype=jnp.float32)

    def pair(**kw):
        kw = dict(batch_size=3, **kw)
        return (JaxTranscriber(jm, {"params": params}, family="yoho", tokenizer=jtok, **kw),
                Transcriber(model, family="yoho", tokenizer=tok, device="cpu", **kw))

    return pair, [_tone_clip(s, model.cfg.n_samples) for s in range(3)]


@pytest.fixture
def python_dtw(monkeypatch):
    """The JAX package's C++ DTW accumulates in float32; the port's numpy
    wavefront follows the Python DP's float64, as JAX's fallback does."""
    monkeypatch.setattr(yoho_tpu.native, "dtw_path_native", lambda cost: None)


def test_fixture_golden_and_jax_tokens(bf16):
    jt, tt, clips, got, want = bf16
    assert tt.model.dtype == torch.bfloat16 and tt.device == torch.device("cpu")
    for r, g in zip(got, GOLDEN):
        assert r.text == g["text"]
        assert [{"start": round(s.start, 4), "end": round(s.end, 4), "text": s.text}
                for s in r.segments] == g["segments"]
    assert _tokens(got) == _tokens(want)
    assert [[s.speaker for s in r.segments] for r in got] == \
        [[s.speaker for s in r.segments] for r in want]
    assert [tt.transcribe(clips[0]).text] == [GOLDEN[0]["text"]]
    # The quantization flags are ignored for the YOHO family, as in the JAX
    # package (tests/test_checkpoint_fixture.py's int8-KV case).
    q = Transcriber(tt.model, family="yoho", tokenizer=tt.tokenizer, batch_size=3,
                    quantized_cross_kv=True, quantized_cache=True,
                    cache_dtype=torch.bfloat16, device="cpu")
    assert (q.quantized_cross_kv, q.quantized_cache) == (False, False)
    assert _tokens(q.transcribe_many(clips)) == _tokens(got)


def test_word_timestamps_and_alignment_match_jax(f32, python_dtw):
    pair, clips = f32
    jt, tt = pair(word_timestamps=True)
    got, want = tt.transcribe_many(clips), jt.transcribe_many(clips)
    assert _tokens(got) == _tokens(want)
    gw = [(w.word, w.start, w.end, w.probability) for r in got for s in r.segments
          for w in s.words or []]
    ww = [(w.word, w.start, w.end, w.probability) for r in want for s in r.segments
          for w in s.words or []]
    assert len(gw) >= 6 and [w[0] for w in gw] == [w[0] for w in ww]
    np.testing.assert_allclose([w[1:] for w in gw], [w[1:] for w in ww], atol=1e-4)
    pairs = list(zip(clips, ("hello world", "good morning", "thank you")))
    got = [tt.align(*pairs[0])] + tt.align_many(pairs)
    want = [jt.align(*pairs[0])] + jt.align_many(pairs)
    assert [[w.word for w in r] for r in got] == [[w.word for w in r] for r in want]
    np.testing.assert_allclose([[w.start, w.end, w.probability] for r in got for w in r],
                               [[w.start, w.end, w.probability] for r in want for w in r],
                               atol=1e-4)


def test_voiceprints_clusters_and_names_match_jax(f32):
    pair, clips = f32
    jt0, _ = pair()
    enrolled = {n: r.segments[0].voiceprint
                for n, r in zip(("alice", "bob"), jt0.transcribe_many(clips[:2]))}
    jt, tt = pair(enrolled_speakers=enrolled)
    got, want = tt.transcribe_many(clips), jt.transcribe_many(clips)
    gs = [s for r in got for s in r.segments]
    ws = [s for r in want for s in r.segments]
    assert [s.voiceprint is None for s in gs] == [s.voiceprint is None for s in ws]
    vps = [(g.voiceprint, w.voiceprint) for g, w in zip(gs, ws) if g.voiceprint is not None]
    assert vps and all(g.shape == (256,) for g, _ in vps)
    np.testing.assert_allclose([g for g, _ in vps], [w for _, w in vps], atol=1e-4)
    assert [s.speaker for s in gs] == [s.speaker for s in ws]
    assert [s.speaker_name for s in gs] == [s.speaker_name for s in ws]
    assert {"alice", "bob"} <= {s.speaker_name for s in gs}


def test_quantize_yoho_decoder_is_bit_exact_with_jax(bf16):
    """Codes and scales of the weight-only int8 decoder equal the JAX
    quantizer's on the same float32 weights. The int8 lane is near-lossless,
    not bit-exact: its transcripts keep each clip's sentence (the semantic
    floor of ``tests/test_checkpoint_fixture.py``)."""
    from yoho_tpu.nn.quantize import quantize_yoho_decoder as jax_quantize
    from yoho_tpu_torch.nn.params import to_jax_params
    from yoho_tpu_torch.nn.quantize import quantize_yoho_decoder

    cfg = jax_session("tiny", str(ROOT))
    want = jax.device_get(jax_quantize(load_params(cfg.weights.asr)))
    _, model = load_yoho_session("tiny", str(ROOT), torch.device("cpu"), dtype=torch.float32)
    got = to_jax_params(quantize_yoho_decoder(model))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        assert flat_g[k].dtype == np.asarray(w).dtype and np.array_equal(flat_g[k], w), k
    _, _, clips, _, _ = bf16
    t8 = load_transcriber(session="tiny", root=str(ROOT), batch=3, int8_weights=True,
                          device="cpu")
    assert t8.model.weights_int8
    for r, sent in zip(t8.transcribe_many(clips), ("hello world", "good morning",
                                                    "thank you")):
        assert sent in r.text


def test_slot_engine_gives_the_library_tokens(bf16):
    """Continuous batching of the YOHO family (float cross K/V and cache,
    no timestamp rules, voiceprints in the assemble step)."""
    from yoho_tpu_torch.infer.continuous import ContinuousBatcher

    _, tt, clips, got, _ = bf16
    batcher = ContinuousBatcher(tt, chunk_tokens=4)
    try:
        served = [batcher.submit(c) for c in clips]
    finally:
        batcher.close()
    assert _tokens(served) == _tokens(got)
    assert [[s.speaker for s in r.segments] for r in served] == \
        [[s.speaker for s in r.segments] for r in got]
    np.testing.assert_array_equal(served[0].segments[0].voiceprint,
                                  got[0].segments[0].voiceprint)


def test_yoho_log_mel_matches_jax():
    from yoho_tpu.audio.frontend import yoho_log_mel as jax_mel
    from yoho_tpu.core.config import YOHOConfig as JaxCfg
    from yoho_tpu_torch.core.config import YOHOConfig
    from yoho_tpu_torch.ops.mel_kernel import fused_yoho_log_mel

    audio = (np.random.default_rng(0).standard_normal((2, 164080)) * 0.1).astype(np.float32)
    audio[1, 50000:] = 0.0
    got = fused_yoho_log_mel(torch.from_numpy(audio), YOHOConfig())
    want = np.asarray(jax_mel(jnp.asarray(audio), JaxCfg()))
    assert got.shape == (2, 1024, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_cli_transcribe_enroll_and_speakers(bf16, tmp_path, capsys):
    """``transcribe --session`` prints the library's transcripts; ``enroll``
    writes one unit voiceprint per name; ``transcribe --speakers`` names
    segments as the JAX transcriber does with the same enrollment file."""
    import wave

    from yoho_tpu_torch.cli.__main__ import main

    jt, tt, clips, got, _ = bf16
    wavs = []
    for s, clip in enumerate(clips):
        path = tmp_path / f"tone{s}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.clip(clip * 32768, -32768, 32767).astype("<i2").tobytes())
        wavs.append(str(path))
    base = ["--session", "tiny", "--root", str(ROOT), "--device", "cpu"]
    assert main(["transcribe", *wavs, *base, "--batch", "3", "--json"]) == 0
    docs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [d["text"] for d in docs] == [g["text"] for g in GOLDEN]
    npz = tmp_path / "speakers.npz"
    assert main(["enroll", *base, "--out", str(npz), f"alice={wavs[0]}",
                 f"bob={wavs[1]}"]) == 0
    from yoho_tpu_torch.infer.diarize import load_enrolled

    enrolled = load_enrolled(npz)
    assert sorted(enrolled) == ["alice", "bob"]
    assert all(abs(np.linalg.norm(e) - 1) < 1e-5 and e.shape == (256,)
               for e in enrolled.values())
    capsys.readouterr()
    assert main(["transcribe", *wavs, *base, "--batch", "3", "--json", "--speakers",
                 str(npz)]) == 0
    named = [[s["speaker_name"] for s in json.loads(x)["segments"]]
             for x in capsys.readouterr().out.splitlines()]
    jt.enrolled_speakers = enrolled
    try:
        want = [[s.speaker_name for s in r.segments] for r in jt.transcribe_many(clips)]
    finally:
        jt.enrolled_speakers = {}
    assert named == want and any(n for row in named for n in row)
    assert main(["enroll", "--list", str(npz)]) == 0
    assert "alice  dim=256" in capsys.readouterr().out


def test_capacity_terms_and_auto_batch(bf16):
    """The YOHO terms of the capacity model equal the buffers the port
    allocates (float cross K/V over the encoder positions, bf16 caches of
    the GQA KV width); ``batch="auto"`` resolves for a session."""
    from yoho_tpu_torch.infer import capacity

    _, tt, clips, _, _ = bf16
    cfg = tt.model.cfg
    terms = capacity.stream_terms(cfg, "yoho", cross_kv=None, cache_quantized=False,
                                  cache_itemsize=2, act_itemsize=2)
    with torch.no_grad():
        mel = tt._features(np.stack(clips[:1]))
        xa = tt.model.encode_audio(mel)
        ckv = tt.model.cross_kvs(xa)
        caches = tt.model.init_caches(1, torch.bfloat16)
    assert terms["cross_kv"] == sum(t.numel() * t.element_size() for kv in ckv for t in kv)
    assert terms["self_cache"] == sum(c.k.numel() * 2 * c.k.element_size() for c in caches)
    assert terms["mel"] == mel.numel() * 4 and terms["encoder_out"] == xa.numel() * 2
    assert capacity.yoho_param_count(cfg, tt.model.vocab_size, 256) == sum(
        p.numel() for p in tt.model.parameters())
    auto = load_transcriber(session="tiny", root=str(ROOT), batch="auto", device="cpu")
    assert isinstance(auto.batch_size, int) and auto.batch_size >= 1
    with pytest.raises(ValueError, match="YOHO family decodes with float"):
        tt.model.cross_kvs(xa, "int8")


def test_voiceprint_encoder_embeds_and_diarizes_as_jax(tmp_path):
    """Whisper-family diarization's encoder (``--diarize-session``): a
    session's ``voiceprint.ckpt`` loads, and ``embed_clip`` and
    ``diarize_segments`` give JAX's embeddings (1e-4) and labels."""
    import shutil

    from yoho_tpu.infer import diarize as jd
    from yoho_tpu.nn.voiceprint import VoiceprintEncoder as JaxEncoder
    from yoho_tpu.train.checkpoint import save_params
    from yoho_tpu_torch.cli.transcribe import load_voiceprint_encoder
    from yoho_tpu_torch.infer import diarize as td
    from yoho_tpu_torch.infer.longform import Segment

    shutil.copytree(ROOT / "tiny", tmp_path / "tiny")
    cfg = jax_session("tiny", str(tmp_path))
    enc = JaxEncoder(cfg.yoho, embedding_dim=256)
    mel = jnp.zeros((1, cfg.yoho.max_audio_len, cfg.yoho.n_mel_bands))
    variables = enc.init(jax.random.PRNGKey(3), mel, jnp.ones((1, cfg.yoho.max_audio_len)))
    save_params(cfg.weights.voiceprint, variables["params"])
    tenc = load_voiceprint_encoder("tiny", str(tmp_path), "cpu")
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal(40000) * 0.1).astype(np.float32)
    np.testing.assert_allclose(td.embed_clip(audio, tenc, batch_size=2),
                               jd.embed_clip(audio, enc, variables, batch_size=2), atol=1e-4)
    segs = [Segment(0.0, 0.5, "a", []), Segment(0.5, 1.2, "b", []), Segment(1.2, 2.4, "c", [])]
    jsegs = [Segment(s.start, s.end, s.text, []) for s in segs]
    td.diarize_segments(segs, audio, 16000, tenc, batch_size=2, threshold=0.9)
    jd.diarize_segments(jsegs, audio, 16000, enc, variables, batch_size=2, threshold=0.9)
    np.testing.assert_allclose([s.voiceprint for s in segs], [s.voiceprint for s in jsegs],
                               atol=1e-4)
    assert [s.speaker for s in segs] == [s.speaker for s in jsegs]


def test_streaming_tracks_speakers(bf16):
    """``StreamingTranscriber(track_speakers=True)`` over the fixture: the
    finalized segments carry stable stream-wide speaker ids."""
    from yoho_tpu_torch.infer.streaming import StreamingTranscriber

    _, tt, clips, got, _ = bf16
    stream = StreamingTranscriber(tt, track_speakers=True)
    out = stream.push(clips[0]) + stream.flush()
    assert stream.text() == GOLDEN[0]["text"]
    with_vp = [s for s in out if s.voiceprint is not None]
    assert with_vp and all(isinstance(s.speaker, int) for s in with_vp)


# ------------------------------------------------------- scoring commands

def _wavs(clips, d: Path) -> list:
    import wave

    paths = []
    for s, clip in enumerate(clips):
        path = d / f"clip{s}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(clip, -1, 1) * 32767).astype("<i2").tobytes())
        paths.append(str(path))
    return paths


def _stdout(main, argv) -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_transcribe_rttm_matches_jax(bf16, tmp_path):
    """``transcribe --session tiny --rttm DIR``: one RTTM per input with the
    text JAX's command writes (its ``_write_sidecars`` over the JAX
    transcriber's results on the same WAV files), and the bulk mode's
    rebuild from saved JSON."""
    from argparse import Namespace

    from yoho_tpu.cli.transcribe import _write_sidecars
    from yoho_tpu_torch.cli.__main__ import main as port

    jt, _, clips, _, _ = bf16
    wavs = _wavs(clips, tmp_path)
    for f, r in zip(wavs, jt.transcribe_many(wavs)):
        _write_sidecars(f, r, Namespace(srt=None, vtt=None, rttm=str(tmp_path / "jax")))
    # --output-dir: a re-run skips the decoded files and rebuilds their
    # RTTM from the saved JSON, as it was.
    base = ["--session", "tiny", "--root", str(ROOT), "--batch", "3", "--device", "cpu",
            "--output-dir", str(tmp_path / "bulk")]
    _stdout(port, ["transcribe", *wavs, *base, "--rttm", str(tmp_path / "port")])
    _stdout(port, ["transcribe", *wavs, *base, "--rttm", str(tmp_path / "rebuilt")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["clip0.rttm", "clip1.rttm", "clip2.rttm"]
    for name in names:
        got = (tmp_path / "port" / name).read_text()
        assert got == (tmp_path / "jax" / name).read_text() and got.startswith("SPEAKER")
        assert (tmp_path / "rebuilt" / name).read_text() == got


def test_evaluate_stm_matches_jax(bf16, tmp_path, capsys):
    """``evaluate --stm``: cpWER by diarized speaker and DER against an STM
    reference; the port command's report equals JAX's ``_evaluate_stm`` on
    the JAX transcriber."""
    from argparse import Namespace

    from yoho_tpu.cli.evaluate import _evaluate_stm
    from yoho_tpu.eval.wer import normalize_for_wer
    from yoho_tpu_torch.cli.__main__ import main as port

    jt, _, clips, _, _ = bf16
    _wavs(clips[:2], tmp_path)
    stm = tmp_path / "ref.stm"
    stm.write_text("clip0 1 alice 0.0 1.0 hello world\n"
                   "clip1 1 bob 0.0 2.0 good morning\n", encoding="utf-8")
    args = Namespace(stm=str(stm), dataset=str(tmp_path), limit=None, json=True)
    assert _evaluate_stm(jt, args, normalize_for_wer) == 0
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = json.loads(_stdout(port, ["evaluate", str(tmp_path), "--session", "tiny", "--root",
                                    str(ROOT), "--stm", str(stm), "--batch", "3", "--json",
                                    "--device", "cpu"]).splitlines()[-1])
    assert got == want and got["files"] == 2 and got["ref_speakers"] == 2
    with pytest.raises(SystemExit):
        port(["evaluate", str(tmp_path), "--hf", "x", "--stm", str(stm), "--device", "cpu"])


def test_speaker_pass_makes_no_logits(f32, monkeypatch):
    """The YOHO speaker pass reads voiceprints from a teacher-forced
    decoder pass and makes no vocabulary logits there (eager code would
    make all of them, batch x positions x vocab in f32: 7 GB at the 512
    windows ``batch="auto"`` gives the default session on an H100); its
    voiceprints are bit for bit those of ``forward_with_voiceprints``."""
    from yoho_tpu_torch.nn.yoho import YOHOTextDecoder

    pair, clips = f32
    _, tt = pair()
    model = tt.model
    monkeypatch.setattr(model, "voiceprints",
                        lambda tokens, mel, xa=None: model.forward_with_voiceprints(tokens, mel)[1])
    want = tt.transcribe_many(clips)
    monkeypatch.undo()
    attach = tt._attach_voiceprints

    def attach_without_logits(*a, **k):
        with monkeypatch.context() as m:
            m.setattr(YOHOTextDecoder, "_logits", lambda self, h: pytest.fail("logits made"))
            return attach(*a, **k)

    monkeypatch.setattr(tt, "_attach_voiceprints", attach_without_logits)
    got = tt.transcribe_many(clips)
    vps = [(g.voiceprint, w.voiceprint) for r, q in zip(got, want)
           for g, w in zip(r.segments, q.segments)]
    assert [g is None for g, _ in vps] == [w is None for _, w in vps]
    vps = [(g, w) for g, w in vps if g is not None]
    assert vps
    for g, w in vps:
        np.testing.assert_array_equal(g, w)
