"""The port's command lines against the JAX package's, on the trained
``whisper_tiny`` fixture exported as an HF directory by the JAX exporter.

The directory gets a GPT-2 ``vocab.json`` + ``merges.txt`` whose ids
1000-1005 are the fixture's words (the 256 byte symbols, then the merges
that spell each word after its space marker), so both packages render and
encode text through their own byte-level BPE. Every port command runs with
``--device cpu``; transcripts, segment and word times, SRT/VTT sidecars,
alignment and the evaluation report equal the JAX command's output.
"""

import contextlib
import io
import json
import threading
import urllib.request
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yoho_tpu
import yoho_tpu.native
from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.nn.export import export_hf_whisper
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.gpt2_bpe import bytes_to_unicode
from yoho_tpu.train.checkpoint import load_params
import yoho_tpu_torch
from yoho_tpu_torch.cli import __main__ as umbrella

FIXTURE = Path(__file__).parent / "fixtures" / "whisper_tiny"
GOLDEN = json.loads((FIXTURE / "golden.json").read_text())
WORDS = json.loads((FIXTURE / "word_vocab.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _python_dtw(monkeypatch):
    # The JAX package's C++ DTW accumulates in float32; the port's numpy
    # wavefront follows its Python DP's float64 (tests/test_torch_align.py).
    monkeypatch.setattr(yoho_tpu.native, "dtw_path_native", lambda cost: None)


def write_word_bpe(d: Path, words: dict) -> None:
    """vocab.json + merges.txt: byte symbols 0-255, left-to-right merges
    spelling each "Ġ" + word, the word's own token at its id."""
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    merges, nxt = [], 256
    for word, wid in words.items():
        piece = "Ġ" + word
        cur = piece[0]
        for ch in piece[1:]:
            merged = cur + ch
            if merged not in vocab:
                merges.append(f"{cur} {ch}")
                vocab[merged] = wid if merged == piece else nxt
                nxt += merged != piece
            cur = merged
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")


def _wav(path: Path, clip: np.ndarray) -> str:
    pcm = np.clip(clip * 32768, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


def _tone_clip(s: int, n_samples: int) -> np.ndarray:
    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * GOLDEN["tones"][s] * np.arange(int(0.25 * 16000)) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = JaxConfig(**json.loads((FIXTURE / "config.json").read_text()))
    template = jax.eval_shape(
        JaxWhisper(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    hf = root / "hf"
    export_hf_whisper(load_params(FIXTURE / "params.msgpack", template), cfg, hf)
    write_word_bpe(hf, WORDS)
    data = root / "data"
    data.mkdir()
    wavs = []
    for i, sentence in enumerate(GOLDEN["sentences"]):
        wavs.append(_wav(data / f"tone{i}.wav", _tone_clip(i, cfg.n_samples)))
        (data / f"tone{i}.txt").write_text(sentence)
    return dict(root=root, hf=str(hf), data=data, wavs=wavs)


def _run(main, argv, rc=0) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == rc
    return buf.getvalue()


def _port(argv, rc=0) -> str:
    return _run(umbrella.main, [*argv, "--device", "cpu"], rc)


def _same_segments(got: dict, want: dict) -> None:
    assert got["text"] == want["text"] and got["language"] == want["language"]
    assert len(got["segments"]) == len(want["segments"])
    for a, b in zip(got["segments"], want["segments"]):
        assert a["text"] == b["text"]
        assert abs(a["start"] - b["start"]) <= 1e-3 and abs(a["end"] - b["end"]) <= 1e-3
        assert (a["words"] is None) == (b["words"] is None)
        for wa, wb in zip(a["words"] or [], b["words"] or []):
            assert wa["word"] == wb["word"]
            assert abs(wa["start"] - wb["start"]) <= 1e-3
            assert abs(wa["end"] - wb["end"]) <= 1e-3


def test_transcribe_json_srt_vtt_output_dir_equal_jax_and_resume(env, tmp_path, capsys):
    from yoho_tpu.cli.transcribe import main as jax_main

    args = [*env["wavs"], "--hf", env["hf"], "--json", "--batch", "2", "--int8-kv",
            "--word-timestamps"]
    want = _run(jax_main, [*args, "--srt", str(tmp_path / "j"), "--vtt", str(tmp_path / "j"),
                           "--output-dir", str(tmp_path / "j")])
    out = ["--srt", str(tmp_path / "p"), "--vtt", str(tmp_path / "p"),
           "--output-dir", str(tmp_path / "p")]
    got = _port(["transcribe", *args, *out])
    want, got = want.splitlines(), got.splitlines()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same_segments(json.loads(a), json.loads(b))
    assert all(json.loads(a)["text"] for a in got)
    for i in range(3):
        _same_segments(json.loads((tmp_path / "p" / f"tone{i}.json").read_text()),
                       json.loads((tmp_path / "j" / f"tone{i}.json").read_text()))
        for ext in ("srt", "vtt"):
            assert ((tmp_path / "p" / f"tone{i}.{ext}").read_text()
                    == (tmp_path / "j" / f"tone{i}.{ext}").read_text())
    capsys.readouterr()
    assert _port(["transcribe", *args, *out]) == ""
    assert "skipping 3 file(s)" in capsys.readouterr().err


def test_align_equals_jax(env):
    from yoho_tpu.cli.align import main as jax_main

    for files, extra in ((env["wavs"], ["--batch", "2"]),
                         (env["wavs"][:1], ["--text", "hello world"])):
        args = [*files, "--hf", env["hf"], *extra]
        want = [json.loads(x) for x in _run(jax_main, args).splitlines()]
        got = [json.loads(x) for x in _port(["align", *args]).splitlines()]
        assert len(got) == len(want) == len(files)
        for a, b in zip(got, want):
            assert [w["word"] for w in a["words"]] == [w["word"] for w in b["words"]]
            assert a["words"], a
            for wa, wb in zip(a["words"], b["words"]):
                assert abs(wa["start"] - wb["start"]) <= 1e-3
                assert abs(wa["end"] - wb["end"]) <= 1e-3


def test_evaluate_equals_jax(env):
    from yoho_tpu.cli.evaluate import main as jax_main

    args = [str(env["data"]), "--hf", env["hf"], "--json", "--batch", "2",
            "--normalizer", "english"]
    want = json.loads(_run(jax_main, args).splitlines()[-1])
    got = json.loads(_port(["evaluate", *args]).splitlines()[-1])
    assert got == want and got["utterances"] == 3


def test_load_transcriber_equals_jax(env):
    t = yoho_tpu_torch.load_transcriber(hf=env["hf"], batch=2, device="cpu")
    j = yoho_tpu.load_transcriber(hf=env["hf"], batch=2)
    got = t.transcribe_many(env["wavs"])
    want = j.transcribe_many(env["wavs"])
    assert [[s.tokens for s in r.segments] for r in got] == \
        [[s.tokens for s in r.segments] for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert t.model.dtype == torch.bfloat16 and t.device == torch.device("cpu")
    auto = yoho_tpu_torch.load_transcriber(hf=env["hf"], batch="auto", device="cpu",
                                           int8_kv=True)
    assert isinstance(auto.batch_size, int) and auto.batch_size >= 1
    # Sessions, diarization and speakers are ported (the YOHO family); a
    # missing session or a whisper model without its diarize encoder fails
    # as in the JAX package; a mesh larger than the one process of a run
    # without a launcher fails as the JAX package's make_mesh does.
    with pytest.raises(FileNotFoundError, match="does not exist"):
        yoho_tpu_torch.load_transcriber(session="main", root=str(env["hf"]), device="cpu")
    with pytest.raises(ValueError, match="diarize_session"):
        yoho_tpu_torch.load_transcriber(hf=env["hf"], speakers={"a": np.ones(4)},
                                        device="cpu")
    with pytest.raises(ValueError, match="does not divide device count 1"):
        yoho_tpu_torch.load_transcriber(hf=env["hf"], mesh="1x4", device="cpu")


def test_int8_lanes_load_the_jax_quantized_weights(env):
    """``--int8-weights --int8-encoder`` quantize the checkpoint's float32
    weights as the JAX package's CLI does: the int8 codes and float32
    scales bit-equal, every float leaf the bf16 of JAX's float32."""
    from yoho_tpu.nn.convert import load_hf_whisper as jax_load
    from yoho_tpu.nn.quantize import quantize_whisper_decoder, quantize_whisper_encoder
    from yoho_tpu_torch.cli.transcribe import load_whisper_model
    from yoho_tpu_torch.nn import params as nn_params

    _, want = jax_load(env["hf"])
    want = jax.device_get(quantize_whisper_encoder(quantize_whisper_decoder(want)))
    _, model = load_whisper_model(env["hf"], torch.device("cpu"), int8_weights=True,
                                  int8_encoder=True)
    assert model.weights_int8 and model.encoder_int8 and model.dtype == torch.bfloat16
    got = nn_params.jax_leaves(model)

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), np.asarray(v)

    want = dict(flat(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].detach()
        if w.dtype == np.int8 or g.dtype == torch.float32:
            assert np.array_equal(g.numpy(), w), k
        else:
            assert torch.equal(g, torch.from_numpy(np.asarray(w, np.float32)).to(g.dtype)), k


def _serve_once(argv, wav: str) -> dict:
    """``serve.main(argv)`` in a thread on port 0: one POST /transcribe of
    ``wav``, then shutdown; the response's JSON."""
    from yoho_tpu_torch.cli import serve as serve_mod

    made, rc, out = [], [], io.StringIO()
    real = serve_mod.serve

    def run():
        with contextlib.redirect_stdout(out):
            rc.append(serve_mod.main(argv))

    serve_mod.serve = lambda *a, **k: made.append(real(*a, **k)) or made[-1]
    try:
        th = threading.Thread(target=run, daemon=True)
        th.start()
        for _ in range(600):
            if "serving on" in out.getvalue():
                break
            th.join(0.1)
    finally:
        serve_mod.serve = real
    assert made, "the server never started"
    port = made[0].server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe",
                                 data=Path(wav).read_bytes(),
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=60) as r:
        doc = json.load(r)
    made[0].shutdown()
    th.join(60)
    assert not th.is_alive() and rc == [0]
    return doc


def test_serve_mesh_1x1_on_the_cpu(env):
    """``serve --mesh 1x1`` runs in this one process (a group of one, no
    launcher; its batcher leads a schedule of one rank) and answers
    /transcribe with the response of the run without ``--mesh``: every
    flag of the port's command lines is ported."""
    argv = ["--hf", env["hf"], "--port", "0", "--batch", "2", "--device", "cpu"]
    want = _serve_once(argv, env["wavs"][0])
    got = _serve_once([*argv, "--mesh", "1x1"], env["wavs"][0])
    assert got == want and got["text"] == GOLDEN["texts"]["bf16"][0]


def test_transcribe_mesh_1x1_on_the_cpu(env):
    """``transcribe --mesh 1x1`` runs in this one process (a group of one,
    no launcher) and prints the unsharded command's JSON."""
    argv = [*env["wavs"], "--hf", env["hf"], "--json", "--device", "cpu"]
    want = [json.loads(x) for x in _run(umbrella.main, ["transcribe", *argv]).splitlines()]
    got = [json.loads(x) for x in _run(umbrella.main, ["transcribe", *argv, "--mesh", "1x1"])
           .splitlines()]
    assert got == want and len(got) == len(env["wavs"])


def test_no_silent_cpu_run(env, monkeypatch):
    """Without CUDA and without --device cpu the command fails with the
    device error; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["transcribe", env["wavs"][0]], ["align", env["wavs"][0], "--text", "hello"],
                ["evaluate", str(env["data"])], ["serve"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            umbrella.main([*cmd, "--hf", env["hf"]])


def test_doctor_passes_and_flags_missing_weights(env, tmp_path):
    from yoho_tpu_torch.cli import doctor

    rows = [json.loads(x) for x in _run(doctor.main, ["--json", "--hf", env["hf"]]).splitlines()]
    status = {r["check"]: r["status"] for r in rows}
    assert status["hf:weights"] == status["hf:config"] == status["hf:tokenizer"] == "ok"
    assert "devices" in status and "kernels" in status
    assert "FAIL" not in status.values()
    (tmp_path / "config.json").write_text("{}")
    rows = [json.loads(x) for x in _run(doctor.main, ["--json", "--no-devices", "--hf",
                                                       str(tmp_path)], rc=1).splitlines()]
    status = {r["check"]: r["status"] for r in rows}
    assert status["hf:weights"] == "FAIL" and status["hf:tokenizer"] == "warn"
    # --session checks a training session (tests/test_torch_diarization.py
    # holds it to the JAX command); a missing one fails.
    rows = [json.loads(x) for x in _run(doctor.main, [
        "--json", "--no-devices", "--session", "main", "--root", str(tmp_path)],
        rc=1).splitlines()]
    assert {r["check"]: r["status"] for r in rows}["session"] == "FAIL"


CORPUS_TOOLS = ("cache-corpus", "import-corpus", "split-tracks", "plot-metrics")


def test_umbrella_lists_the_commands(capsys):
    from yoho_tpu.cli.__main__ import COMMANDS as JAX_COMMANDS

    assert umbrella.main([]) == 0
    usage = capsys.readouterr().out
    assert set(umbrella.COMMANDS) == set(JAX_COMMANDS)
    for name in JAX_COMMANDS:
        assert f"  {name} " in usage
    assert umbrella.main(["nope"]) == 2


@pytest.mark.parametrize("name", sorted(CORPUS_TOOLS))
def test_umbrella_names_the_item_of_an_unported_command(name, capsys):
    """No command is unported any more: the corpus tools, the last ones
    that named their ROADMAP item, reach their own parsers
    (``tests/test_torch_corpus_tools.py`` runs them against JAX's)."""
    with pytest.raises(SystemExit) as e:
        umbrella.main([name, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith(f"usage: yoho-torch {name}") and "Queue 1 item" not in out


@pytest.fixture(scope="module")
def corpus(env):
    """Two tracks of the fixture's tone clips with their words as SRT."""
    from yoho_tpu_torch.text.srt import Subtitle, compose_srt
    import datetime as dt

    root = env["root"] / "corpus"
    (root / "transcripts").mkdir(parents=True)
    (root / "audio").mkdir()
    for i in range(2):
        n = int(1.28 * 16000)
        _wav(root / "audio" / f"t{i}.wav", _tone_clip(i, n))
        sub = Subtitle(1, dt.timedelta(seconds=0.05), dt.timedelta(seconds=0.3),
                       GOLDEN["sentences"][i])
        (root / "transcripts" / f"t{i}.srt").write_text(compose_srt([sub]))
    return root


def test_finetune_then_transcribe_the_export(env, corpus, tmp_path):
    out = tmp_path / "tuned"
    _port(["finetune", "--hf", env["hf"], "--data", str(corpus), "--out", str(out),
           "--batch", "2", "--updates", "1", "--warmup", "1", "--lr", "1e-3",
           "--no-augment", "--val-every", "0", "--f32", "--language", "en"])
    assert (out / "model.safetensors").is_file() and (out / "vocab.json").is_file()
    from yoho_tpu_torch.nn.convert import load_hf_whisper

    _, before = load_hf_whisper(env["hf"])
    _, after = load_hf_whisper(out)
    fc1 = ("decoder", "blocks_0", "mlp", "fc1", "kernel")
    a, b = after, before
    for k in fc1:
        a, b = a[k], b[k]
    assert not np.array_equal(a, b)  # one update moved the weights
    docs = [json.loads(x) for x in _port(["transcribe", *env["wavs"][:2], "--hf", str(out),
                                           "--json", "--batch", "2"]).splitlines()]
    assert len(docs) == 2 and all(isinstance(d["text"], str) for d in docs)


def test_distill_from_a_student_directory(env, corpus, tmp_path):
    out = tmp_path / "draft"
    text = _port(["distill", "--hf", env["hf"], "--student-hf", env["hf"], "--data",
                  str(corpus), "--out", str(out), "--batch", "2", "--updates", "1",
                  "--warmup", "1", "--no-augment", "--val-every", "0", "--f32",
                  "--language", "en"])
    assert "exported draft checkpoint" in text
    assert (out / "model.safetensors").is_file()


def test_serve_main_answers_a_request(env, monkeypatch):
    from yoho_tpu_torch.cli import serve as serve_mod

    made = []
    real = serve_mod.serve
    monkeypatch.setattr(serve_mod, "serve", lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    out = io.StringIO()

    def run():
        with contextlib.redirect_stdout(out):
            rc.append(serve_mod.main(["--hf", env["hf"], "--port", "0", "--batch", "2",
                                      "--device", "cpu", "--no-warmup"]))

    rc = []
    th = threading.Thread(target=run, daemon=True)
    th.start()
    for _ in range(600):
        if "serving on" in out.getvalue():
            break
        th.join(0.1)
    assert made, "the server never started"
    port = made[0].server_address[1]
    assert f"http://127.0.0.1:{port} " in out.getvalue()
    body = Path(env["wavs"][0]).read_bytes()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe", data=body,
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=60) as r:
        doc = json.load(r)
    assert doc["text"] == GOLDEN["texts"]["bf16"][0]
    made[0].shutdown()
    th.join(60)
    assert not th.is_alive() and rc == [0]


def test_structured_logger_and_trace_equal_jax_and_write(tmp_path):
    """The port's ``utils/logging.py`` writes the JAX logger's records;
    ``utils/profiling.trace`` (``transcribe --profile``) writes a Chrome
    trace of the region."""
    from yoho_tpu.utils.logging import StructuredLogger as JaxLogger
    from yoho_tpu_torch.utils.logging import StructuredLogger
    from yoho_tpu_torch.utils.profiling import trace

    lines = []
    for cls in (StructuredLogger, JaxLogger):
        buf = io.StringIO()
        cls("train", stream=buf).info("update", step=3, loss=2.5, path=Path("x"))
        rec = json.loads(buf.getvalue())
        rec.pop("ts")
        lines.append(rec)
    assert lines[0] == lines[1]
    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
