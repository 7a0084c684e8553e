"""The port's corpus tools (``import-corpus``, ``cache-corpus``,
``split-tracks``, ``plot-metrics``) against the JAX package's: the same
inputs, made from a seed, through both; every file either package writes
is byte-equal to the other's. The port's commands run through the
``yoho-torch`` dispatch (``yoho_tpu_torch.cli.__main__``)."""

import datetime as dt
import shutil
import wave
from pathlib import Path

import numpy as np
import pytest

from yoho_tpu_torch.cli.__main__ import main as umbrella


def _wav(path, seconds=0.5, rate=16000, freq=440.0, seed=0):
    n = int(seconds * rate)
    noise = np.random.default_rng(seed).standard_normal(n) * 0.01
    x = 0.3 * np.sin(2 * np.pi * freq * np.arange(n) / rate) + noise
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return path


def _flac(path, seconds=0.5, rate=16000):
    from yoho_tpu_torch.audio.io import save_audio

    path.parent.mkdir(parents=True, exist_ok=True)
    save_audio((0.3 * np.sin(2 * np.pi * 330 * np.arange(int(seconds * rate)) / rate)
                ).astype(np.float32), path, rate)
    return path


def _commonvoice(root):
    lines = ["client_id\tpath\tsentence\tup_votes"]
    for i in range(4):
        _wav(root / "clips" / f"cv{i}.wav", 0.3 + 0.1 * i, seed=i)
        lines.append(f"spk{i % 2}\tcv{i}.wav\tsentence number {i}\t2")
    lines += ["spkX\tmissing.wav\torphan row\t0", "spkY\tcv0.wav\t\t0"]
    (root / "validated.tsv").write_text("\n".join(lines), encoding="utf-8")
    return []


def _librispeech(root):
    d = root / "19" / "198"
    _flac(d / "19-198-0000.flac", 0.4)
    _flac(d / "19-198-0001.flac", 0.6)
    (d / "19-198.trans.txt").write_text(
        "19-198-0000 HELLO THERE\n19-198-0001 GENERAL KENOBI\n19-198-0002 NO AUDIO\n",
        encoding="utf-8")
    return []


def _ljspeech(root):
    _wav(root / "wavs" / "LJ001-0001.wav", 0.3)
    _wav(root / "wavs" / "LJ001-0002.wav", 0.4, seed=1)
    (root / "metadata.csv").write_text(
        "LJ001-0001|has 2 nums|has two nums\nLJ001-0002|only raw text\n", encoding="utf-8")
    return []


def _csv(root):
    for i in range(4):
        _wav(root / f"d{i % 2}" / "utt.wav" if i < 2 else root / f"c{i}.wav", 0.3, seed=i)
    rows = ["audio,transcript,who", "d0/utt.wav,first words,alice", "d1/utt.wav,same stem,bob",
            "c2.wav,odd speaker,../evil", "c3.wav,more words,alice"]
    (root / "index.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return ["--format", "csv", "--audio-col", "audio", "--text-col", "transcript",
            "--speaker-col", "who"]


def _tree(root: Path):
    """Relative path -> bytes of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("layout", [_commonvoice, _librispeech, _ljspeech, _csv],
                         ids=["commonvoice", "librispeech", "ljspeech", "csv"])
def test_import_corpus_writes_jax_bytes(layout, tmp_path, capsys):
    from yoho_tpu.cli.import_corpus import main as jax_main

    src = tmp_path / "src"
    src.mkdir()
    extra = layout(src)
    args = ["--copy", "--speakers", "-q", *extra]
    assert jax_main([str(src), str(tmp_path / "jax"), *args]) == 0
    want = capsys.readouterr().out
    assert umbrella(["import-corpus", str(src), str(tmp_path / "port"), *args]) == 0
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "port"), "DST") == want.replace(str(tmp_path / "jax"),
                                                                      "DST")
    jtree, ttree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(ttree) >= 4 and any(k.startswith("transcripts/") for k in ttree)
    assert ttree == jtree
    if layout is not _ljspeech:
        assert any(k.startswith("speakers/") for k in ttree)


def test_import_corpus_links_and_probes_like_jax(tmp_path):
    """Symlinked audio (the default) points where JAX's links point; the
    FLAC header probe gives JAX's duration."""
    from yoho_tpu.cli.import_corpus import import_corpus as jax_import
    from yoho_tpu.cli.import_corpus import probe_duration as jax_probe
    from yoho_tpu_torch.cli.import_corpus import import_corpus, probe_duration

    src = tmp_path / "src"
    _librispeech(src)
    want = jax_import(src, tmp_path / "jax", speakers=True, quiet=True)
    got = import_corpus(src, tmp_path / "port", speakers=True, quiet=True)
    assert got == want == {"imported": 2, "skipped": 1, "format": "librispeech"}
    for link in sorted((tmp_path / "port").rglob("*.flac")):
        twin = tmp_path / "jax" / link.relative_to(tmp_path / "port")
        assert link.is_symlink() and link.readlink() == twin.readlink()
    flac = sorted(src.rglob("*.flac"))[0]
    assert probe_duration(flac) == jax_probe(flac) == pytest.approx(0.4, abs=1e-3)


def test_cache_corpus_writes_jax_flac_and_keeps_one_file_per_stem(tmp_path):
    from yoho_tpu.cli.cache_corpus import main as jax_main
    from yoho_tpu_torch.train.dataloader import list_audio_files

    for i in range(3):
        _wav(tmp_path / "jax" / "noisy" / "audio" / f"a{i}.wav", 0.5 + 0.25 * i, seed=i)
    _wav(tmp_path / "jax" / "clean" / "audio" / "c.wav", 1.0, seed=9)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    before = list_audio_files(tmp_path / "port" / "noisy" / "audio")
    assert jax_main([str(tmp_path / "jax"), "--workers", "1"]) == 0
    assert umbrella(["cache-corpus", str(tmp_path / "port"), "--workers", "1"]) == 0
    ttree = _tree(tmp_path / "port")
    assert sum(k.endswith(".flac") for k in ttree) == 4
    assert ttree == _tree(tmp_path / "jax")
    after = list_audio_files(tmp_path / "port" / "noisy" / "audio")
    assert [p.stem for p in after] == [p.stem for p in before]
    assert all(p.suffix == ".flac" for p in after)
    # A second run converts nothing.
    assert umbrella(["cache-corpus", str(tmp_path / "port"), "--workers", "1"]) == 0
    assert _tree(tmp_path / "port") == ttree


def test_split_tracks_writes_jax_chunks(tmp_path):
    from yoho_tpu.cli.split_tracks import main as jax_main
    from yoho_tpu_torch.text.srt import Subtitle, compose_srt, parse_srt

    src = tmp_path / "src"
    _wav(src / "audio" / "a.wav", 10.0)
    subs = [Subtitle(i + 1, dt.timedelta(seconds=a), dt.timedelta(seconds=b), t)
            for i, (a, b, t) in enumerate([(0.5, 1.5, "one"), (3.5, 4.5, "two"),
                                           (7.9, 9.0, "three")])]
    (src / "transcripts" / "a.srt").parent.mkdir(parents=True)
    (src / "transcripts" / "a.srt").write_text(compose_srt(subs))
    args = ["--approx_duration", "4", "--workers", "1"]
    assert jax_main([str(src), str(tmp_path / "jax"), *args]) == 0
    assert umbrella(["split-tracks", str(src), str(tmp_path / "port"), *args]) == 0
    ttree = _tree(tmp_path / "port")
    assert ttree == _tree(tmp_path / "jax") and len(ttree) >= 4
    # No chunk cuts a subtitle: each fits inside its chunk's audio.
    for srt in sorted((tmp_path / "port" / "transcripts").iterdir()):
        with wave.open(str(tmp_path / "port" / "audio" / f"{srt.stem}.wav")) as w:
            seconds = w.getnframes() / w.getframerate()
        for s in parse_srt(srt.read_text()):
            assert 0 <= s.start.total_seconds() < s.end.total_seconds() <= seconds


def test_plot_metrics_once_renders_jax_png(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from yoho_tpu.cli.plot_metrics import main as jax_main

    rows = "update,learning_rate,loss,val_loss\n1,0.001,5.0,\n2,0.0009,4.2,4.5\n3,0.0008,3.9,\n"
    for pkg in ("jax", "port"):
        csv = tmp_path / pkg / "s" / "stages" / "2" / "metrics.csv"
        csv.parent.mkdir(parents=True)
        csv.write_text(rows)
    assert jax_main(["s", "2", "--root", str(tmp_path / "jax"), "--once"]) == 0
    assert umbrella(["plot-metrics", "s", "2", "--root", str(tmp_path / "port"), "--once"]) == 0
    png = tmp_path / "port" / "s" / "stages" / "2" / "metrics.png"
    assert png.stat().st_size > 1000
    assert png.read_bytes() == (tmp_path / "jax" / "s" / "stages" / "2" /
                                "metrics.png").read_bytes()
