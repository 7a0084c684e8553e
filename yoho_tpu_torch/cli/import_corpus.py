"""``yoho-torch import-corpus``: import public ASR corpora into the training
corpus layout (the JAX package's ``cli/import_corpus.py``; the files it
writes are the same byte for byte).

The reference assumes its corpus already exists as a dir of SRT
transcripts with sibling mp3s (``train/utils/dataloaders.py:36,53``) and
ships no tooling to produce one. This importer converts the standard
public layouts:

- **CommonVoice**: ``validated.tsv`` (tab-separated ``client_id`` /
  ``path`` / ``sentence`` columns) + ``clips/*.mp3``
- **LibriSpeech**: nested ``<spk>/<chap>/<spk>-<chap>.trans.txt`` lines
  (``<utt-id> TEXT``) + sibling ``<utt-id>.flac``
- **LJSpeech**: ``metadata.csv`` (pipe-separated ``id|raw|normalized``)
  + ``wavs/<id>.wav``
- **generic CSV/TSV**: ``--audio-col`` / ``--text-col``
  (``--speaker-col`` optional)

into ``<dst>/transcripts/<stem>.srt`` + ``<dst>/audio/<stem>.<ext>`` —
the layout ``TranscriptionDataloader`` and ``yoho-torch evaluate`` consume.
Each clip becomes one SRT whose single utterance spans the real audio
duration (probed from the container header where possible, decoded
otherwise), so the dataloader's frame-timestamp targets are exact.

Audio is symlinked by default (``--copy`` to copy); run
``yoho-torch cache-corpus`` afterwards to transcode everything to FLAC for
fast in-process decode. With ``--speakers``, clips whose source row
carries a speaker id are ALSO linked into ``<dst>/speakers/<id>/`` —
the ``dataset.speakers`` layout stage-3 voiceprint training reads.

Usage: yoho-torch import-corpus <src> <dst> [--format auto] [--tsv FILE]
           [--copy] [--speakers] [--limit N] [--min-chars 1]
           [--audio-col PATH] [--text-col TEXT] [--speaker-col COL]
"""

from __future__ import annotations

import argparse
import csv
import datetime as dt
import re
import shutil
import sys
from pathlib import Path
from typing import Iterator, Optional, Tuple

# (stem, audio_path, text, speaker_or_None)
Row = Tuple[str, Path, str, Optional[str]]


def probe_duration(path: Path, sample_rate: int = 16000) -> float:
    """Audio duration in seconds, header-only where the container allows.

    WAV and FLAC (the cache-corpus output) are read from their headers;
    everything else decodes through the owned codec stack
    (``audio/io.py``) — a one-time cost at import, after which
    ``yoho-torch cache-corpus`` makes every later read a FLAC header probe.
    """
    suf = path.suffix.lower()
    if suf == ".wav":
        import wave

        try:
            with wave.open(str(path), "rb") as w:
                rate = w.getframerate()
                if rate > 0:
                    return w.getnframes() / rate
        except Exception:
            pass  # non-PCM / malformed header: decode below
    elif suf == ".flac":
        d = _flac_duration(path)
        if d is not None:
            return d
    from yoho_tpu_torch.audio.io import load_audio

    return len(load_audio(path, sample_rate)) / sample_rate


def _flac_duration(path: Path) -> Optional[float]:
    """STREAMINFO-only FLAC duration via the owned decoder's header
    parser (``audio/flac.py``); None on ANY unreadable/malformed header
    so ``probe_duration`` falls back to a full decode — a damaged header
    does not imply an undecodable file."""
    from yoho_tpu_torch.audio.flac import flac_stream_info

    try:
        with open(path, "rb") as f:
            rate, _, _, total = flac_stream_info(f.read(64))
    except (OSError, ValueError):
        return None
    return total / rate if total else None  # 0 = "unknown" per spec


def _iter_commonvoice(src: Path, tsv: Optional[str]) -> Iterator[Row]:
    if tsv:
        tables = [src / tsv]
        if not tables[0].exists():
            raise FileNotFoundError(tables[0])
    else:
        tables = [src / "validated.tsv"]
        if not tables[0].exists():
            # Tables that must never be auto-imported: invalidated.tsv is
            # community-REJECTED clips (same schema, known-bad
            # transcripts) and reported.tsv is a complaint log. Pass
            # --tsv explicitly to override.
            bad = {"invalidated.tsv", "reported.tsv"}
            tables = [t for t in sorted(src.glob("*.tsv"))
                      if t.name not in bad]
        if not tables:
            raise FileNotFoundError(f"no .tsv table under {src}")
    clips = src / "clips"
    for table in tables:
        with open(table, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f, delimiter="\t"):
                rel = (row.get("path") or "").strip()
                text = (row.get("sentence") or "").strip()
                if not rel or not text:
                    continue
                audio = clips / rel if (clips / rel).exists() else src / rel
                yield Path(rel).stem, audio, text, \
                    (row.get("client_id") or "").strip() or None


def _iter_librispeech(src: Path) -> Iterator[Row]:
    for trans in sorted(src.rglob("*.trans.txt")):
        for line in trans.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            utt, _, text = line.partition(" ")
            if not text.strip():
                continue
            audio = trans.parent / f"{utt}.flac"
            if not audio.exists():  # some mirrors re-encode to wav
                audio = trans.parent / f"{utt}.wav"
            yield utt, audio, text.strip(), utt.split("-", 1)[0] or None


def _iter_ljspeech(src: Path) -> Iterator[Row]:
    meta = src / "metadata.csv"
    if not meta.exists():
        raise FileNotFoundError(meta)
    for line in meta.read_text(encoding="utf-8").splitlines():
        # id|raw|normalized — normalized preferred (numbers verbalized)
        parts = line.split("|")
        if len(parts) < 2:
            continue
        stem = parts[0].strip()
        text = (parts[2] if len(parts) > 2 and parts[2].strip()
                else parts[1]).strip()
        if not stem or not text:
            continue
        yield stem, src / "wavs" / f"{stem}.wav", text, None


def _iter_csv(src: Path, tsv: Optional[str], audio_col: str, text_col: str,
              speaker_col: Optional[str]) -> Iterator[Row]:
    if tsv:
        table = src / tsv
    else:
        cands = sorted(src.glob("*.tsv")) + sorted(src.glob("*.csv"))
        if not cands:
            raise FileNotFoundError(f"no .csv/.tsv table under {src}")
        table = cands[0]
    delim = "\t" if table.suffix.lower() == ".tsv" else ","
    with open(table, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter=delim)
        missing = {audio_col, text_col} - set(reader.fieldnames or ())
        if missing:
            raise ValueError(
                f"{table.name} lacks column(s) {sorted(missing)}; "
                f"has {reader.fieldnames}")
        for row in reader:
            rel = (row.get(audio_col) or "").strip()
            text = (row.get(text_col) or "").strip()
            if not rel or not text:
                continue
            spk = (row.get(speaker_col) or "").strip() if speaker_col else ""
            yield Path(rel).stem, src / rel, text, spk or None


def detect_format(src: Path) -> str:
    if (src / "validated.tsv").exists() or (src / "clips").is_dir():
        return "commonvoice"
    if (src / "metadata.csv").exists() and (src / "wavs").is_dir():
        return "ljspeech"
    if next(src.rglob("*.trans.txt"), None) is not None:
        return "librispeech"
    raise SystemExit(
        f"cannot auto-detect corpus format under {src} — pass --format "
        "(commonvoice needs validated.tsv or clips/, ljspeech "
        "metadata.csv + wavs/, librispeech *.trans.txt)")


def _one_utterance_srt(text: str, duration: float) -> str:
    from yoho_tpu_torch.text.srt import Subtitle, compose_srt

    return compose_srt([Subtitle(
        index=1, start=dt.timedelta(0),
        end=dt.timedelta(seconds=max(duration, 0.01)), content=text)])


def _safe_component(name: str) -> str:
    """One path component: no separators, no traversal, never empty.

    Speaker ids (and stems) come straight out of corpus tables — a value
    like ``a/b`` or ``..`` used raw under ``dst/speakers/`` would write
    outside the tree."""
    name = re.sub(r"[^\w.-]", "_", name)
    if not name.strip("._"):  # '', '.', '..', '___' -> unusable
        return "_"
    return name


def _place(src: Path, dst: Path, copy: bool) -> None:
    if dst.exists() or dst.is_symlink():
        dst.unlink()
    if copy:
        shutil.copyfile(src, dst)
    else:
        dst.symlink_to(src.resolve())


def import_corpus(src: Path, dst: Path, fmt: str = "auto",
                  tsv: Optional[str] = None, copy: bool = False,
                  speakers: bool = False, limit: Optional[int] = None,
                  min_chars: int = 1, audio_col: str = "path",
                  text_col: str = "sentence",
                  speaker_col: Optional[str] = None,
                  sample_rate: int = 16000, quiet: bool = False) -> dict:
    """Run one import; returns ``{"imported": N, "skipped": M}``."""
    src, dst = Path(src), Path(dst)
    if fmt == "auto":
        fmt = detect_format(src)
    rows: Iterator[Row] = {
        "commonvoice": lambda: _iter_commonvoice(src, tsv),
        "librispeech": lambda: _iter_librispeech(src),
        "ljspeech": lambda: _iter_ljspeech(src),
        "csv": lambda: _iter_csv(src, tsv, audio_col, text_col, speaker_col),
    }[fmt]()

    (dst / "transcripts").mkdir(parents=True, exist_ok=True)
    (dst / "audio").mkdir(parents=True, exist_ok=True)
    imported = skipped = 0
    # Stems from different source subdirs can collide (e.g. generic CSV
    # rows spk1/utt1.wav + spk2/utt1.wav); a raw stem would silently
    # overwrite the earlier pair while still counting it as imported.
    seen: dict = {}
    for stem, audio, text, speaker in rows:
        if limit is not None and imported >= limit:
            break
        if len(text) < min_chars or not audio.exists():
            if not quiet:
                why = "missing audio" if not audio.exists() else "short text"
                print(f"skip {stem}: {why}", file=sys.stderr)
            skipped += 1
            continue
        try:
            duration = probe_duration(audio, sample_rate)
        except Exception as e:  # undecodable clip: keep importing
            if not quiet:
                print(f"skip {stem}: {type(e).__name__}: {e}",
                      file=sys.stderr)
            skipped += 1
            continue
        stem = _safe_component(stem)
        n = seen.get(stem, 0)
        seen[stem] = n + 1
        if n:
            stem = f"{stem}-{n + 1}"
        (dst / "transcripts" / f"{stem}.srt").write_text(
            _one_utterance_srt(text, duration), encoding="utf-8")
        _place(audio, dst / "audio" / (stem + audio.suffix.lower()), copy)
        if speakers and speaker:
            spk_dir = dst / "speakers" / _safe_component(speaker)
            spk_dir.mkdir(parents=True, exist_ok=True)
            _place(audio, spk_dir / (stem + audio.suffix.lower()), copy)
        imported += 1
    return {"imported": imported, "skipped": skipped, "format": fmt}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="yoho-torch import-corpus",
        description="Convert a public ASR corpus into the SRT training "
                    "layout (transcripts/*.srt + audio/*)")
    parser.add_argument("src", type=Path, help="corpus root")
    parser.add_argument("dst", type=Path, help="output dataset dir")
    parser.add_argument("--format", default="auto",
                        choices=("auto", "commonvoice", "librispeech",
                                 "ljspeech", "csv"))
    parser.add_argument("--tsv", default=None, metavar="FILE",
                        help="table file relative to src (default: "
                             "validated.tsv / first *.tsv|*.csv)")
    parser.add_argument("--copy", action="store_true",
                        help="copy audio instead of symlinking")
    parser.add_argument("--speakers", action="store_true",
                        help="also build speakers/<id>/ links for stage-3 "
                             "voiceprint training (rows with speaker ids)")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--min-chars", type=int, default=1,
                        help="skip transcripts shorter than this")
    parser.add_argument("--audio-col", default="path")
    parser.add_argument("--text-col", default="sentence")
    parser.add_argument("--speaker-col", default=None)
    parser.add_argument("--rate", type=int, default=16000,
                        help="decode rate for duration probes of "
                             "headerless formats")
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)

    stats = import_corpus(args.src, args.dst, args.format, args.tsv,
                          args.copy, args.speakers, args.limit,
                          args.min_chars, args.audio_col, args.text_col,
                          args.speaker_col, args.rate, args.quiet)
    print(f"imported {stats['imported']} utterances "
          f"({stats['format']}), skipped {stats['skipped']} -> {args.dst}")
    if not args.copy:
        print("audio symlinked; run `yoho-torch cache-corpus` to transcode to "
              "FLAC (materializes + speeds up decode)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
