"""``yoho-torch cache-corpus``: transcode a training corpus to FLAC for fast
lossless decode (the JAX package's ``cli/cache_corpus.py``; the same FLAC
bytes).

The reference measured compressed decode at 40-500x the cost of raw
arrays and resorted to pickled numpy caches
(``experiments/decoding_benchmark.py:50-70``). This framework's answer is
its own FLAC codec (``yoho_tpu_torch/native/flac.cpp``: encode 123x realtime, decode
~700x): one pass over a corpus converts mp3/m4a/ogg/wav to mono FLAC at
the training sample rate — ~60% of WAV size, exact int16 round-trip from
the conversion point on, decoded in-process with no codec libraries
needed afterwards.

The dataloader needs no configuration: its audio-suffix search prefers
``.flac`` over the compressed originals, so cached files win
automatically while the originals stay in place (use ``--delete-source``
to reclaim the space).

Usage: yoho-torch cache-corpus <dataset_dir> [--rate 16000] [--workers N]
       (dataset_dir is a session dataset root containing */audio/, or a
        single directory of audio files)
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

# Formats worth transcoding (wav included: FLAC is smaller and still exact).
_SOURCE_SUFFIXES = (".wav", ".mp3", ".mp4", ".m4a", ".ogg", ".opus")


def _audio_dirs(root: Path):
    if (root / "audio").is_dir():
        return [root / "audio"]
    subs = [d / "audio" for d in sorted(root.iterdir())
            if (d / "audio").is_dir()] if root.is_dir() else []
    return subs or [root]


def _convert(args):
    src, rate, delete = args
    from yoho_tpu_torch.audio.flac import encode_flac
    from yoho_tpu_torch.audio.io import load_audio

    dst = src.with_suffix(".flac")
    if dst.exists() and dst.stat().st_mtime >= src.stat().st_mtime:
        return src, dst, 0.0, "up-to-date"
    t0 = time.monotonic()
    pcm = load_audio(src, rate)  # mono int16 at the training rate
    blob = encode_flac(pcm.astype("int32").reshape(-1, 1), rate)
    # Temp name unique per SOURCE: same-stem sources (a.wav + a.mp3) must
    # not truncate each other's in-flight write (jobs are also deduped by
    # stem in main(), this is belt-and-braces).
    tmp = dst.with_name(f"{dst.name}.{src.suffix.lstrip('.')}.tmp")
    tmp.write_bytes(blob)
    tmp.replace(dst)  # atomic: readers never see a partial file
    if delete and src.suffix.lower() != ".flac":
        src.unlink()
    return src, dst, time.monotonic() - t0, "converted"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="yoho-torch cache-corpus",
        description="Transcode a corpus to FLAC for fast lossless decode")
    parser.add_argument("root", type=str,
                        help="dataset root (contains */audio/) or audio dir")
    parser.add_argument("--rate", type=int, default=16000,
                        help="target sample rate (the training rate)")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--delete-source", action="store_true",
                        help="remove the original after a successful "
                             "conversion")
    args = parser.parse_args(argv)

    root = Path(args.root)
    if not root.exists():
        print(f"error: {root} does not exist", file=sys.stderr)
        return 2
    files = []
    for d in _audio_dirs(root):
        # One job per stem: a.wav and a.mp3 would both target a.flac —
        # keep the preferred source (suffix order = decode-fidelity order).
        by_stem = {}
        for f in sorted(d.iterdir()):
            suf = f.suffix.lower()
            if suf not in _SOURCE_SUFFIXES:
                continue
            cur = by_stem.get(f.stem)
            if cur is None or (_SOURCE_SUFFIXES.index(suf)
                               < _SOURCE_SUFFIXES.index(cur.suffix.lower())):
                by_stem[f.stem] = f
        files += [by_stem[s] for s in sorted(by_stem)]
    if not files:
        print(f"no convertible audio under {root}")
        return 0

    jobs = [(f, args.rate, args.delete_source) for f in files]
    results = []
    if args.workers > 1 and len(jobs) > 1:
        # spawn, not fork: fork() of a multithreaded process can deadlock.
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(args.workers) as pool:
            for r in pool.imap_unordered(_convert, jobs):
                results.append(r)
                print(f"  {r[0].name} -> {r[1].name} [{r[3]}]", flush=True)
    else:
        for job in jobs:
            r = _convert(job)
            results.append(r)
            print(f"  {r[0].name} -> {r[1].name} [{r[3]}]", flush=True)

    converted = [r for r in results if r[3] == "converted"]
    src_mb = sum(r[0].stat().st_size for r in converted
                 if r[0].exists()) / 1e6
    dst_mb = sum(r[1].stat().st_size for r in converted) / 1e6
    print(f"{len(converted)} converted ({len(results) - len(converted)} "
          f"up-to-date), {dst_mb:.1f} MB FLAC"
          + (f" from {src_mb:.1f} MB source" if src_mb else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
