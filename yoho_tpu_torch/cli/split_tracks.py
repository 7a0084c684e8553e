"""``yoho-torch split-tracks`` (the JAX package's ``cli/split_tracks.py``):
split long (audio, SRT) pairs into ~N-second chunks at utterance
boundaries (never cutting through speech), re-basing subtitle timestamps.

Parity with ``train/tools/split_transcribed_tracks.py:28-109`` on the
from-scratch SRT/audio stack; output chunks are WAV (mp4 only when ffmpeg
exists).

Usage: ``python -m yoho_tpu_torch.cli split-tracks <source> <target>
[--sample_rate 16000] [--approx_duration 48] [--workers N]``
"""

import argparse
import datetime as dt
import os
from pathlib import Path

from yoho_tpu_torch.audio.io import load_audio_f32, save_audio
from yoho_tpu_torch.text.srt import compose_srt, parse_srt, sort_and_reindex


def split_track(audio, transcript, sample_rate: int, approx_chunk: dt.timedelta):
    """-> [(chunk_audio, [rebased subtitles])]; pure, tested directly."""
    remaining = sort_and_reindex(transcript)[::-1]
    chunks = []
    start_time = dt.timedelta()
    n = len(audio)
    while remaining:
        chunk_subs = []
        end_time = start_time + approx_chunk
        while remaining:
            nxt = remaining.pop()
            if nxt.end > end_time:
                remaining.append(nxt)
                if nxt.start < end_time:
                    end_time = nxt.start  # shrink: never cut through speech
                break
            chunk_subs.append(nxt)
        start_sample = int(start_time.total_seconds() * sample_rate)
        end_sample = int(end_time.total_seconds() * sample_rate)
        if chunk_subs:
            chunk_audio = audio[start_sample : min(end_sample, n - 1)]
            for sub in chunk_subs:
                sub.start -= start_time
                sub.end -= start_time
            chunks.append((chunk_audio, chunk_subs))
        if end_sample >= n:
            break
        start_time = end_time
    return chunks


def process_file(args):
    audio_path, sample_rate, approx_chunk, source, target = args
    transcript_path = source / "transcripts" / audio_path.with_suffix(".srt").name
    if not transcript_path.exists():
        return 0
    subs = list(parse_srt(transcript_path.read_text(encoding="utf-8")))
    audio = load_audio_f32(audio_path, sample_rate)
    chunks = split_track(audio, subs, sample_rate, approx_chunk)
    for i, (chunk_audio, chunk_subs) in enumerate(chunks):
        stem = audio_path.stem
        save_audio(chunk_audio, target / "audio" / f"{stem}.{i}.wav", sample_rate)
        (target / "transcripts" / f"{stem}.{i}.srt").write_text(
            compose_srt(sort_and_reindex(chunk_subs)), encoding="utf-8"
        )
    return len(chunks)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="yoho-torch split-tracks",
        description="Split audio+SRT pairs into chunks at utterance boundaries."
    )
    parser.add_argument("source_path", type=str)
    parser.add_argument("target_path", type=str)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--approx_duration", type=int, default=48)
    parser.add_argument("--workers", type=int, default=os.cpu_count())
    args = parser.parse_args(argv)

    source, target = Path(args.source_path), Path(args.target_path)
    (target / "audio").mkdir(parents=True, exist_ok=True)
    (target / "transcripts").mkdir(parents=True, exist_ok=True)
    approx = dt.timedelta(seconds=args.approx_duration)
    files = sorted((source / "audio").iterdir())
    tasks = [(f, args.sample_rate, approx, source, target) for f in files]

    if args.workers and args.workers > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(args.workers) as pool:
            counts = pool.map(process_file, tasks)
    else:
        counts = [process_file(t) for t in tasks]
    print(f"Wrote {sum(counts)} chunks from {len(files)} tracks to {target}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
