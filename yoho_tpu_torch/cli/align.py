"""CLI: forced alignment of known transcripts (``yoho-torch align``).

The port's counterpart of the JAX package's ``cli/align.py``. Subtitle and
karaoke tooling: given audio and its transcript, emit word timings without
decoding (the text is teacher-forced through the decoder and aligned by
DTW against the cross-attention map — ``Transcriber.align_many``,
``infer/word_timestamps.py``). Both families: ``--hf DIR`` or
``--session NAME``.

Inputs pair each audio file with a transcript: ``--text`` for a single
file, or a sibling ``<stem>.txt`` next to each audio file. Output is
JSONL (one line per file) or SRT per-word cues (``--srt DIR``).
"""

import argparse
import json as jsonlib
import sys
from pathlib import Path


def main(argv=None):
    from yoho_tpu_torch.cli.transcribe import (
        batch_size_arg,
        build_whisper_transcriber,
        build_yoho_transcriber,
    )
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(
        description="Forced alignment: word timings for known transcripts")
    parser.add_argument("files", nargs="+", type=str,
                        help="audio files (one window each: <= 30 s; split "
                             "longer material first)")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", type=str, help="HF Whisper checkpoint directory")
    src.add_argument("--session", type=str, help="YOHO training session name")
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--text", type=str, default=None,
                        help="the transcript (single audio file only); "
                             "otherwise each file needs a sibling "
                             "<stem>.txt")
    parser.add_argument("--language", type=str, default="en")
    parser.add_argument("--batch", type=batch_size_arg, default=8,
                        help="decode batch size, or 'auto' (device-memory "
                             "capacity model)")
    parser.add_argument("--srt", type=str, default=None, metavar="DIR",
                        help="also write per-word SRT cues per input")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = cli_device(args)

    if args.text and len(args.files) > 1:
        parser.error("--text pairs with exactly one audio file; for many "
                     "files put a <stem>.txt next to each")

    pairs = []
    for f in args.files:
        if args.text:
            text = args.text
        else:
            txt = Path(f).with_suffix(".txt")
            if not txt.exists():
                parser.error(f"no transcript for {f}: pass --text or "
                             f"create {txt}")
            text = txt.read_text(encoding="utf-8").strip()
        pairs.append((f, text))

    language = None if args.language == "auto" else args.language
    if args.hf:
        t = build_whisper_transcriber(args.hf, 0, args.batch, language, True,
                                      device=device)
    else:
        t = build_yoho_transcriber(args.session, args.root, 0, args.batch,
                                   device=device)

    all_words = t.align_many(pairs)
    for (f, _text), words in zip(pairs, all_words):
        print(jsonlib.dumps({
            "file": f,
            "words": [{"word": w.word, "start": w.start, "end": w.end,
                       "probability": w.probability}
                      for w in words],
        }, ensure_ascii=False))
        if args.srt:
            import datetime as dt

            from yoho_tpu_torch.text.srt import Subtitle, compose_srt

            subs = [Subtitle(index=i + 1,
                             start=dt.timedelta(seconds=w.start),
                             end=dt.timedelta(seconds=max(w.end, w.start)),
                             content=w.word.strip())
                    for i, w in enumerate(words)]
            out = Path(args.srt) / (Path(f).stem + ".srt")
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(compose_srt(subs), encoding="utf-8")
    if not any(all_words):
        print("warning: no words aligned (empty transcripts?)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
