"""Umbrella CLI: ``yoho-torch <command> ...`` (also ``python -m
yoho_tpu_torch.cli`` and ``python -m yoho_tpu_torch``).

The JAX package's command table: every command of the JAX package runs in
the port.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "transcribe": ("yoho_tpu_torch.cli.transcribe", "Transcribe audio files"),
    "serve": ("yoho_tpu_torch.cli.serve", "HTTP transcription server"),
    "evaluate": ("yoho_tpu_torch.cli.evaluate", "WER/CER evaluation over a corpus"),
    "finetune": ("yoho_tpu_torch.cli.finetune",
                 "Fine-tune a Whisper checkpoint on an SRT corpus"),
    "distill": ("yoho_tpu_torch.cli.distill",
                "Distill a small draft Whisper for speculative decoding"),
    "create-session": ("yoho_tpu_torch.cli.create_session", "Scaffold a training session"),
    "run-session": ("yoho_tpu_torch.cli.run_session", "Run a training stage (0-4)"),
    "plot-metrics": ("yoho_tpu_torch.cli.plot_metrics",
                     "Live metrics dashboard for a session"),
    "split-tracks": ("yoho_tpu_torch.cli.split_tracks",
                     "Split long (audio, SRT) pairs into chunks"),
    "cache-corpus": ("yoho_tpu_torch.cli.cache_corpus",
                     "Transcode a corpus to FLAC for fast decode"),
    "import-corpus": ("yoho_tpu_torch.cli.import_corpus",
                      "Import CommonVoice/LibriSpeech/LJSpeech/CSV "
                      "corpora into the SRT training layout"),
    "summary": ("yoho_tpu_torch.cli.summary", "Model/param summary"),
    "enroll": ("yoho_tpu_torch.cli.enroll",
               "Enroll speaker voiceprints for recognition"),
    "align": ("yoho_tpu_torch.cli.align",
              "Forced alignment: word timings for known transcripts"),
    "score-diarization": ("yoho_tpu_torch.cli.score_diarization",
                          "DER between reference and hypothesis RTTM"),
    "doctor": ("yoho_tpu_torch.cli.doctor",
               "Environment self-check (CUDA, kernels, codecs, checkpoints)"),
}


def _usage() -> str:
    lines = ["usage: yoho-torch <command> [args...]", "", "commands:"]
    width = max(map(len, COMMANDS))
    for name, (_module, desc) in COMMANDS.items():
        lines.append(f"  {name:<{width}}  {desc}")
    lines.append("")
    lines.append("run 'yoho-torch <command> --help' for command arguments")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        if not argv or argv[0] in ("-h", "--help"):
            print(_usage())
            return 0
        name = argv[0]
        if name not in COMMANDS:
            print(f"yoho-torch: unknown command {name!r}\n\n{_usage()}",
                  file=sys.stderr)
            return 2
        module = importlib.import_module(COMMANDS[name][0])
        return module.main(argv[1:]) or 0
    except BrokenPipeError:  # e.g. `yoho-torch --help | head`
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
