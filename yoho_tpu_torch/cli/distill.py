"""Distill a small same-vocab draft Whisper for speculative decoding.

The port's counterpart of the JAX package's ``cli/distill.py``:
``yoho-torch distill --hf <teacher> --student-preset tiny --data <corpus>
--out <dir>`` (or ``--student-hf <small_ckpt>`` to start from existing
small weights). The exported dir plugs straight into ``yoho-torch serve
--hf <teacher> --draft-hf <dir>``; the printed teacher-agreement is the
projected speculative acceptance rate. See ``train/distill.py`` for the
loss. A preset student starts from ``nn.params.init_random`` weights from
``--seed`` (the JAX package draws flax's initializers instead). Under a
launcher (``torchrun --nproc-per-node N -m yoho_tpu_torch.cli distill
...``) the command joins the process group first and the distiller runs
data parallel over every rank; rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import sys


def main(argv=None):
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(
        description="Distill a small draft Whisper from a teacher "
                    "checkpoint on an SRT corpus")
    parser.add_argument("--hf", type=str, required=True,
                        help="teacher checkpoint dir (frozen)")
    student = parser.add_mutually_exclusive_group(required=True)
    student.add_argument("--student-hf", type=str,
                         help="initialize the student from an existing "
                              "small checkpoint (e.g. a local whisper-tiny)")
    student.add_argument("--student-preset", type=str,
                         help="random-init student from a size preset "
                              "(tiny/base/small/...), vocab matched to "
                              "the teacher")
    parser.add_argument("--data", type=str, required=True,
                        help="corpus dir with transcripts/*.srt + audio/*")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--alpha", type=float, default=0.5,
                        help="CE weight: loss = alpha*CE + (1-alpha)*KL")
    parser.add_argument("--tau", type=float, default=2.0,
                        help="distillation temperature")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--updates", type=int, default=2000)
    parser.add_argument("--warmup", type=int, default=100)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--final-lr", type=float, default=1e-6)
    parser.add_argument("--accum", type=int, default=1)
    parser.add_argument("--remat", action="store_true",
                        help="gradient-checkpoint the student's blocks "
                             "(same grads, less activation memory)")
    parser.add_argument("--no-timestamps", action="store_true")
    parser.add_argument("--language", type=str, action="append", default=None)
    parser.add_argument("--no-augment", action="store_true")
    parser.add_argument("--val-every", type=int, default=100,
                        help="updates between validations (0 = never); "
                             "each validation prints teacher-agreement")
    parser.add_argument("--max-target-len", type=int, default=None)
    parser.add_argument("--workers", action="store_true")
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.updates < 1:
        parser.error("--updates must be >= 1")
    if args.accum < 1:
        parser.error("--accum must be >= 1")
    if args.tau <= 0:
        parser.error("--tau must be > 0")
    from yoho_tpu_torch.parallel.mesh import init_distributed, is_coordinator, launched

    if launched():  # one process per rank: join the group first
        init_distributed(args.device)
    device = cli_device(args)

    import torch

    from yoho_tpu_torch.cli.transcribe import whisper_token_table
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.nn.convert import load_hf_whisper
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.train.distill import WhisperDistiller

    t_cfg, t_params = load_hf_whisper(args.hf)
    table = whisper_token_table(t_cfg, args.hf)
    if table.text_backend is None:
        print(f"error: no tokenizer files found at {args.hf!r} — "
              "distillation must ENCODE transcripts; add vocab.json+"
              "merges.txt or tokenizer.json to the teacher dir.",
              file=sys.stderr)
        return 2

    if args.student_hf:
        s_cfg, s_params = load_hf_whisper(args.student_hf)
        if s_cfg.n_vocab != t_cfg.n_vocab:
            print(f"error: student vocab {s_cfg.n_vocab} != teacher vocab "
                  f"{t_cfg.n_vocab} — speculative verify compares token "
                  "ids, so the draft must share the tokenizer (e.g. a "
                  "large-v3 teacher needs a v3-vocab student).",
                  file=sys.stderr)
            return 2
    else:
        if args.student_preset not in WHISPER_PRESETS:
            parser.error(f"unknown preset {args.student_preset!r}; "
                         f"choose from {sorted(WHISPER_PRESETS)}")
        # Vocab matched (speculative verify compares ids) AND mel matched
        # (the speculative Transcriber feeds ONE shared mel to both
        # models — e.g. a large-v3 teacher needs a 128-mel draft even
        # though public tiny uses 80).
        s_cfg = dataclasses.replace(WHISPER_PRESETS[args.student_preset],
                                    n_vocab=t_cfg.n_vocab, n_mels=t_cfg.n_mels)
        s_params = init_random(Whisper(s_cfg, dtype=torch.float32, device=device),
                               seed=args.seed)

    distiller = WhisperDistiller(
        t_cfg, t_params, s_cfg, s_params, table, args.data, args.out,
        alpha=args.alpha, tau=args.tau,
        batch_size=args.batch, updates=args.updates,
        warmup_updates=args.warmup, learning_rate=args.lr,
        final_learning_rate=args.final_lr,
        accumulated_batches=args.accum,
        timestamps=not args.no_timestamps,
        language_whitelist=args.language,
        augment=not args.no_augment,
        device=device,
        compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
        validation_frequency=args.val_every,
        max_target_len=args.max_target_len,
        use_multiprocessing=args.workers,
        src_dir=args.hf, seed=args.seed,
        remat=args.remat,
    )
    del t_params, s_params  # the distiller holds its own copies on the device
    out = distiller.run(progress=importlib.util.find_spec("tqdm") is not None)
    if not is_coordinator():
        return 0
    if distiller.last_agreement is not None:
        print(f"final teacher-agreement: {distiller.last_agreement:.3f}")
    print(f"exported draft checkpoint to {out} — serve with "
          f"`yoho-torch serve --hf {args.hf} --draft-hf {out}`")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
