"""Fine-tune a Whisper checkpoint on an SRT corpus, on the GPU.

The port's counterpart of the JAX package's ``cli/finetune.py``:
``yoho-torch finetune --hf <ckpt_dir> --data <corpus> --out <dir>``, where
<corpus> holds ``transcripts/*.srt`` + ``audio/*`` pairs. The result is a
standard HF checkpoint directory: serve it right back with ``yoho-torch
serve --hf <out>`` or ``transcribe --hf <out>``. See
``train/whisper_finetune.py`` for the trainer. Under a launcher
(``torchrun --nproc-per-node N -m yoho_tpu_torch.cli finetune ...``) the
command joins the process group first and the trainer runs data parallel
over every rank (JAX's ``make_mesh(-1, 1)``); rank 0 alone prints and
writes.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys


def main(argv=None):
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(
        description="Fine-tune a Whisper checkpoint on an SRT corpus")
    parser.add_argument("--hf", type=str, required=True,
                        help="source checkpoint dir (config.json + weights "
                             "+ tokenizer files)")
    parser.add_argument("--data", type=str, required=True,
                        help="corpus dir with transcripts/*.srt + audio/*")
    parser.add_argument("--out", type=str, required=True,
                        help="output checkpoint dir (HF layout)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--updates", type=int, default=1000)
    parser.add_argument("--warmup", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--final-lr", type=float, default=1e-7)
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation micro-steps per update")
    parser.add_argument("--remat", action="store_true",
                        help="gradient-checkpoint every transformer block: "
                             "same loss/grads, ~one extra forward, far less "
                             "activation memory — lets bigger batches fit")
    parser.add_argument("--freeze-encoder", action="store_true",
                        help="train the decoder only (halves optimizer "
                             "memory and most backward FLOPs)")
    parser.add_argument("--optimizer", choices=("adamw", "adafactor"),
                        default="adamw",
                        help="adafactor drops AdamW's two param-sized "
                             "moment trees (factored second moments only)")
    parser.add_argument("--lora", type=int, default=0, metavar="RANK",
                        help="LoRA parameter-efficient fine-tune: train "
                             "rank-RANK adapters on frozen base weights "
                             "(<1%% of params; exports BOTH the merged "
                             "checkpoint and a re-applicable "
                             "lora_adapter.msgpack)")
    parser.add_argument("--lora-alpha", type=float, default=None,
                        help="LoRA scale numerator (merged delta = "
                             "alpha/rank * A@B; default 2*rank)")
    parser.add_argument("--lora-targets", type=str, default=None,
                        metavar="REGEX",
                        help="module-path regex choosing adapted kernels "
                             "(default: q/v projections of every "
                             "attention)")
    parser.add_argument("--task", type=str, default="transcribe",
                        choices=("transcribe", "translate"))
    parser.add_argument("--no-timestamps", action="store_true",
                        help="train without timestamp tokens "
                             "(<|notimestamps|> prompt)")
    parser.add_argument("--language", type=str, action="append", default=None,
                        help="whitelist corpus language(s); repeatable "
                             "(default: accept all, per-file detection)")
    parser.add_argument("--speechless-ratio", type=float, default=0.0,
                        help="fraction of no-speech negative samples "
                             "(ambient audio, empty transcript)")
    parser.add_argument("--ambient", type=str, default=None, metavar="DIR",
                        help="ambient-noise corpus (audio/ subdir) feeding "
                             "--speechless-ratio negatives; without it "
                             "negatives are synthesized low noise")
    parser.add_argument("--no-augment", action="store_true")
    parser.add_argument("--val-every", type=int, default=100,
                        help="updates between validations (0 = never)")
    parser.add_argument("--max-target-len", type=int, default=None,
                        help="decoder token budget per window (default: "
                             "the model's n_text_ctx)")
    parser.add_argument("--workers", action="store_true",
                        help="multiprocessing dataloader workers")
    parser.add_argument("--f32", action="store_true",
                        help="full f32 compute (default bf16 autocast, "
                             "f32 params/optimizer)")
    parser.add_argument("--seed", type=int, default=0)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.updates < 1:
        parser.error("--updates must be >= 1")
    if args.accum < 1:
        parser.error("--accum must be >= 1")
    if args.lora < 0:
        parser.error("--lora must be >= 0 (0 = full fine-tune)")
    from yoho_tpu_torch.parallel.mesh import init_distributed, is_coordinator, launched

    if launched():  # one process per rank: join the group first
        init_distributed(args.device)
    device = cli_device(args)

    import torch

    from yoho_tpu_torch.cli.transcribe import whisper_token_table
    from yoho_tpu_torch.nn.convert import load_hf_whisper
    from yoho_tpu_torch.train.whisper_finetune import WhisperFinetuner

    cfg, params = load_hf_whisper(args.hf)
    table = whisper_token_table(cfg, args.hf)
    if table.text_backend is None:
        print(f"error: no tokenizer files found at {args.hf!r} — "
              "fine-tuning must ENCODE transcripts; add vocab.json+"
              "merges.txt or tokenizer.json to the checkpoint dir.",
              file=sys.stderr)
        return 2

    tuner = WhisperFinetuner(
        cfg, params, table, args.data, args.out,
        batch_size=args.batch, updates=args.updates,
        warmup_updates=args.warmup, learning_rate=args.lr,
        final_learning_rate=args.final_lr,
        accumulated_batches=args.accum,
        freeze_encoder=args.freeze_encoder,
        task=args.task, timestamps=not args.no_timestamps,
        language_whitelist=args.language,
        speechless_ratio=args.speechless_ratio,
        ambient_dir=args.ambient,
        augment=not args.no_augment,
        device=device,
        compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
        validation_frequency=args.val_every,
        max_target_len=args.max_target_len,
        use_multiprocessing=args.workers,
        src_dir=args.hf, seed=args.seed,
        remat=args.remat, optimizer=args.optimizer,
        lora_rank=args.lora, lora_alpha=args.lora_alpha,
        lora_targets=args.lora_targets,
    )
    del params  # the trainer holds its own copy on the device
    out = tuner.run(progress=importlib.util.find_spec("tqdm") is not None)
    if is_coordinator():
        print(f"exported fine-tuned checkpoint to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
