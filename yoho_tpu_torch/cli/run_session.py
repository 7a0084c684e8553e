"""``yoho-torch run-session``: start or resume a training stage of a
session (the JAX package's ``cli/run_session.py``).

Stage 0 trains the tokenizer (on the host); stages 1-4 (transcription
pretraining, voice reconstruction, the voiceprint encoder, joint
fine-tuning) train on the GPU unless ``--device cpu``, at ``--compute-dtype``
under autocast. Under a launcher the command joins the process group
first (as the JAX command calls ``init_distributed``) and the stage trains
over the session's ``[mesh]`` (``train/trainer.py``; ``long_context_factor
> 1`` over (data, seq)); rank 0 alone prints and writes. NCCL on the
cards, gloo with ``--device cpu``:

    torchrun --nproc-per-node N -m yoho_tpu_torch.cli run-session <name> 1

Usage: ``python -m yoho_tpu_torch.cli run-session <name> <stage 0-4>
          [--root ./sessions] [--max-updates N] [--compute-dtype bf16] [--no-workers]``
"""

from __future__ import annotations

import argparse
import importlib
import json
from dataclasses import asdict

import torch

STAGE_HELP = (
    "Stage of training to start/resume:\n"
    "\t0 - Train tokenizer\n"
    "\t1 - Pretrain transcription without voiceprints\n"
    "\t2 - Train voice reconstruction\n"
    "\t3 - Finetune voiceprint encoder\n"
    "\t4 - Finetune transcription with voiceprints"
)
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_STAGE_MODULES = {1: "stage1_asr_pretrain", 2: "stage2_reconstruction",
                  3: "stage3_voiceprint", 4: "stage4_joint_finetune"}


def main(argv=None):
    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(
        prog="yoho-torch run-session",
        description="Starts/Resumes the training of a session",
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("name", type=str, help="Name of the session")
    parser.add_argument("stage", type=int, choices=[0, 1, 2, 3, 4], help=STAGE_HELP)
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--max-updates", type=int, default=None)
    parser.add_argument("--compute-dtype", choices=sorted(_DTYPES), default="f32",
                        help="autocast type of the training forward (float32 "
                             "parameters and optimizer state either way)")
    parser.add_argument("--no-workers", action="store_true",
                        help="load batches in the training process (no dataloader "
                             "worker processes)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    from yoho_tpu_torch.parallel.mesh import barrier, init_distributed, is_coordinator, launched

    if launched():  # one process per rank: join the group first
        init_distributed(args.device)
    config = load_session_config(args.name, args.root)
    if is_coordinator():
        print("Loaded config:")
        print(json.dumps(asdict(config), indent=4, default=str))
    if args.stage == 0:
        from yoho_tpu_torch.train.stages.stage0_tokenizer import main as stage_main

        if is_coordinator():  # host work with one output file
            stage_main(config)
        barrier("tokenizer")
    else:
        stage_main = importlib.import_module(
            f"yoho_tpu_torch.train.stages.{_STAGE_MODULES[args.stage]}").main
        stage_main(config, max_updates=args.max_updates, device=cli_device(args),
                   compute_dtype=_DTYPES[args.compute_dtype],
                   use_multiprocessing=not args.no_workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
