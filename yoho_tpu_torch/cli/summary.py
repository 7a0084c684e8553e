"""``yoho-torch summary``: model architecture summary and parameter counts
(the JAX package's ``cli/summary.py``).

The model is built on PyTorch's ``meta`` device, so nothing is allocated
and no card is needed.

Usage: ``python -m yoho_tpu_torch.cli summary (--whisper small | --session main)``
"""

from __future__ import annotations

import argparse


def _param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())


def main(argv=None):
    parser = argparse.ArgumentParser(prog="yoho-torch summary", description="Model summary")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--whisper", type=str,
                     help="Whisper preset name (tiny..large-v3)")
    src.add_argument("--session", type=str, help="YOHO session name")
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--tabulate", action="store_true",
                        help="print the module tree as well")
    args = parser.parse_args(argv)

    if args.whisper:
        from yoho_tpu_torch.core.config import WHISPER_PRESETS
        from yoho_tpu_torch.nn.whisper import Whisper

        cfg = WHISPER_PRESETS[args.whisper]
        model = Whisper(cfg, device="meta")
        print(f"whisper-{args.whisper}: {cfg.n_audio_layer} enc + "
              f"{cfg.n_text_layer} dec layers, d={cfg.n_audio_state}, "
              f"vocab={cfg.n_vocab}")
        print(f"parameters: {_param_count(model) / 1e6:.1f} M")
    else:
        from yoho_tpu_torch.core.config import load_session_config
        from yoho_tpu_torch.nn.yoho import YOHOModel
        from yoho_tpu_torch.text.tokenizer import YOHOTokenizer

        config = load_session_config(args.session, args.root)
        cfg = config.yoho
        tok = YOHOTokenizer.load(config.weights.tokenizer)
        model = YOHOModel(cfg, tok.vocab_size, device="meta")
        print(f"YOHO {args.session}: {cfg.n_audio_blocks} enc + "
              f"{cfg.n_text_blocks} dec blocks, d={cfg.dims}, "
              f"vocab={tok.vocab_size}")
        print(f"parameters: {_param_count(model) / 1e6:.2f} M")
    if args.tabulate:
        print(model)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
