"""Device selection for the command lines.

The JAX package's ``utils/platform.py`` makes ``JAX_PLATFORMS=cpu`` mean
what it says; the port's counterpart is the ``--device`` flag every
command line takes. By default a command runs on the GPU and fails with
``resolve_device``'s error when CUDA is absent: it never runs on the CPU
unless asked (``--device cpu``).

``enable_compilation_cache`` has no counterpart: nothing is compiled per
process. The kernels are built once per source into
``yoho_tpu_torch/_build/``, so ``YOHO_COMPILE_CACHE`` is accepted and does
nothing.
"""

from __future__ import annotations

import argparse

import torch

from yoho_tpu_torch.core.device import resolve_device

DEVICE_HELP = ("'cuda' (the default: fails without CUDA), 'cuda:N' or 'cpu' "
               "(the plain PyTorch path; what JAX_PLATFORMS=cpu is to the "
               "JAX package). YOHO_COMPILE_CACHE has no effect here: the "
               "kernels build once into yoho_tpu_torch/_build/")


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default=None, help=DEVICE_HELP)


def cli_device(args) -> torch.device:
    """The command's device (``--device``), resolved before anything is
    loaded, so a machine without CUDA fails at once."""
    return resolve_device(args.device)
