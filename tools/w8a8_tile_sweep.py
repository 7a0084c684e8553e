#!/usr/bin/env python3
"""Time tile shapes of the w8a8 kernel on one NVIDIA GPU.

    python3 tools/w8a8_tile_sweep.py

Builds ``yoho_tpu_torch/csrc/w8a8_dense.cu`` once per variant below, each
with some of its tile constants replaced (one ``nvcc`` per variant, all
started together, into ``yoho_tpu_torch/_build/sweep/``), checks that every
variant's output equals the plain version's bit for bit, and prints one
JSON line per shape with each variant's device time (ms, ``chip_smoke.py``'s
``time_ms``: L2 flushed between calls) at the encoder MLP shapes of a batch
of 16 windows. The first line is the card's name and power limit. Needs
CUDA; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> constants of csrc/w8a8_dense.cu to replace ("shipped" changes none).
VARIANTS = {
    "shipped": {},
    "warps 8 x (64x32), 64-byte k-steps, 4 stages":
        {"BK": 64, "STAGES": 4, "THREADS": 256, "WM": 64},
    "warps 8 x (64x32), 128-byte k-steps, 3 stages": {"THREADS": 256, "WM": 64},
    "warps 4 x (64x64), 64-byte k-steps, 4 stages":
        {"BK": 64, "STAGES": 4, "THREADS": 128, "WM": 64, "WN": 64},
    "warps 8 x (64x64), block 128x256, 64-byte k-steps, 4 stages":
        {"BK": 64, "STAGES": 4, "THREADS": 256, "MIN_BLOCKS": 1, "BN": 256, "WM": 64,
         "WN": 64},
    "warps 16 x (32x32), 256-byte k-steps, 2 stages": {"BK": 256, "STAGES": 2},
}
SHAPES = (("large-v3-turbo fc1 + GELU", 1280, 5120, 1), ("large-v3-turbo fc2", 5120, 1280, 0),
          ("small fc1 + GELU", 768, 3072, 1))
ROWS = 16 * 1500


def variant_source(src: str, sub: dict) -> str:
    for key, val in sub.items():
        pattern = {"BM": r"\bBM = \d+", "BN": r"\bBN = \d+", "BK": r"\bBK = \d+",
                   "WM": r"\bWM = \d+", "WN": r"\bWN = \d+"}.get(
                       key, rf"constexpr int {key} = \d+")
        src, n = re.subn(pattern, pattern.split(" = ")[0].replace(r"\b", "") + f" = {val}",
                         src, count=1)
        if n != 1:
            raise ValueError(f"constant {key} not found")
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("w8a8_tile_sweep: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from yoho_tpu_torch.ops import _build
    from yoho_tpu_torch.ops import w8a8_dense as w8

    print(chip_smoke.card_line(), flush=True)
    src = (_build.CSRC / "w8a8_dense.cu").read_text()
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, sub in enumerate(VARIANTS.values()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(variant_source(src, sub))
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"libv{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (name, _), (i, proc) in zip(VARIANTS.items(), enumerate(procs)):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        regs = re.search(r"w8a8_gemmI13__nv_bfloat16.*?Used (\d+) registers", log, re.S)
        print(json.dumps({"variant": name, "registers": int(regs.group(1))}), flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"libv{i}.so")), "w8a8_dense")
        fn.argtypes, fn.restype = w8.KERNEL.argtypes, ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ptr = _build.ptr
    for label, k, n, gelu in SHAPES:
        x = torch.randn((ROWS, k), generator=gen, device=dev).to(torch.bfloat16)
        w_q, w_scale = w8.quantize_rows(torch.randn((n, k), generator=gen, device=dev) * 0.02)
        w_scale = w_scale[:, 0].contiguous()
        bias = torch.randn((n,), generator=gen, device=dev) * 0.02
        want = w8.w8a8_dense_reference(x, w_q, w_scale, bias,
                                       activation="gelu_tanh" if gelu else None)
        xq = torch.empty((ROWS, k), dtype=torch.int8, device=dev)
        xs = torch.empty((ROWS,), dtype=torch.float32, device=dev)
        out = torch.empty((ROWS, n), dtype=torch.bfloat16, device=dev)
        ms = {}
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(1, 1, ptr(x), ptr(w_q), ptr(w_scale), ptr(bias), ptr(xq), ptr(xs),
                         ptr(out), ROWS, n, k, gelu, _build.stream_of(out))
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: output differs from the plain version")
            ms[name] = chip_smoke.time_ms(call, 20, flush)
        print(json.dumps({"shape": f"{label} M={ROWS} K={k} N={n}", "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
