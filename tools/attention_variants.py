#!/usr/bin/env python3
"""Time variants of the flash and decode attention kernels on one NVIDIA GPU.

    python3 tools/attention_variants.py [--parent DIR]

Builds ``yoho_tpu_torch/csrc/flash_attention.cu`` and ``decode_attention.cu``
once per variant below, each with some of its constants replaced (one
``nvcc`` per variant, all started together, into
``yoho_tpu_torch/_build/variants/``); with ``--parent DIR`` also the two
sources of another checkout (an earlier tree unpacked there, built against
its own headers), so that two trees are compared on one card in one run.
Each variant is held to the plain version (``chip_smoke.py``'s tolerances)
and timed with ``chip_smoke.py``'s ``time_ms`` (device time, L2 flushed
between calls) at the main paths' shapes, in turns: every variant once per
round, three rounds, and the median is printed. One JSON line per case;
the first line is the card's name and power limit. Needs CUDA; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (source, constants to replace); "shipped" replaces none.
VARIANTS = {
    "flash shipped": ("flash_attention.cu", {}),
    "flash 2 consumer warpgroups": ("flash_attention.cu", {"NWG": 2}),
    "flash 4 stages": ("flash_attention.cu", {"STAGES": 4}),
    "decode shipped": ("decode_attention.cu", {}),
    "decode 2 stages": ("decode_attention.cu", {"STAGES": 2}),
    "decode 8 warps (128-position chunks)": ("decode_attention.cu", {"WARPS": 8}),
    "decode clusters for 1 block per SM": ("decode_attention.cu", {"BLOCKS_PER_SM": 1}),
    "decode clusters for 4 blocks per SM": ("decode_attention.cu", {"BLOCKS_PER_SM": 4}),
}
ROUNDS = 3


def variant_source(src: str, sub: dict) -> str:
    for key, val in sub.items():
        src, n = re.subn(rf"constexpr int {key} = \d+", f"constexpr int {key} = {val}", src,
                         count=1)
        if n != 1:
            raise ValueError(f"constant {key} not found")
    return src


def build(jobs):
    """jobs: name -> (source text, include dir). Returns name -> CDLL."""
    from yoho_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, (text, inc)) in enumerate(jobs.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs.append((name, out_dir / f"libv{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-o",
             str(out_dir / f"libv{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
        spills = sorted({int(r) for r in re.findall(r"(\d+) bytes spill stores", log)})
        print(json.dumps({"variant": name, "registers": regs, "spill_store_bytes": spills}),
              flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_variants: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="checkout whose two kernels to time as well")
    args = ap.parse_args(argv)

    import chip_smoke
    from yoho_tpu_torch.nn.kv_cache import QuantizedKV, quantize_kv
    from yoho_tpu_torch.ops import _build
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa

    print(chip_smoke.card_line(), flush=True)
    jobs = {name: (variant_source((_build.CSRC / src).read_text(), sub), _build.CSRC)
            for name, (src, sub) in VARIANTS.items()}
    if args.parent is not None:
        csrc = args.parent.resolve() / "yoho_tpu_torch" / "csrc"
        for src in ("flash_attention.cu", "decode_attention.cu"):
            kind = src.split("_")[0]
            jobs[f"{kind} parent"] = ((csrc / src).read_text(), csrc)
    libs = build(jobs)

    def entry(name):
        lib = libs[name]
        if name.startswith("flash"):
            fn, argtypes = lib.flash_attention_forward, fa.KERNEL.argtypes
        else:
            fn = lib.decode_attention
            argtypes = list(da.KERNEL.argtypes)
            # An earlier tree's decode entry takes an f32 workspace after `out`.
            if "float* part" in jobs[name][0]:
                argtypes.insert(8, ctypes.c_void_p)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn, len(argtypes)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ptr, stream = _build.ptr, _build.stream_of

    def run(calls, check):
        """calls: name -> call(); times them in turns, ROUNDS rounds."""
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            check(name)
        times = {name: [] for name in calls}
        for _ in range(ROUNDS):
            for name, call in calls.items():
                times[name].append(chip_smoke.time_ms(call, 20, flush))
        return {name: statistics.median(t) for name, t in times.items()}

    flash_names = [n for n in libs if n.startswith("flash")]
    decode_names = [n for n in libs if n.startswith("decode")]
    for heads in (12, 20):
        q, k, v = (torch.randn((16, 1500, heads, 64), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        out = torch.empty_like(q)
        want = fa.attention_reference(q, k, v, False, 0.125)
        calls = {}
        for name in flash_names:
            fn, _ = entry(name)

            def call(fn=fn):
                err = fn(1, ptr(q), ptr(k), ptr(v), ptr(out), 16, heads, 1500, 1500, 1500,
                         64, 0.125, 0, stream(q))
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            calls[name] = call

        def check(name):
            chip_smoke.check_close(name, out, want, 1e-2, 1e-2)
        print(json.dumps({"case": f"flash 16x1500x{heads}x64 bf16",
                          "ms": run(calls, check)}), flush=True)
        del q, k, v, out, want

    def kv(t):
        return (torch.randn((16, 12, 64, t), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))

    cross = quantize_kv(*kv(1500), pad_to=128)
    cache = quantize_kv(*kv(512))
    k_bf16, v_bf16 = kv(1500)
    for label, kvs, s, pos, kv_len in (
            ("cross int8 S=1 (T 1536, kv_len 1500)", cross, 1, None, 1500),
            ("cross int8 S=3 (prefill)", cross, 3, None, 1500),
            ("self int8 S=1 pos=0", cache, 1, 0, 512),
            ("self int8 S=1 pos=200", cache, 1, 200, 512),
            ("self int8 S=1 pos=447", cache, 1, 447, 512),
            ("cross bf16 S=1 (T 1500, the unquantized lane)", (k_bf16, v_bf16), 1, None, 1500)):
        q = (torch.randn((16, 12, s, 64), generator=gen, device=dev) * 0.35).to(torch.bfloat16)
        k_, v_, ks, vs = ((kvs.k_q, kvs.v_q, kvs.k_scale, kvs.v_scale)
                          if isinstance(kvs, QuantizedKV) else (*kvs, None, None))
        t = k_.shape[3]
        out = torch.empty((16, s, 12, 64), dtype=torch.bfloat16, device=dev)
        part = torch.empty((16 * 12 * -(-t // 256) * s * 66,), dtype=torch.float32, device=dev)
        want = da.decode_attention_reference(q, k_, v_, ks, vs, pos, kv_len)
        calls = {}
        for name in decode_names:
            fn, n_args = entry(name)
            head = [1, 0 if ks is not None else 2, ptr(q), ptr(k_), ptr(v_),
                    ptr(ks) if ks is not None else None, ptr(vs) if vs is not None else None,
                    ptr(out)] + ([ptr(part)] if n_args == 19 else [])
            tail = [16, 12, 12, s, 64, t, kv_len, int(pos is not None), pos or 0, stream(q)]

            def call(fn=fn, a=head + tail):
                err = fn(*a)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            calls[name] = call

        def check(name):
            chip_smoke.check_close(name, out, want, 0.05, 0.02)
        print(json.dumps({"case": f"decode {label}", "ms": run(calls, check)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
