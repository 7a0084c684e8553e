#!/usr/bin/env python3
"""Time variants of the w8a8 and log-mel kernels on one NVIDIA GPU.

    python3 tools/kernel_variants.py [--parent DIR]

Builds ``yoho_tpu_torch/csrc/w8a8_dense.cu`` and ``mel_kernel.cu`` once per
variant below, each with some of its constants or lines replaced (one
``nvcc`` per variant, all started together, into
``yoho_tpu_torch/_build/variants/``);
with ``--parent DIR`` also the two sources of another checkout (an earlier
tree unpacked there, built against its own headers), so that two trees are
compared on one card in one run. Each variant is held to the plain version
(w8a8: bit for bit; mel: ``chip_smoke.py``'s 1e-4), but for the ones marked
"timing only", which leave part of the work out, and timed with
``chip_smoke.py``'s ``kernel_ms`` (device time, L2 flushed between calls) at
the main paths' shapes, in turns: every variant once per round, three
rounds, and the median is printed, split by kernel for the w8a8 entry
point's two launches. One JSON line per case; the first line is the card's
name and power limit. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from attention_variants import build, variant_source  # noqa: E402  (adds the repo root)

# name -> (source, constants to replace, source lines to replace); "shipped"
# replaces none. A variant whose replaced lines leave part of the work out
# says "timing only" in its name: it shows where the time goes, and is not
# held to the plain version.
_GELU_MATH = "  if (GELU) {"
_TANH = "t[i] = tanhf(__fmul_rn(GELU_C, __fadd_rn(y[i], t[i])));"
_LONG_ROWS = "quantize_rows<InT, 8, 4, 1><<<M, 256, 0, stream>>>"
VARIANTS = {
    "w8a8 shipped (ping-pong, 4 stages, epilogue 2 rows side by side)": ("w8a8_dense.cu", {}, {}),
    "w8a8 cooperative (one 256-row tile, 2 stages)": ("w8a8_dense.cu",
                                                      {"PINGPONG": 0, "STAGES": 2}, {}),
    "w8a8 ping-pong, 3 stages": ("w8a8_dense.cu", {"STAGES": 3}, {}),
    "w8a8 three warpgroups in turn, 64-row tiles, 3 stages": (
        "w8a8_dense.cu", {"NWG": 3, "BM": 64, "STAGES": 3}, {}),
    "w8a8 epilogue 1 row at a time": ("w8a8_dense.cu", {"EPI_ROWS": 1}, {}),
    "w8a8 epilogue 4 rows side by side": ("w8a8_dense.cu", {"EPI_ROWS": 4}, {}),
    "w8a8 quantize rows over 4096: 4 warps, 64 values a thread": (
        "w8a8_dense.cu", {}, {_LONG_ROWS: "quantize_rows<InT, 4, 8, 1><<<M, 128, 0, stream>>>"}),
    "w8a8 without the GELU (timing only)": ("w8a8_dense.cu", {}, {_GELU_MATH: "  if (false) {"}),
    "w8a8 GELU with tanh left out (timing only)": (
        "w8a8_dense.cu", {}, {_TANH: "t[i] = __fmul_rn(GELU_C, __fadd_rn(y[i], t[i]));"}),
    "mel shipped (64 frames, 2 groups per warp)": ("mel_kernel.cu", {}, {}),
    "mel 32-frame tiles": ("mel_kernel.cu", {"TF": 32}, {}),
    "mel 1 group per warp": ("mel_kernel.cu", {"GPW": 1, "MAX_WARPS": 26}, {}),
}
ROUNDS = 3
ROWS = 16 * 1500  # encoder rows of a batch of 16 windows
W8A8_SHAPES = (("large-v3-turbo fc1 + GELU", 1280, 5120, 1),
               ("large-v3-turbo fc2", 5120, 1280, 0),
               ("small fc1 + GELU", 768, 3072, 1))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="checkout whose two kernels to time as well")
    args = ap.parse_args(argv)

    import chip_smoke
    from yoho_tpu_torch.audio.filters import mel_filter_bank
    from yoho_tpu_torch.audio.frontend import log_mel_spectrogram, pad_for_convention
    from yoho_tpu_torch.ops import _build
    from yoho_tpu_torch.ops import mel_kernel as mk
    from yoho_tpu_torch.ops import w8a8_dense as w8

    print(chip_smoke.card_line(), flush=True)
    jobs = {}
    for name, (src, sub, lines) in VARIANTS.items():
        text = variant_source((_build.CSRC / src).read_text(), sub)
        for old, new in lines.items():
            if old not in text:
                raise ValueError(f"{name}: {old!r} not found")
            text = text.replace(old, new)
        jobs[name] = (text, _build.CSRC)
    if args.parent is not None:
        csrc = args.parent.resolve() / "yoho_tpu_torch" / "csrc"
        jobs["w8a8 parent"] = ((csrc / "w8a8_dense.cu").read_text(), csrc)
        jobs["mel parent"] = ((csrc / "mel_kernel.cu").read_text(), csrc)
    libs = build(jobs)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ptr, stream = _build.ptr, _build.stream_of

    def run(calls, check):
        """calls: name -> call(); times them in turns, ROUNDS rounds. Returns
        name -> median ms of the call, and of each of its kernels when it
        launches more than one (keyed by the kernel's name up to "<")."""
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            check(name)
        times = {name: [] for name in calls}
        for _ in range(ROUNDS):
            for name, call in calls.items():
                times[name].append(chip_smoke.kernel_ms(call, 20, flush))
        out = {}
        for name, runs in times.items():
            total = statistics.median(sum(r.values()) for r in runs)
            if len(runs[0]) == 1:
                out[name] = total
                continue
            out[name] = {"total": total}
            for kernel in runs[0]:
                out[name][kernel.split("<")[0].split("::")[-1]] = statistics.median(
                    r.get(kernel, 0.0) for r in runs)
        return out

    def entry(name, symbol, argtypes):
        fn = getattr(libs[name], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    for label, k, n, gelu in W8A8_SHAPES:
        x = torch.randn((ROWS, k), generator=gen, device=dev).to(torch.bfloat16)
        w_q, w_scale = w8.quantize_rows(torch.randn((n, k), generator=gen, device=dev) * 0.02)
        w_scale = w_scale[:, 0].contiguous()
        bias = torch.randn((n,), generator=gen, device=dev) * 0.02
        want = w8.w8a8_dense_reference(x, w_q, w_scale, bias,
                                       activation="gelu_tanh" if gelu else None)
        xq = torch.empty((ROWS, k), dtype=torch.int8, device=dev)
        xs = torch.empty((ROWS,), dtype=torch.float32, device=dev)
        out = torch.empty((ROWS, n), dtype=torch.bfloat16, device=dev)
        calls = {}
        for name in (nm for nm in libs if nm.startswith("w8a8")):
            fn = entry(name, "w8a8_dense", w8.KERNEL.argtypes)

            def call(fn=fn):
                err = fn(1, 1, ptr(x), ptr(w_q), ptr(w_scale), ptr(bias), ptr(xq), ptr(xs),
                         ptr(out), ROWS, n, k, gelu, stream(out))
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            calls[name] = call

        def check(name):
            if "timing only" not in name and not torch.equal(out, want):
                raise AssertionError(f"{name}: output differs from the plain version")
        print(json.dumps({"case": f"w8a8 {label} M={ROWS} K={k} N={n}",
                          "ms": run(calls, check)}), flush=True)
        del x, w_q, want, xq, out

    audio = torch.randn((16, 480_000), generator=gen, device=dev) * 0.1
    padded, frames = pad_for_convention(audio, 400, 160, "whisper")
    padded = padded.contiguous()
    for n_mels in (80, 128):
        kw = dict(sample_rate=16000, n_fft=400, hop=160, n_mels=n_mels, mel_scale="slaney",
                  convention="whisper", log_floor=1e-10)
        want = log_mel_spectrogram(audio, **kw)
        out = torch.empty((16, frames, n_mels), dtype=torch.float32, device=dev)
        consts = [torch.from_numpy(c).to(dev) for c in mk._constants(
            16000, 400, 160, n_mels, "slaney", False)]
        # An earlier tree's kernel takes the dense bases and filterbank.
        dense = [torch.from_numpy(c).to(dev) for c in (*mk._windowed(400, False), (
            mel_filter_bank(16000, 400, n_mels, mel_scale="slaney").T.copy()))]
        calls = {}
        for name in (nm for nm in libs if nm.startswith("mel")):
            fn = entry(name, "mel_log_spectrogram", mk.KERNEL.argtypes)
            c = dense if "const float* cos_w" in jobs[name][0] else consts

            def call(fn=fn, c=c):
                err = fn(ptr(padded), 16, padded.shape[1], frames, ptr(c[0]), ptr(c[1]),
                         ptr(c[2]), ptr(out), 400, 160, 201, n_mels, 1e-10, stream(out))
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            calls[name] = call

        def check(name):
            chip_smoke.check_close(name, out, want, 1e-4, 1e-4)
        print(json.dumps({"case": f"mel whisper {n_mels} mels 16x480000",
                          "ms": run(calls, check)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
