#!/usr/bin/env python3
"""Time variants of the flash and decode attention kernels on one NVIDIA GPU.

    python3 tools/attention_variants.py [--parent DIR] [--variants NAME,...]

Builds ``yoho_tpu_torch/csrc/flash_attention.cu``, ``decode_attention.cu``
(decode's FMA route: one query, f32 q) and ``decode_attention_mq.cu``
(its tensor-core route: several bf16 queries) once per variant below, each
with some of its constants or expressions replaced (one ``nvcc`` per
variant, all started together, into ``yoho_tpu_torch/_build/variants/``;
``--variants`` builds only the named ones); with ``--parent DIR`` also the
flash and both decode sources of another checkout (an earlier tree
unpacked there whose decode has both routes and whose flash takes the
KV-head count; built against its own headers and called through its own
C entry points), so that two trees are compared on one card in one run.
The parent's kernels are first held to the shipped ones bit for bit at
every head dim the parent takes (to 256): flash in f32 and bf16 at every
width and at padded head dims, equal and grouped heads, causal or not,
``kv_len`` inside a tile, Tq != Tk; decode over float, int8 and int4 K/V
at every width and padded head dims, one query in both types and f32 runs
of 4 (and 32 to width 128) on the FMA route, bf16 runs of 4, 32 and 224 on
the tensor-core route, no / scalar / per-row ``pos``, groups 1 and 2, every
load branch. One line per kernel route counts the cases, and the exit
code is 1 if any differs. Each variant is held to the plain
version (``chip_smoke.py``'s tolerances) and timed with ``chip_smoke.py``'s
``time_ms`` (device time, L2 flushed between calls) at the main paths'
shapes and the YOHO shapes (head dims 16, 32, 48, 64, 96 and 128 on grouped
K/V, which this tree's kernels read unexpanded), and decode's reads on
each route (the multi-query reads: prefills, folded beams, verify steps on
tensor cores) against the parent's same route, in turns (a variant marked "timing only"
leaves part of the work out and is not held to the plain version: it shows
where the time goes): every variant once forward and
once backward a round, three rounds, and the median is printed. "flash
padded to width 64" runs bf16 head dims 8-32 on the width-64 route, TMA
zero-filling the columns past D; "2 (3) consumer warpgroups" runs every
launch at widths 16-64 on two (three) instead of the count ``pick_nwg``
chooses. One JSON line per case; the first line is the card's name and power
limit. Needs CUDA; imports no JAX.
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

# The shipped width selection of the flash wgmma route, and the Geo lines
# that give width 128 its stages and Q buffers.
_FLASH_WIDTHS = "D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128"
_FLASH_ST = "ST = STAGES;"
_FLASH_QB = "QB = W == 128 ? 1 : QBUF;"

# The multi-query route's step width, its loop over a warp's steps, and its
# conversion of a chunk's codes.
_MQ_NG = "if (wm > 1) return launch<KIND, W, TC / 16, SPLIT>(a, wm, n_rt);"
_MQ_STEPS = "for (int tp = p0; has_rows && tp < p0 + ppw; tp += step) {"
_MQ_CONVERT = "      convert16<KIND, W>(st, tl, warp, lane, last);\n"

# name -> (source, replacements); "shipped" replaces nothing. A key that is a
# name replaces that constant's value; any other key is text, replaced once.
VARIANTS = {
    "flash shipped": ("flash_attention.cu", {}),
    "flash 2 consumer warpgroups": ("flash_attention.cu", {"NWG": 2}),
    "flash 3 consumer warpgroups": ("flash_attention.cu", {"NWG_ALT": 3}),
    "flash 4 stages": ("flash_attention.cu", {_FLASH_ST: "ST = W == 128 ? STAGES : 4;"}),
    "flash padded to width 64": ("flash_attention.cu",
                                 {_FLASH_WIDTHS: "D <= 64 ? 64 : 128"}),
    "flash width 128: 2 Q buffers, 2 stages": (
        "flash_attention.cu", {_FLASH_ST: "ST = W == 128 ? 2 : STAGES;",
                               _FLASH_QB: "QB = W == 128 ? 2 : QBUF;"}),
    "decode shipped": ("decode_attention.cu", {}),
    "decode 2 stages": ("decode_attention.cu", {"STAGES": 2}),
    "decode 8 warps (128-position chunks)": ("decode_attention.cu", {"WARPS": 8}),
    "decode clusters for 1 block per SM": ("decode_attention.cu", {"BLOCKS_PER_SM": 1}),
    "decode clusters for 4 blocks per SM": ("decode_attention.cu", {"BLOCKS_PER_SM": 4}),
    "decode_mq shipped": ("decode_attention_mq.cu", {}),
    "decode_mq 2 stages": ("decode_attention_mq.cu", {"STAGES": 2}),
    "decode_mq 4 stages": ("decode_attention_mq.cu", {"STAGES": 4}),
    "decode_mq clusters for 1 block per SM": ("decode_attention_mq.cu", {"BLOCKS_PER_SM": 1}),
    "decode_mq clusters for 4 blocks per SM": ("decode_attention_mq.cu", {"BLOCKS_PER_SM": 4}),
    "decode_mq one 16-position group a step at every row count": (
        "decode_attention_mq.cu",
        {_MQ_NG: "if (false) return launch<KIND, W, TC / 16, SPLIT>(a, wm, n_rt);"}),
    "decode_mq without the products (timing only)": ("decode_attention_mq.cu", {
        _MQ_STEPS: "for (int tp = p0; false && tp < p0 + ppw; tp += step) {"}),
    "decode_mq without the code conversion (timing only)": ("decode_attention_mq.cu", {
        _MQ_CONVERT: ""}),
}
ROUNDS = 3
# The parent's sources, by the name of their job.
PARENT_SOURCES = {"flash parent": "flash_attention.cu", "decode parent": "decode_attention.cu",
                  "decode_mq parent": "decode_attention_mq.cu"}
# The head dims the parity cases take: every width and padded dims (int4:
# even), up to the parent's widest, 256.
PARITY_FLASH_DIMS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 136, 200, 256)
PARITY_DECODE_DIMS = (8, 16, 32, 48, 64, 100, 128, 200, 256)


def variant_source(src: str, sub: dict) -> str:
    for key, val in sub.items():
        if key.isidentifier():
            src, n = re.subn(rf"constexpr int {key} = \d+", f"constexpr int {key} = {val}",
                             src, count=1)
        else:
            n = src.count(key)
            src = src.replace(key, val, 1)
        if n != 1:
            raise ValueError(f"{key!r} not found once")
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
    ap.add_argument("--parent", type=Path, help="checkout whose two kernels to hold the "
                                                 "shipped ones to and time as well")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS to build "
                                       "(default: all)")
    args = ap.parse_args(argv)

    import chip_smoke
    from yoho_tpu_torch.nn.kv_cache import QuantizedKV, quantize_kv, quantize_kv4
    from yoho_tpu_torch.ops import _build
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa

    print(chip_smoke.card_line(), flush=True)
    chosen = VARIANTS if args.variants is None else {
        n: VARIANTS[n] for n in args.variants.split(",")}
    jobs = {name: (variant_source((_build.CSRC / src).read_text(), sub), _build.CSRC)
            for name, (src, sub) in chosen.items()}
    if args.parent is not None:
        csrc = args.parent.resolve() / "yoho_tpu_torch" / "csrc"
        for name, src in PARENT_SOURCES.items():
            if name.replace("parent", "shipped") in jobs:  # the kernels chosen
                jobs[name] = ((csrc / src).read_text(), csrc)
    libs = build(jobs)
    fns = {}
    for name, lib in libs.items():
        flash = name.startswith("flash")
        fn = lib.flash_attention_forward if flash else \
            lib.decode_attention_mq if name.startswith("decode_mq") else lib.decode_attention
        fn.argtypes = (fa if flash else da).KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ptr, stream = _build.ptr, _build.stream_of

    def flash_call(name, q, k, v, out, causal=False, kv_len=None):
        b, s, h, d = q.shape
        t, hkv = k.shape[1], k.shape[2]

        def call():
            err = fns[name](1 if q.dtype == torch.bfloat16 else 0, ptr(q), ptr(k), ptr(v),
                            ptr(out), b, h, hkv, s, t, kv_len or t, d, d ** -0.5, int(causal),
                            stream(q))
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    def decode_call(name, q, k, v, ks, vs, out, pos=None, kv_len=None):
        """One call of a decode entry point (one launch)."""
        b, hq, s, d = q.shape
        rows = isinstance(pos, torch.Tensor)
        kind = "float" if ks is None else "int4" if k.dtype == torch.uint8 else "int8"

        def call():
            err = fns[name](1 if q.dtype == torch.bfloat16 else 0, da.KINDS.index(kind),
                            ptr(q), ptr(k), ptr(v), ptr(ks) if ks is not None else None,
                            ptr(vs) if vs is not None else None, ptr(out), b, hq, k.shape[1],
                            s, d, k.shape[3], kv_len or k.shape[3], int(pos is not None),
                            0 if pos is None or rows else pos, ptr(pos) if rows else None,
                            stream(q))
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    def same(calls, out):
        """Runs each call into ``out`` (NaN-filled first) and compares the
        bits; an output left non-finite counts as a difference."""
        got = []
        for call in calls:
            out.fill_(float("nan"))
            call()
            got.append(out.clone())
        torch.cuda.synchronize()
        bits = [g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32) for g in got]
        return bool(torch.isfinite(got[1]).all()) and torch.equal(*bits)

    def parity(kernel, cases):
        """cases: (label, out, {name: call}); prints the count, True if all equal."""
        n, bad = 0, []
        for label, out, calls in cases:
            n += 1
            if not same([calls[f"{kernel} parent"], calls[f"{kernel} shipped"]], out):
                bad.append(label)
        print(json.dumps({"parity": kernel, "against": str(args.parent), "cases": n,
                          "bit_identical": n - len(bad), "differ": bad[:40]}), flush=True)
        return not bad

    def flash_cases():
        """Every route the parent takes: f32 and bf16 at every width and
        padded head dims, equal and grouped heads."""
        for dtype in (torch.float32, torch.bfloat16):
            for d in PARITY_FLASH_DIMS:
                for causal, tq, t, kv_len, heads, kvh in (
                        (False, 300, 300, None, 3, 3), (True, 300, 300, None, 3, 3),
                        (False, 300, 300, 129, 3, 3), (True, 256, 256, 200, 2, 2),
                        (False, 6, 1500, None, 3, 3), (False, 512, 512, None, 6, 3),
                        (True, 130, 130, None, 4, 1)):
                    q = torch.randn((2, tq, heads, d), generator=gen, device=dev).to(dtype)
                    k, v = (torch.randn((2, t, kvh, d), generator=gen, device=dev).to(dtype)
                            for _ in range(2))
                    out = torch.empty_like(q)
                    yield (f"{str(dtype)[6:]} D={d} causal={causal} {tq}x{t} kv_len={kv_len} "
                           f"{heads} on {kvh}", out,
                           {n: flash_call(n, q, k, v, out, causal, kv_len)
                            for n in ("flash parent", "flash shipped")})

    def decode_cases(route):
        """The reads of one route ("fma": one query, f32 runs of 4 and 32;
        "mma": bf16 runs of 4, 32 and 224) at every width and padded head
        dims, every kind and load branch, no / scalar / per-row pos, groups
        1 and 2."""
        prefix = "decode_mq" if route == "mma" else "decode"
        for kind in da.KINDS:
            for d in PARITY_DECODE_DIMS:
                for q_dtype in (torch.float32, torch.bfloat16):
                    for t, kv_len in ((333, 300), (1500, 1500), (512, 512), (1536, 1500)):
                        kf, vf = (torch.randn((2, 2, d, t), generator=gen, device=dev)
                                  .to(torch.bfloat16) for _ in range(2))
                        kv = ((kf.to(q_dtype), vf.to(q_dtype), None, None) if kind == "float"
                              else (quantize_kv if kind == "int8" else quantize_kv4)(kf, vf))
                        kv = (kv.k_q, kv.v_q, kv.k_scale, kv.v_scale) \
                            if isinstance(kv, QuantizedKV) else kv
                        for s in (1, 4, 32, 224):
                            if da.kernel_route(s, q_dtype) != route or (
                                    route == "fma" and s > (32 if d <= 128 else 4)):
                                continue
                            for pos in (None, 100, torch.tensor([0, kv_len - s],
                                                                dtype=torch.int32, device=dev)):
                                for groups in (1, 2):
                                    q = (torch.randn((2, 2 * groups, s, d), generator=gen,
                                                     device=dev) * d ** -0.5).to(q_dtype)
                                    out = torch.empty((2, s, 2 * groups, d), dtype=q_dtype,
                                                      device=dev)
                                    p = "rows" if isinstance(pos, torch.Tensor) else pos
                                    yield (f"{kind} {str(q_dtype)[6:]} D={d} T={t} S={s} "
                                           f"pos={p} groups={groups}", out,
                                           {n: decode_call(n, q, *kv, out, pos, kv_len)
                                            for n in (f"{prefix} parent", f"{prefix} shipped")})

    ok = True
    if args.parent is not None:
        if "flash parent" in libs:
            ok &= parity("flash", flash_cases())
        if "decode parent" in libs:
            ok &= parity("decode", decode_cases("fma"))
        if "decode_mq parent" in libs:
            ok &= parity("decode_mq", decode_cases("mma"))

    def run(calls, check):
        """calls: name -> call(); times them in turns, ROUNDS rounds, each
        round every variant forward then backward."""
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            if "timing only" not in name:  # a variant that leaves work out
                check(name)
        times = {name: [] for name in calls}
        for _ in range(ROUNDS):
            for name in list(calls) + list(calls)[::-1]:
                times[name].append(chip_smoke.time_ms(calls[name], 20, flush))
        return {name: statistics.median(t) for name, t in times.items()}

    flash_names = [n for n in libs if n.startswith("flash")]
    for b, t, heads, kvh, d, causal in (
            (16, 1500, 12, 12, 64, False), (16, 1500, 20, 20, 64, False),
            (16, 448, 12, 12, 64, True), (16, 512, 24, 12, 16, False),
            (16, 512, 12, 6, 32, False), (16, 512, 4, 2, 128, False),
            (16, 512, 4, 2, 96, False), (16, 512, 6, 3, 64, False),
            (16, 256, 6, 3, 64, True), (16, 512, 8, 4, 48, False)):
        if not flash_names:
            break
        q = torch.randn((b, t, heads, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, t, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        out = torch.empty_like(q)
        want = fa.attention_reference(q, k, v, causal, d ** -0.5)

        def check(name):
            chip_smoke.check_close(name, out, want, 1e-2, 1e-2)
        print(json.dumps({"case": f"flash {b}x{t}x{heads} on {kvh}x{d} bf16"
                                  + (" causal" if causal else ""),
                          "route": fa.kernel_route(d), "width": fa.kernel_width(d),
                          "ms": run({n: flash_call(n, q, k, v, out, causal)
                                     for n in flash_names}, check),
                          "card": chip_smoke.card_line()}), flush=True)
        del q, k, v, out, want

    def kv(t, heads=12, d=64):
        return (torch.randn((16, heads, d, t), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))

    cross = quantize_kv(*kv(1500), pad_to=128)
    cache = quantize_kv(*kv(512))
    spread = torch.tensor([round(442 * i / 15) for i in range(16)], dtype=torch.int32,
                          device=dev)
    # (label, K/V, queries, pos, kv_len, query heads)
    cases = [("cross int8 S=1 (T 1536, kv_len 1500)", cross, 1, None, 1500, 12),
             ("self int8 S=1 pos=0", cache, 1, 0, 512, 12),
             ("self int8 S=1 pos=200", cache, 1, 200, 512, 12),
             ("self int8 S=1 pos=447", cache, 1, 447, 512, 12),
             ("cross bf16 S=1 (T 1500, the unquantized lane)", tuple(kv(1500)), 1, None, 1500,
              12),
             ("cross int8 S=2 (the draft's step; T 1536)", cross, 2, None, 1500, 12),
             ("cross int8 S=3 (prefill)", cross, 3, None, 1500, 12),
             ("cross int8 folded beams S=5 (T 1536, kv_len 1500)", cross, 5, None, 1500, 12),
             ("self int8 verify S=5 causal pos=200 (T 512)", cache, 5, 200, 512, 12),
             ("self int8 verify S=5 causal pos=447 (T 512)", cache, 5, 447, 512, 12),
             ("self int8 verify S=5 per-row pos 0..442 (T 512)", cache, 5, spread, 512, 12),
             ("self int8 prefill S=224 causal pos=0 (T 512)", cache, 224, 0, 512, 12),
             ("cross int8 prefill S=224", cross, 224, None, 1500, 12),
             ("cross int8 folded beam prefill S=1120", cross, 1120, None, 1500, 12)]
    for d, heads in ((16, 24), (32, 12), (128, 4)):
        cases.append((f"D={d} cross bf16 S=1, {heads} on {heads // 2} heads (T 512)",
                      tuple(kv(512, heads // 2, d)), 1, None, 512, heads))
    draft_cache, draft_cross = quantize_kv(*kv(512, 6)), quantize_kv(*kv(1500, 6), pad_to=128)
    cases += [("draft self int8 S=2 causal pos=199, 6 heads (T 512)", draft_cache, 2, 199, 512,
               6),
              ("draft cross int8 S=2, 6 heads (T 1536, kv_len 1500)", draft_cross, 2, None, 1500,
               6),
              ("yoho self bf16 S=5 causal pos=200, 6 on 3 heads (T 256)", tuple(kv(256, 3)), 5,
               200, 256, 6),
              ("yoho self bf16 S=1 causal pos=200, 6 on 3 heads (T 256)", tuple(kv(256, 3)), 1,
               200, 256, 6),
              ("yoho cross bf16 S=5, 6 on 3 heads (T 512)", tuple(kv(512, 3)), 5, None, 512, 6),
              ("D=256 cross bf16 S=1, 2 on 1 heads (T 512)", tuple(kv(512, 1, 256)), 1, None,
               512, 2),
              ("D=256 cross bf16 S=5, 2 on 1 heads (T 512)", tuple(kv(512, 1, 256)), 5, None,
               512, 2)]
    del cache
    for label, kvs, s, pos, kv_len, heads in cases:
        k_, v_, ks, vs = ((kvs.k_q, kvs.v_q, kvs.k_scale, kvs.v_scale)
                          if isinstance(kvs, QuantizedKV) else (*kvs, None, None))
        d = k_.shape[2] * (2 if k_.dtype == torch.uint8 else 1)
        route = da.kernel_route(s)
        names = [n for n in libs if n.startswith("decode_mq" if route == "mma" else "decode ")]
        if not names:
            continue
        q = (torch.randn((16, heads, s, d), generator=gen, device=dev) * d ** -0.5
             ).to(torch.bfloat16)
        out = torch.empty((16, s, heads, d), dtype=torch.bfloat16, device=dev)
        want = da.decode_attention_reference(q, k_, v_, ks, vs, pos, kv_len,
                                             groups=heads // k_.shape[1])

        def check(name):
            chip_smoke.check_close(name, out, want, 0.05, 0.02)
        print(json.dumps({"case": f"decode {label}", "route": route,
                          "ms": run({n: decode_call(n, q, k_, v_, ks, vs, out, pos, kv_len)
                                     for n in names}, check),
                          "card": chip_smoke.card_line()}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
