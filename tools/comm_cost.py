#!/usr/bin/env python3
"""Time the comm layer's collectives on the card, one call at a time.

    python3 tools/comm_cost.py [--calls N]

Starts a group of one process over NCCL (``parallel.mesh.make_mesh``, no
launcher) and times, at the shapes the whisper-small mesh path gives them,
each way of making one collective: ``parallel.mesh.all_reduce`` (the
port's: ``torch.distributed.all_reduce``), the same with ``async_op=True``
and a ``wait()``, PyTorch's functional collective
(``torch.distributed._functional_collectives.all_reduce`` and its
``wait_tensor``), and, for scale, one elementwise kernel on the same
tensor; then ``parallel.mesh.all_gather`` of the logits. Host time per
call: the wall of ``N`` calls in a row, then a synchronize. Device time
per call: ``torch.profiler`` over the same ``N`` calls, summed by kernel.

``--e2e`` then serves whisper-small (seed-0 random bf16 weights, int8
cross-K/V and cache, batch 16, ``chip_smoke.py``'s three requests) through
an unsharded ``Transcriber`` and one over the mesh of one, in turns
(plain, mesh, mesh, plain): the walls, and the caching allocator's device
allocations (``cudaMalloc`` calls) during each call; with ``--trace``
also one traced call of each (CPU and CUDA activity; slow): the host's
self time by op, top 15. The environment names PyTorch's NCCL settings
(``TORCH_NCCL_*``); the line prints those that are set. Then the mesh path
again with its collectives swapped out, to split its wall: the comm
layer's functions replaced by ones that return their input (the layout
alone: masked lookup, the slicing, no collective), and ``all_reduce``
issued with ``async_op=True`` and never waited on.

One JSON line per case; the first line is the card's name and power
limit. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _device_us(run) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            out[ev.key[:60]] = out.get(ev.key[:60], 0.0) + ev.self_device_time_total
    return out


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--e2e", action="store_true")
    parser.add_argument("--trace", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("comm_cost: CUDA is not available", file=sys.stderr)
        return 1
    from yoho_tpu_torch.parallel import mesh as pm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    mesh = pm.make_mesh(1, 1)
    group = mesh.group("model")
    n = args.calls

    def funcol_reduce(t):
        funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    def async_reduce(t):
        dist.all_reduce(t, group=group, async_op=True).wait()

    cases = {
        "elementwise add_ (one kernel, for scale)": lambda t: t.add_(0),
        "parallel.mesh.all_reduce (dist.all_reduce)": lambda t: pm.all_reduce(t, mesh),
        "dist.all_reduce(async_op=True).wait()": async_reduce,
        "functional all_reduce + wait_tensor": funcol_reduce,
    }
    shapes = {"decode step (16, 1, 768) bf16": ((16, 1, 768), torch.bfloat16),
              "encoder block (16, 1500, 768) bf16": ((16, 1500, 768), torch.bfloat16)}
    with torch.inference_mode():
        for shape_name, (shape, dtype) in shapes.items():
            t = torch.randn(shape, device=mesh.device).to(dtype)
            for name, fn in cases.items():
                for _ in range(20):
                    fn(t)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(t)
                torch.cuda.synchronize()
                host_us = (time.perf_counter() - t0) / n * 1e6
                dev = _device_us(lambda: [fn(t) for _ in range(n)])
                print(json.dumps(dict(case=name, shape=shape_name, calls=n,
                                      host_us_per_call=host_us,
                                      device_us_per_call={k: v / n for k, v in dev.items()},
                                      card=card)), flush=True)
        logits = torch.randn((16, 1, 51865), device=mesh.device)
        for _ in range(20):
            pm.all_gather(logits, mesh, "model", dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            pm.all_gather(logits, mesh, "model", dim=-1)
        torch.cuda.synchronize()
        print(json.dumps(dict(case="parallel.mesh.all_gather (list + cat)",
                              shape="logits (16, 1, 51865) f32", calls=n,
                              host_us_per_call=(time.perf_counter() - t0) / n * 1e6,
                              card=card)), flush=True)
    if args.e2e:
        _e2e(mesh, card, args.trace)
    pm.shutdown()
    return 0


def _e2e(mesh, card: str, trace: bool) -> None:
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    cfg = WHISPER_PRESETS["small"]
    audios = chip_smoke._requests()
    kw = dict(token_table=WhisperTokenTable(multilingual=True), batch_size=16,
              quantized_cross_kv="int8", quantized_cache=True, cache_dtype=torch.bfloat16)

    def build():
        return init_random(Whisper(cfg, dtype=torch.bfloat16), seed=0)

    paths = {"plain": Transcriber(build(), **kw), "mesh": Transcriber(build(), mesh=mesh, **kw)}
    walls = {"plain": [], "mesh": []}
    mallocs = {"plain": [], "mesh": []}
    for name in ("plain", "mesh", "mesh", "plain"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["num_device_alloc"]
        t0 = time.perf_counter()
        paths[name].transcribe_many(audios)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        mallocs[name].append(torch.cuda.memory_stats()["num_device_alloc"] - before)
    env = {k: v for k, v in os.environ.items() if k.startswith("TORCH_NCCL")}
    print(json.dumps(dict(case="whisper-small e2e wall, in turns", wall_s=walls,
                          device_allocs=mallocs, env=env, card=card)), flush=True)
    import torch.distributed as dist

    from yoho_tpu_torch.nn import layers
    from yoho_tpu_torch.parallel import mesh as pm

    def no_wait(t, mesh, axis="model", op="sum"):
        dist.all_reduce(t, group=mesh.group(axis), async_op=True)
        return t

    swaps = {"no collective": (lambda t, *a, **k: t, lambda t, *a, **k: t),
             "all_reduce not waited on": (no_wait, pm.all_gather)}
    saved = layers.all_reduce, layers.all_gather
    for name, (reduce, gather) in swaps.items():
        layers.all_reduce, layers.all_gather = reduce, gather
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths["mesh"].transcribe_many(audios)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            layers.all_reduce, layers.all_gather = saved
        print(json.dumps(dict(case=f"whisper-small mesh path, {name}", wall_s=wall,
                              card=card)), flush=True)
    for name, tr in paths.items() if trace else ():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.transcribe_many(audios)
            torch.cuda.synchronize()
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
        print(json.dumps(dict(case=f"{name}: host self ms by op (traced call)", card=card,
                              ops={e.key[:60]: [round(e.self_cpu_time_total / 1e3, 2), e.count]
                                   for e in top})), flush=True)


if __name__ == "__main__":
    sys.exit(main())
