#!/usr/bin/env python3
"""Drive the PyTorch port (``yoho_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --profile  # all phases; the second e2e run traced

Phases, one output line each (JSON after the phase name):

1. ``card``: name and power limit from ``nvidia-smi``, first as it prints
   them, then with the PyTorch and CUDA versions.
2. ``build``: compiles every kernel of ``yoho_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and prints the seconds.
3. ``kernel``: each kernel at the main path's shapes on the card against
   its plain PyTorch version on the same inputs, with the stated
   tolerance; its device time per call (``torch.profiler``, L2 flushed
   between calls), the plain version's, a PyTorch library call's
   where one computes the same function (a yardstick only: the port never
   calls it), and the bound: the larger of bytes over 3.35 TB/s and
   operations over the peak rate of their type (H100 SXM data sheet).
4. ``e2e``: whisper-small at full width with random bf16 weights from a
   seed, int8 cross-K/V and int8 self-cache, greedy decode with timestamps,
   batch 16, through ``Transcriber.transcribe_many`` on requests of 12 s,
   30 s and 75 s of synthetic audio. Checks: finite encoder output and
   logits that agree with the CPU plain path on one window, the same
   tokens on a second run, and every kernel launched during the run.
   With ``--profile`` the second run's device activity is traced with
   ``torch.profiler`` and a ``profile`` line gives the device time by
   kernel and the device's busy share of the untraced run's wall time.
5. ``kernels``: one JSON object with every kernel's numbers.
6. The last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Needs CUDA and the
``yoho_tpu_torch`` package beside this file; imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
SEED = 0


def emit(phase: str, **fields) -> None:
    print(f"{phase} {json.dumps(fields, sort_keys=True)}", flush=True)


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_us_by_kernel(run) -> dict:
    """Runs ``run`` under ``torch.profiler`` (CUDA activity only) and
    returns the device time of each kernel, memcpy and memset, in us."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0.0) + ev.self_device_time_total
    return out


def time_ms(fn, iters: int, flush) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels it launches, averaged over ``iters`` calls (host time between
    launches is not counted). ``flush`` (a buffer larger than the 50 MB
    L2) is rewritten before each call so inputs come from memory, as
    they do on the main path; the flush's own kernels are left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    flush_names = set(_device_us_by_kernel(lambda: flush.zero_()))

    def body():
        for _ in range(iters):
            flush.zero_()
            fn()

    us = _device_us_by_kernel(body)
    return sum(v for k, v in us.items() if k not in flush_names) / iters / 1e3


def check_close(name, got, want, rtol, atol) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, rtol {rtol}, atol {atol})")
    return err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_checks(card: str) -> dict:
    """Phase 3: every kernel against its plain version at the main path's
    shapes (whisper-small, batch 16). Returns the JSON entry per kernel."""
    import torch

    from yoho_tpu_torch.audio.frontend import log_mel_spectrogram
    from yoho_tpu_torch.nn.kv_cache import quantize_kv, quantize_kv4
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa
    from yoho_tpu_torch.ops import mel_kernel as mk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    entries = {}

    def record(kernel, case, err, ms, plain_ms, nbytes, flops, kind, library_ms,
               tol, main=True):
        b_ms, b_by = bound(nbytes, flops, kind)
        emit("kernel", name=kernel.name, case=case, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
             bound_by=b_by, bound_from=f"{nbytes:.0f} B, {flops:.0f} {kind} ops",
             tolerance=tol, card=card)
        if main:
            entries[kernel.name] = dict(
                name=kernel.name, route="cuda",
                source=f"yoho_tpu_torch/csrc/{kernel.source}",
                replaces=kernel.replaces.split()[0], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)

    # Kernel 1: the log-mel frontend of 16 windows of 30 s.
    b, n = 16, 480_000
    audio = torch.randn((b, n), generator=gen, device=dev) * 0.1
    kw = dict(sample_rate=16000, n_fft=400, hop=160, n_mels=80,
              mel_scale="slaney", convention="whisper", log_floor=1e-10)
    got = mk.fused_log_mel(audio, **kw)
    want = log_mel_spectrogram(audio, **kw)
    err = check_close("mel", got, want, 1e-4, 1e-4)
    frames, n_freq = 3000, 201
    flops = b * frames * (4 * 400 * n_freq + 3 * n_freq + 2 * n_freq * 80)
    nbytes = audio.numel() * 4 + got.numel() * 4 + 2 * 400 * n_freq * 4 + n_freq * 80 * 4
    record(mk.KERNEL, "whisper 16x480000", err,
           time_ms(lambda: mk.fused_log_mel(audio, **kw), 20, flush),
           time_ms(lambda: log_mel_spectrogram(audio, **kw), 5, flush),
           nbytes, flops, "fp32", None, "rtol 1e-4, atol 1e-4")
    sc = audio[:2, :16000 * 10]
    skw = dict(kw, convention="scipy", mel_scale="htk", log_floor=1e-13)
    err = check_close("mel scipy", mk.fused_log_mel(sc, **skw),
                      log_mel_spectrogram(sc, **skw), 1e-3, 2e-3)
    emit("kernel", name=mk.KERNEL.name, case="scipy 2x160000", max_abs_err=err,
         tolerance="rtol 1e-3, atol 2e-3")

    # Kernel 2: encoder self-attention, (16, 1500, 12, 64) bf16, scale 1/8.
    shape = (16, 1500, 12, 64)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    scale = 64 ** -0.5
    got = fa.flash_attention(q, k, v, scale=scale)
    err = check_close("flash", got, fa.attention_reference(q, k, v, False, scale),
                      1e-2, 1e-2)
    err_c = check_close("flash causal", fa.flash_attention(q[:2], k[:2], v[:2], True, scale),
                        fa.attention_reference(q[:2], k[:2], v[:2], True, scale), 1e-2, 1e-2)
    emit("kernel", name=fa.KERNEL.name, case="causal 2x1500", max_abs_err=err_c,
         tolerance="rtol 1e-2, atol 1e-2")

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)

    flops = 4 * 16 * 12 * 1500 * 1500 * 64
    record(fa.KERNEL, "encoder 16x1500x12x64 bf16", err,
           time_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 5, flush),
           time_ms(lambda: fa.attention_reference(q, k, v, False, scale), 3, flush),
           4 * q.numel() * 2, flops, "bf16", time_ms(sdpa, 5, flush),
           "rtol 1e-2, atol 1e-2")
    del q, k, v

    # Kernel 3: decode reads. Cross: int8 (16, 12, 64, 1500); self: int8
    # cache (16, 12, 64, 512) read causally at pos.
    def kv(t, shape_d=64):
        return (torch.randn((16, 12, shape_d, t), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))

    def q_of(s):
        return (torch.randn((16, 12, s, 64), generator=gen, device=dev) * 0.35
                ).to(torch.bfloat16)

    def case(label, qq, k_, v_, ks, vs, pos, packing, main=False, library=None):
        args = (qq, k_, v_, ks, vs, pos, None, 1, packing)
        got = da.fused_decode_attention(*args)
        err = check_close(f"decode {label}", got, da.decode_attention_reference(*args),
                          0.05, 0.02)
        t = k_.shape[3]
        t_read = min(t, pos + qq.shape[2]) if pos is not None else t
        per_pos = k_.shape[0] * k_.shape[1] * k_.shape[2] * k_.element_size() * 2
        nbytes = per_pos * t_read + (ks is not None) * 2 * 16 * 12 * t_read * 2 \
            + 2 * qq.numel() * 2
        flops = 4 * 16 * 12 * qq.shape[2] * t_read * 64
        record(da.KERNEL, label, err, time_ms(lambda: da.fused_decode_attention(*args), 50, flush),
               time_ms(lambda: da.decode_attention_reference(*args), 10, flush),
               nbytes, flops, "bf16", library() if library else None,
               "rtol 0.05, atol 0.02", main=main)

    cross = quantize_kv(*kv(1500))
    case("cross int8 S=1", q_of(1), cross.k_q, cross.v_q, cross.k_scale,
         cross.v_scale, None, 1, main=True)
    case("cross int8 S=3 (prefill)", q_of(3), cross.k_q, cross.v_q, cross.k_scale,
         cross.v_scale, None, 1)
    self_kv = quantize_kv(*kv(512))
    case("self int8 S=1 pos=200", q_of(1), self_kv.k_q, self_kv.v_q,
         self_kv.k_scale, self_kv.v_scale, 200, 1)
    c4 = quantize_kv4(*kv(1500))
    case("cross int4 S=1", q_of(1), c4.k_q, c4.v_q, c4.k_scale, c4.v_scale, None, 2)
    kb, vb = kv(1500)
    qb = q_of(1)

    def sdpa_decode():
        return torch.nn.functional.scaled_dot_product_attention(
            qb, kb.transpose(2, 3), vb.transpose(2, 3), scale=1.0)

    case("cross bf16 S=1", qb, kb, vb, None, None, None, 1, library=lambda: time_ms(
        sdpa_decode, 50, flush))
    return entries


class _IdText:
    """Renders token ids as numbers: random weights have no vocabulary."""

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _profiled(fn):
    """Runs ``fn`` with its device activity traced; returns its result and
    the device time per kernel name (ms)."""
    box = []
    us = _device_us_by_kernel(lambda: box.append(fn()))
    return box[0], {k: v / 1e3 for k, v in us.items()}


def e2e(card: str, kernels, trace: bool = False) -> dict:
    """Phase 4: whisper-small served end to end through the port."""
    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    cfg = WHISPER_PRESETS["small"]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    rng = np.random.default_rng(SEED)
    seconds = (12, 30, 75)
    audios = [(0.1 * rng.standard_normal(s * 16000)).astype(np.float32)
              for s in seconds]

    # Reference on a small input: one window through the card's kernels
    # against the CPU plain path in float32 with the same weights.
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"))
        xa = model.encode_audio(mel)
        prompt = torch.as_tensor([table.sot_sequence("en")], device="cuda")
        logits, _ = model.decode_step(prompt, model.init_caches(1, quantized=True),
                                      model.cross_kvs(xa, "int8"), 0)
        if not (torch.isfinite(xa).all() and torch.isfinite(logits).all()):
            raise AssertionError("non-finite encoder output or logits")
        if xa.shape != (1, 1500, 768) or logits.shape != (1, 3, cfg.n_vocab):
            raise AssertionError(f"shapes {tuple(xa.shape)}, {tuple(logits.shape)}")
        ref = Whisper(cfg, dtype=torch.float32, device="cpu")
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        xa_ref = ref.encode_audio(mel.cpu())
        logits_ref, _ = ref.decode_step(prompt.cpu(), ref.init_caches(1),
                                        ref.cross_kvs(xa_ref), 0)
        rel_xa = float((xa.float().cpu() - xa_ref).norm() / xa_ref.norm())
        rel_lg = float((logits.cpu() - logits_ref).norm() / logits_ref.norm())
        if rel_xa > 3e-2 or rel_lg > 5e-2:
            raise AssertionError(f"card vs CPU reference: encoder rel err {rel_xa}, "
                                 f"logits rel err {rel_lg}")
        emit("reference", window=1, encoder_rel_err=rel_xa, logits_rel_err=rel_lg,
             tolerance="encoder 3e-2, logits 5e-2 (bf16 card vs f32 CPU)")
        del ref

    tr = Transcriber(model, token_table=table, batch_size=16,
                     quantized_cross_kv="int8", quantized_cache=True,
                     cache_dtype=torch.bfloat16)
    runs = []
    for i in range(2):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if trace and i == 1:
            results, by_name = _profiled(lambda: tr.transcribe_many(audios))
        else:
            results = tr.transcribe_many(audios)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((wall, results, {k.name: k.launches for k in kernels}))
    if trace:
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        emit("profile", run="second e2e run, device activity traced",
             traced_wall_ms=runs[1][0] * 1e3, untraced_wall_ms=runs[0][0] * 1e3,
             device_busy_ms=busy, device_busy_share=busy / (runs[0][0] * 1e3),
             top_device_ms={k[:90]: round(v, 3) for k, v in top}, card=card)
    (wall, results, launches), (wall2, results2, _) = runs
    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    if toks != [[t for s in r.segments for t in s.tokens] for r in results2]:
        raise AssertionError("second run gave other tokens")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    n_tok = sum(len(t) for t in toks)
    # Two decode-attention launches (self, cross) per layer per step.
    steps = launches["decode_attention"] // (2 * cfg.n_text_layer)
    emit("e2e", model="whisper-small", batch=16, requests=list(seconds),
         windows=5, wall_s=wall, wall_s_second_run=wall2,
         audio_s_per_s=sum(seconds) / wall, segment_tokens=n_tok,
         tokens_per_s=n_tok / wall, decode_steps=steps,
         batch_tokens_per_s=16 * steps / wall, launches=launches, card=card)
    return launches


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "yoho_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: no yoho_tpu_torch package beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))

    card = card_line()
    print(card, flush=True)  # name and power limit, as nvidia-smi prints them
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    from yoho_tpu_torch.ops import _build
    from yoho_tpu_torch.ops import decode_attention, flash_attention, mel_kernel

    t0 = time.perf_counter()
    per_source = _build.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source)

    kernels = [mel_kernel.KERNEL, flash_attention.KERNEL, decode_attention.KERNEL]
    entries = kernel_checks(card)
    launches = e2e(card, kernels, "--profile" in argv)
    print(json.dumps({"kernels": [
        dict(entries[k.name], launches=launches[k.name]) for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
