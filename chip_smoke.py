#!/usr/bin/env python3
"""Drive the PyTorch port (``yoho_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --profile  # all phases; the second e2e run traced

Phases, one output line each (JSON after the phase name):

1. ``card``: name and power limit from ``nvidia-smi``, first as it prints
   them, then with the PyTorch and CUDA versions.
2. ``build``: compiles every kernel of ``yoho_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and prints the seconds.
3. ``kernel``: each kernel at the main paths' shapes on the card against
   its plain PyTorch version on the same inputs, with the stated
   tolerance; its device time per call (``torch.profiler``, L2 flushed
   between calls), the plain version's, a PyTorch library call's
   where one computes the same function (a yardstick only: the port never
   calls it), and the bound: the largest of bytes over 3.35 TB/s and the
   operations of each type over that type's peak rate (H100 SXM data
   sheet), counted for the work the design runs (the mel kernel's three
   TF32 products; its FP32-only figure beside it).
   The w8a8 cases also time two labelled yardsticks: ``torch._int_mm`` on
   the pre-quantized operands (the int8 product alone) and bf16
   ``F.linear`` (+ tanh-GELU), what the bf16 lane computes, and split the
   kernel's time into its row-quantize pass and its GEMM; the mel cases
   time a ``torch.stft`` yardstick (cuFFT, not the same rounding). Flash
   runs at whisper-small's 12, turbo's 20 and whisper-tiny's 6 heads
   (SDPA's time beside each), and at the alignment pass's causal 448 x 448
   and cross 448 x 1500; decode attention on the
   cross K/V padded to 1536 positions (kv_len 1500) as the main path
   stores them, for prefill, and on the self cache at pos 0, 200 and 447;
   beam search's folded cross read (5 queries a stream), a 224-token
   prompt's prefill (7 launches of 32 queries) on the cache and on the
   cross K/V, the folded beam prefill of that prompt (35 launches), the
   unpadded bf16 cross read of language detection, speculative decoding's
   5-query verify read, causal on the cache at pos 200 and 447, the
   draft's 2-query reads at 6 heads on its cache and cross K/V, and
   continuous batching's reads of the cache with one position per row (16
   rows spread from 0 to 447, all at 200, all at 0, and the 5-query verify
   read at spread positions), whose bound counts each row's valid prefix.
4. ``e2e``: whisper-small at full width with random bf16 weights from a
   seed, int8 cross-K/V and int8 self-cache, greedy decode with timestamps,
   batch 16, through ``Transcriber.transcribe_many`` on requests of 12 s,
   30 s and 75 s of synthetic audio. Checks: finite encoder output and
   logits that agree with the CPU plain path on one window, the same
   tokens on a second run, and the kernels of the path (all but w8a8)
   launched during the run.
5. ``e2e-int8``: the same for whisper large-v3-turbo (1280 wide, 32
   encoder and 4 decoder layers, 128 mels, vocab 51866) with its random
   bf16 weights quantized on the card into both int8 lanes
   (``encoder_int8``: W8A8 encoder MLPs through the w8a8 kernel;
   ``weights_int8``: int8 decoder weights and tied embedding) and
   ``fast_gelu``; the CPU reference is the same quantized model in f32,
   and every kernel, w8a8 included, must launch.
6. ``e2e-options``: whisper-small at full width and depth (random bf16
   weights, int8 cross-K/V and cache, batch 16, the same three requests)
   through one ``Transcriber`` with beams 5, ``language=None``, word
   timestamps, hotwords, a logit bias, ``repetition_penalty`` 1.1,
   ``no_repeat_ngram_size`` 3 and a 224-token per-request prompt on the
   75 s request; ``transcribe_many`` twice (the same tokens and word
   timings both times), then ``condition_on_previous_text`` on the 75 s
   request. Checks: the language logits, one folded beam step's logits
   and the alignment map of one window against the CPU plain path in
   float32; a hook on the decode kernel's launch counts every read's
   (rows, queries, positions) and holds them to the beam arithmetic
   (per layer: the detection step, each batch's prefill in 32-query
   chunks, one self read at 80 rows and one folded cross read of 5
   queries at 16 rows per step; no cross read at 80 rows).
   With ``--profile`` each path's second run is traced with
   ``torch.profiler`` and a ``profile`` line gives the device time of the
   top kernels and of each of the port's own kernel functions, and the
   device's busy share of the untraced run's wall time; the trace must
   hold no combine kernel (decode attention is one launch).
7. ``e2e-files``: whisper-small as in ``e2e``, with ``vad_filter`` and
   ``hallucination_silence_threshold`` 2.0, on the same three requests
   written as files: 12 s as a stereo int16 WAV at 44.1 kHz, 30 s as a
   16-bit FLAC from the port's encoder, 75 s as a mono int16 WAV at 16 kHz
   with 20 s of zeros in the middle. Checks: the decoded samples equal the
   port's ``resample`` of the written arrays within one int16 step, the
   75 s request's speech map leaves the zeros out, the same tokens on a
   second call, every segment inside its request, and mel, flash and
   decode attention launched. It prints which decoder read the FLAC and
   the windows decoded with and without the VAD.
8. ``e2e-spec``: whisper-small (bf16, int8 cross-K/V and cache, batch 16)
   decoding speculatively at gamma 4 on the three requests, with two
   drafts: whisper-tiny with random weights from seed 1 (it mostly
   disagrees: the low-acceptance worst case) and the target itself (every
   round commits gamma + 1 tokens but at ties). Checks: one verify step's
   logits against the CPU plain path in float32; a hook on the decode
   kernel's launch holds every read to the round arithmetic (per batch the
   prompt's prefill by both models; per round and draft layer one S = 2
   step and gamma - 1 S = 1 steps at the draft's heads, then per target
   layer one 5-query verify step; each a causal read of the cache and a
   read of the cross K/V at 16 rows); one host sync per round; each row's
   tokens equal greedy's (the ``e2e`` configuration, run again with its
   processed logits recorded) up to its first difference, and there the
   greedy top-2 margin is at most 4 bf16 ulps of the larger logit. It
   prints per draft the wall, audio-s/s, rounds, tokens committed per
   round, host syncs, the rows that diverge and the decode launches by
   shape; ``phase-wall`` lines give each of the two phases' seconds.
9. ``e2e-serve``: whisper-small (random bf16 weights, int8 cross-K/V and
   cache, timestamps, 16 slots, ``chunk_tokens`` 16) served continuously.
   (a) ``SlotEngine`` with a fixed schedule: the 5 windows of the three
   requests in four waves, admitted before chunks 0, 2, 5 and 9 (20
   windows for 16 slots); (b) ``serve(transcriber, port=0, continuous=
   True)`` after ``warmup``, with the three requests to ``POST
   /transcribe``, the 30 s request to ``/v1/audio/transcriptions`` as
   verbose_json and srt, and a ``/stream`` WebSocket session of the 75 s
   request in 1 s frames, all at once, then the same with
   ``continuous=False`` (the micro-batcher); (c) the speculative slots,
   gamma 4 with the target as its own draft, the 5 windows admitted one
   per chunk. Checks: every decoded window equals greedy's (the ``e2e``
   configuration, one batch of every distinct window) up to its first
   difference, where greedy's top-2 margin is at most 4 bf16 ulps; a hook
   on the decode kernel's launch sees every causal read inside a chunk at
   per-row positions (16 rows; S = 5 verify reads in (c)) and none at a
   scalar one; each chunk runs under PyTorch's sync debug mode set to
   raise (no host sync inside a chunk) and each ``reap`` makes one;
   ``/statz`` and ``/metrics`` count the requests, the responses hold
   ``transcribe_many``'s segments where no window left greedy, and
   ``drain`` returns. It prints per part the wall and audio-s/s, the
   chunks, host syncs and slot occupancy per chunk, the requests served
   and the decode launches by (rows, queries, per-row, scalar or no
   position); a ``phase-wall`` line gives the phase's seconds.
10. ``kernels``: one JSON object with every kernel's numbers; launches are
   summed over the e2e paths' first runs (and the conditioning call),
   ``e2e-files``' first call and every ``e2e-spec`` and ``e2e-serve`` run.
11. The last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Needs CUDA and the
``yoho_tpu_torch`` package beside this file; imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}
SEED = 0
BATCH, ENC_CTX = 16, 1500      # the e2e batch, and encoder positions per window


def emit(phase: str, **fields) -> None:
    print(f"{phase} {json.dumps(fields, sort_keys=True)}", flush=True)


def bound(nbytes: float, ops: dict):
    """The least time (ms) for ``nbytes`` of memory traffic and ``ops``
    operations by type, each type at its own peak (tensor cores and FP32
    units run side by side): the largest of these times, and whether bytes
    or operations set it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_FLOPS[kind] for kind, n in ops.items()) * 1e3
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


def _port_kernels(by_name: dict) -> dict:
    """Device ms of the port's own kernels (the functions of ``csrc/``, in
    anonymous namespaces), summed by function name."""
    out = {}
    for name, ms in by_name.items():
        m = re.search(r"\(anonymous namespace\)::(?:\w+::)*(\w+)", name)
        if m and "at::native" not in name:
            out[m.group(1)] = round(out.get(m.group(1), 0.0) + ms, 3)
    return out


def kernel_ms(fn, iters: int, flush) -> dict:
    """Device time of one call of ``fn`` per kernel name (ms), averaged
    over ``iters`` calls (host time between launches is not counted).
    ``flush`` (a buffer larger than the 50 MB L2) is rewritten before each
    call so inputs come from memory, as they do on the main path; the
    flush's own kernels are left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    flush_names = set(_device_us_by_kernel(lambda: flush.zero_()))

    def body():
        for _ in range(iters):
            flush.zero_()
            fn()

    for _ in range(3):  # a trace that kept no kernel of the call is taken again
        us = _device_us_by_kernel(body)
        out = {k: v / iters / 1e3 for k, v in us.items() if k not in flush_names}
        if out:
            return out
    raise RuntimeError("the profiler recorded no kernel of the call")


def time_ms(fn, iters: int, flush) -> float:
    """The summed device time of the kernels of one call of ``fn`` (ms);
    see ``kernel_ms``."""
    return sum(kernel_ms(fn, iters, flush).values())


def yardstick_ms(fn, flush):
    """``time_ms`` of a library call that is only a yardstick: a call this
    PyTorch build refuses is reported as its error, not a failure."""
    try:
        return time_ms(fn, 20, flush)
    except RuntimeError as e:
        return f"not measured: {str(e).splitlines()[0][:160]}"


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
    """Phase 3: every kernel against its plain version at the main paths'
    shapes (batch 16: whisper-small, and large-v3-turbo for the mel at 128
    and the w8a8 kernel). Returns the JSON entry per kernel."""
    import torch

    from yoho_tpu_torch.audio.filters import mel_filter_bank
    from yoho_tpu_torch.audio.frontend import log_mel_spectrogram
    from yoho_tpu_torch.nn.kv_cache import quantize_kv, quantize_kv4
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa
    from yoho_tpu_torch.ops import mel_kernel as mk
    from yoho_tpu_torch.ops import w8a8_dense as w8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    entries = {}

    def record(kernel, case, err, ms, plain_ms, nbytes, ops, library_ms, tol, main=True,
               **extra):
        b_ms, b_by = bound(nbytes, ops)
        emit("kernel", name=kernel.name, case=case, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
             bound_from=f"{nbytes:.0f} B, " + ", ".join(
                 f"{n:.0f} {kind} ops" for kind, n in ops.items()),
             tolerance=tol, card=card, **extra)
        if main:
            entries[kernel.name] = dict(
                name=kernel.name, route="cuda",
                source=f"yoho_tpu_torch/csrc/{kernel.source}",
                replaces=kernel.replaces.split()[0], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)

    # Kernel 1: the log-mel frontend of 16 windows of 30 s, at whisper-small's
    # 80 mels and large-v3-turbo's 128.
    b, n, frames, n_fft, hop, n_freq = 16, 480_000, 3000, 400, 160, 201
    audio = torch.randn((b, n), generator=gen, device=dev) * 0.1
    kw = dict(sample_rate=16000, n_fft=n_fft, hop=hop, n_mels=80,
              mel_scale="slaney", convention="whisper", log_floor=1e-10)
    hann = torch.hann_window(n_fft, periodic=True, device=dev)
    for n_mels, main in ((80, True), (128, False)):
        kwm = dict(kw, n_mels=n_mels)
        got = mk.fused_log_mel(audio, **kwm)
        err = check_close(f"mel {n_mels}", got, log_mel_spectrogram(audio, **kwm), 1e-4, 1e-4)
        consts = mk._constants(16000, n_fft, hop, n_mels, "slaney", False)
        nnz = int(consts[1][-1])  # mel weights the sparse projection reads
        # The design's work: three TF32 products (frames x n_fft) x
        # (n_fft x 2 n_freq) on the tensor cores; the power (3 operations
        # per bin) and the sparse mel projection (2 per weight) in FP32.
        # The FP32-only figure is the same DFT on FMAs, the route of PR 1.
        tf32_ops = 3 * 2 * b * frames * n_fft * 2 * n_freq
        fp32_ops = b * frames * (3 * n_freq + 2 * nnz)
        nbytes = audio.numel() * 4 + got.numel() * 4 + sum(c.nbytes for c in consts)
        filt_t = torch.from_numpy(mel_filter_bank(16000, n_fft, n_mels, mel_scale="slaney")).to(dev)

        def stft_log_mel():
            spec = torch.stft(audio, n_fft, hop, window=hann, center=True, pad_mode="reflect",
                              return_complex=True)
            power = spec[..., :-1].abs() ** 2
            return torch.log10(torch.clamp_min(filt_t @ power, 1e-10))

        record(mk.KERNEL, f"whisper {n_mels} mels 16x480000", err,
               time_ms(lambda: mk.fused_log_mel(audio, **kwm), 20, flush),
               time_ms(lambda: log_mel_spectrogram(audio, **kwm), 5, flush),
               nbytes, {"tf32": tf32_ops, "fp32": fp32_ops}, None, "rtol 1e-4, atol 1e-4",
               main=main,
               bound_fp32_route_ms=bound(nbytes, {"fp32": 2 * b * frames * n_fft * 2 * n_freq
                                                  + fp32_ops})[0],
               yardsticks={"stft_log_mel_ms (torch.stft + |.|^2 + mel matmul + log10: "
                           "cuFFT, other rounding, (B, mels, frames) layout)":
                           yardstick_ms(stft_log_mel, flush)})
    sc = audio[:2, :16000 * 10]
    skw = dict(kw, convention="scipy", mel_scale="htk", log_floor=1e-13)
    err = check_close("mel scipy", mk.fused_log_mel(sc, **skw),
                      log_mel_spectrogram(sc, **skw), 1e-3, 2e-3)
    emit("kernel", name=mk.KERNEL.name, case="scipy 2x160000", max_abs_err=err,
         tolerance="rtol 1e-3, atol 2e-3")
    del audio, got

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
           4 * q.numel() * 2, {"bf16": flops}, time_ms(sdpa, 5, flush),
           "rtol 1e-2, atol 1e-2")
    del q, k, v
    # large-v3-turbo's encoder: 20 heads.
    q, k, v = (torch.randn((16, 1500, 20, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    err = check_close("flash turbo", fa.flash_attention(q, k, v, scale=scale),
                      fa.attention_reference(q, k, v, False, scale), 1e-2, 1e-2)
    record(fa.KERNEL, "encoder 16x1500x20x64 bf16 (large-v3-turbo)", err,
           time_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 5, flush),
           time_ms(lambda: fa.attention_reference(q, k, v, False, scale), 3, flush),
           4 * q.numel() * 2, {"bf16": 4 * 16 * 20 * 1500 * 1500 * 64}, time_ms(sdpa, 5, flush),
           "rtol 1e-2, atol 1e-2", main=False)
    del q, k, v
    # whisper-tiny's encoder, the draft of phase e2e-spec: 6 heads.
    q, k, v = (torch.randn((16, 1500, 6, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    err = check_close("flash tiny", fa.flash_attention(q, k, v, scale=scale),
                      fa.attention_reference(q, k, v, False, scale), 1e-2, 1e-2)
    record(fa.KERNEL, "encoder 16x1500x6x64 bf16 (whisper-tiny, the draft)", err,
           time_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 5, flush),
           time_ms(lambda: fa.attention_reference(q, k, v, False, scale), 3, flush),
           4 * q.numel() * 2, {"bf16": 4 * 16 * 6 * 1500 * 1500 * 64}, time_ms(sdpa, 5, flush),
           "rtol 1e-2, atol 1e-2", main=False)
    del q, k, v
    # The alignment pass of word timestamps (phase e2e-options): the
    # teacher-forced decoder's causal self-attention over 448 tokens and
    # its cross-attention of 448 queries over 1500 encoder positions.
    for label, tq, tk, causal in (("decoder causal 16x448x12x64 bf16", 448, 448, True),
                                  ("decoder cross 16x448 over 1500, 12 heads bf16",
                                   448, 1500, False)):
        q = torch.randn((16, tq, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((16, tk, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        err = check_close(f"flash {label}", fa.flash_attention(q, k, v, causal, scale),
                          fa.attention_reference(q, k, v, causal, scale), 1e-2, 1e-2)
        pairs = tq * (tq + 1) // 2 if causal else tq * tk

        def sdpa_tf(q=q, k=k, v=v, causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
                scale=scale)

        record(fa.KERNEL, label, err,
               time_ms(lambda: fa.flash_attention(q, k, v, causal, scale), 20, flush),
               time_ms(lambda: fa.attention_reference(q, k, v, causal, scale), 5, flush),
               (q.numel() * 2 + k.numel() + v.numel()) * 2, {"bf16": 4 * 16 * 12 * pairs * 64},
               time_ms(sdpa_tf, 20, flush), "rtol 1e-2, atol 1e-2", main=False)
        del q, k, v

    # Kernel 3: decode reads. Cross: int8 (16, 12, 64, 1536) padded from
    # 1500 (kv_len 1500), the layout of the main path; self: int8 cache
    # (16, 12, 64, 512) read causally up to pos.
    def kv(t, heads=12):
        return (torch.randn((16, heads, 64, t), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))

    def q_of(s, heads=12):
        return (torch.randn((16, heads, s, 64), generator=gen, device=dev) * 0.35
                ).to(torch.bfloat16)

    def case(label, qq, k_, v_, ks, vs, pos, packing, kv_len=None, main=False, library=None,
             **extra):
        """One decode read against its plain version; ``pos`` None, an int,
        or a list (one position per row: continuous batching's per-row
        causal read, passed as an int32 tensor on the card)."""
        b_, h_, s_ = qq.shape[:3]
        rows = [pos] * b_ if pos is None or isinstance(pos, int) else list(pos)
        if not (pos is None or isinstance(pos, int)):
            pos = torch.tensor(rows, dtype=torch.int32, device=dev)
        args = (qq, k_, v_, ks, vs, pos, kv_len, 1, packing)
        before = da.KERNEL.launches
        got = da.fused_decode_attention(*args)
        launches = da.KERNEL.launches - before
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"decode {label}: non-finite output")
        err = check_close(f"decode {label}", got, da.decode_attention_reference(*args),
                          0.05, 0.02)
        # The positions this call needs, row by row: those below kv_len and
        # the row's pos + S; a causal query i reads the keys up to pos + i.
        t_all = k_.shape[3] if kv_len is None else kv_len
        t_rows = [t_all if p is None else min(t_all, p + s_) for p in rows]
        keys = sum(s_ * t_all if p is None else sum(min(t_all, p + i + 1) for i in range(s_))
                   for p in rows)
        per_pos = k_.shape[1] * k_.shape[2] * k_.element_size() * 2  # K and V of a row
        nbytes = (per_pos + (ks is not None) * 2 * h_ * 2) * sum(t_rows) \
            + 2 * qq.numel() * 2 + (0 if isinstance(pos, (int, type(None))) else 4 * b_)
        flops = 4 * h_ * keys * 64
        record(da.KERNEL, label, err, time_ms(lambda: da.fused_decode_attention(*args), 50, flush),
               time_ms(lambda: da.decode_attention_reference(*args), 10, flush),
               nbytes, {"bf16": flops}, library() if library else None,
               "rtol 0.05, atol 0.02", main=main, launches_per_call=launches, **extra)

    cross = quantize_kv(*kv(1500), pad_to=128)
    case("cross int8 S=1 (T 1536, kv_len 1500)", q_of(1), cross.k_q, cross.v_q,
         cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len, main=True)
    case("cross int8 S=3 (prefill)", q_of(3), cross.k_q, cross.v_q, cross.k_scale,
         cross.v_scale, None, 1, kv_len=cross.kv_len)
    self_kv = quantize_kv(*kv(512))
    for pos in (0, 200, 447):
        case(f"self int8 S=1 pos={pos}", q_of(1), self_kv.k_q, self_kv.v_q,
             self_kv.k_scale, self_kv.v_scale, pos, 1)
    c4 = quantize_kv4(*kv(1500), pad_to=128)
    case("cross int4 S=1", q_of(1), c4.k_q, c4.v_q, c4.k_scale, c4.v_scale, None, 2,
         kv_len=c4.kv_len)
    kb, vb = kv(1500)
    qb = q_of(1)

    def sdpa_decode():
        return torch.nn.functional.scaled_dot_product_attention(
            qb, kb.transpose(2, 3), vb.transpose(2, 3), scale=1.0)

    case("cross bf16 S=1 (T 1500, rows through registers; language detection)", qb, kb, vb,
         None, None, None, 1, library=lambda: time_ms(sdpa_decode, 50, flush))
    # The request options' reads (phase e2e-options): beam search's cross
    # read, 5 beams folded into the queries of each stream's untiled K/V;
    # a 224-token prompt's prefill, chunked into 32-query launches, on the
    # cache (causal at pos 0) and on the cross K/V; the beam prefill of
    # that prompt (5 x 224 folded queries).
    case("cross int8 folded beams S=5 (B 16, T 1536, kv_len 1500)", q_of(5), cross.k_q,
         cross.v_q, cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len)
    case("self int8 prefill S=224 causal pos=0 (T 512, 7 launches)", q_of(224), self_kv.k_q,
         self_kv.v_q, self_kv.k_scale, self_kv.v_scale, 0, 1)
    case("cross int8 prefill S=224 (7 launches)", q_of(224), cross.k_q, cross.v_q,
         cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len)
    case("cross int8 folded beam prefill S=1120 (35 launches)", q_of(1120), cross.k_q,
         cross.v_q, cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len)
    # Speculative decoding (phase e2e-spec): the target's verify step, 5
    # queries (gamma 4 + 1) causal on the cache at a non-zero pos (its cross
    # read is the S=5 shape above), and whisper-tiny's draft step of 2
    # queries at 6 heads on its cache and its cross K/V.
    for pos in (200, 447):
        case(f"self int8 verify S=5 causal pos={pos} (T 512)", q_of(5), self_kv.k_q,
             self_kv.v_q, self_kv.k_scale, self_kv.v_scale, pos, 1)
    # Continuous batching (phase e2e-serve): the slots' causal reads of the
    # int8 cache with one position per row: spread from 0 to 447, every row
    # at 200 (beside the scalar read at 200 above), every row at 0 (most
    # blocks of each cluster read nothing and combine as empty states), and
    # the speculative slots' 5-query verify read at spread positions.
    spread = [round(447 * i / 15) for i in range(16)]
    for label, s_, rows in (("S=1 rows spread 0..447", 1, spread),
                            ("S=1 every row at 200", 1, [200] * 16),
                            ("verify S=5 rows spread 0..442", 5, [min(p, 442) for p in spread]),
                            ("S=1 every row at 0", 1, [0] * 16)):
        case(f"self int8 per-row pos {label} (T 512)", q_of(s_), self_kv.k_q, self_kv.v_q,
             self_kv.k_scale, self_kv.v_scale, rows, 1, per_row_pos=rows)
    draft_self = quantize_kv(*kv(512, heads=6))
    case("draft self int8 S=2 causal pos=199, 6 heads (T 512)", q_of(2, heads=6),
         draft_self.k_q, draft_self.v_q, draft_self.k_scale, draft_self.v_scale, 199, 1)
    draft_cross = quantize_kv(*kv(1500, heads=6), pad_to=128)
    case("draft cross int8 S=2, 6 heads (T 1536, kv_len 1500)", q_of(2, heads=6),
         draft_cross.k_q, draft_cross.v_q, draft_cross.k_scale, draft_cross.v_scale, None, 1,
         kv_len=draft_cross.kv_len)
    del kb, vb, qb, cross, self_kv, c4, draft_self, draft_cross

    # Kernel 4: the W8A8 encoder MLP of a batch of 16 windows (M = 24,000
    # rows): large-v3-turbo's fc1 (with the tanh GELU) and fc2, and
    # whisper-small's fc1. Weights are random at init_random's scale,
    # quantized per output channel as nn/quantize.py does.
    m = BATCH * ENC_CTX
    for label, k, n, act, main in (
            ("large-v3-turbo fc1 + GELU", 1280, 5120, "gelu_tanh", True),
            ("large-v3-turbo fc2", 5120, 1280, None, False),
            ("small fc1 + GELU", 768, 3072, "gelu_tanh", False)):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=dev) * 0.02
        bias = torch.randn((n,), generator=gen, device=dev) * 0.02
        w_q, w_scale = w8.quantize_rows(w)
        w_scale = w_scale[:, 0].contiguous()
        args = (x, w_q, w_scale, bias)
        got = w8.w8a8_dense(*args, activation=act)
        want = w8.w8a8_dense_reference(*args, activation=act)
        # The JAX package's pin (tests/test_ops.py): one weight step x
        # max|x| x 1.1 (a 1-ulp scale difference flips an int8 round on an
        # exact half), plus one rounding of the bf16 output, and >= 98% of
        # the outputs identical.
        atol = float(w_scale.max()) * float(x.float().abs().max()) * 1.1 + 1e-5
        err = check_close(f"w8a8 {label}", got, want, 2.0 ** -8, atol)
        same = float((got.to(torch.bfloat16) == want.to(torch.bfloat16)).float().mean())
        if same <= 0.98:
            raise AssertionError(f"w8a8 {label}: only {same:.4f} of outputs identical")
        bit_identical = bool(torch.equal(got, want))
        del want
        xq = w8.quantize_rows(x)[0]
        w_bf16, b_bf16 = w.to(torch.bfloat16), bias.to(torch.bfloat16)

        def bf16_lane(act=act):
            y = torch.nn.functional.linear(x, w_bf16, b_bf16)
            return torch.nn.functional.gelu(y, approximate="tanh") if act else y

        yard = {"int_mm_ms (int8 product alone)": yardstick_ms(
                    lambda: torch._int_mm(xq, w_q.t()), flush),
                "bf16_linear_ms (F.linear" + (" + tanh-GELU)" if act else ")"):
                    yardstick_ms(bf16_lane, flush)}
        # The entry point's two launches, timed apart: the row quantize pass
        # (x read once, xq and xs written: bound by bytes) and the GEMM.
        split = kernel_ms(lambda: w8.w8a8_dense(*args, activation=act), 20, flush)
        quant_ms = sum(v for name, v in split.items() if "quantize_rows" in name)
        nbytes = m * k * 2 + n * k + 2 * n * 4 + m * n * 2
        record(w8.KERNEL, f"{label} M={m} K={k} N={n}", err, sum(split.values()),
               time_ms(lambda: w8.w8a8_dense_reference(*args, activation=act), 3, flush),
               nbytes, {"int8": 2 * m * k * n}, None,
               f"one weight step x max|x| x 1.1 = {atol:.4g}, rtol 2^-8, "
               f">= 98% identical (got {same:.4f})", main=main, yardsticks=yard,
               bit_identical=bit_identical, quantize_ms=quant_ms,
               gemm_ms=sum(split.values()) - quant_ms,
               quantize_bound_ms=bound(m * k * 3 + m * 4, {"fp32": 2 * m * k})[0])
        del x, w, xq, got, w_bf16
    return entries


class _IdText:
    """A text backend of numbers: random weights have no vocabulary, so
    every id is a word written as its number (with the byte-BPE space
    marker on its piece)."""

    def encode(self, text):
        return [int(w) for w in text.split()]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    def convert_ids_to_tokens(self, ids):
        return [f"\u0120{int(i)}" for i in ids]


def _profiled(fn):
    """Runs ``fn`` with its device activity traced; returns its result and
    the device time per kernel name (ms)."""
    box = []
    us = _device_us_by_kernel(lambda: box.append(fn()))
    return box[0], {k: v / 1e3 for k, v in us.items()}


SPEC_GAMMA = 4


def _requests():
    """The three requests of the e2e phases: 12 s, 30 s and 75 s of noise
    from the seed."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [(0.1 * rng.standard_normal(s * 16000)).astype(np.float32) for s in (12, 30, 75)]


# The two e2e paths: (phase, preset, int8 lanes, fast_gelu, v3 token table,
# reference tolerance on the encoder output and the logits).
PATHS = (
    ("e2e", "small", False, False, False, (3e-2, 5e-2)),
    # On the card the W8A8 MLPs quantize bf16 activations, on the CPU f32
    # ones: codes near an exact half differ, so the two drift apart more
    # than in bf16 alone.
    ("e2e-int8", "large-v3-turbo", True, True, True, (5e-2, 5e-2)),
)


def _emit_profile(phase: str, runs, by_name: dict, card: str, **extra) -> None:
    """The ``profile`` line of a traced second run: device busy time against
    the untraced first run's wall, the top kernels, the port's kernels."""
    # Decode attention is one launch per call: no second combine pass.
    if any("combine" in name for name in by_name):
        raise AssertionError(f"{phase}: a combine kernel ran: {sorted(by_name)}")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", path=phase, run="second run, device activity traced",
         traced_wall_ms=runs[1][0] * 1e3, untraced_wall_ms=runs[0][0] * 1e3,
         device_busy_ms=busy, device_busy_share=busy / (runs[0][0] * 1e3),
         top_device_ms={k[:90]: round(v, 3) for k, v in top},
         port_kernels_ms=_port_kernels(by_name), card=card, **extra)


def e2e(card: str, kernels, phase: str, preset: str, int8: bool, fast_gelu: bool,
        v3: bool, tol, trace: bool = False) -> dict:
    """Phases 4 and 5: one whisper model served end to end through the
    port; returns the launches of its first run."""
    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.quantize import quantize_whisper_decoder, quantize_whisper_encoder
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    cfg = WHISPER_PRESETS[preset]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16, fast_gelu=fast_gelu), seed=SEED)
    if int8:  # the card quantizes its own random bf16 weights
        quantize_whisper_decoder(quantize_whisper_encoder(model))
    lanes = dict(weights_int8=model.weights_int8, encoder_int8=model.encoder_int8,
                 fast_gelu=fast_gelu)
    table = WhisperTokenTable(multilingual=True, v3=v3, text_backend=_IdText())
    if table.n_vocab != cfg.n_vocab:
        raise AssertionError(f"token table of {table.n_vocab} ids for a {cfg.n_vocab} vocab")
    seconds = (12, 30, 75)
    audios = _requests()

    # Reference on a small input: one window through the card's kernels
    # against the CPU plain path in float32 with the same weights (the same
    # int8 codes and scales where the lanes are on).
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"), cfg.n_mels)
        xa = model.encode_audio(mel)
        prompt = torch.as_tensor([table.sot_sequence("en")], device="cuda")
        logits, _ = model.decode_step(prompt, model.init_caches(1, quantized=True),
                                      model.cross_kvs(xa, "int8"), 0)
        if not (torch.isfinite(xa).all() and torch.isfinite(logits).all()):
            raise AssertionError("non-finite encoder output or logits")
        if xa.shape != (1, cfg.n_audio_ctx, cfg.n_audio_state) \
                or logits.shape != (1, 3, cfg.n_vocab):
            raise AssertionError(f"shapes {tuple(xa.shape)}, {tuple(logits.shape)}")
        ref = Whisper(cfg, dtype=torch.float32, device="cpu", **lanes)
        ref.load_state_dict({k: (v.float() if v.is_floating_point() else v).cpu()
                             for k, v in model.state_dict().items()})
        xa_ref = ref.encode_audio(mel.cpu())
        logits_ref, _ = ref.decode_step(prompt.cpu(), ref.init_caches(1),
                                        ref.cross_kvs(xa_ref), 0)
        rel_xa = float((xa.float().cpu() - xa_ref).norm() / xa_ref.norm())
        rel_lg = float((logits.cpu() - logits_ref).norm() / logits_ref.norm())
        if rel_xa > tol[0] or rel_lg > tol[1]:
            raise AssertionError(f"{phase}: card vs CPU reference: encoder rel err "
                                 f"{rel_xa}, logits rel err {rel_lg}")
        emit("reference", path=phase, window=1, encoder_rel_err=rel_xa,
             logits_rel_err=rel_lg,
             tolerance=f"encoder {tol[0]}, logits {tol[1]} (bf16 card vs f32 CPU)")
        del ref, xa_ref, logits_ref

    tr = Transcriber(model, token_table=table, batch_size=BATCH,
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
        _emit_profile(phase, runs, by_name, card)
    (wall, results, launches), (wall2, results2, _) = runs
    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    if toks != [[t for s in r.segments for t in s.tokens] for r in results2]:
        raise AssertionError(f"{phase}: second run gave other tokens")
    windows = sum(len(chunk_audio(a, tr.chunk_samples, tr.stride_samples)[1])
                  for a in audios)
    batches = -(-windows // BATCH)
    # The W8A8 kernel runs twice per encoder block per batch on the int8
    # lane, and never otherwise; every other kernel runs on both paths.
    want_w8a8 = 2 * cfg.n_audio_layer * batches if model.encoder_int8 else 0
    idle = [name for name, n in launches.items() if n == 0 and name != W8A8.name]
    if idle or launches[W8A8.name] != want_w8a8:
        raise AssertionError(f"{phase}: kernels never launched: {idle}; w8a8 "
                             f"{launches[W8A8.name]} launches, {want_w8a8} expected")
    n_tok = sum(len(t) for t in toks)
    # Two decode-attention launches (self, cross) per layer per step.
    steps = launches["decode_attention"] // (2 * cfg.n_text_layer * batches)
    emit(phase, model=f"whisper-{preset}", lanes=lanes, batch=BATCH,
         requests=list(seconds), windows=windows, wall_s=wall, wall_s_second_run=wall2,
         audio_s_per_s=sum(seconds) / wall, segment_tokens=n_tok,
         tokens_per_s=n_tok / wall, decode_steps=steps,
         batch_tokens_per_s=BATCH * steps * batches / wall, launches=launches, card=card)
    return launches


def _rel_err(got, want) -> float:
    import torch

    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    return float((got - want).norm() / want.norm())


def e2e_options(card: str, kernels, trace: bool = False) -> dict:
    """Phase 6: whisper-small served with the request options (beam search
    over the untiled cross-K/V, language detection, word timestamps, logit
    bias, hotwords, repetition rules, a 224-token per-request prompt), then
    previous-text conditioning; returns the launches of its runs."""
    from collections import Counter

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase, beams = "e2e-options", 5
    cfg = WHISPER_PRESETS["small"]
    layers = cfg.n_text_layer
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    rng = np.random.default_rng(SEED)
    seconds = (12, 30, 75)
    audios = [(0.1 * rng.standard_normal(s * 16000)).astype(np.float32) for s in seconds]
    # 230 ids, of which the prompt keeps the last 220: with <|startofprev|>
    # and the SOT sequence, 224 tokens, the per-request prompt budget.
    prompts = [None, None, " ".join(str(int(i)) for i in rng.integers(1000, 50000, 230))]
    options = dict(language=None, word_timestamps=True, hotwords="1000 1001, 2000",
                   logit_bias={3000: 2.0, 4000: -1.0}, repetition_penalty=1.1,
                   no_repeat_ngram_size=3)
    serving = dict(quantized_cross_kv="int8", quantized_cache=True,
                   cache_dtype=torch.bfloat16)
    tr = Transcriber(model, token_table=table, batch_size=BATCH, beams=beams, **options,
                     **serving)

    # Reference on one window: the language logits, one folded beam step and
    # the alignment map from the card against the CPU plain path in float32
    # with the same weights (float cross-K/V and cache there).
    tol = 5e-2
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        ref = Whisper(cfg, dtype=torch.float32, device="cpu")
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        ref_tr = Transcriber(ref, token_table=table, batch_size=1, beams=beams,
                             device="cpu", **options)
        lang_logits = tr._language_logits(window)
        lang_ref = ref_tr._language_logits(window)
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"), cfg.n_mels)
        xa, xa_ref = model.encode_audio(mel), ref.encode_audio(mel.cpu())
        prompt = torch.as_tensor([table.sot_sequence("en")] * beams)
        step = torch.as_tensor([[100 * (j + 1)] for j in range(beams)])

        def beam_step(m, ckv, caches, dev):
            m.decode_step(prompt.to(dev), caches, ckv, 0)
            return m.decode_step(step.to(dev), caches, ckv, prompt.shape[1])[0]

        # The cross-K/V of the one window, untiled: the 5 beams fold into
        # its queries.
        beam_logits = beam_step(model, model.cross_kvs(xa, "int8"),
                                model.init_caches(beams, torch.bfloat16, None, True), "cuda")
        beam_ref = beam_step(ref, ref.cross_kvs(xa_ref), ref.init_caches(beams), "cpu")
        tokens = torch.full((1, cfg.n_text_ctx), table.eot)
        forced = table.sot_sequence("en") + [int(i) for i in rng.integers(1000, 50000, 200)]
        tokens[0, :len(forced)] = torch.as_tensor(forced)
        amap = model.cross_attention_map(tokens.cuda(), xa)
        amap_ref = ref.cross_attention_map(tokens, xa_ref)
        errs = dict(language_logits_rel_err=_rel_err(lang_logits, lang_ref),
                    beam_step_logits_rel_err=_rel_err(beam_logits, beam_ref),
                    alignment_map_rel_err=_rel_err(amap, amap_ref))
        finite = all(bool(torch.isfinite(torch.as_tensor(x)).all())
                     for x in (lang_logits, beam_logits, amap))
        shapes_ok = (lang_logits.shape == (1, cfg.n_vocab)
                     and beam_logits.shape == (beams, 1, cfg.n_vocab)
                     and amap.shape == (1, cfg.n_text_ctx, cfg.n_audio_ctx))
        emit("reference", path=phase, window=1, **errs,
             tolerance=f"each {tol} (bf16 card, int8 cross-K/V and cache, vs f32 CPU)")
        if not finite or not shapes_ok or max(errs.values()) > tol:
            raise AssertionError(f"{phase}: card vs CPU reference: finite {finite}, "
                                 f"shapes {shapes_ok}, {errs}")
        del ref, ref_tr, xa_ref, amap_ref, beam_ref

    # Every decode-attention launch's (rows, queries, positions, causal),
    # through a hook on the kernel's launch.
    shapes: Counter = Counter()
    launch = da.KERNEL.launch

    def recording_launch(*args):
        shapes[(args[8], args[11], args[13], args[15])] += 1
        launch(*args)

    def counted(fn):
        for k in kernels:
            k.launches = 0
        shapes.clear()
        da.KERNEL.launch = recording_launch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del da.KERNEL.launch
        return wall, out, {k.name: k.launches for k in kernels}, Counter(shapes)

    def serve():
        return tr.transcribe_many(audios, prompts=prompts)

    runs = [counted(serve)]
    if trace:
        box = []
        wall2, _, _, _ = counted(lambda: box.append(_profiled(serve)))
        results2, by_name = box[0]
        # index_select runs as PyTorch's vectorized_gather_kernel on the card.
        families = {"beam cache reorder (index_select)": "vectorized_gather_kernel",
                    "beam top-k (topk, sort)": "[Tt]op[Kk]|[Ss]ort|[Rr]adix",
                    "scans (cumsum)": "[Ss]can"}
        _emit_profile(phase, [runs[0][:2], (wall2, results2)], by_name, card, by_family={
            label: round(sum(v for k, v in by_name.items() if re.search(pat, k)), 3)
            for label, pat in families.items()})
    else:
        wall2, results2, _, _ = counted(serve)
    wall, results, launches, seen = runs[0]

    def words(rs):
        return [[(s.tokens, [(w.word, w.start, w.end, w.probability) for w in s.words or []])
                 for s in r.segments] for r in rs]

    if words(results) != words(results2):
        raise AssertionError(f"{phase}: second run gave other tokens or word timings")
    n_words = sum(len(w) for r in words(results) for _, w in r)
    if n_words == 0 or any(r.language_probability is None for r in results):
        raise AssertionError(f"{phase}: {n_words} words; languages "
                             f"{[(r.language, r.language_probability) for r in results]}")

    # The launch arithmetic: per layer, one detection step (self, bf16 cross),
    # per decode batch a prefill (self at B*K rows; cross folded, K x P
    # queries of the B untiled rows, in 32-query chunks), then per step one
    # self read at B*K rows and one folded cross read of K queries at B rows.
    b, rows = BATCH, BATCH * beams
    n_win = [len(chunk_audio(a, tr.chunk_samples, tr.stride_samples)[1]) for a in audios]
    batches = {p: -(-sum(n for n, q in zip(n_win, prompts) if (q is None) == (p == 3)) // b)
               for p in (3, 224)}
    steps = seen[(b, beams, 1536, 0)] // layers
    want = Counter({(b, 1, 1500, 0): layers, (b, 1, 128, 1): layers,
                    (rows, 3, 512, 1): layers * batches[3],
                    (b, 3 * beams, 1536, 0): layers * batches[3],
                    (rows, 32, 512, 1): 7 * layers * batches[224],
                    (b, 32, 1536, 0): 35 * layers * batches[224],
                    (rows, 1, 512, 1): layers * steps, (b, beams, 1536, 0): layers * steps})
    cross_rows = sorted({k[0] for k in seen if k[2] == 1536})
    if seen != want or cross_rows != [b] or launches[da.KERNEL.name] != sum(want.values()):
        raise AssertionError(f"{phase}: decode-attention launches {dict(seen)} "
                             f"({launches[da.KERNEL.name]}), expected {dict(want)}")
    idle = [name for name, n in launches.items() if n == 0 and name != W8A8.name]
    if idle or launches[W8A8.name]:
        raise AssertionError(f"{phase}: kernels never launched: {idle}; w8a8 "
                             f"{launches[W8A8.name]} launches")

    # Previous-text conditioning on the 75 s request: window by window,
    # greedy. The initial prompt alone fills the context budget, so every
    # window's prompt is the 224-token <|startofprev|> context of the
    # initial prompt and the history.
    seq = Transcriber(model, token_table=table, batch_size=BATCH,
                      condition_on_previous_text=True, initial_prompt=prompts[2],
                      **options, **serving)
    c_wall, c_result, c_launches, c_seen = counted(lambda: seq.transcribe(audios[2]))
    c_tokens = [t for s in c_result.segments for t in s.tokens]
    chunked = c_seen[(1, 32, 512, 1)]
    if not c_tokens or chunked != 7 * layers * n_win[2] \
            or c_seen[(1, 32, 1536, 0)] != chunked:
        raise AssertionError(f"{phase}: conditioning gave {len(c_tokens)} tokens, "
                             f"decode launches {dict(c_seen)}")

    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    n_tok = sum(len(t) for t in toks)
    emit(phase, model="whisper-small", options=dict(options, beams=beams, prompts=[
        None if q is None else "224-token prompt" for q in prompts]), batch=BATCH,
        requests=list(seconds), windows=sum(n_win), wall_s=wall, wall_s_second_run=wall2,
        audio_s_per_s=sum(seconds) / wall, segment_tokens=n_tok, tokens_per_s=n_tok / wall,
        words=n_words, languages=[(r.language, r.language_probability) for r in results],
        decode_steps=steps, batch_tokens_per_s=b * steps / wall,
        decode_launches_by_shape={f"B{k[0]} S{k[1]} T{k[2]}{' causal' if k[3] else ''}": n
                                  for k, n in sorted(seen.items())},
        cross_read_rows=cross_rows, launches=launches,
        conditioning=dict(wall_s=c_wall, audio_s_per_s=seconds[2] / c_wall,
                          segment_tokens=len(c_tokens),
                          windows_with_224_token_prompt=chunked // (7 * layers),
                          launches=c_launches), card=card)
    return {k: launches[k] + c_launches[k] for k in launches}


def e2e_files(card: str, kernels) -> dict:
    """Phase e2e-files: whisper-small served from audio files with the VAD
    and the silence-hallucination filter; returns the launches of its first
    call."""
    import tempfile
    import wave

    import numpy as np
    import torch

    from yoho_tpu_torch import native
    from yoho_tpu_torch.audio.flac import encode_flac
    from yoho_tpu_torch.audio.io import load_audio_f32, resample
    from yoho_tpu_torch.audio.vad import collapse_silence
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase, sr = "e2e-files", 16000
    cfg = WHISPER_PRESETS["small"]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    audios = _requests()
    # 20 s of digital silence in the middle of the 75 s request.
    gap = (int(27.5 * sr), int(47.5 * sr))
    audios[2][gap[0]:gap[1]] = 0.0

    def pcm16(x):
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)

    def write_wav(path, pcm, rate, channels):
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        stereo = pcm16(resample(audios[0], sr, 44100))
        write_wav(tmp / "a.wav", np.repeat(stereo, 2), 44100, 2)  # interleaved L, R
        flac_pcm = pcm16(audios[1])
        (tmp / "b.flac").write_bytes(encode_flac(flac_pcm.astype(np.int64)[:, None], sr))
        mono = pcm16(audios[2])
        write_wav(tmp / "c.wav", mono, sr, 1)
        paths = [tmp / "a.wav", tmp / "b.flac", tmp / "c.wav"]

        # The decoded samples against the port's resample of the same array,
        # within one int16 step.
        step = 1.0 / 32768.0
        decoded = [load_audio_f32(pth, sr) for pth in paths]
        expect = [resample(stereo.astype(np.float32) / 32768.0, 44100, sr),
                  flac_pcm.astype(np.float32) / 32768.0, mono.astype(np.float32) / 32768.0]
        decode_err = [float(np.abs(d - e).max()) for d, e in zip(decoded, expect)]
        if any(len(d) != len(e) for d, e in zip(decoded, expect)) or max(decode_err) > step:
            raise AssertionError(f"{phase}: decoded samples off the resampled arrays by "
                                 f"{decode_err} (one int16 step {step})")
        # The VAD leaves the silent stretch out (its 300 ms pads aside).
        _, smap = collapse_silence(decoded[2], sr)
        inner = (gap[0] + int(0.4 * sr), gap[1] - int(0.4 * sr))
        kept = [(o, o + n) for _c, o, n in smap.chunks]
        if any(a < inner[1] and b > inner[0] for a, b in kept):
            raise AssertionError(f"{phase}: the speech map {kept} keeps the silence {gap}")

        tr = Transcriber(model, token_table=table, batch_size=BATCH,
                         quantized_cross_kv="int8", quantized_cache=True,
                         cache_dtype=torch.bfloat16, vad_filter=True,
                         hallucination_silence_threshold=2.0)
        runs = []
        for _ in range(2):
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = tr.transcribe_many([str(pth) for pth in paths])
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, results,
                         {k.name: k.launches for k in kernels}))
    (wall, results, launches), (wall2, results2, _) = runs
    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    if toks != [[t for s in r.segments for t in s.tokens] for r in results2]:
        raise AssertionError(f"{phase}: second call gave other tokens")
    seconds = [len(d) / sr for d in decoded]
    outside = [(i, s.start, s.end) for i, r in enumerate(results) for s in r.segments
               if not 0 <= s.start <= s.end <= seconds[i] + 1e-3]
    idle = [name for name, n in launches.items() if n == 0 and name != W8A8.name]
    if outside or idle or not any(toks):
        raise AssertionError(f"{phase}: segments outside their request {outside[:4]}; "
                             f"kernels never launched {idle}; tokens {sum(map(len, toks))}")

    def windows(xs):
        return sum(len(chunk_audio(x, tr.chunk_samples, tr.stride_samples)[1]) for x in xs)

    n_tok = sum(len(t) for t in toks)
    emit(phase, model="whisper-small", batch=BATCH,
         files=["12 s stereo int16 WAV 44.1 kHz", "30 s 16-bit FLAC",
                "75 s mono int16 WAV 16 kHz, 20 s of zeros in the middle"],
         flac_decoder="native" if native.get_lib() is not None else "python",
         decode_err_vs_resample=decode_err,
         windows_without_vad=windows(decoded),
         windows_with_vad=windows([collapse_silence(d, sr)[0] for d in decoded]),
         speech_seconds=[round(collapse_silence(d, sr)[1].speech_seconds, 3) for d in decoded],
         wall_s=wall, wall_s_second_call=wall2, audio_s_per_s=sum(seconds) / wall,
         segment_tokens=n_tok, launches=launches, card=card)
    return launches


def _window_key(window) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(window, np.float32).tobytes()).hexdigest()


def _tie_check(phase: str, label: str, rows, ref) -> dict:
    """Each decoded row's tokens equal the greedy reference row of the
    same window up to their first difference, and differ there only inside
    a tie: a top-2 margin of greedy's processed logits of at most 4 bf16
    ulps of the larger logit. ``rows``: [(key, tokens)]; ``ref``: {key:
    (greedy tokens, greedy top-2 per position)}, the key a window's hash or
    a row index. Returns the rows checked, those that diverged and the
    largest margin there, in ulps."""
    import numpy as np

    diverged, worst = 0, 0.0
    for key, tok in rows:
        if key not in ref:
            raise AssertionError(f"{phase} ({label}): a decoded row has no reference row")
        g_tok, g_top2 = ref[key]
        n = min(len(tok), len(g_tok))
        diff = np.flatnonzero(np.asarray(tok[:n]) != np.asarray(g_tok[:n]))
        if len(diff) == 0:
            continue
        diverged += 1
        i = int(diff[0])
        first, second = (float(x) for x in g_top2[i])
        ulp = 2.0 ** (np.floor(np.log2(abs(first))) - 7)  # bf16: 8 significant bits
        worst = max(worst, (first - second) / ulp)
        if first - second > 4 * ulp:
            raise AssertionError(f"{phase} ({label}): row {key} leaves greedy at {i} with a "
                                 f"top-2 margin of {first - second} "
                                 f"({(first - second) / ulp} bf16 ulps of {first})")
    return dict(rows_checked=len(rows), rows_diverging=diverged,
                largest_margin_at_divergence_bf16_ulps=worst)


def e2e_spec(card: str, kernels) -> dict:
    """Phase e2e-spec: whisper-small decoding speculatively with two drafts
    (whisper-tiny with random weights: low acceptance; the target itself:
    full acceptance but at ties); returns the launches of its runs."""
    from collections import Counter

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase, gamma = "e2e-spec", SPEC_GAMMA
    cfg = WHISPER_PRESETS["small"]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    tiny = init_random(Whisper(WHISPER_PRESETS["tiny"], dtype=torch.bfloat16), seed=1)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    audios = _requests()
    serving = dict(token_table=table, batch_size=BATCH, quantized_cross_kv="int8",
                   quantized_cache=True, cache_dtype=torch.bfloat16)
    seconds = sum(len(a) for a in audios) / 16000

    # Reference on one window: a verify step of gamma + 1 queries after the
    # prompt's prefill, card (bf16, int8 cross-K/V and cache) against the
    # CPU plain path in float32 with the same weights.
    tol = 5e-2
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"), cfg.n_mels)
        ref = Whisper(cfg, dtype=torch.float32, device="cpu")
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        prompt = torch.as_tensor([table.sot_sequence("en")])
        # The last prompt token again, then 4 proposals.
        block = torch.as_tensor([[int(prompt[0, -1]), 1000, 2000, 3000, 4000]])

        def verify(m, ckv, caches, dev):
            m.decode_step(prompt.to(dev), caches, ckv, 0)
            return m.decode_step(block.to(dev), caches, ckv, prompt.shape[1] - 1)[0]

        got = verify(model, model.cross_kvs(model.encode_audio(mel), "int8"),
                     model.init_caches(1, torch.bfloat16, cfg.n_text_ctx + gamma + 2, True),
                     "cuda")
        want = verify(ref, ref.cross_kvs(ref.encode_audio(mel.cpu())),
                      ref.init_caches(1, None, cfg.n_text_ctx + gamma + 2), "cpu")
        rel = _rel_err(got, want)
        emit("reference", path=phase, window=1, verify_step_logits_rel_err=rel,
             tolerance=f"{tol} (bf16 card, int8 cross-K/V and cache, vs f32 CPU)")
        if not bool(torch.isfinite(got).all()) or got.shape != (1, gamma + 1, cfg.n_vocab) \
                or rel > tol:
            raise AssertionError(f"{phase}: verify logits {tuple(got.shape)}, rel err {rel}")
        del ref, want

    # Every decode-attention launch's (rows, heads, queries, positions,
    # causal), through a hook on the kernel's launch.
    shapes: Counter = Counter()
    launch = da.KERNEL.launch

    def recording_launch(*args):
        shapes[(args[8], args[9], args[11], args[13], args[15])] += 1
        launch(*args)

    def serve(tr):
        """One transcribe_many with its decode rows captured: (wall, rows
        of (tokens, length), launches, read shapes)."""
        rows = []
        decode = tr._decode_with_fallback

        def capturing(b, mel, prompt=None, **kw):
            out = decode(b, mel, prompt, **kw)
            rows.extend(zip(out[0], out[1]))
            return out

        for k in kernels:
            k.launches = 0
        shapes.clear()
        tr._decode_with_fallback = capturing
        da.KERNEL.launch = recording_launch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.transcribe_many(audios)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del da.KERNEL.launch, tr._decode_with_fallback
        return wall, rows, {k.name: k.launches for k in kernels}, Counter(shapes)

    # Greedy, with the two largest of its processed logits (after the
    # suppression and the timestamp rules) recorded at every position: the
    # margin a speculative row may flip inside.
    greedy = Transcriber(model, **serving)
    top2 = torch.zeros((BATCH, cfg.n_text_ctx, 2), device="cuda")
    build = greedy._logits_fn

    def recording_rules(prompt_len):
        rules = build(prompt_len)

        def fn(logits, tokens, pos):
            out = rules(logits, tokens, pos)
            top2[:, pos] = torch.topk(out, 2, dim=-1).values
            return out

        return fn

    greedy._logits_fn = recording_rules
    g_wall, g_rows, g_launches, _ = serve(greedy)
    if len(g_rows) != BATCH:  # the recorded logits are one batch's
        raise AssertionError(f"{phase}: {len(g_rows)} decode rows, one batch expected")
    g_top2 = top2.cpu().numpy()
    n_prompt = len(greedy._prompt_ids())

    total = dict(g_launches)
    out = {}
    draft_cfgs = {"whisper-tiny, random (seed 1)": tiny, "the target itself": model}
    for label, draft in draft_cfgs.items():
        tr = Transcriber(model, draft_model=draft, speculative_gamma=gamma, **serving)
        tr.speculative_stats.clear()
        wall, rows, launches, seen = serve(tr)
        stats = dict(tr.speculative_stats)
        # The launch arithmetic: per batch a prefill of the prompt by both
        # models; per round, per draft layer one S = 2 step and gamma - 1
        # S = 1 steps, then per target layer one verify step of gamma + 1
        # queries; each step one self read (causal, the 512-position cache)
        # and one cross read (the 1536-padded int8 K/V) at 16 rows.
        batches, rounds = len(rows) // BATCH + (len(rows) % BATCH > 0), stats["rounds"]
        dc, lt = draft.cfg, cfg.n_text_layer
        want = Counter()
        for heads, layers, s, n in ((cfg.n_text_head, lt, n_prompt, batches),
                                    (dc.n_text_head, dc.n_text_layer, n_prompt, batches),
                                    (dc.n_text_head, dc.n_text_layer, 2, rounds),
                                    (dc.n_text_head, dc.n_text_layer, 1, rounds * (gamma - 1)),
                                    (cfg.n_text_head, lt, gamma + 1, rounds)):
            want[(BATCH, heads, s, 512, 1)] += layers * n
            want[(BATCH, heads, s, 1536, 0)] += layers * n
        if seen != want or launches[da.KERNEL.name] != sum(want.values()):
            raise AssertionError(f"{phase} ({label}): decode-attention launches "
                                 f"{dict(seen)}, expected {dict(want)}")
        idle = [name for name, n in launches.items() if n == 0 and name != W8A8.name]
        if idle or launches[W8A8.name] or stats["syncs"] != rounds:
            raise AssertionError(f"{phase} ({label}): kernels never launched {idle}, "
                                 f"w8a8 {launches[W8A8.name]}, stats {stats}")
        # Each row equals greedy up to its first difference, and differs
        # there only inside a tie.
        ties = _tie_check(phase, label, [(j, tok) for j, (tok, _n) in enumerate(rows)],
                          {j: (g_tok, g_top2[j]) for j, (g_tok, _g) in enumerate(g_rows)})
        for name, n in launches.items():
            total[name] += n
        out[label] = dict(
            wall_s=wall, audio_s_per_s=seconds / wall, rounds=rounds,
            committed_per_round=stats["committed"] / rounds, host_syncs=stats["syncs"],
            rows_diverging=ties["rows_diverging"],
            largest_margin_at_divergence_bf16_ulps=ties["largest_margin_at_divergence_bf16_ulps"],
            decode_launches_by_shape={f"B{k[0]} H{k[1]} S{k[2]} T{k[3]}"
                                      f"{' causal' if k[4] else ''}": n
                                      for k, n in sorted(seen.items())},
            launches=launches)
    windows = sum(len(chunk_audio(a, greedy.chunk_samples, greedy.stride_samples)[1])
                  for a in audios)
    emit(phase, model="whisper-small", gamma=gamma, batch=BATCH, windows=windows,
         greedy=dict(wall_s=g_wall, audio_s_per_s=seconds / g_wall), drafts=out, card=card)
    return total


def e2e_serve(card: str, kernels) -> dict:
    """Phase e2e-serve: whisper-small served continuously. (a) the slot
    engine with a fixed admission schedule; (b) the HTTP servers, slot
    engine and micro-batcher, with concurrent clients; (c) the speculative
    slots. Returns the launches of the three parts' measured runs (the
    greedy reference and the servers' warmups not counted)."""
    import io
    import socket
    import struct
    import threading
    import urllib.request
    import warnings
    import wave
    from collections import Counter, defaultdict
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from yoho_tpu_torch.cli.serve import drain, serve, warmup
    from yoho_tpu_torch.cli.serve_openai import _decode_wav_bytes
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.infer.slot_engine import SlotEngine, _Window
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.srt import compose_srt, segments_to_subtitles
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
    from yoho_tpu_torch.utils import websocket as ws

    phase, chunk_tokens, sr = "e2e-serve", 16, 16000
    cfg = WHISPER_PRESETS["small"]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    serving = dict(token_table=table, batch_size=BATCH, quantized_cross_kv="int8",
                   quantized_cache=True, cache_dtype=torch.bfloat16)
    audios = _requests()
    seconds = [len(a) / sr for a in audios]

    # The kernels' launches: set to 0 just before each part's measured run
    # and summed just after it.
    total = Counter()

    def zero_launches():
        for k in kernels:
            k.launches = 0

    def take_launches(label):
        got = {k.name: k.launches for k in kernels}
        idle = [name for name, n in got.items() if n == 0 and name != W8A8.name]
        if idle or got[W8A8.name]:
            raise AssertionError(f"{phase} ({label}): kernels never launched {idle}, "
                                 f"w8a8 {got[W8A8.name]}")
        total.update(got)
        return got

    # Every decode-attention launch: whether it ran inside a chunk, its
    # rows, its queries, and its causal position (per-row, scalar, or none:
    # a cross read).
    shapes: Counter = Counter()
    in_chunk = [False]
    launch = da.KERNEL.launch

    def recording_launch(*args):
        shapes[(in_chunk[0], args[8], args[11], "per-row pos" if args[17] is not None
                else "scalar pos" if args[15] else "no pos")] += 1
        launch(*args)

    def by_shape():
        return {f"{'chunk' if k[0] else 'outside chunks'} B{k[1]} S{k[2]} {k[3]}": n
                for k, n in sorted(shapes.items())}

    def chunk_hook(engine):
        """Runs each chunk of ``engine`` with the launch flag set and with
        PyTorch's sync debug mode raising on any host sync."""
        chunk = engine._chunk

        def checked(state):
            in_chunk[0] = True
            torch.cuda.set_sync_debug_mode("error")
            try:
                chunk(state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                in_chunk[0] = False

        engine._chunk = checked

    def reap_syncs(engine):
        """Counts the host syncs PyTorch sees in each reap of ``engine``
        (sync debug mode "warn"); returns the running count."""
        reap, seen = engine.reap, [0]

        def counted():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    got = reap()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            seen[0] += sum("called a synchronizing CUDA operation" in str(w.message)
                           for w in caught)
            return got

        engine.reap = counted
        return seen

    def capture_rows(tr, rows):
        """Records (window key, tokens) of every window ``tr`` decodes in a
        batch (the padding rows of a short batch left out)."""
        features, decode = tr._features, tr._decode_with_fallback
        last = []

        def capturing_features(wins):
            last[:] = [np.asarray(wins, np.float32)]
            return features(wins)

        def capturing_decode(b, mel, prompt=None, **kw):
            res = decode(b, mel, prompt, **kw)
            rows.extend((_window_key(w), t) for w, t in zip(last[0], res[0]) if w.any())
            return res

        tr._features, tr._decode_with_fallback = capturing_features, capturing_decode

    # The greedy reference (the e2e configuration): every distinct window
    # the phase decodes in one batch of 16, with greedy's top-2 processed
    # logits at each position (the margin a row may flip inside).
    wav_30 = io.BytesIO()
    with wave.open(wav_30, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(np.round(audios[1] * 32767), -32768, 32767)
                      .astype(np.int16).tobytes())
    wav_30 = wav_30.getvalue()
    greedy = Transcriber(model, **serving)
    windows = [w for a in audios for w in chunk_audio(a, greedy.chunk_samples,
                                                      greedy.stride_samples)[0]]
    ref_windows = windows + list(chunk_audio(_decode_wav_bytes(wav_30, sr),
                                             greedy.chunk_samples, greedy.stride_samples)[0])
    top2 = torch.zeros((BATCH, cfg.n_text_ctx, 2), device=model.device)
    build = greedy._logits_fn

    def recording_rules(prompt_len):
        rules = build(prompt_len)

        def fn(logits, tokens, pos):
            out = rules(logits, tokens, pos)
            top2[:, pos] = torch.topk(out, 2, dim=-1).values
            return out

        return fn

    greedy._logits_fn = recording_rules
    batch = np.zeros((BATCH, greedy.chunk_samples), np.float32)
    for j, w in enumerate(ref_windows):
        batch[j, :len(w)] = w
    g_tokens, g_lengths, _aux = greedy._decode_with_fallback(BATCH, greedy._features(batch))
    g_top2 = top2.cpu().numpy()
    ref = {_window_key(batch[j]): (g_tokens[j], g_top2[j]) for j in range(len(ref_windows))}
    prompt = np.asarray(greedy._prompt_ids(), np.int64)
    out = {}
    da.KERNEL.launch = recording_launch
    try:
        # (a) The engine: the 5 windows of the three requests in four waves,
        # admitted before chunks 0, 2, 5 and 9 (20 windows for 16 slots: the
        # last wave waits for freed slots).
        tr = Transcriber(model, **serving)
        engine = SlotEngine(tr, slots=BATCH, chunk_tokens=chunk_tokens)
        chunk_hook(engine)
        syncs = reap_syncs(engine)
        shapes.clear()
        waves, queue, done, chunk = (0, 2, 5, 9), [], [], 0
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        while queue or engine.busy or chunk <= waves[-1]:
            if chunk in waves:
                queue += [_Window(w, prompt) for w in windows]
            if queue and engine.free_slots:
                del queue[:engine.admit_many(queue)]
                done += engine.reap()
            if engine.busy:
                done += engine.step()
            chunk += 1
        wall = time.perf_counter() - t0
        launches = take_launches("a")
        stats = dict(engine.stats)
        if len(done) != len(waves) * len(windows) or syncs[0] != stats["reaps"]:
            raise AssertionError(f"{phase} (a): {len(done)} windows reaped, {syncs[0]} "
                                 f"host syncs seen in reaps, stats {stats}")
        inside = {k: n for k, n in shapes.items() if k[0]}
        per_kind = stats["chunks"] * chunk_tokens * cfg.n_text_layer
        want = {(True, BATCH, 1, "per-row pos"): per_kind, (True, BATCH, 1, "no pos"): per_kind}
        if inside != want:
            raise AssertionError(f"{phase} (a): decode launches inside chunks {inside}, "
                                 f"expected {want}")
        ties = _tie_check(phase, "engine", [(_window_key(np.pad(w.window, (
            0, greedy.chunk_samples - len(w.window)))), w.tokens) for w in done], ref)
        out["engine"] = dict(
            wall_s=wall, audio_s_per_s=len(waves) * sum(seconds) / wall,
            windows=len(done), chunks=stats["chunks"], host_syncs_in_chunks=0,
            host_syncs_in_reaps=syncs[0], reaps=stats["reaps"],
            slot_occupancy_per_chunk=stats["occupied_slot_chunks"] / stats["chunks"],
            decode_launches=by_shape(), launches=launches, **ties)

        # (b) The servers: the three requests to /transcribe, the 30 s
        # request to the OpenAI endpoint as verbose_json and srt (a WAV
        # upload), and a /stream session of the 75 s request in 1 s frames,
        # all at once; first through the slot engine, then the micro-batcher.
        def post(url, path, body, ctype):
            req = urllib.request.Request(url + path, data=body, headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.read()

        def openai(url, fmt):
            bnd = "smokeboundary"
            body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
                    f"filename=\"a.wav\"\r\n\r\n").encode() + wav_30 + (
                f"\r\n--{bnd}\r\nContent-Disposition: form-data; name=\"response_format\""
                f"\r\n\r\n{fmt}\r\n--{bnd}--\r\n").encode()
            return post(url, "/v1/audio/transcriptions", body,
                        f"multipart/form-data; boundary={bnd}")

        def stream(url, audio):
            host, port = url.replace("http://", "").split(":")
            s = socket.create_connection((host, int(port)), timeout=600)
            s.sendall(("GET /stream HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                       "Connection: Upgrade\r\nSec-WebSocket-Key: AAAAAAAAAAAAAAAAAAAAAA==\r\n"
                       "Sec-WebSocket-Version: 13\r\n\r\n").encode())
            resp = b""
            while b"\r\n\r\n" not in resp:
                resp += s.recv(4096)
            mask = b"\x01\x02\x03\x04"

            def send(payload, opcode):
                n = len(payload)
                hdr = (bytes([0x80 | opcode, 0x80 | n]) if n < 126 else
                       bytes([0x80 | opcode, 0xFE]) + struct.pack(">H", n) if n < 65536 else
                       bytes([0x80 | opcode, 0xFF]) + struct.pack(">Q", n))
                m = np.frombuffer(mask * (n // 4 + 1), np.uint8)[:n]
                s.sendall(hdr + mask + (np.frombuffer(payload, np.uint8) ^ m).tobytes())

            finals = []
            try:
                for i in range(0, len(audio), sr):
                    send(audio[i:i + sr].astype("<f4").tobytes(), ws.OP_BINARY)
                send(b'{"op": "end"}', ws.OP_TEXT)
                rfile, wfile = s.makefile("rb"), s.makefile("wb")
                while True:
                    msg = ws.read_message(rfile, wfile)
                    if msg is None:
                        raise AssertionError(f"{phase}: /stream closed before its final message")
                    body = json.loads(msg[1])
                    if "error" in body:
                        raise AssertionError(f"{phase}: /stream error {body['error']}")
                    if not body.get("partial"):
                        finals += body["segments"]
                    if body.get("final"):
                        return finals
            finally:
                s.close()

        def keys_of(audio):
            return [_window_key(np.pad(w, (0, greedy.chunk_samples - len(w))))
                    for w in chunk_audio(audio, greedy.chunk_samples, greedy.stride_samples)[0]]

        def same(a, b):
            n = min(len(a), len(b))
            return np.array_equal(np.asarray(a[:n]), np.asarray(b[:n]))

        # transcribe_many's responses, with the tokens of every window it
        # decoded: a response is held against them where each of its
        # windows decoded to the same tokens on the server.
        exp_rows = []
        capture_rows(greedy, exp_rows)
        expected = greedy.transcribe_many(audios)
        audio_30 = _decode_wav_bytes(wav_30, sr)
        expected_30 = greedy.transcribe_many([audio_30])[0]
        exp_rows = dict(exp_rows)
        srt_30 = compose_srt(segments_to_subtitles(expected_30.segments))
        n_requests = 3 + 2 + len(chunk_audio(audios[2], greedy.chunk_samples,
                                            greedy.stride_samples)[0])
        for continuous in (True, False):
            label = "servers, slot engine" if continuous else "servers, micro-batcher"
            tr = Transcriber(model, **serving)
            rows = []
            if continuous:
                server = serve(tr, port=0, continuous=True, chunk_tokens=chunk_tokens)
                engine = server.batcher.engine
                chunk_hook(engine)
                reap = engine.reap

                def capturing_reap(reap=reap):
                    got = reap()
                    rows.extend((_window_key(np.pad(w.window, (0, tr.chunk_samples
                                                                - len(w.window)))), w.tokens)
                                for w in got)
                    return got

                engine.reap = capturing_reap
            else:
                server = serve(tr, port=0, continuous=False)
                capture_rows(tr, rows)
            warmup(server)
            rows.clear()
            base = dict(engine.stats) if continuous else {}  # the warmup's chunks left out
            url = f"http://127.0.0.1:{server.server_address[1]}"
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            shapes.clear()
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(6) as pool:
                futs = [pool.submit(post, url, "/transcribe", a.astype("<f4").tobytes(),
                                    "application/octet-stream") for a in audios]
                futs += [pool.submit(openai, url, f) for f in ("verbose_json", "srt")]
                futs.append(pool.submit(stream, url, audios[2]))
                results = [f.result(timeout=900) for f in futs]
            wall = time.perf_counter() - t0
            launches = take_launches(label)
            with urllib.request.urlopen(url + "/statz") as r:
                statz = json.load(r)
            with urllib.request.urlopen(url + "/metrics") as r:
                metrics = r.read().decode()
            t_drain = time.perf_counter()
            drain(server, timeout_s=30)
            t_drain = time.perf_counter() - t_drain
            if statz["requests_served"] != n_requests or \
                    f"yoho_requests_served_total {n_requests}" not in metrics:
                raise AssertionError(f"{phase} ({label}): /statz {statz}, {n_requests} "
                                     "requests expected")
            ties = _tie_check(phase, label, rows, ref)
            # Each response whose windows all decoded here to transcribe_many's
            # tokens holds transcribe_many's result: the text and each
            # segment's times and text (/transcribe), times, text and tokens
            # (verbose_json, /stream), the same srt. A response with a window
            # that left transcribe_many's tokens (inside a tie, as checked
            # above) is named on a line of its own.
            served = defaultdict(list)
            for key, tok in rows:
                served[key].append(tok)

            def timed(segs):  # /transcribe: times and text
                return [(s_["start"], s_["end"], s_["text"]) for s_ in segs]

            def toks(segs):  # /stream: its own window plan, so text and tokens
                return [(s_["text"], s_["tokens"]) for s_ in segs]

            def want_timed(r, with_tokens=False):
                return [(s_.start, s_.end, s_.text)
                        + ((list(map(int, s_.tokens)),) if with_tokens else ())
                        for s_ in r.segments]

            bodies = [json.loads(r) for r in results[:4]]
            verbose = bodies[3]
            responses = [(f"/transcribe {int(seconds[i])} s", audios[i],
                          (bodies[i]["text"], timed(bodies[i]["segments"])),
                          (expected[i].text, want_timed(expected[i]))) for i in range(3)]
            responses += [
                ("verbose_json 30 s", audio_30,
                 (verbose["text"], [(s_["start"], s_["end"], s_["text"], s_["tokens"])
                                    for s_ in verbose["segments"]]),
                 (expected_30.text, want_timed(expected_30, True))),
                ("srt 30 s", audio_30, results[4].decode(), srt_30),
                ("/stream 75 s", audios[2], toks(results[5]),
                 [(s_.text, list(map(int, s_.tokens))) for s_ in expected[2].segments])]
            checked, skipped = [], []
            for name, audio, got, want in responses:
                keys = keys_of(audio)
                if any(key not in served or key not in exp_rows for key in keys):
                    raise AssertionError(f"{phase} ({label}): {name}: a window of the "
                                         "request was not decoded")
                if not all(same(t, exp_rows[key]) for key in keys for t in served[key]):
                    skipped.append(name)
                    emit("response-check-skipped", path=phase, part=label, response=name,
                         reason="a window decoded to other tokens than transcribe_many's "
                                "(inside a tie)")
                    continue
                if got != want:
                    raise AssertionError(f"{phase} ({label}): {name} differs from "
                                         f"transcribe_many's: {got!r} against {want!r}")
                checked.append(name)
            inside = sorted(k for k in shapes if k[0] and k[3] != "no pos")
            if continuous and (not inside or any(k[3] != "per-row pos" for k in inside)):
                raise AssertionError(f"{phase} ({label}): causal reads in chunks {inside}")
            out[label] = dict(wall_s=wall, audio_s_per_s=(sum(seconds) + 30 * 2 + seconds[2])
                              / wall, requests_served=statz["requests_served"],
                              drain_s=t_drain, statz=statz, **ties,
                              responses_checked=checked, responses_skipped=skipped,
                              **({"chunks": engine.stats["chunks"] - base["chunks"],
                                  "reaps": engine.stats["reaps"] - base["reaps"],
                                  "slot_occupancy_per_chunk":
                                      (engine.stats["occupied_slot_chunks"]
                                       - base["occupied_slot_chunks"])
                                      / max(engine.stats["chunks"] - base["chunks"], 1)}
                                 if continuous else {}),
                              decode_launches=by_shape(), launches=launches)

        # (c) The speculative slots: gamma 4 with the target as its own
        # draft, the 5 windows admitted one per chunk.
        gamma = SPEC_GAMMA
        tr = Transcriber(model, draft_model=model, speculative_gamma=gamma, **serving)
        engine = SlotEngine(tr, slots=BATCH, chunk_tokens=chunk_tokens)
        chunk_hook(engine)
        syncs = reap_syncs(engine)
        shapes.clear()
        queue, done = [_Window(w, prompt) for w in windows], []
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        while queue or engine.busy:
            if queue and engine.free_slots:
                del queue[:engine.admit_many(queue[:1])]
                done += engine.reap()
            if engine.busy:
                done += engine.step()
        wall = time.perf_counter() - t0
        launches = take_launches("c")
        stats = dict(engine.stats)
        rounds = stats["chunks"] * max(1, chunk_tokens // (gamma + 1))
        verify = shapes.get((True, BATCH, gamma + 1, "per-row pos"), 0)
        inside_scalar = [k for k in shapes if k[0] and k[3] == "scalar pos"]
        if verify != rounds * cfg.n_text_layer or inside_scalar or len(done) != len(windows) \
                or syncs[0] != stats["reaps"]:
            raise AssertionError(f"{phase} (c): verify reads {verify}, {rounds} rounds, "
                                 f"scalar causal reads in chunks {inside_scalar}, "
                                 f"{len(done)} windows, {syncs[0]} host syncs seen in "
                                 f"{stats['reaps']} reaps")
        ties = _tie_check(phase, "speculative slots", [(_window_key(np.pad(w.window, (
            0, tr.chunk_samples - len(w.window)))), w.tokens) for w in done], ref)
        out["speculative slots"] = dict(
            gamma=gamma, wall_s=wall, audio_s_per_s=sum(seconds) / wall, rounds=rounds,
            chunks=stats["chunks"], host_syncs_in_chunks=0, host_syncs_in_reaps=syncs[0],
            reaps=stats["reaps"],
            slot_occupancy_per_chunk=stats["occupied_slot_chunks"] / stats["chunks"],
            decode_launches=by_shape(), launches=launches, **ties)
    finally:
        del da.KERNEL.launch
    emit(phase, model="whisper-small", slots=BATCH, chunk_tokens=chunk_tokens,
         requests=[int(x) for x in seconds], parts=out, launches=dict(total), card=card)
    return dict(total)


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
    from yoho_tpu_torch.ops import decode_attention, flash_attention, mel_kernel, w8a8_dense

    t0 = time.perf_counter()
    per_source = _build.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source)

    kernels = [mel_kernel.KERNEL, flash_attention.KERNEL, decode_attention.KERNEL,
               w8a8_dense.KERNEL]
    entries = kernel_checks(card)
    launches = {k.name: 0 for k in kernels}
    for path in PATHS:
        for name, n in e2e(card, kernels, *path, trace="--profile" in argv).items():
            launches[name] += n
    for name, n in e2e_options(card, kernels, trace="--profile" in argv).items():
        launches[name] += n
    for phase in (e2e_files, e2e_spec, e2e_serve):
        t0 = time.perf_counter()
        for name, n in phase(card, kernels).items():
            launches[name] += n
        emit("phase-wall", path=phase.__name__.replace("_", "-"),
             seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [
        dict(entries[k.name], launches=launches[k.name]) for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
