"""Fused decode attention over time-minor (B, H, D, T) KV: the CUDA kernels
``csrc/decode_attention.cu`` (the FMA route) and ``csrc/decode_attention_mq.cu``
(the tensor-core route), and their plain PyTorch version.

Counterpart of the JAX package's ``ops/decode_attention.py::
fused_decode_attention``, with the same contract:

  q        (B, Hq, S, D)   f32/bf16, already scaled
  k, v     (B, Hkv, D, T)  int8 (with scales), (B, Hkv, D/2, T) uint8
                           nibble-packed int4 (``packing=2``), or the type
                           of q (scales None)
  k_scale  (B, Hkv, 1, T)  bf16 per-position scales on the scores
  v_scale  (B, Hkv, 1, T)  bf16, folded into the attention weights
  pos      int or (B,)     causal: query row i of batch row b sees keys
           int32 tensor    <= pos + i, or <= pos[b] + i for a per-row
                           tensor on q's device (continuous batching)
  kv_len   int             only keys < kv_len are valid
  groups   int             Hq = groups * Hkv; head h reads kv head h//groups

Returns (B, S, Hq, D) in q's type. D is any head dim >= 1 (int4: an even
one), up to 256 run at the smallest instantiated width W that holds it
(:func:`kernel_width`; zero-padded in shared memory), above 256 split into
slices of width 256 (:func:`kernel_slices`): a cluster per slice sums the
scores over all of D (K's rows in parts of 256, int4's in byte rows of 128,
each holding dims r and r + D/2) and computes its slice's outputs.
Unlike the TPU kernel, T need not be a multiple of 128: int8/int4/bf16
rows of a multiple of 16 bytes (the padded cross K/V, the cache) stream in
by TMA tile loads, rows of a multiple of 4 bytes by asynchronous word
copies, any other T element by element. A thread-block cluster per
(b, head) merges its blocks' softmax states (sm_90a). Two routes
(:func:`kernel_route`): several bf16 queries (a prompt's prefill, beams
folded into the query axis, a speculative verify) run on tensor cores, one
launch per call at any S, the K/V of a KV head read once for all its query
heads ("mma"); a single query, and f32 q at any S, run on FMAs ("fma"), at
most 32 queries a launch (4 at width 256): longer f32 runs go through it in
chunks, one launch each, a causal chunk whose first query is i0 at
``pos + i0`` (for a per-row ``pos`` an offset tensor on the device). A
per-row ``pos`` is read by the kernels only, never by the host: the grid
spans ``min(T, kv_len)`` and each (b, h) ends its row at
``min(T, kv_len, pos[b] + S)``. Batch x heads lie on a grid axis of at most
65,535 blocks (the FMA route: B x Hq; tensor cores: B x Hkv): a larger
batch (a beam step's B x K rows) launches in runs of rows, one count each
(``_build.row_chunks``); below the limit the call is one launch. The
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches a kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from yoho_tpu_torch.ops._build import I, P, CudaKernel, ptr, row_chunks, stream_of

# Both entry points take the same arguments: q dtype, K/V kind, q, k, v,
# k_scale, v_scale, out, B, Hq, Hkv, S, D, T, kv_len, causal, pos,
# per-row pos, stream.
_ARGS = [I, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P, P]
_REPLACES = "yoho_tpu/ops/decode_attention.py:140 _decode_attention_call"
KERNEL = CudaKernel("decode_attention", "decode_attention.cu", "decode_attention", _ARGS,
                    replaces=_REPLACES)
KERNEL_MQ = CudaKernel("decode_attention_mq", "decode_attention_mq.cu", "decode_attention_mq",
                       _ARGS, replaces=_REPLACES)
KERNELS = (KERNEL, KERNEL_MQ)

_QTYPES = {torch.float32: 0, torch.bfloat16: 1}
KINDS = ("int8", "int4", "float")  # the kernels' K/V kind codes 0, 1, 2
# The instantiated head dims, the same for every K/V kind: 64 is whisper
# and the full-width YOHO model. Every other head dim up to 256 runs padded
# to the next, every one above in slices of 256: any D >= 1, an even one for
# int4 (a byte holds dims r and r + D/2).
WIDTHS = (16, 32, 64, 128, 256)
MAX_QUERIES = 32    # queries per FMA launch (its per-row softmax states)
MAX_QUERIES_256 = 4  # at width 256, and split
NEG_INF = torch.finfo(torch.float32).min


def kernel_slices(d: int, kind: str = "float") -> tuple:
    """The widths of the slices of the output dims that the kernels compute
    head dim ``d`` in for K/V of ``kind`` ("float", "int8" or "int4"): up to
    256 one slice at the smallest of :data:`WIDTHS` that holds it, above 256
    (split) one slice of width 256 per 256 dims, the last padded (264 ->
    (256, 256)); an int4 slice is 128 byte rows, dims r and r + D/2 of each.
    Raises ``ValueError`` for a head dim they do not take (below 1; int4:
    also an odd one: a byte holds dims r and r + D/2, and the JAX package's
    ``quantize_kv4`` cannot pack an odd one either)."""
    if kind not in KINDS:
        raise ValueError(f"unknown K/V kind {kind!r}")
    if d < 1:
        raise ValueError(f"decode kernel head dim {d} below 1 for {kind} K/V")
    if kind == "int4" and d % 2:
        raise ValueError(f"decode kernel head dim {d} not even for {kind} K/V")
    if d > WIDTHS[-1]:
        return (WIDTHS[-1],) * -(-d // WIDTHS[-1])
    return (next(w for w in WIDTHS if w >= d),)


def kernel_width(d: int, kind: str = "float") -> int:
    """The instantiated width W the kernels run head dim ``d`` at for K/V
    of ``kind``: the smallest of :data:`WIDTHS` that holds it, 256 for
    every slice above 256 (:func:`kernel_slices`). Raises ``ValueError``
    for a head dim they do not take (below 1; int4: also an odd one)."""
    return kernel_slices(d, kind)[0]


def kernel_route(s: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The route a read of ``s`` queries in q of ``dtype`` runs: "mma"
    (tensor cores, ``decode_attention_mq.cu``) for several bf16 queries,
    "fma" (``decode_attention.cu``) for one query or f32 q."""
    return "mma" if dtype == torch.bfloat16 and s >= 2 else "fma"


def is_row_pos(pos) -> bool:
    """True for a per-row position vector (B,), the continuous-batching
    layout where every row decodes at its own position."""
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def unpack_int4(x: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """(…, D/2, …) uint8 nibble-packed -> (…, D, …) int8 in [-8, 7]."""
    lo = (x & 0xF).to(torch.int8) - 8
    hi = (x >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=axis)


def attend_time_minor(q, k, v, k_scale, v_scale, mask, dtype) -> torch.Tensor:
    """Plain attention against time-minor K/V; q (B, H, S, D) pre-scaled,
    k and v (B, H, D, T) as stored (integer codes or floats), scales
    (B, H, 1, T) or None, ``mask`` broadcastable to (B, H, S, T) or None.
    The arithmetic of the JAX package's ``_attend_quantized``: f32 scores,
    finfo.min mask, softmax, ``v_scale`` folded into the weights, weights
    and values in ``dtype`` for the value product. Returns (B, S, H, D)."""
    scores = torch.einsum("bhsd,bhdt->bhst", q.float(), k.to(dtype).float())
    if k_scale is not None:
        scores = scores * k_scale.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        w = w * v_scale.float()
    out_t = torch.einsum("bhdt,bhst->bhds", v.to(dtype), w.to(dtype))
    return out_t.permute(0, 3, 1, 2)


def decode_attention_reference(q, k, v, k_scale=None, v_scale=None, pos=None,
                               kv_len: Optional[int] = None, groups: int = 1,
                               packing: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same contract)."""
    t = k.shape[3]
    s = q.shape[2]
    if packing == 2:
        k, v = unpack_int4(k), unpack_int4(v)
    if groups > 1:
        k, v = k.repeat_interleave(groups, 1), v.repeat_interleave(groups, 1)
        if k_scale is not None:
            k_scale = k_scale.repeat_interleave(groups, 1)
            v_scale = v_scale.repeat_interleave(groups, 1)
    cols = torch.arange(t, device=q.device)
    mask = None
    if kv_len is not None and kv_len < t:
        mask = (cols < kv_len)[None, :].expand(s, t)
    if pos is not None:
        rows = torch.arange(s, device=q.device)[:, None]
        if is_row_pos(pos):  # JAX's decode_mask of a vector: (B, 1, S, T)
            causal = (cols[None, None, :] <= pos.long()[:, None, None] + rows)[:, None]
        else:
            causal = cols[None, :] <= int(pos) + rows
        mask = causal if mask is None else mask & causal
    return attend_time_minor(q, k, v, k_scale, v_scale, mask, q.dtype)


def fused_decode_attention(q, k, v, k_scale=None, v_scale=None, pos=None,
                           kv_len: Optional[int] = None, groups: int = 1,
                           packing: int = 1) -> torch.Tensor:
    """Decode attention through a kernel (CUDA) or its plain version
    (CPU); see the module docstring for the contract."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[3]
    kv_len = t if kv_len is None else int(kv_len)
    if hq != groups * hkv or k.shape != (b, hkv, d // packing, t) \
            or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} disagree (groups={groups}, "
                         f"packing={packing})")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    row_pos = is_row_pos(pos)
    if row_pos and (pos.shape != (b,) or pos.device != q.device
                    or pos.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"per-row pos must be a ({b},) integer tensor on "
                         f"{q.device}, got {tuple(pos.shape)} {pos.dtype} on "
                         f"{pos.device}")
    route = kernel_route(s, q.dtype)
    chunk = MAX_QUERIES if d <= 128 else MAX_QUERIES_256
    if route == "fma" and s > chunk:
        out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
        for i0 in range(0, s, chunk):
            i1 = min(i0 + chunk, s)
            out[:, i0:i1] = fused_decode_attention(
                q[:, :, i0:i1], k, v, k_scale, v_scale,
                None if pos is None else (pos + i0 if row_pos else int(pos) + i0),
                kv_len, groups, packing)
        return out
    if not q.is_cuda:
        return decode_attention_reference(q, k, v, k_scale, v_scale, pos,
                                          kv_len, groups, packing)
    if q.dtype not in _QTYPES:
        raise TypeError(f"decode kernel takes f32 or bf16 q, got {q.dtype}")
    if packing == 2:
        kind = "int4"
        if k.dtype != torch.uint8:
            raise TypeError(f"packed int4 K/V must be uint8, got {k.dtype}")
    elif k.dtype == torch.int8:
        kind = "int8"
    elif k.dtype == q.dtype:
        kind = "float"
    else:
        raise TypeError(f"decode kernel takes int8, packed int4 or {q.dtype} "
                        f"K/V, got {k.dtype}")
    if (kind == "float") != (k_scale is None):
        raise ValueError("integer K/V need scales; float K/V take none")
    kernel_width(d, kind)
    if kind != "float" and (k_scale.shape != (b, hkv, 1, t)
                           or k_scale.dtype != torch.bfloat16
                           or v_scale.shape != k_scale.shape
                           or v_scale.dtype != torch.bfloat16):
        raise ValueError("scales must be bf16 of shape (B, Hkv, 1, T)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ks = k_scale.contiguous() if k_scale is not None else None
    vs = v_scale.contiguous() if v_scale is not None else None
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    causal = pos is not None
    # A per-row pos goes to the kernel as an int32 device pointer; the
    # scalar stays an int argument.
    pos_rows = pos.to(torch.int32).contiguous() if row_pos else None
    # Batch x heads lie on a grid axis of at most 65,535 blocks (the FMA
    # route's y: every query head; the tensor-core route's z: every KV
    # head): a larger batch launches in runs of rows, each counted.
    for b0, b1 in row_chunks(b, hkv if route == "mma" else hq):
        rows = slice(b0, b1)
        (KERNEL_MQ if route == "mma" else KERNEL).launch(
            _QTYPES[q.dtype], KINDS.index(kind), ptr(q[rows]), ptr(k[rows]), ptr(v[rows]),
            ptr(ks[rows]) if ks is not None else None,
            ptr(vs[rows]) if vs is not None else None, ptr(out[rows]),
            b1 - b0, hq, hkv, s, d, t, kv_len, int(causal),
            int(pos) if causal and not row_pos else 0,
            ptr(pos_rows[rows]) if row_pos else None, stream_of(q))
    return out
