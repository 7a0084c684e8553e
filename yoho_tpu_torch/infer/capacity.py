"""Device-memory capacity model: a safe serving batch (``batch_size="auto"``).

The port's counterpart of the JAX package's ``infer/capacity.py``, refit to
the buffers the port allocates on a CUDA card. A suggestion is how many
decode streams fit in the device's memory beside the weights. Per stream
(one row of a decode batch), each term one of the port's own buffers:

* cross-attention K/V (``Whisper.cross_kvs``) — int8 (int4: two codes a
  byte) codes ``2 * n_text_layer * n_state * T`` with T the encoder length
  padded to a multiple of 128 (1500 -> 1536), plus bf16 scales per (head,
  position) ``2 * n_text_layer * n_head * T * 2`` bytes; float K/V keep the
  model's type and the unpadded length;
* self-attention cache (``Whisper.init_caches``) — ``2 * n_text_layer *
  n_state * L`` cells, L the decode horizon rounded up to 128 (448 -> 512),
  in the cache's type, or int8 codes plus bf16 scales per (head, position);
  beams keep one cache per beam (the cross K/V stay one per stream);
* the audio window (``n_samples`` f32), its log-mel (``n_frames * n_mels``
  f32) and the encoder output (``n_audio_ctx * n_audio_state`` in the
  model's type), which the decode holds;
* staging: the encoder's live activations while a batch encodes, one block
  at a time (eager PyTorch frees each block's temporaries), so
  ``_STAGING_CELLS * n_audio_ctx * n_audio_state`` in the model's type
  whatever the depth. These are not buffers the port sizes itself, and
  they do not coexist with the caches (the encode peak comes before the
  decode holds its K/V), so the term is what the encode peak needs beyond
  the other terms, calibrated on the card: ``chip_smoke.py``'s
  ``capacity`` line takes ``max_memory_allocated`` through log-mel,
  encode, int8 cross-K/V, prefill and 8 decode steps at batch 16 and 32,
  the slope per stream. On an NVIDIA H100 80GB HBM3 (700 W) the readings
  left room for -1.4 tensors (whisper-small: the decode's hold sets its
  peak), 3.7 (large-v3-turbo int8) and 4.8 (large-v3-turbo bf16), and
  whisper-small's slope moved by 2.3 MB (one tensor at its width) between
  two calls; 6 keeps the sum at or above every reading with about a
  tensor to spare. On one card the captured greedy programs keep their
  cross-K/V, caches and graph pool between calls
  (``infer/decode_programs.py``), so a repeated call encodes beside them:
  the transcriber encodes a batch in row chunks of an eighth, no fewer
  than 16 rows (``DecodeProgramsMixin._encode``), whose activations fit in
  this term; ``chip_smoke.py``'s e2e-auto holds a repeated call's peak to
  the model as well as the first call's.

The YOHO family (``family="yoho"``) has the same terms at its own widths:
float cross K/V and caches of ``kv_heads * head_dim`` cells a position
(the GQA KV width, half the model width), over ``encoder_positions``
(512) and the decode horizon rounded to 128 (256), the 164,080-sample
window, its 1,024 x 128 log-mel, and the encoder's 512 x ``dims``
activations. Its staging term is 9 such tensors: the card's reading
(``chip_smoke.py``'s e2e-yoho ``capacity`` line, NVIDIA H100 80GB HBM3,
700 W) left room for 7.5 at the default width, above the 6 of whisper's.

The device's memory is ``torch.cuda.mem_get_info``'s total on the resolved
device (the host's physical memory for a CPU device); the fixed cost is the
model's parameters and buffers as stored (the int8 lanes' codes and scales,
the float32 LayerNorms), a draft model's too, and a reserve for the CUDA
context, cuBLAS workspaces and the allocator's rounding.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

# Held back beside the weights: the CUDA context, cuBLAS workspaces, the
# caching allocator's rounding.
RESERVE_BYTES = 1 << 30
_LANE = 128  # the port pads cross K/V and rounds cache lengths to this
# The encoder's peak beyond the other terms, in (encoder positions x
# encoder width) tensors of the model's type, calibrated on the card
# (module doc): whisper's 4x GELU MLP and YOHO's 3x SwiGLU (gate, up and
# their product live together).
_STAGING_CELLS = {"whisper": 6, "yoho": 9}


# ---------------------------------------------------------------------------
# Parameter counts (analytic, as in the JAX package)
# ---------------------------------------------------------------------------

def whisper_param_count(cfg) -> int:
    """Parameters of a Whisper checkpoint from its dimensions."""
    s_a, s_t = cfg.n_audio_state, cfg.n_text_state
    # Conv stem: (n_mels -> s, k=3) then (s -> s, k=3), both biased.
    conv = cfg.n_mels * s_a * 3 + s_a + s_a * s_a * 3 + s_a
    # Encoder block: attn 4*s^2 (+q/v/out biases), MLP 8*s^2, 2 LNs.
    enc = cfg.n_audio_layer * (12 * s_a * s_a + 12 * s_a) + 2 * s_a
    # Decoder block: self 4*s^2 + cross 4*s^2 + MLP 8*s^2, 3 LNs.
    dec = cfg.n_text_layer * (16 * s_t * s_t + 18 * s_t) + 2 * s_t
    embed = cfg.n_vocab * s_t + cfg.n_text_ctx * s_t  # tied logits
    return conv + enc + dec + embed


def yoho_param_count(cfg, vocab_size: int, voiceprint_dim: int = 256) -> int:
    """Parameters of the YOHO model (``nn/yoho.py``) from its dimensions:
    the JAX package's count plus the RMSNorm scales and the voiceprint
    head, which it leaves out."""
    s = cfg.dims
    conv = cfg.n_mel_bands * s * 3 + s * s * 3 + 2 * s + 2 * s  # + norm1, norm2
    # GQA with kv_heads = q_heads // 2: q + out = 2*s^2, k + v = s^2;
    # SwiGLU(3x) = 9*s^2 (encoder), SwiGLU(1.5x) = 4.5*s^2 (decoder), with
    # 2 (encoder) and 4 (decoder) RMSNorms a block.
    enc = cfg.n_audio_blocks * (int(12 * s * s) + 2 * s)
    dec = cfg.n_text_blocks * (int(10.5 * s * s) + 4 * s)
    # A Mixture-of-Experts block (nn/moe.py) holds n_experts SwiGLUs and an
    # s x n_experts router in place of its one SwiGLU.
    n = cfg.n_experts
    if n > 0:
        every = cfg.moe_every_n
        moe_enc = sum(i % every == every - 1 for i in range(cfg.n_audio_blocks))
        moe_dec = sum(i % every == every - 1 for i in range(cfg.n_text_blocks)) \
            if cfg.moe_in_decoder else 0
        enc += moe_enc * ((n - 1) * 3 * s * int(s * 3) + s * n)
        dec += moe_dec * ((n - 1) * 3 * s * int(s * 1.5) + s * n)
    return conv + enc + dec + s + vocab_size * s + s * voiceprint_dim


def module_bytes(model: torch.nn.Module) -> int:
    """Bytes of a module's parameters and buffers as stored on its device."""
    tensors = list(model.parameters()) + list(model.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Per-stream terms
# ---------------------------------------------------------------------------

def _round_up(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


def _kv_bytes(n_layer: int, n_state: int, n_head: int, t: int,
              mode) -> int:
    """K and V over ``t`` positions for ``n_layer`` layers: ``mode`` None
    (or a float item size) for float values, "int8" or "int4" for codes
    with bf16 scales per (head, position)."""
    if mode in ("int8", "int4"):
        codes = 2 * n_layer * n_state * t // (2 if mode == "int4" else 1)
        return codes + 2 * n_layer * n_head * t * 2
    return 2 * n_layer * n_state * t * int(mode)


def _widths(cfg, family: str) -> tuple:
    """(decoder layers, K/V cells a position, K/V heads, encoder positions,
    encoder width, default horizon, mel cells) of a configuration."""
    if family == "whisper":
        return (cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head,
                cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_text_ctx,
                cfg.n_frames * cfg.n_mels)
    if family == "yoho":
        kvh = max(1, cfg.n_text_heads // 2)  # nn/yoho.py's KV heads
        return (cfg.n_text_blocks, kvh * (cfg.dims // cfg.n_text_heads), kvh,
                cfg.encoder_positions, cfg.dims, cfg.max_text_len,
                cfg.max_audio_len * cfg.n_mel_bands)
    raise ValueError(f"unknown family {family!r}")


def stream_terms(cfg, family: str = "whisper", *, horizon: Optional[int] = None,
                 cross_kv="int8", cache_quantized: bool = True,
                 cache_itemsize: int = 2, act_itemsize: int = 2,
                 beams: int = 0) -> Dict[str, int]:
    """Device bytes one decode stream holds, by buffer (module doc).

    ``cross_kv``: "int8", "int4" or None (float K/V in the model's type);
    ``cache_quantized``: an int8 self cache, else one of
    ``cache_itemsize``-byte cells; ``act_itemsize``: the model's type;
    ``beams``: caches per stream (0 and 1 mean one). The YOHO family has
    float K/V and caches only."""
    n_layer, n_state, n_head, n_ctx, enc_state, default_horizon, mel = \
        _widths(cfg, family)
    staging = _STAGING_CELLS[family]
    horizon = default_horizon if horizon is None else horizon
    enc_cells = n_ctx * enc_state
    if cross_kv in ("int8", "int4"):
        cross = _kv_bytes(n_layer, n_state, n_head, _round_up(n_ctx, _LANE), cross_kv)
    else:
        cross = _kv_bytes(n_layer, n_state, n_head, n_ctx, act_itemsize)
    cache = _kv_bytes(n_layer, n_state, n_head, _round_up(max(1, horizon), _LANE),
                      "int8" if cache_quantized else cache_itemsize)
    return {
        "cross_kv": cross,
        "self_cache": cache * max(1, beams),
        "audio": cfg.n_samples * 4,
        "mel": mel * 4,
        "encoder_out": enc_cells * act_itemsize,
        "staging": staging * enc_cells * act_itemsize,
    }


def stream_bytes(cfg, family: str = "whisper", **kw) -> int:
    """The sum of :func:`stream_terms`."""
    return sum(stream_terms(cfg, family, **kw).values())


def device_memory_bytes(device) -> int:
    """Memory of ``device``: ``torch.cuda.mem_get_info``'s total for a CUDA
    device, the host's physical memory for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    if device.type == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise ValueError(f"no memory reading for device {device}")


def suggest_batch_size(cfg, family: str = "whisper", *, device_bytes: int,
                       weight_bytes: Optional[int] = None,
                       vocab_size: Optional[int] = None,
                       quantum: int = 8, max_batch: int = 512,
                       extra_fixed_bytes: int = 0, extra_stream_bytes: int = 0,
                       data_shards: int = 1, model_shards: int = 1,
                       **terms) -> int:
    """A serving batch that fits in ``device_bytes`` (one device's).

    ``weight_bytes``: the model as one device stores it (default: the
    analytic parameter count in bf16 over ``model_shards``; a YOHO config
    needs ``vocab_size`` for it); ``extra_fixed_bytes`` /
    ``extra_stream_bytes``: what the configuration alone cannot see (a
    draft model and its per-stream buffers); ``data_shards`` /
    ``model_shards``: the mesh axes. Data parallelism multiplies the batch
    by ``data_shards``; tensor parallelism splits the K/V terms (the cross
    K/V and the self cache hold this rank's heads) over ``model_shards``,
    while every rank holds the stream's audio, log-mel, encoder output and
    staging whole. (The JAX package divides every term: on four H100s that
    predicted 232 MB for whisper-small's 16 streams a rank where 389 MB
    were measured; PERF.md.) ``terms``: :func:`stream_terms`' keywords.
    Returns at least 1, at most ``max_batch``, rounded down to ``quantum``
    above it, times ``data_shards``."""
    m = max(1, model_shards)
    if weight_bytes is None:
        weight_bytes = 2 * (whisper_param_count(cfg) if family == "whisper"
                            else yoho_param_count(cfg, vocab_size)) // m
    budget = device_bytes - weight_bytes - RESERVE_BYTES - max(0, extra_fixed_bytes)
    split = stream_terms(cfg, family, **terms)
    kv = split.pop("cross_kv") + split.pop("self_cache")
    per_stream = -(-kv // m) + sum(split.values()) + max(0, extra_stream_bytes)
    batch = min(max(0, budget) // per_stream, max_batch)
    if batch >= quantum:
        batch = (batch // quantum) * quantum
    return max(1, int(batch)) * max(1, data_shards)


def _lane_kwargs(t, model, horizon: int) -> dict:
    """:func:`stream_terms`' keywords under a ``Transcriber``'s settings
    for ``model`` (its model or its draft)."""
    q = t.quantized_cross_kv
    return dict(horizon=horizon,
                cross_kv={False: None, None: None, True: "int8"}.get(q, q),
                cache_quantized=bool(t.quantized_cache),
                cache_itemsize=torch.empty((), dtype=t.cache_dtype).element_size(),
                act_itemsize=torch.empty((), dtype=model.dtype).element_size(),
                beams=t.beams)


def resolve_auto_batch(t) -> int:
    """Resolve ``Transcriber(batch_size="auto")`` from its live settings:
    its model (and draft) as stored on its device, the cross-K/V and cache
    lanes, the beams, the speculative horizon and its mesh (a sharded
    model's bytes are this device's). Over a mesh the batch is a rank's
    batch times the data axis, so a slot engine over it (``serve --mesh
    --batch auto``) holds a rank's batch of slots on each rank."""
    horizon, fixed, extra = t.max_len, 0, 0
    if t.draft_model is not None:
        # Both cache sets hold the stale-write workspace past the horizon
        # (gamma + 2 slots); the draft encodes the same window.
        horizon = t.max_len + t.speculative_gamma + 2
        fixed = module_bytes(t.draft_model)
        d_terms = stream_terms(t.draft_model.cfg, t.family,
                               **_lane_kwargs(t, t.draft_model, horizon))
        extra = sum(v for k, v in d_terms.items() if k not in ("audio", "mel"))
    mesh = getattr(t, "mesh", None)
    shards = {} if mesh is None else mesh.shape
    return suggest_batch_size(
        t.model.cfg, t.family, device_bytes=device_memory_bytes(t.device),
        weight_bytes=module_bytes(t.model), extra_fixed_bytes=fixed,
        extra_stream_bytes=extra, data_shards=shards.get("data", 1),
        model_shards=shards.get("model", 1), **_lane_kwargs(t, t.model, horizon))
