"""Layers: whisper's multi-head attention with decode caches, MLP and
LayerNorm; YOHO's grouped-query attention with RoPE, SwiGLU and RMSNorm.

The JAX package's ``nn/layers.py``. Whisper keeps OpenAI's
attention semantics: biases on q/v/out but not k, and the 0.25-power scale
``head_dim**-0.25`` on both q and k. Attention modes:

* full self-attention ``forward(x)``, causal with ``causal=True``;
* full cross-attention ``forward(x, xa=encoder_out)``;
* cached self decode ``forward(x, cache=..., pos=i)`` -> (out, cache),
  ``pos`` an int or a per-row (B,) tensor (continuous batching);
* cached cross decode ``forward(x, cross_kv=...)`` with K/V from :meth:`kv`
  or a :class:`QuantizedKV`. Beam search passes B*K query rows against
  an untiled (B, ...) cross K/V: the K beams of a stream fold into the
  query axis (:func:`_beam_fold`, :func:`_fold_queries`), so all of them
  share one cross read.

The full modes run through the flash kernel, the cached modes read their
K/V through the decode attention kernel. The JAX package's explicit
boolean masks (``causal_mask``, ``decode_mask``) are not needed: both
kernels take the causal rule and the valid length as arguments.
:meth:`MultiHeadAttention.attention_map` (the word-timestamp alignment
signal) is plain PyTorch, as it is an XLA einsum in the JAX package.

The int8 serving layers hold their codes and scales as buffers, filled by
``nn/quantize.py`` (or ``nn/params.py`` from a JAX-quantized tree), never
trained: :class:`QuantizedDense` (weight-only, the decoder's
``weights_int8``), :class:`Int8Dense` (W8A8 through the w8a8 kernel, the
encoder MLPs' ``encoder_int8``) and :class:`QuantizedEmbed` (the tied
embedding with per-row scales).

The YOHO family (:class:`GroupedQueryAttention`, :class:`SwiGLU`,
:class:`RMSNorm`, :func:`rope_angles`, :func:`apply_rope`) follows the JAX
layers of the same names: bias-free projections, rotary positions on
interleaved even/odd pairs (not the half-split convention), queries scaled
by ``head_dim**-0.5`` after the rotation, every query head attending its
own group's KV head (head h reads KV head ``h // groups``). The flax
``DenseGeneral`` projections to (heads, head_dim) are :class:`DenseGeneral`
here, an ``nn.Linear`` of width heads x head_dim that remembers the split
(``nn/params.py`` reshapes the (in, H, D) kernels). Full modes hand the
unexpanded KV heads to the flash kernel and cached modes give ``groups`` to
the decode attention kernel; each reads a KV head once for its group, as
``jnp.repeat`` on the head axis would give it to every query head.

Tensor parallelism (``parallel/sharding.py::shard_params``): a layer cut
over the ``model`` axis of a mesh holds the mesh as ``tp``. Attention then
runs its local heads (the head dim and the scale stay global), the
row-parallel out projection and the MLPs' fc2/down sum their partial
outputs over the axis (:func:`model_sum`, one all-reduce), and a
vocabulary-sharded embedding looks up its own rows (:func:`embed_tokens`)
and gathers its logits (:func:`vocab_logits`). A layer without ``tp``
computes as before. Under autograd (training) these collectives are the
differentiable ones of ``parallel/mesh.py``, and a sharded layer's input
passes :func:`model_copy` (identity forward, the gradient all-reduced over
the axis: Megatron's pair with :func:`model_sum`); without a gradient they
are the in-place serving collectives, and :func:`model_copy` is nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from yoho_tpu_torch.core.device import full_fp32
from yoho_tpu_torch.nn.kv_cache import (
    KVCache,
    QuantizedKV,
    QuantizedKVCache,
    attend_quantized,
)
from yoho_tpu_torch.ops.decode_attention import fused_decode_attention, is_row_pos
from yoho_tpu_torch.ops.flash_attention import flash_attention
from yoho_tpu_torch.ops.w8a8_dense import quantize_rows as quantize_act_rows  # noqa: F401
from yoho_tpu_torch.ops.w8a8_dense import w8a8_dense
from yoho_tpu_torch.parallel.mesh import AXIS_MODEL, copy_to, gather_over, sum_over


def model_copy(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The input of a sharded layer's column-parallel half: ``x``, whose
    gradient (under autograd) sums the model ranks' parts."""
    tp = getattr(mod, "tp", None)
    return x if tp is None else copy_to(x, tp, AXIS_MODEL)


def model_sum(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel layer's output: the partial sums of the model axis
    added (one all-reduce) when ``mod`` is sharded, else ``x``."""
    tp = getattr(mod, "tp", None)
    return x if tp is None else sum_over(x, tp, AXIS_MODEL)


def embed_tokens(emb: nn.Module, ids: torch.Tensor) -> torch.Tensor:
    """Token lookup. A vocabulary-sharded table looks up the ids in its own
    rows, zeros for the others, and the model axis sums the ranks' rows."""
    tp = getattr(emb, "tp", None)
    if tp is None:
        return emb(ids)
    local = ids - emb.vocab_start
    hit = (local >= 0) & (local < emb.num_embeddings)
    vec = F.embedding(torch.where(hit, local, 0), emb.weight)
    return sum_over(torch.where(hit[..., None], vec, torch.zeros_like(vec)),
                    tp, AXIS_MODEL)


def vocab_logits(emb: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """Tied logits over a vocabulary-sharded table gathered along the
    vocabulary (the ranks' rows in order); else as they are. The hidden
    state entering the product passes :func:`model_copy` first."""
    tp = getattr(emb, "tp", None)
    return logits if tp is None else gather_over(logits, tp, AXIS_MODEL, dim=-1)


def _head_mean(mod: nn.Module, w: torch.Tensor, heads: int) -> torch.Tensor:
    """The mean of (B, H, S, T) attention weights over all heads: over the
    local ones, or their sum over the model axis for a sharded layer."""
    tp = getattr(mod, "tp", None)
    if tp is None:
        return w.mean(dim=1)
    return sum_over(w.sum(dim=1), tp, AXIS_MODEL) / (heads * tp.shape[AXIS_MODEL])


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S, D)."""
    return x.transpose(1, 2)


def _bhdt(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, D, S) — the KV storage layout."""
    return x.permute(0, 2, 3, 1)


def _beam_fold(q_batch: int, kv_batch: int) -> int:
    """K (``q_batch // kv_batch``) when beam search passed the untiled
    (B, ...) cross K/V for its B*K query rows, else 1. Every beam of a
    stream attends the same encoder output: folding the beams into the
    query axis reads that K/V once instead of K times."""
    if kv_batch == q_batch or q_batch % kv_batch:
        return 1
    return q_batch // kv_batch


def _fold_queries(q: torch.Tensor, fold: int) -> torch.Tensor:
    """(Bc*fold, H, S, D) -> (Bc, H, fold*S, D), beams major in the new
    query axis (row b*fold+j -> query j*S+s), so the attention output
    (Bc, fold*S, H, D) reshapes straight back to (Bc*fold, S, H, D)."""
    bc = q.shape[0] // fold
    h, s, d = q.shape[1:]
    return (q.reshape(bc, fold, h, s, d).transpose(1, 2)
            .reshape(bc, h, fold * s, d))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 parameters and statistics, output in the
    input's type — what flax's ``LayerNorm(dtype=bf16)`` computes."""

    def __init__(self, n_state: int, device=None):
        super().__init__(n_state, eps=1e-5, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


CrossKV = Union[Tuple[torch.Tensor, torch.Tensor], QuantizedKV]
Cache = Union[KVCache, QuantizedKVCache]


class _Int8Weights(nn.Module):
    """An (out, in) int8 weight with per-output-channel f32 scales and an
    optional f32 bias, as buffers; ``dtype`` is the model's type."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones((out_features,), **f32))
        self.register_buffer("bias", torch.zeros((out_features,), **f32)
                             if bias else None)


class QuantizedDense(_Int8Weights):
    """Weight-only int8 linear layer: the JAX package's ``QuantizedDense``
    with its numerics: the product of x and the int8 codes accumulated in
    f32, times the per-channel scale, one rounding to the model's type, then
    the bias added in that type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_fp32():  # operands of the model's type are exact in f32
            y = F.linear(x.to(self.dtype).float(), self.weight_q.float())
        y = (y * self.weight_scale).to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Int8Dense(_Int8Weights):
    """W8A8 linear layer (the JAX package's ``Int8Dense``): activations
    quantized per row at run time, int8 x int8 product, per-channel rescale,
    bias and the optional tanh-GELU (``activation="gelu_tanh"``) fused, all
    in the w8a8 kernel; the output is in the model's type."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None,
                 activation: Optional[str] = None):
        super().__init__(in_features, out_features, bias, dtype, device)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8a8_dense(x, self.weight_q, self.weight_scale, self.bias,
                          activation=self.activation, out_dtype=self.dtype)


class QuantizedEmbed(nn.Module):
    """Tied embedding stored int8 with per-row (per-token) f32 scales; serves
    the lookup and the tied logits (the JAX package's ``QuantizedEmbed``)."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            (num_embeddings, features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            (num_embeddings,), dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        vec = self.weight_q[ids].to(self.dtype)
        return vec * self.weight_scale[ids].unsqueeze(-1).to(self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits: the f32 product with the codes, times each row's
        scale."""
        with full_fp32():
            y = F.linear(x.float(), self.weight_q.float())
        return y * self.weight_scale


class RMSNorm(nn.Module):
    """flax's ``nn.RMSNorm``: epsilon 1e-6, the mean square in float32, the
    float32 scale applied to the float32 product, one rounding to
    ``dtype``; the parameter keeps flax's name, ``scale``."""

    def __init__(self, n_state: int, dtype=torch.float32, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n_state, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps) * self.scale
        return (xf * mul).to(self.dtype)


class DenseGeneral(nn.Linear):
    """flax ``DenseGeneral`` projecting to ``features`` = (heads, head_dim),
    bias-free: an ``nn.Linear`` to heads x head_dim whose output is viewed
    as (..., heads, head_dim)."""

    def __init__(self, in_features: int, features: Tuple[int, int],
                 dtype=torch.float32, device=None):
        super().__init__(in_features, features[0] * features[1], bias=False,
                         dtype=dtype, device=device)
        self.features = tuple(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).unflatten(-1, self.features)


class QuantizedDenseGeneral(QuantizedDense):
    """Weight-only int8 :class:`DenseGeneral` (the JAX package's
    ``QuantizedDenseGeneral``): per-output-channel scales over (h, hd)."""

    def __init__(self, in_features: int, features: Tuple[int, int],
                 dtype=torch.float32, device=None):
        super().__init__(in_features, features[0] * features[1], bias=False,
                         dtype=dtype, device=device)
        self.features = tuple(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).unflatten(-1, self.features)


class SwiGLU(nn.Module):
    """Gated MLP: down(silu(gate(x)) * up(x)), bias-free."""

    def __init__(self, d_in: int, hidden_dim: int, dtype=torch.float32,
                 device=None, weights_int8: bool = False):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        dense = QuantizedDense if weights_int8 else nn.Linear
        self.gate = dense(d_in, hidden_dim, **kw)
        self.up = dense(d_in, hidden_dim, **kw)
        self.down = dense(hidden_dim, d_in, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = model_copy(self, x)
        h = silu(self.gate(x))
        # In place where no gradient is taken: the same product, one hidden-
        # sized tensor less at the peak (:func:`gelu`).
        h = h * self.up(x) if torch.is_grad_enabled() else h.mul_(self.up(x))
        return model_sum(self, self.down(h))


def rope_angles(positions: torch.Tensor, head_dim: int,
                variant: str = "standard", base: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., head_dim // 2) for the given positions, f32.

    ``standard``: theta_i = base^(-2i/d). ``decade``: theta_i = 10^-i with
    positions starting at 1 (the reference's spectrum)."""
    half = head_dim // 2
    dev = positions.device
    i = torch.arange(0, half, dtype=torch.float32, device=dev)
    # The base is filled on the device: a tensor made from a host scalar
    # would copy it there, a host sync inside every decode step.
    if variant == "standard":
        freqs = torch.pow(torch.full((), base, dtype=torch.float32, device=dev),
                          -i * 2.0 / head_dim)
        pos = positions.float()
    elif variant == "decade":
        freqs = torch.pow(torch.full((), 10.0, dtype=torch.float32, device=dev), -i)
        pos = positions.float() + 1.0
    else:
        raise ValueError(f"unknown rope variant {variant!r}")
    ang = pos[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[2i], x[2i+1]): x (B, S, H, D), cos/sin
    (S, D/2), or (B, S, D/2) for per-row positions. In x's type, as the
    JAX package computes it (the f32 tables promote and the result is
    rounded once)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    if cos.ndim == 3:  # (B, S, D/2) -> (B, S, 1, D/2)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[:, None, :], sin[:, None, :]  # (S, 1, D/2)
    r1 = x1 * c - x2 * s
    r2 = x1 * s + x2 * c
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _positions(n: int, pos, device) -> torch.Tensor:
    """RoPE positions of ``n`` new tokens at offset ``pos``: (n,), or
    (B, n) for a per-row ``pos`` tensor (continuous batching)."""
    steps = torch.arange(n, device=device)
    if pos is None:
        return steps
    if is_row_pos(pos):
        return pos.long()[:, None] + steps[None, :]
    return steps + int(pos)


class GroupedQueryAttention(nn.Module):
    """GQA with RoPE and decode caches (the JAX package's
    ``GroupedQueryAttention``). Modes:

    * full self-attention ``forward(x)``, causal with ``causal=True``;
    * full cross-attention ``forward(x, xa=encoder_out)``: keys rotated by
      their own positions;
    * cached self decode ``forward(x, cache=..., pos=i)`` -> (out, cache);
    * cached cross decode ``forward(x, cross_kv=(k, v), pos=i)`` with K/V
      from :meth:`kv` (rotated, time-minor); queries rotated by ``pos``.
      Beam search passes B*K query rows against the untiled (B, ...) K/V:
      the beams fold into the query axis after the rotation."""

    def __init__(self, q_heads: int, dims: int, kv_heads: Optional[int] = None,
                 rope_variant: str = "standard", dtype=torch.float32,
                 device=None, weights_int8: bool = False):
        super().__init__()
        kvh = kv_heads or q_heads
        if q_heads % kvh:
            raise ValueError(f"q_heads ({q_heads}) must be divisible by "
                             f"kv_heads ({kvh})")
        if dims % q_heads:
            raise ValueError(f"dims ({dims}) must be divisible by q_heads "
                             f"({q_heads})")
        self.q_heads, self.kv_heads, self.dims = q_heads, kvh, dims
        self.groups = q_heads // kvh
        self.head_dim = dims // q_heads
        self.rope_variant = rope_variant
        kw = dict(dtype=dtype, device=device)
        dg = QuantizedDenseGeneral if weights_int8 else DenseGeneral
        self.q_proj = dg(dims, (q_heads, self.head_dim), **kw)
        self.k_proj = dg(dims, (kvh, self.head_dim), **kw)
        self.v_proj = dg(dims, (kvh, self.head_dim), **kw)
        self.out_proj = (QuantizedDense if weights_int8 else nn.Linear)(
            dims, dims, bias=False, **kw)

    def _rope(self, x: torch.Tensor, n: int, pos=None) -> torch.Tensor:
        cos, sin = rope_angles(_positions(n, pos, x.device), self.head_dim,
                               self.rope_variant)
        return apply_rope(x, cos, sin)

    def _expand(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """KV heads -> query heads: head h reads KV head h // groups."""
        return t.repeat_interleave(self.groups, dim) if self.groups > 1 else t

    def kv(self, xa: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V from the encoder output, keys rotated by
        their positions; time-minor (B, Hkv, D, T)."""
        k = self._rope(self.k_proj(xa), xa.shape[1])
        return _bhdt(k), _bhdt(self.v_proj(xa))

    def attention_map(self, x: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Head-averaged cross-attention weights (B, S, T) in f32 (the
        word-timestamp alignment signal), with the decode's rotations."""
        q = _bhsd(self._rope(self.q_proj(x), x.shape[1])) * self.head_dim ** -0.5
        k = self._expand(_bhdt(self._rope(self.k_proj(xa), xa.shape[1])), 1)
        with full_fp32():
            scores = torch.einsum("bhsd,bhdt->bhst", q.float(), k.float())
        return _head_mean(self, torch.softmax(scores, dim=-1), self.q_heads)

    def forward(self, x: torch.Tensor, xa: Optional[torch.Tensor] = None,
                causal: bool = False, cache: Optional[KVCache] = None,
                pos: Optional[Union[int, torch.Tensor]] = None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        b, s = x.shape[:2]
        x = model_copy(self, x)
        if xa is not None:
            xa = model_copy(self, xa)
        q = self._rope(self.q_proj(x), s, pos)  # (B, S, Hq, D)
        if cache is None and cross_kv is None:
            # Full modes, KV heads unexpanded (the kernel reads KV head
            # h // groups for query head h). The flash kernel scales the
            # f32 scores, which equals scaling q first (as JAX does) when
            # head_dim**-0.5 is a power of two (D = 16, 64); otherwise
            # (D = 32, 128) q is scaled in its own type, as JAX scales it.
            scale = self.head_dim ** -0.5
            if math.frexp(scale)[0] != 0.5:
                q, scale = q * scale, 1.0
            src = x if xa is None else xa
            k = self._rope(self.k_proj(src), src.shape[1], pos)
            out = flash_attention(q, k, self.v_proj(src), causal=causal, scale=scale)
            return model_sum(self, self.out_proj(out.reshape(b, s, -1)))
        q = _bhsd(q) * self.head_dim ** -0.5
        if cross_kv is not None:
            k, v = cross_kv
            fold = _beam_fold(b, k.shape[0])
            if fold > 1:
                q = _fold_queries(q, fold)
            out = fused_decode_attention(q, k.to(q.dtype), v.to(q.dtype),
                                         groups=self.groups)
            return model_sum(self, self.out_proj(out.reshape(b, s, -1)))
        k = _bhdt(self._rope(self.k_proj(x), s, pos))
        cache = cache.update(pos, k, _bhdt(self.v_proj(x)))
        out = fused_decode_attention(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                                     pos=pos, groups=self.groups)
        return model_sum(self, self.out_proj(out.reshape(b, s, -1))), cache


class MultiHeadAttention(nn.Module):
    """Whisper-semantics MHA with optional decode caches (see module doc).
    ``weights_int8``: the four projections are :class:`QuantizedDense`."""

    def __init__(self, n_state: int, n_head: int, dtype=torch.float32,
                 device=None, weights_int8: bool = False):
        super().__init__()
        self.n_state = n_state
        self.n_head = n_head  # this rank's heads once sharded
        self.head_dim = n_state // n_head
        kw = dict(dtype=dtype, device=device)
        dense = QuantizedDense if weights_int8 else nn.Linear
        self.q_proj = dense(n_state, n_state, **kw)
        self.k_proj = dense(n_state, n_state, bias=False, **kw)
        self.v_proj = dense(n_state, n_state, **kw)
        self.out_proj = dense(n_state, n_state, **kw)

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.25

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.view(b, s, -1, self.head_dim)

    def attention_map(self, x: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Head-averaged cross-attention weights (B, S, T) in f32: the
        alignment signal of word timestamps (DTW). q and k scaled in the
        model's type, scores in f32."""
        q = _bhsd(self._split(self.q_proj(x)) * self.scale)
        k = _bhdt(self._split(self.k_proj(xa)) * self.scale)
        with full_fp32():
            scores = torch.einsum("bhsd,bhdt->bhst", q.float(), k.float())
        return _head_mean(self, torch.softmax(scores, dim=-1), self.n_head)

    def kv(self, xa: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V from the encoder output, once per window,
        time-minor (B, H, D, T); k is pre-scaled."""
        k = _bhdt(self._split(self.k_proj(xa)) * self.scale)
        v = _bhdt(self._split(self.v_proj(xa)))
        return k, v

    def kv_tm(self, xa: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross K/V still in the projections' time-major (B, T, H, D)
        layout, for quantizing before the transpose."""
        return (self._split(self.k_proj(xa)) * self.scale,
                self._split(self.v_proj(xa)))

    def forward(self, x: torch.Tensor, xa: Optional[torch.Tensor] = None,
                causal: bool = False,
                cache: Optional[Cache] = None,
                pos: Optional[Union[int, torch.Tensor]] = None,
                cross_kv: Optional[CrossKV] = None):
        b, s = x.shape[:2]
        x = model_copy(self, x)
        if xa is not None:
            xa = model_copy(self, xa)
        if cache is None and cross_kv is None:
            # Unscaled q and k; the flash kernel applies scale**2 to the
            # f32 scores.
            src = x if xa is None else xa
            out = flash_attention(self._split(self.q_proj(x)),
                                  self._split(self.k_proj(src)),
                                  self._split(self.v_proj(src)),
                                  causal=causal, scale=self.scale * self.scale)
            return model_sum(self, self.out_proj(out.reshape(b, s, -1)))

        q = _bhsd(self._split(self.q_proj(x)) * self.scale)
        if cross_kv is not None:
            quantized = isinstance(cross_kv, QuantizedKV)
            fold = _beam_fold(b, (cross_kv.k_q if quantized else cross_kv[0]).shape[0])
            if fold > 1:
                q = _fold_queries(q, fold)
            if quantized:
                out = attend_quantized(q, cross_kv)
            else:
                k, v = (t.to(q.dtype) for t in cross_kv)
                out = fused_decode_attention(q, k, v)
            return model_sum(self, self.out_proj(out.reshape(b, s, -1)))

        k = _bhdt(self._split(self.k_proj(x)) * self.scale)
        v = _bhdt(self._split(self.v_proj(x)))
        cache = cache.update(pos, k, v)
        if isinstance(cache, QuantizedKVCache):
            out = attend_quantized(q, cache.as_quantized_kv(), pos=pos)
        else:
            out = fused_decode_attention(q, cache.k.to(q.dtype),
                                         cache.v.to(q.dtype), pos=pos)
        return model_sum(self, self.out_proj(out.reshape(b, s, -1))), cache


def gelu(x: torch.Tensor, approximate: str = "none") -> torch.Tensor:
    """``F.gelu``, in place where no gradient is taken (inference): the same
    values, one tensor of ``x``'s size less at the peak. A captured decode
    program keeps its buffers while the next call encodes beside them
    (``infer/graphs.py``), so the encoder's peak is what that call adds."""
    if torch.is_grad_enabled():
        return F.gelu(x, approximate=approximate)
    return torch.ops.aten.gelu_(x, approximate=approximate)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``F.silu``, in place where no gradient is taken (:func:`gelu`)."""
    return F.silu(x, inplace=not torch.is_grad_enabled())


class MLP(nn.Module):
    """Whisper MLP: fc1 -> exact (erf) GELU -> fc2, 4x expansion.

    ``weights_int8``: fc1 and fc2 are :class:`QuantizedDense`. ``w8a8``: they
    are :class:`Int8Dense`, and the GELU is the tanh approximation fused into
    fc1's kernel epilogue (part of the ``encoder_int8`` approximation).
    ``gelu_tanh``: the tanh approximation without int8 (``fast_gelu``)."""

    def __init__(self, n_state: int, expansion: int = 4, dtype=torch.float32,
                 device=None, weights_int8: bool = False, w8a8: bool = False,
                 gelu_tanh: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gelu_tanh = gelu_tanh
        hidden = n_state * expansion
        if w8a8:
            self.fc1 = Int8Dense(n_state, hidden, activation="gelu_tanh", **kw)
            self.fc2 = Int8Dense(hidden, n_state, **kw)
        else:
            dense = QuantizedDense if weights_int8 else nn.Linear
            self.fc1 = dense(n_state, hidden, **kw)
            self.fc2 = dense(hidden, n_state, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(model_copy(self, x))
        if not isinstance(self.fc1, Int8Dense):  # else fused into fc1
            h = gelu(h, approximate="tanh" if self.gelu_tanh else "none")
        return model_sum(self, self.fc2(h))


def realized_token_probs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """p(tokens[:, i] | tokens[:, :i]) from teacher-forced logits (B, S, V):
    position i - 1 predicts token i, and the forced first position gets
    probability 1. f32 throughout (the word-confidence surface)."""
    logits = logits.float()[:, :-1]
    picked = logits.gather(-1, tokens[:, 1:, None].long())[..., 0]
    probs = torch.exp(picked - torch.logsumexp(logits, dim=-1))
    return torch.cat([torch.ones((tokens.shape[0], 1), dtype=torch.float32,
                                 device=probs.device), probs], dim=1)


def realized_token_probs_streamed(h: torch.Tensor, logits_fn, tokens: torch.Tensor,
                                  chunk: int = 16) -> torch.Tensor:
    """:func:`realized_token_probs` of ``logits_fn(h)`` (h (B, S, D)) without
    materializing the (B, S, V) f32 logits: positions go through
    ``logits_fn`` ``chunk`` at a time, each position's logits an
    independent row, so the result equals the dense version."""
    b, s = tokens.shape
    nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    lps = []
    for i0 in range(0, s, chunk):
        logits = logits_fn(h[:, i0:i0 + chunk]).float()
        picked = logits.gather(-1, nxt[:, i0:i0 + chunk, None])[..., 0]
        lps.append(picked - torch.logsumexp(logits, dim=-1))
    lp = torch.cat(lps, dim=1)
    return torch.cat([torch.ones((b, 1), dtype=torch.float32, device=lp.device),
                      torch.exp(lp[:, :s - 1])], dim=1)
