"""Whisper layers: multi-head attention with decode caches, MLP, LayerNorm.

The whisper subset of the JAX package's ``nn/layers.py``, with OpenAI's
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
"""

from __future__ import annotations

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
from yoho_tpu_torch.ops.decode_attention import fused_decode_attention
from yoho_tpu_torch.ops.flash_attention import flash_attention
from yoho_tpu_torch.ops.w8a8_dense import quantize_rows as quantize_act_rows  # noqa: F401
from yoho_tpu_torch.ops.w8a8_dense import w8a8_dense


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


class MultiHeadAttention(nn.Module):
    """Whisper-semantics MHA with optional decode caches (see module doc).
    ``weights_int8``: the four projections are :class:`QuantizedDense`."""

    def __init__(self, n_state: int, n_head: int, dtype=torch.float32,
                 device=None, weights_int8: bool = False):
        super().__init__()
        self.n_state = n_state
        self.n_head = n_head
        kw = dict(dtype=dtype, device=device)
        dense = QuantizedDense if weights_int8 else nn.Linear
        self.q_proj = dense(n_state, n_state, **kw)
        self.k_proj = dense(n_state, n_state, bias=False, **kw)
        self.v_proj = dense(n_state, n_state, **kw)
        self.out_proj = dense(n_state, n_state, **kw)

    @property
    def scale(self) -> float:
        return (self.n_state // self.n_head) ** -0.25

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.view(b, s, self.n_head, self.n_state // self.n_head)

    def attention_map(self, x: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Head-averaged cross-attention weights (B, S, T) in f32: the
        alignment signal of word timestamps (DTW). q and k scaled in the
        model's type, scores in f32."""
        q = _bhsd(self._split(self.q_proj(x)) * self.scale)
        k = _bhdt(self._split(self.k_proj(xa)) * self.scale)
        with full_fp32():
            scores = torch.einsum("bhsd,bhdt->bhst", q.float(), k.float())
        return torch.softmax(scores, dim=-1).mean(dim=1)

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
        if cache is None and cross_kv is None:
            # Unscaled q and k; the flash kernel applies scale**2 to the
            # f32 scores.
            src = x if xa is None else xa
            out = flash_attention(self._split(self.q_proj(x)),
                                  self._split(self.k_proj(src)),
                                  self._split(self.v_proj(src)),
                                  causal=causal, scale=self.scale * self.scale)
            return self.out_proj(out.reshape(b, s, self.n_state))

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
            return self.out_proj(out.reshape(b, s, self.n_state))

        k = _bhdt(self._split(self.k_proj(x)) * self.scale)
        v = _bhdt(self._split(self.v_proj(x)))
        cache = cache.update(pos, k, v)
        if isinstance(cache, QuantizedKVCache):
            out = attend_quantized(q, cache.as_quantized_kv(), pos=pos)
        else:
            out = fused_decode_attention(q, cache.k.to(q.dtype),
                                         cache.v.to(q.dtype), pos=pos)
        return self.out_proj(out.reshape(b, s, self.n_state)), cache


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
        h = self.fc1(x)
        if not isinstance(self.fc1, Int8Dense):  # else fused into fc1
            h = F.gelu(h, approximate="tanh" if self.gelu_tanh else "none")
        return self.fc2(h)


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
