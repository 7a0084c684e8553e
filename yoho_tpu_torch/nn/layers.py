"""Whisper layers: multi-head attention with decode caches, MLP, LayerNorm.

The whisper subset of the JAX package's ``nn/layers.py``, with OpenAI's
attention semantics: biases on q/v/out but not k, and the 0.25-power scale
``head_dim**-0.25`` on both q and k. Attention modes:

* full self-attention ``forward(x)``, causal with ``causal=True``;
* full cross-attention ``forward(x, xa=encoder_out)``;
* cached self decode ``forward(x, cache=..., pos=i)`` -> (out, cache);
* cached cross decode ``forward(x, cross_kv=...)`` with K/V from :meth:`kv`
  or a :class:`QuantizedKV`.

The full modes run through the flash kernel, the cached modes read their
K/V through the decode attention kernel. The JAX package's explicit
boolean masks (``causal_mask``, ``decode_mask``) are not needed: both
kernels take the causal rule and the valid length as arguments.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from yoho_tpu_torch.nn.kv_cache import (
    KVCache,
    QuantizedKV,
    QuantizedKVCache,
    attend_quantized,
)
from yoho_tpu_torch.ops.decode_attention import fused_decode_attention
from yoho_tpu_torch.ops.flash_attention import flash_attention


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S, D)."""
    return x.transpose(1, 2)


def _bhdt(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, D, S) — the KV storage layout."""
    return x.permute(0, 2, 3, 1)


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


class MultiHeadAttention(nn.Module):
    """Whisper-semantics MHA with optional decode caches (see module doc)."""

    def __init__(self, n_state: int, n_head: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_state = n_state
        self.n_head = n_head
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(n_state, n_state, **kw)
        self.k_proj = nn.Linear(n_state, n_state, bias=False, **kw)
        self.v_proj = nn.Linear(n_state, n_state, **kw)
        self.out_proj = nn.Linear(n_state, n_state, **kw)

    @property
    def scale(self) -> float:
        return (self.n_state // self.n_head) ** -0.25

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.view(b, s, self.n_head, self.n_state // self.n_head)

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
                cache: Optional[Cache] = None, pos: Optional[int] = None,
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
            if (cross_kv.k_q if quantized else cross_kv[0]).shape[0] != b:
                raise NotImplementedError(
                    "beam-shared cross-KV (query folding) is not in the "
                    "PyTorch port yet (ROADMAP.md, Queue 1 item 8)")
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
    """Whisper MLP: fc1 -> exact (erf) GELU -> fc2, 4x expansion."""

    def __init__(self, n_state: int, expansion: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = nn.Linear(n_state, n_state * expansion, **kw)
        self.fc2 = nn.Linear(n_state * expansion, n_state, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))
