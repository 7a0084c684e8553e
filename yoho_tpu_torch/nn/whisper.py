"""Whisper encoder-decoder in PyTorch.

The JAX package's ``nn/whisper.py`` with the same parameter names (see
``nn/params.py`` for carrying its weights across): conv stem k=3 pad=1
(second conv stride 2) with exact GELU, fixed sinusoidal encoder
positions, pre-LN blocks, learned decoder positions, tied-embedding
logits in float32, and a KV-cached ``decode_step``. Full-sequence
attention (the encoder's, and the teacher-forcing decoder's causal self and
cross) runs through the flash kernel; every decode read of the caches and
of the cross-K/V runs through the decode attention kernel.

The serving lanes carry the JAX flags and meanings: ``weights_int8`` (the
decoder's projections, MLPs and tied embedding int8, weight-only),
``encoder_int8`` (the encoder block MLPs W8A8 through the w8a8 kernel, with
the tanh GELU) and ``fast_gelu`` (the tanh GELU in the encoder MLPs). The
int8 weights come from ``nn/quantize.py`` or a JAX-quantized tree.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.core.device import full_fp32, resolve_device
from yoho_tpu_torch.nn.kv_cache import (
    KVCache,
    QuantizedKVCache,
    quantize_kv,
    quantize_kv4,
)
from yoho_tpu_torch.nn.layers import (
    MLP,
    Int8Dense,
    LayerNorm,
    MultiHeadAttention,
    QuantizedEmbed,
    realized_token_probs_streamed,
)
from yoho_tpu_torch.ops.decode_attention import is_row_pos


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """OpenAI Whisper's fixed positional encoding (host-side constant)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32)


class EncoderBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, dtype=torch.float32, device=None,
                 w8a8: bool = False, gelu_tanh: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(n_state, device=device)
        self.attn = MultiHeadAttention(n_state, n_head, dtype=dtype, device=device)
        self.ln2 = LayerNorm(n_state, device=device)
        # W8A8 quantizes the MLP only: the square attention projections
        # stay in the model's type, as in the JAX package.
        self.mlp = MLP(n_state, dtype=dtype, device=device, w8a8=w8a8,
                       gelu_tanh=gelu_tanh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class DecoderBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, dtype=torch.float32, device=None,
                 weights_int8: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device, weights_int8=weights_int8)
        self.ln1 = LayerNorm(n_state, device=device)
        self.attn = MultiHeadAttention(n_state, n_head, **kw)
        self.ln2 = LayerNorm(n_state, device=device)
        self.cross_attn = MultiHeadAttention(n_state, n_head, **kw)
        self.ln3 = LayerNorm(n_state, device=device)
        self.mlp = MLP(n_state, **kw)

    def forward(self, x, xa):
        x = x + self.attn(self.ln1(x), causal=True)
        x = x + self.cross_attn(self.ln2(x), xa=xa)
        return x + self.mlp(self.ln3(x))

    def step(self, x, cache, cross_kv, pos):
        """One cached decode step: x is (B, S_new, D)."""
        a, cache = self.attn(self.ln1(x), cache=cache, pos=pos)
        x = x + a
        x = x + self.cross_attn(self.ln2(x), cross_kv=cross_kv)
        return x + self.mlp(self.ln3(x)), cache


class AudioEncoder(nn.Module):
    """Conv stem (exact GELU), sinusoidal positions, pre-LN blocks. ``w8a8``
    and ``gelu_tanh`` reach the block MLPs only."""

    def __init__(self, cfg: WhisperConfig, dtype=torch.float32, device=None,
                 w8a8: bool = False, gelu_tanh: bool = False):
        super().__init__()
        c = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv1 = nn.Conv1d(c.n_mels, c.n_audio_state, 3, padding=1, **kw)
        self.conv2 = nn.Conv1d(c.n_audio_state, c.n_audio_state, 3, stride=2,
                               padding=1, **kw)
        self.register_buffer(
            "positions",
            torch.from_numpy(sinusoids(c.n_audio_ctx, c.n_audio_state)).to(
                device=device, dtype=dtype),
            persistent=False)
        self.blocks = nn.ModuleList(
            EncoderBlock(c.n_audio_state, c.n_audio_head, w8a8=w8a8,
                         gelu_tanh=gelu_tanh, **kw)
            for _ in range(c.n_audio_layer))
        self.ln_post = LayerNorm(c.n_audio_state, device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_frames, n_mels) -> (B, n_audio_ctx, n_state)."""
        x = mel.to(self.dtype).transpose(1, 2)
        with full_fp32():  # a float32 model's convolutions, not TF32
            x = F.gelu(self.conv1(x))
            x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positions
        for blk in self.blocks:
            x = blk(x)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    """Learned positions, pre-LN blocks with cross-attention, tied logits.
    ``weights_int8``: the blocks' dense layers are ``QuantizedDense`` and the
    tied embedding a ``QuantizedEmbed``."""

    def __init__(self, cfg: WhisperConfig, dtype=torch.float32, device=None,
                 weights_int8: bool = False):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.token_embedding = (QuantizedEmbed if weights_int8 else nn.Embedding)(
            c.n_vocab, c.n_text_state, **kw)
        self.positional_embedding = nn.Parameter(
            torch.empty(c.n_text_ctx, c.n_text_state, **kw))
        self.blocks = nn.ModuleList(
            DecoderBlock(c.n_text_state, c.n_text_head, weights_int8=weights_int8, **kw)
            for _ in range(c.n_text_layer))
        self.ln = LayerNorm(c.n_text_state, device=device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits in float32: operands of the model's type
        are exact in f32, and the product accumulates and stays in f32 (a
        bf16 output would round the logits and flip argmax near ties)."""
        if isinstance(self.token_embedding, QuantizedEmbed):
            return self.token_embedding.logits(x)
        with full_fp32():
            return F.linear(x.float(), self.token_embedding.weight.float())

    def forward(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Full-sequence (teacher-forcing) forward -> f32 logits."""
        t = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        for blk in self.blocks:
            x = blk(x, xa)
        return self._logits(self.ln(x))

    def init_caches(self, batch: int, dtype=None, max_len: Optional[int] = None,
                    quantized: bool = False):
        c = self.cfg
        dtype = dtype or self.dtype
        max_len = -(-(max_len or c.n_text_ctx) // 128) * 128
        cls = QuantizedKVCache if quantized else KVCache
        device = self.positional_embedding.device
        return [cls.zeros(batch, c.n_text_head, max_len,
                          c.n_text_state // c.n_text_head, dtype, device=device)
                for _ in range(c.n_text_layer)]

    def cross_kvs(self, xa: torch.Tensor, quantize: Union[bool, str] = False):
        """Per-layer cross-attention K/V, once per window. ``quantize``:
        False (the model's type), True/"int8" or "int4". Quantized K/V
        are zero-padded along T to a multiple of 128 with the valid length
        kept as ``kv_len`` (the JAX package's layout when its kernel runs):
        a padded int8 row is a multiple of 16 bytes, which the decode
        kernel's TMA loads need."""
        mode = {False: None, True: "int8"}.get(quantize, quantize)
        if mode == "int8":
            return [quantize_kv(*blk.cross_attn.kv_tm(xa), pad_to=128, time_major=True)
                    for blk in self.blocks]
        if mode == "int4":
            return [quantize_kv4(*blk.cross_attn.kv_tm(xa), pad_to=128, time_major=True)
                    for blk in self.blocks]
        if mode is not None:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        return [blk.cross_attn.kv(xa) for blk in self.blocks]

    def cross_attention_map(self, tokens: torch.Tensor, xa: torch.Tensor,
                            with_probs: bool = False):
        """Teacher-forced forward that collects the alignment signal: the
        cross-attention weights averaged over the heads of the upper half of
        the decoder layers (the heuristic for a checkpoint without an
        alignment-head mask). Returns (B, S_text, T_audio) f32; with
        ``with_probs`` also the realized-token probabilities (B, S_text) f32
        from the same forward. The self-attention (causal) and the residual
        cross-attention run through the flash kernel."""
        t = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        align_from = len(self.blocks) // 2
        acc = None
        for i, blk in enumerate(self.blocks):
            x = x + blk.attn(blk.ln1(x), causal=True)
            x_in = blk.ln2(x)
            if i >= align_from:
                w = blk.cross_attn.attention_map(x_in, xa)
                acc = w if acc is None else acc + w
            x = x + blk.cross_attn(x_in, xa=xa)
            x = x + blk.mlp(blk.ln3(x))
        amap = acc / max(len(self.blocks) - align_from, 1)
        if not with_probs:
            return amap
        return amap, realized_token_probs_streamed(self.ln(x), self._logits, tokens)

    def decode_step(self, tokens: torch.Tensor, caches: List, cross_kvs, pos):
        """Cached step: tokens (B, S_new) at absolute position ``pos``, an
        int or a per-row (B,) tensor on the model's device (each row at its
        own position: continuous batching; the host never reads it).
        Returns (f32 logits (B, S_new, vocab), caches)."""
        s = tokens.shape[1]
        x = self.token_embedding(tokens)
        # Clipped like jnp.take(mode="clip"): rows past n_text_ctx stay
        # finite (a NaN K/V would poison every row through the mask).
        steps = torch.arange(s, device=x.device)
        if is_row_pos(pos):
            idx = pos.long()[:, None] + steps[None, :]  # (B, S_new)
        else:
            idx = steps + int(pos)
        x = x + self.positional_embedding[torch.clamp(idx, 0, self.cfg.n_text_ctx - 1)]
        new_caches = []
        for blk, cache, ckv in zip(self.blocks, caches, cross_kvs):
            x, nc = blk.step(x, cache, ckv, pos)
            new_caches.append(nc)
        return self._logits(self.ln(x)), new_caches


class Whisper(nn.Module):
    """Full model; ``forward(mel, tokens)`` is the teacher-forcing pass.

    ``device=None`` places it on CUDA (and raises when CUDA is absent);
    pass ``device="cpu"`` for the plain PyTorch path. Parameters start
    uninitialized: fill them with ``nn.params.load_jax_params`` or
    ``nn.params.init_random``; the int8 lanes (``weights_int8``,
    ``encoder_int8``) hold zero codes until ``load_jax_params`` fills them,
    or are made from a float model by ``nn.quantize``. ``fast_gelu`` changes
    no weights."""

    def __init__(self, cfg: WhisperConfig, dtype=torch.float32,
                 weights_int8: bool = False, encoder_int8: bool = False,
                 fast_gelu: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = AudioEncoder(cfg, dtype=dtype, device=device,
                                    w8a8=encoder_int8, gelu_tanh=fast_gelu)
        self.decoder = TextDecoder(cfg, dtype=dtype, device=device,
                                   weights_int8=weights_int8)

    @property
    def device(self) -> torch.device:
        return self.decoder.positional_embedding.device

    @property
    def weights_int8(self) -> bool:
        return isinstance(self.decoder.token_embedding, QuantizedEmbed)

    @property
    def encoder_int8(self) -> bool:
        return any(isinstance(b.mlp.fc1, Int8Dense) for b in self.encoder.blocks)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))

    def encode_audio(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    def decode_text(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, xa)

    def cross_kvs(self, xa: torch.Tensor, quantize: Union[bool, str] = False):
        return self.decoder.cross_kvs(xa, quantize)

    def init_caches(self, batch: int, dtype=None, max_len: Optional[int] = None,
                    quantized: bool = False):
        return self.decoder.init_caches(batch, dtype, max_len, quantized)

    def decode_step(self, tokens, caches, cross_kvs, pos):
        return self.decoder.decode_step(tokens, caches, cross_kvs, pos)

    def cross_attention_map(self, tokens, xa, with_probs: bool = False):
        return self.decoder.cross_attention_map(tokens, xa, with_probs)
