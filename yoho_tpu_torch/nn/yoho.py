"""The YOHO model: GQA + RoPE + RMSNorm + SwiGLU encoder-decoder with a
voiceprint (speaker-embedding) head.

The JAX package's ``nn/yoho.py`` with the same parameter names (see
``nn/params.py``): a conv stem (3-tap convolutions padded one frame on
each side, as flax's ``SAME``, and a stride-2 max pool that drops an odd
last frame, as flax's ``VALID``) halving time 1024 -> 512, KV heads =
query heads // 2, no absolute positions (RoPE only), an RMSNorm of the
encoder output inside every decoder block before its cross-attention
(``ln_kv``), tied-embedding logits accumulated in float32, and a
voiceprint head whose output is L2-normalized with ``max(norm, 1e-6)``.

Full-sequence attention (the encoder's, and the teacher-forcing decoder's
causal self and cross) runs through the flash kernel on the unexpanded KV
heads; every decode read of the self cache and of the cross K/V runs
through the decode attention kernel with ``groups``. The cross K/V and the
self cache are float (the model's type): the YOHO family has no int8 K/V
lane. ``weights_int8`` is the weight-only int8 decoder
(``nn/quantize.py::quantize_yoho_decoder``). With ``n_experts > 0``
every ``moe_every_n``-th encoder block (and decoder block, with
``moe_in_decoder``) carries a :class:`nn.moe.MoESwiGLU` in place of its
SwiGLU (:func:`encoder_block_kwargs`, :func:`decoder_block_kwargs`).
``remat=True`` checkpoints every block while a gradient is recorded, as
the JAX package's ``maybe_remat`` does.

In the model's type the rotated queries and keys are rounded to it, so the
kernels read bf16 operands; the JAX package lets its f32 rotation tables
promote them to f32. In float32 the two compute the same.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from yoho_tpu_torch.core.config import YOHOConfig
from yoho_tpu_torch.core.device import full_fp32, resolve_device
from yoho_tpu_torch.nn.kv_cache import KVCache, cross_kv_rows
from yoho_tpu_torch.nn.layers import (
    GroupedQueryAttention,
    QuantizedDense,
    QuantizedEmbed,
    RMSNorm,
    SwiGLU,
    embed_tokens,
    model_copy,
    realized_token_probs_streamed,
    silu,
    vocab_logits,
)
from yoho_tpu_torch.nn.moe import MoESwiGLU


def encoder_block_kwargs(cfg: YOHOConfig, index: int) -> dict:
    """Constructor keywords of encoder block ``index``: every
    ``moe_every_n``-th block (index % n == n - 1) is MoE when
    ``n_experts > 0``."""
    moe = cfg.n_experts > 0 and index % cfg.moe_every_n == cfg.moe_every_n - 1
    return dict(q_heads=cfg.n_audio_heads, kv_heads=max(1, cfg.n_audio_heads // 2),
                dims=cfg.dims, n_experts=cfg.n_experts if moe else 0,
                moe_top_k=cfg.moe_top_k,
                expert_capacity_factor=cfg.expert_capacity_factor)


def decoder_block_kwargs(cfg: YOHOConfig, index: int) -> dict:
    """Constructor keywords of decoder block ``index``: MoE only when both
    ``n_experts > 0`` and ``moe_in_decoder``."""
    moe = (cfg.n_experts > 0 and cfg.moe_in_decoder
           and index % cfg.moe_every_n == cfg.moe_every_n - 1)
    return dict(q_heads=cfg.n_text_heads, kv_heads=max(1, cfg.n_text_heads // 2),
                dims=cfg.dims, n_experts=cfg.n_experts if moe else 0,
                moe_top_k=cfg.moe_top_k,
                expert_capacity_factor=cfg.expert_capacity_factor)


def _mlp(dims: int, hidden: int, n_experts: int, moe_top_k: int,
         expert_capacity_factor: float, weights_int8: bool = False, **kw) -> nn.Module:
    if n_experts > 0:
        if weights_int8:
            raise ValueError(
                "weights_int8 decoder serving does not support MoE "
                "decoder blocks (moe_in_decoder) — serve the MoE "
                "decoder in bf16/f32 or keep the decoder dense")
        return MoESwiGLU(dims, n_experts, hidden, top_k=moe_top_k,
                         capacity_factor=expert_capacity_factor, **kw)
    return SwiGLU(dims, hidden, weights_int8=weights_int8, **kw)


def _run(blk, remat: bool, *args):
    """One block, checkpointed when ``remat`` and a gradient is recorded."""
    if remat and torch.is_grad_enabled():
        return checkpoint(blk, *args, use_reentrant=False)
    return blk(*args)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-6) over the last axis."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)


class YOHOEncoderBlock(nn.Module):
    def __init__(self, q_heads: int, kv_heads: int, dims: int, n_experts: int = 0,
                 moe_top_k: int = 2, expert_capacity_factor: float = 2.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = RMSNorm(dims, **kw)
        self.attn = GroupedQueryAttention(q_heads, dims, kv_heads, **kw)
        self.ln2 = RMSNorm(dims, **kw)
        self.mlp = _mlp(dims, int(dims * 3), n_experts, moe_top_k,
                        expert_capacity_factor, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class YOHODecoderBlock(nn.Module):
    def __init__(self, q_heads: int, kv_heads: int, dims: int, n_experts: int = 0,
                 moe_top_k: int = 2, expert_capacity_factor: float = 2.0,
                 dtype=torch.float32, device=None, weights_int8: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = RMSNorm(dims, **kw)
        self.attn = GroupedQueryAttention(q_heads, dims, kv_heads,
                                          weights_int8=weights_int8, **kw)
        self.ln2 = RMSNorm(dims, **kw)
        self.ln_kv = RMSNorm(dims, **kw)
        self.cross_attn = GroupedQueryAttention(q_heads, dims, kv_heads,
                                                weights_int8=weights_int8, **kw)
        self.ln3 = RMSNorm(dims, **kw)
        self.mlp = _mlp(dims, int(dims * 1.5), n_experts, moe_top_k,
                        expert_capacity_factor, weights_int8=weights_int8, **kw)

    def forward(self, x, xa):
        x = x + self.attn(self.ln1(x), causal=True)
        x = x + self.cross_attn(self.ln2(x), xa=self.ln_kv(xa))
        return x + self.mlp(self.ln3(x))

    def step(self, x, cache: KVCache, cross_kv, pos):
        a, cache = self.attn(self.ln1(x), cache=cache, pos=pos)
        x = x + a
        x = x + self.cross_attn(self.ln2(x), cross_kv=cross_kv, pos=pos)
        return x + self.mlp(self.ln3(x)), cache

    def cross_kv(self, xa):
        return self.cross_attn.kv(self.ln_kv(xa))


class YOHOAudioEncoder(nn.Module):
    """Conv stem, then the GQA blocks: (B, frames, mels) -> (B, frames // 2,
    dims)."""

    def __init__(self, cfg: YOHOConfig, dtype=torch.float32, device=None,
                 remat: bool = False):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=dtype, device=device)
        self.conv1 = nn.Conv1d(c.n_mel_bands, c.dims, 3, padding=1, **kw)
        self.norm1 = RMSNorm(c.dims, **kw)
        self.conv2 = nn.Conv1d(c.dims, c.dims, 3, padding=1, **kw)
        self.norm2 = RMSNorm(c.dims, **kw)
        self.blocks = nn.ModuleList(
            YOHOEncoderBlock(**encoder_block_kwargs(c, i), **kw)
            for i in range(c.n_audio_blocks))

    def stem(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, S_frames, n_mels) -> (B, S_frames // 2, dims)."""
        x = mel.to(self.dtype).transpose(1, 2)
        with full_fp32():  # a float32 model's convolutions, not TF32
            x = self.conv1(x).transpose(1, 2)
            x = silu(self.norm1(x)).transpose(1, 2)
            x = F.max_pool1d(x, 2, 2)
            x = self.conv2(x).transpose(1, 2)
        return silu(self.norm2(x))

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = _run(blk, self.remat, x)
        return x

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.run_blocks(self.stem(mel))


class YOHOTextDecoder(nn.Module):
    """Token embedding, GQA blocks with cross-attention, RMSNorm, tied
    logits and the voiceprint head."""

    def __init__(self, cfg: YOHOConfig, vocab_size: int, voiceprint_dim: int = 256,
                 dtype=torch.float32, device=None, weights_int8: bool = False,
                 remat: bool = False):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=dtype, device=device)
        self.token_embedding = (QuantizedEmbed if weights_int8 else nn.Embedding)(
            vocab_size, c.dims, **kw)
        self.blocks = nn.ModuleList(
            YOHODecoderBlock(**decoder_block_kwargs(c, i), weights_int8=weights_int8, **kw)
            for i in range(c.n_text_blocks))
        self.ln = RMSNorm(c.dims, **kw)
        self.voiceprint_head = (QuantizedDense if weights_int8 else nn.Linear)(
            c.dims, voiceprint_dim, bias=False, **kw)

    def _hidden(self, tokens, xa):
        x = embed_tokens(self.token_embedding, tokens)
        for blk in self.blocks:
            x = _run(blk, self.remat, x, xa)
        return self.ln(x)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits accumulated and kept in float32, also under
        autocast (training), where both operands are first rounded to the
        compute type, as the JAX package casts them to its ``dtype``."""
        if isinstance(self.token_embedding, QuantizedEmbed):
            return self.token_embedding.logits(h)
        emb = self.token_embedding.weight
        if torch.is_autocast_enabled(h.device.type):
            dt = torch.get_autocast_dtype(h.device.type)
            h, emb = h.to(dt), emb.to(dt)
        h = model_copy(self.token_embedding, h)
        with torch.autocast(h.device.type, enabled=False), full_fp32():
            return vocab_logits(self.token_embedding, F.linear(h.float(), emb.float()))

    def _voiceprints(self, h: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.voiceprint_head(h))

    def forward(self, tokens, xa):
        return self._logits(self._hidden(tokens, xa))

    def cross_attention_map(self, tokens, xa, with_probs: bool = False):
        """Teacher-forced forward collecting the word-alignment signal: the
        cross-attention weights averaged over the heads of the upper half of
        the decoder blocks, (B, S_text, T_audio) f32; with ``with_probs``
        also the realized-token probabilities (B, S_text) of the same
        forward. Each block RMSNorms the encoder output (``ln_kv``) before
        its cross-attention, as the main forward does."""
        x = embed_tokens(self.token_embedding, tokens)
        align_from = len(self.blocks) // 2
        acc = None
        for i, blk in enumerate(self.blocks):
            x = x + blk.attn(blk.ln1(x), causal=True)
            x_in = blk.ln2(x)
            xa_in = blk.ln_kv(xa)
            if i >= align_from:
                w = blk.cross_attn.attention_map(x_in, xa_in)
                acc = w if acc is None else acc + w
            x = x + blk.cross_attn(x_in, xa=xa_in)
            x = x + blk.mlp(blk.ln3(x))
        amap = acc / max(len(self.blocks) - align_from, 1)
        if not with_probs:
            return amap
        return amap, realized_token_probs_streamed(self.ln(x), self._logits, tokens)

    def with_voiceprints(self, tokens, xa):
        """(f32 logits, L2-normalized voiceprint embeddings per position)."""
        h = self._hidden(tokens, xa)
        return self._logits(h), self._voiceprints(h)

    def voiceprints(self, tokens, xa):
        """:meth:`with_voiceprints`' voiceprints without its logits."""
        return self._voiceprints(self._hidden(tokens, xa))

    def init_caches(self, batch: int, dtype=None, max_len: Optional[int] = None,
                    quantized: bool = False) -> List[KVCache]:
        """Float caches, one per block, with a horizon rounded up to a
        multiple of 128. The YOHO family has no int8 cache lane."""
        if quantized:
            raise ValueError("the YOHO family decodes with float caches "
                             "(no quantized_cache lane)")
        aligned = -(-(max_len or self.cfg.max_text_len) // 128) * 128
        device = self.ln.scale.device
        # Each block's own KV heads: this rank's when the model is sharded.
        return [KVCache.zeros(batch, blk.attn.kv_heads, aligned, blk.attn.head_dim,
                              dtype or self.dtype, device=device)
                for blk in self.blocks]

    def cross_kvs(self, xa, quantize=False, out=None, rows=None):
        """Per-block cross K/V (rotated keys), once per window, float in the
        model's type. The YOHO family has no quantized cross-K/V lane.
        ``out``: an earlier result, written in place one block at a time,
        ``rows`` rows of ``xa`` at a time (``Whisper.cross_kvs``)."""
        if quantize:
            raise ValueError("the YOHO family decodes with float cross K/V "
                             "(no quantized_cross_kv lane)")
        return [cross_kv_rows(blk.cross_kv, xa, rows, dst)
                for blk, dst in zip(self.blocks, out or [None] * len(self.blocks))]

    def decode_step(self, tokens, caches, cross_kvs, pos, with_voiceprints: bool = True):
        """Cached step: tokens (B, S_new) at ``pos`` (an int or a per-row
        (B,) tensor). Returns (f32 logits, voiceprints or None, caches)."""
        x = embed_tokens(self.token_embedding, tokens)
        new_caches = []
        for blk, cache, ckv in zip(self.blocks, caches, cross_kvs):
            x, nc = blk.step(x, cache, ckv, pos)
            new_caches.append(nc)
        h = self.ln(x)
        vp = self._voiceprints(h) if with_voiceprints else None
        return self._logits(h), vp, new_caches


class YOHOModel(nn.Module):
    """Joint ASR + diarization + speaker-recognition model.

    ``device=None`` places it on CUDA (and raises when CUDA is absent);
    ``device="cpu"`` runs the plain PyTorch path. Parameters start
    uninitialized: fill them with ``nn.params.load_jax_params`` or
    ``nn.params.init_random``."""

    def __init__(self, cfg: YOHOConfig, vocab_size: int, voiceprint_dim: int = 256,
                 dtype=torch.float32, weights_int8: bool = False, device=None,
                 remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.voiceprint_dim = voiceprint_dim
        self.dtype = dtype
        self.encoder = YOHOAudioEncoder(cfg, dtype=dtype, device=device, remat=remat)
        self.decoder = YOHOTextDecoder(cfg, vocab_size, voiceprint_dim, dtype=dtype,
                                       device=device, weights_int8=weights_int8,
                                       remat=remat)

    @property
    def device(self) -> torch.device:
        return self.decoder.ln.scale.device

    @property
    def weights_int8(self) -> bool:
        return isinstance(self.decoder.token_embedding, QuantizedEmbed)

    def forward(self, tokens: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        # Argument order (text, audio), as the JAX model's __call__.
        return self.decoder(tokens, self.encoder(mel))

    def encode_audio(self, mel):
        return self.encoder(mel)

    def decode_text(self, tokens, xa):
        return self.decoder(tokens, xa)

    def cross_attention_map(self, tokens, xa, with_probs: bool = False):
        return self.decoder.cross_attention_map(tokens, xa, with_probs)

    def forward_with_voiceprints(self, tokens, mel):
        return self.decoder.with_voiceprints(tokens, self.encoder(mel))

    def voiceprints(self, tokens, mel, xa=None):
        """The voiceprints of :meth:`forward_with_voiceprints` alone: the
        speaker pass reads no logits, and eager code would make them all
        (batch x positions x vocab in f32; the JAX package's jit drops
        them unmade). ``xa``: the encoder output of ``mel`` when the caller
        has it (the decode program's), which skips the encoder."""
        return self.decoder.voiceprints(tokens, self.encoder(mel) if xa is None else xa)

    def cross_kvs(self, xa, quantize=False, out=None, rows=None):
        return self.decoder.cross_kvs(xa, quantize, out, rows)

    def init_caches(self, batch: int, dtype=None, max_len: Optional[int] = None,
                    quantized: bool = False):
        return self.decoder.init_caches(batch, dtype, max_len, quantized)

    def decode_step(self, tokens, caches, cross_kvs, pos, with_voiceprints: bool = True):
        return self.decoder.decode_step(tokens, caches, cross_kvs, pos,
                                        with_voiceprints)
