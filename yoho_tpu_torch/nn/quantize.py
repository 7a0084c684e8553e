"""Post-training int8 quantization for serving: the whisper half of the JAX
package's ``nn/quantize.py``.

Two schemes, both symmetric absmax with one f32 scale per output channel
(``max(absmax / 127, 1e-12)``, codes ``clip(round(w / scale), -127, 127)``),
bit-exact with the JAX functions on the same float weights:

* **Decoder, weight-only** (:func:`quantize_whisper_decoder` ->
  ``weights_int8``): q/k/v/out and fc1/fc2 of every decoder block become
  :class:`~yoho_tpu_torch.nn.layers.QuantizedDense`, the tied token
  embedding a :class:`~yoho_tpu_torch.nn.layers.QuantizedEmbed` with one
  scale per row.
* **Encoder, W8A8** (:func:`quantize_whisper_encoder` -> ``encoder_int8``):
  fc1/fc2 of every encoder block become
  :class:`~yoho_tpu_torch.nn.layers.Int8Dense` (activations quantized at run
  time, the w8a8 kernel, the tanh GELU fused into fc1). Attention, the conv
  stem and the LayerNorms stay in the model's type.

The two touch disjoint modules and compose. Both work in place on a float
port ``Whisper`` and on its own device, so a model on the card quantizes its
weights there, and return the model.
"""

from __future__ import annotations

import torch
from torch import nn

from yoho_tpu_torch.nn.layers import Int8Dense, QuantizedDense, QuantizedEmbed
from yoho_tpu_torch.ops.w8a8_dense import quantize_rows

_DENSE_NAMES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def quantize_dense_params(weight: torch.Tensor, bias=None) -> dict:
    """(out, in) float weight [+ bias] -> {weight_q (out, in) int8,
    weight_scale (out,) f32 [, bias f32]}: one scale per output channel,
    which is one per row of ``nn.Linear``'s layout."""
    q, scale = quantize_rows(weight)
    out = {"weight_q": q, "weight_scale": scale[:, 0]}
    if bias is not None:
        out["bias"] = bias.detach().float()  # a tensor, not the Parameter
    return out


def quantize_embed_params(weight: torch.Tensor) -> dict:
    """(V, D) embedding -> {weight_q (V, D) int8, weight_scale (V,) f32}:
    one scale per row (per token)."""
    q, scale = quantize_rows(weight)
    return {"weight_q": q, "weight_scale": scale[:, 0]}


def _fill(layer: nn.Module, params: dict) -> nn.Module:
    for name, val in params.items():
        setattr(layer, name, val)
    return layer


@torch.no_grad()
def _quantized(linear: nn.Linear, cls, dtype, **kw) -> nn.Module:
    layer = cls(linear.in_features, linear.out_features,
                bias=linear.bias is not None, dtype=dtype,
                device=linear.weight.device, **kw)
    return _fill(layer, quantize_dense_params(linear.weight, linear.bias))


@torch.no_grad()
def quantize_whisper_decoder(model):
    """A float ``Whisper`` -> its ``weights_int8`` form (in place)."""
    dec = model.decoder
    emb = dec.token_embedding
    if not isinstance(emb, nn.Embedding):
        raise ValueError("the decoder is quantized already")
    dec.token_embedding = _fill(
        QuantizedEmbed(emb.num_embeddings, emb.embedding_dim, dtype=model.dtype,
                       device=emb.weight.device),
        quantize_embed_params(emb.weight))
    for blk in dec.blocks:
        for sub in (blk.attn, blk.cross_attn, blk.mlp):
            for name in _DENSE_NAMES:
                lin = getattr(sub, name, None)
                if isinstance(lin, nn.Linear):
                    setattr(sub, name, _quantized(lin, QuantizedDense, model.dtype))
    return model


@torch.no_grad()
def quantize_whisper_encoder(model):
    """A float ``Whisper`` -> its ``encoder_int8`` form (in place): the
    encoder block MLPs become W8A8, with the tanh GELU fused into fc1."""
    for blk in model.encoder.blocks:
        mlp = blk.mlp
        if not isinstance(mlp.fc1, nn.Linear):
            raise ValueError("the encoder MLPs are quantized already")
        mlp.fc1 = _quantized(mlp.fc1, Int8Dense, model.dtype, activation="gelu_tanh")
        mlp.fc2 = _quantized(mlp.fc2, Int8Dense, model.dtype)
    return model
