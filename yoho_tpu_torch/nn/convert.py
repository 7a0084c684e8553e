"""HF Whisper checkpoint directory -> the JAX-layout param pytree.

The port's counterpart of the JAX package's ``nn/convert.py``. The JAX
loader goes through ``transformers.WhisperForConditionalGeneration``; the
machine with the card has neither ``transformers`` nor ``safetensors``, so
this module reads a local checkpoint directory itself:

* ``config.json`` with ``json`` (missing fields take transformers'
  ``WhisperConfig`` defaults);
* ``model.safetensors``: an 8-byte little-endian header length, a JSON
  header (dtype code, shape and byte range of each tensor) and the raw
  bytes, read through ``torch.frombuffer`` over a copy-on-write ``mmap``,
  so the weights are paged in as they are read and never copied on the
  host; a sharded ``model.safetensors.index.json`` names its shards;
* ``pytorch_model.bin`` through ``torch.load(weights_only=True,
  mmap=True)``.

Hub ids are not resolved: the port loads local directories only.

Layout mapping (torch -> flax), as in the JAX package:
  * Linear weight (out, in)            -> kernel (in, out)       [transpose]
  * Conv1d weight (out, in, k)         -> kernel (k, in, out)    [permute]
  * Embedding weight                   -> embedding              [copy]
  * encoder.embed_positions            -> dropped (fixed sinusoids, recomputed)
  * decoder.embed_positions            -> positional_embedding

The transposes are numpy views of the file's pages; ``nn.params.
load_jax_params`` turns them back into the module's layout (contiguous
again) while it copies them onto the model's device and type.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from yoho_tpu_torch.core.config import WhisperConfig

# safetensors dtype codes this reader knows; any other code raises.
_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}

# transformers' WhisperConfig defaults, for fields a config.json leaves out.
_HF_DEFAULTS = {"vocab_size": 51865, "num_mel_bins": 80, "encoder_layers": 4,
                "encoder_attention_heads": 6, "decoder_layers": 4,
                "decoder_attention_heads": 6, "d_model": 384,
                "max_source_positions": 1500, "max_target_positions": 448}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors over a
    copy-on-write ``mmap`` of the file (the map lives as long as a tensor
    does). Raises ``ValueError`` on a dtype code it does not know or a
    byte range that does not fit its tensor or the file."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    n = int.from_bytes(mm[:8], "little")
    if n <= 0 or 8 + n > len(mm):
        raise ValueError(f"{path}: not a safetensors file (header length {n})")
    header = json.loads(mm[8:8 + n])
    start = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        code = info["dtype"]
        if code not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code!r}, "
                             "which this reader does not know")
        dtype, shape = _DTYPES[code], [int(d) for d in info["shape"]]
        lo, hi = (int(v) for v in info["data_offsets"])
        numel = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if hi - lo != numel * itemsize or lo < 0 or start + hi > len(mm):
            raise ValueError(f"{path}: tensor {name!r} byte range [{lo}, {hi}) "
                             f"does not hold {shape} {code}")
        out[name] = (torch.frombuffer(mm, dtype=dtype, count=numel,
                                      offset=start + lo).reshape(shape)
                     if numel else torch.empty(shape, dtype=dtype))
    return out


def read_hf_config(path) -> dict:
    """``config.json`` of a local checkpoint directory."""
    cfg_path = Path(path) / "config.json"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"no config.json in {path}")
    return json.loads(cfg_path.read_text(encoding="utf-8"))


def load_hf_state_dict(path) -> Dict[str, torch.Tensor]:
    """The weights of a local checkpoint directory: ``model.safetensors``,
    a sharded ``model.safetensors.index.json``, or ``pytorch_model.bin``,
    in that order."""
    p = Path(path)
    if (p / "model.safetensors").is_file():
        return read_safetensors(p / "model.safetensors")
    index = p / "model.safetensors.index.json"
    if index.is_file():
        weight_map = json.loads(index.read_text(encoding="utf-8"))["weight_map"]
        sd: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            sd.update(read_safetensors(p / shard))
        missing = sorted(set(weight_map) - set(sd))
        if missing:
            raise KeyError(f"{index}: tensors not found in their shards: {missing[:5]}")
        return sd
    if (p / "pytorch_model.bin").is_file():
        return torch.load(p / "pytorch_model.bin", map_location="cpu",
                          weights_only=True, mmap=True)
    raise FileNotFoundError(
        f"no model.safetensors, model.safetensors.index.json or "
        f"pytorch_model.bin in {path}")


def _lin(sd, prefix, bias=True):
    out = {"kernel": sd[prefix + ".weight"].T}
    if bias:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _ln(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _conv(sd, prefix):
    return {"kernel": sd[prefix + ".weight"].transpose(2, 1, 0),  # (k, in, out)
            "bias": sd[prefix + ".bias"]}


def _attn(sd, prefix, k_bias=False):
    return {
        "q_proj": _lin(sd, prefix + ".q_proj"),
        "k_proj": _lin(sd, prefix + ".k_proj", bias=k_bias),
        "v_proj": _lin(sd, prefix + ".v_proj"),
        "out_proj": _lin(sd, prefix + ".out_proj"),
    }


def _to_numpy(val) -> np.ndarray:
    """A float leaf as float32 numpy (bf16 and f16 upcast, exactly); an
    f32 tensor over the file's pages stays a view of them."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu()
        if val.is_floating_point() and val.dtype != torch.float32:
            val = val.float()
        return val.numpy()
    arr = np.asarray(val)
    return arr.astype(np.float32) if arr.dtype.kind == "f" and arr.dtype != np.float32 else arr


def convert_hf_whisper(state_dict: Mapping, cfg: WhisperConfig) -> dict:
    """A transformers WhisperModel / WhisperForConditionalGeneration
    state dict (torch tensors or numpy arrays) -> the param pytree
    (``{"encoder": ..., "decoder": ...}`` of float32 numpy arrays)."""
    sd = {}
    for key, val in state_dict.items():
        # Both WhisperModel ("encoder...") and
        # WhisperForConditionalGeneration ("model.encoder...") keys.
        if key.startswith("model."):
            key = key[len("model."):]
        if key == "proj_out.weight":
            continue  # tied to embed_tokens
        sd[key] = _to_numpy(val)

    enc: dict = {
        "conv1": _conv(sd, "encoder.conv1"),
        "conv2": _conv(sd, "encoder.conv2"),
        "ln_post": _ln(sd, "encoder.layer_norm"),
    }
    for i in range(cfg.n_audio_layer):
        p = f"encoder.layers.{i}"
        enc[f"blocks_{i}"] = {
            "ln1": _ln(sd, f"{p}.self_attn_layer_norm"),
            "attn": _attn(sd, f"{p}.self_attn"),
            "ln2": _ln(sd, f"{p}.final_layer_norm"),
            "mlp": {"fc1": _lin(sd, f"{p}.fc1"), "fc2": _lin(sd, f"{p}.fc2")},
        }

    dec: dict = {
        "token_embedding": {"embedding": sd["decoder.embed_tokens.weight"]},
        "positional_embedding": sd["decoder.embed_positions.weight"],
        "ln": _ln(sd, "decoder.layer_norm"),
    }
    for i in range(cfg.n_text_layer):
        p = f"decoder.layers.{i}"
        dec[f"blocks_{i}"] = {
            "ln1": _ln(sd, f"{p}.self_attn_layer_norm"),
            "attn": _attn(sd, f"{p}.self_attn"),
            "ln2": _ln(sd, f"{p}.encoder_attn_layer_norm"),
            "cross_attn": _attn(sd, f"{p}.encoder_attn"),
            "ln3": _ln(sd, f"{p}.final_layer_norm"),
            "mlp": {"fc1": _lin(sd, f"{p}.fc1"), "fc2": _lin(sd, f"{p}.fc2")},
        }
    return {"encoder": enc, "decoder": dec}


def hf_config_to_whisper(hf_config: Mapping) -> WhisperConfig:
    """A transformers Whisper ``config.json`` (as a dict) -> WhisperConfig.

    ``chunk_seconds`` is not an HF field: it is derived from the encoder
    geometry (stride-2 conv stem: ``n_frames = 2 * n_audio_ctx``), so a
    checkpoint with a window other than 30 s (an exported tiny test
    geometry) loads with a consistent window."""
    c = {**_HF_DEFAULTS, **hf_config}
    sr, hop = 16000, 160
    return WhisperConfig(
        n_mels=c["num_mel_bins"],
        n_audio_ctx=c["max_source_positions"],
        chunk_seconds=2 * c["max_source_positions"] * hop / sr,
        n_audio_state=c["d_model"],
        n_audio_head=c["encoder_attention_heads"],
        n_audio_layer=c["encoder_layers"],
        n_vocab=c["vocab_size"],
        n_text_ctx=c["max_target_positions"],
        n_text_state=c["d_model"],
        n_text_head=c["decoder_attention_heads"],
        n_text_layer=c["decoder_layers"],
    )


def load_hf_whisper(model_path):
    """A local HF Whisper checkpoint directory -> (cfg, params), params the
    float32 numpy pytree ``nn.params.load_jax_params`` fills a port
    ``Whisper`` from (cast to the model's type there)."""
    p = Path(model_path)
    if not p.is_dir():
        raise FileNotFoundError(
            f"{model_path!r} is not a local checkpoint directory; the PyTorch "
            "port loads local directories only (no hub download)")
    cfg = hf_config_to_whisper(read_hf_config(p))
    return cfg, convert_hf_whisper(load_hf_state_dict(p), cfg)
