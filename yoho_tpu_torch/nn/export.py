"""yoho_tpu Whisper param pytree -> HF checkpoint directory.

Inverse of ``nn/convert.py``: after TPU fine-tuning (``yoho finetune``),
the updated parameters are written back as a standard
``WhisperForConditionalGeneration`` checkpoint (config.json +
model.safetensors [+ tokenizer files copied from the source dir]) so the
result loads anywhere — including back into this framework's own
``--hf`` path. The reference has no training-export at all (its Whisper
integration is inference-only, ``yoho/src/nn/whisper.py``); this closes
the train->serve loop.

Layout mapping (flax -> torch), mirroring convert.py:
  * kernel (in, out)        -> Linear weight (out, in)     [transpose]
  * kernel (k, in, out)     -> Conv1d weight (out, in, k)  [permute]
  * embedding               -> Embedding weight            [copy]
  * encoder positions       -> regenerated sinusoids (convert.py drops
    them on load; HF would otherwise RANDOMLY init them on reload)
  * proj_out                -> omitted (tied to embed_tokens)

The port's copy of the JAX package's ``nn/export.py``. The machine with
the card has no ``safetensors`` package, so :func:`save_safetensors` writes
the format itself: an 8-byte little-endian header length, a JSON header
(dtype, shape and byte range of each tensor, padded with spaces to a
multiple of 8) and the raw little-endian bytes.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict

import numpy as np

from yoho_tpu_torch.core.config import WhisperConfig

_SAFETENSORS_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
                       np.dtype(np.int8): "I8", np.dtype(np.int32): "I32",
                       np.dtype(np.int64): "I64", np.dtype(np.uint8): "U8"}

# Checkpoint-dir companions that make the exported dir a drop-in
# replacement for the source (tokenizer, feature extractor, generation
# defaults). Copied verbatim when present; all optional.
_COMPANION_FILES = (
    "config.json",
    "generation_config.json",
    "preprocessor_config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "vocab.json",
    "merges.txt",
    "normalizer.json",
    "added_tokens.json",
)


def _np32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _lin(out: Dict[str, np.ndarray], prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _np32(p["kernel"]).T.copy()
    if "bias" in p:
        out[prefix + ".bias"] = _np32(p["bias"])


def _ln(out: Dict[str, np.ndarray], prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _np32(p["scale"])
    out[prefix + ".bias"] = _np32(p["bias"])


def _conv(out: Dict[str, np.ndarray], prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _np32(p["kernel"]).transpose(2, 1, 0).copy()
    out[prefix + ".bias"] = _np32(p["bias"])


def _attn(out: Dict[str, np.ndarray], prefix: str, p: dict) -> None:
    _lin(out, prefix + ".q_proj", p["q_proj"])
    _lin(out, prefix + ".k_proj", p["k_proj"])
    _lin(out, prefix + ".v_proj", p["v_proj"])
    _lin(out, prefix + ".out_proj", p["out_proj"])


def whisper_params_to_hf(params: dict, cfg: WhisperConfig) -> Dict[str, np.ndarray]:
    """Our param pytree -> flat HF ``model.*`` state dict (numpy f32)."""
    from yoho_tpu_torch.nn.whisper import sinusoids

    sd: Dict[str, np.ndarray] = {}
    enc, dec = params["encoder"], params["decoder"]

    _conv(sd, "model.encoder.conv1", enc["conv1"])
    _conv(sd, "model.encoder.conv2", enc["conv2"])
    _ln(sd, "model.encoder.layer_norm", enc["ln_post"])
    # convert.py:11 drops the (fixed, sinusoidal) encoder positions on
    # load; transformers would re-init them RANDOMLY if absent here.
    sd["model.encoder.embed_positions.weight"] = _np32(
        sinusoids(cfg.n_audio_ctx, cfg.n_audio_state))
    for i in range(cfg.n_audio_layer):
        b = enc[f"blocks_{i}"]
        p = f"model.encoder.layers.{i}"
        _ln(sd, f"{p}.self_attn_layer_norm", b["ln1"])
        _attn(sd, f"{p}.self_attn", b["attn"])
        _ln(sd, f"{p}.final_layer_norm", b["ln2"])
        _lin(sd, f"{p}.fc1", b["mlp"]["fc1"])
        _lin(sd, f"{p}.fc2", b["mlp"]["fc2"])

    sd["model.decoder.embed_tokens.weight"] = _np32(
        dec["token_embedding"]["embedding"])
    sd["model.decoder.embed_positions.weight"] = _np32(
        dec["positional_embedding"])
    _ln(sd, "model.decoder.layer_norm", dec["ln"])
    for i in range(cfg.n_text_layer):
        b = dec[f"blocks_{i}"]
        p = f"model.decoder.layers.{i}"
        _ln(sd, f"{p}.self_attn_layer_norm", b["ln1"])
        _attn(sd, f"{p}.self_attn", b["attn"])
        _ln(sd, f"{p}.encoder_attn_layer_norm", b["ln2"])
        _attn(sd, f"{p}.encoder_attn", b["cross_attn"])
        _ln(sd, f"{p}.final_layer_norm", b["ln3"])
        _lin(sd, f"{p}.fc1", b["mlp"]["fc1"])
        _lin(sd, f"{p}.fc2", b["mlp"]["fc2"])
    return sd


def save_safetensors(tensors: Dict[str, np.ndarray], path, metadata=None) -> None:
    """Write ``tensors`` as a safetensors file (see the module doc), names
    in sorted order; written to a temp file and renamed."""
    header = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _SAFETENSORS_DTYPES:
            raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors code here")
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[arr.dtype],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)
    tmp.replace(path)


def _synth_config(cfg: WhisperConfig) -> dict:
    """Minimal transformers WhisperConfig dict when no source config.json
    is available (architecture fields only; generation defaults omitted)."""
    return {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "num_mel_bins": cfg.n_mels,
        "max_source_positions": cfg.n_audio_ctx,
        "d_model": cfg.n_audio_state,
        "encoder_attention_heads": cfg.n_audio_head,
        "encoder_layers": cfg.n_audio_layer,
        "decoder_attention_heads": cfg.n_text_head,
        "decoder_layers": cfg.n_text_layer,
        "encoder_ffn_dim": 4 * cfg.n_audio_state,
        "decoder_ffn_dim": 4 * cfg.n_text_state,
        "vocab_size": cfg.n_vocab,
        "max_target_positions": cfg.n_text_ctx,
        "activation_function": "gelu",
        "is_encoder_decoder": True,
        "tie_word_embeddings": True,
        # Standard whisper token ids — but never past the actual vocab
        # (exported tiny test geometries would otherwise get an
        # eos/decoder_start beyond the embedding table, so a reloaded
        # transformers generate() indexes out of range or never stops).
        "eos_token_id": min(50257 if cfg.n_vocab != 51864 else 50256,
                            cfg.n_vocab - 1),
        "pad_token_id": min(50257 if cfg.n_vocab != 51864 else 50256,
                            cfg.n_vocab - 1),
        "decoder_start_token_id": min(
            50258 if cfg.n_vocab != 51864 else 50257, cfg.n_vocab - 1),
    }


def export_hf_whisper(params: dict, cfg: WhisperConfig, out_dir,
                      src_dir=None, copy_config: bool = True) -> Path:
    """Write ``params`` as an HF Whisper checkpoint dir.

    ``src_dir`` (the checkpoint the fine-tune started from) donates
    config.json, tokenizer and preprocessor files so the exported dir is
    a complete drop-in; without it a minimal config.json is synthesized
    (tokenizer files must then be added for text rendering).
    ``copy_config=False`` synthesizes config.json even with a src_dir —
    for distillation, where ``src_dir`` is the TEACHER (right tokenizer,
    wrong architecture).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sd = whisper_params_to_hf(params, cfg)
    save_safetensors(sd, out / "model.safetensors", metadata={"format": "pt"})

    copied = set()
    if src_dir is not None:
        src = Path(src_dir)
        for name in _COMPANION_FILES:
            if not copy_config:
                # src_dir is a DIFFERENT architecture (the distillation
                # teacher): config.json and generation_config.json carry
                # architecture-coupled fields (e.g. alignment_heads as
                # [layer, head] pairs of the teacher's decoder) that
                # would crash or corrupt word timestamps on the student.
                if name in ("config.json", "generation_config.json"):
                    continue
                if name == "preprocessor_config.json":
                    # Frontend file: only valid if the mel resolution
                    # matches the student's.
                    try:
                        feat = json.loads(
                            (src / name).read_text()).get("feature_size")
                    except (OSError, ValueError):
                        feat = None
                    if feat != cfg.n_mels:
                        continue
            if (src / name).is_file():
                shutil.copyfile(src / name, out / name)
                copied.add(name)
    if "config.json" not in copied:
        (out / "config.json").write_text(
            json.dumps(_synth_config(cfg), indent=2))
    return out
