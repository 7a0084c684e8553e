"""Import hygiene and device selection of the PyTorch port.

The port imports no JAX and nothing of the JAX package, so it runs where
neither is installed; its entry points run on CUDA unless the caller asks
for the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _modules():
    pkg = ROOT / "yoho_tpu_torch"
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in pkg.rglob("*.py"))


def test_every_module_imports_without_jax():
    mods = [m.removesuffix(".__init__") for m in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flax', 'yoho_tpu.')) or m == 'yoho_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert len(mods) >= 20
    # The request options', the audio input's, speculative decoding's and
    # the serving layer's modules are among them.
    assert {"yoho_tpu_torch.infer.beam", "yoho_tpu_torch.infer.logit_rules",
            "yoho_tpu_torch.infer.word_timestamps", "yoho_tpu_torch.audio.io",
            "yoho_tpu_torch.audio.flac", "yoho_tpu_torch.audio.codecs",
            "yoho_tpu_torch.audio.vad", "yoho_tpu_torch.native",
            "yoho_tpu_torch.infer.speculative", "yoho_tpu_torch.infer.slot_engine",
            "yoho_tpu_torch.infer.continuous", "yoho_tpu_torch.infer.continuous_spec",
            "yoho_tpu_torch.infer.batching", "yoho_tpu_torch.infer.streaming",
            "yoho_tpu_torch.text.srt", "yoho_tpu_torch.utils.websocket",
            "yoho_tpu_torch.cli.serve", "yoho_tpu_torch.cli.serve_openai",
            "yoho_tpu_torch.cli.serve_ws"} <= set(mods)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_never_name_the_jax_package():
    for path in (ROOT / "yoho_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and not stripped.startswith(
                    ("import yoho_tpu.", "from yoho_tpu.", "import yoho_tpu ",
                     "from yoho_tpu ")), f"{path}: {stripped}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(monkeypatch):
    from yoho_tpu_torch.core.device import resolve_device

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("caller", [True, False])
def test_full_fp32_is_local_to_its_block(caller):
    """``full_fp32`` turns TF32 off inside its block and gives the caller's
    settings back after it; picking a device changes neither."""
    from yoho_tpu_torch.core.device import full_fp32, resolve_device

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = caller
        resolve_device("cpu")
        with full_fp32():
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, False)
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (caller, caller)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def test_whisper_needs_device_cpu_without_cuda(monkeypatch):
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.nn.whisper import Whisper

    cfg = WhisperConfig(n_audio_ctx=8, n_audio_state=16, n_audio_head=2,
                        n_audio_layer=1, n_vocab=64, n_text_ctx=8, n_text_state=16,
                        n_text_head=2, n_text_layer=1)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Whisper(cfg)
    model = Whisper(cfg, device="cpu")
    assert model.device == torch.device("cpu")


def test_transcriber_needs_device_cpu_without_cuda(monkeypatch):
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    cfg = WhisperConfig(n_audio_ctx=8, n_audio_state=16, n_audio_head=2,
                        n_audio_layer=1, n_vocab=51865, n_text_ctx=8,
                        n_text_state=16, n_text_head=2, n_text_layer=1)
    model = Whisper(cfg, device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transcriber(model, token_table=WhisperTokenTable())
    Transcriber(model, token_table=WhisperTokenTable(), device="cpu")


def test_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """A CPU tensor never touches the kernel build (no nvcc here), and
    launch counters stay at 0."""
    from yoho_tpu_torch.ops import (
        decode_attention,
        flash_attention,
        mel_kernel,
        w8a8_dense,
    )

    kernels = (mel_kernel.KERNEL, flash_attention.KERNEL, decode_attention.KERNEL,
               w8a8_dense.KERNEL)
    before = [k.launches for k in kernels]
    mel_kernel.fused_log_mel(torch.zeros(1, 1600))
    flash_attention.flash_attention(*(torch.zeros(1, 4, 1, 8) for _ in range(3)))
    decode_attention.fused_decode_attention(
        torch.zeros(1, 1, 1, 8), torch.zeros(1, 1, 8, 4, dtype=torch.int8),
        torch.zeros(1, 1, 8, 4, dtype=torch.int8),
        torch.ones(1, 1, 1, 4, dtype=torch.bfloat16),
        torch.ones(1, 1, 1, 4, dtype=torch.bfloat16))
    w8a8_dense.w8a8_dense(torch.zeros(3, 32), torch.zeros(8, 32, dtype=torch.int8),
                          torch.ones(8), activation="gelu_tanh")
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)
