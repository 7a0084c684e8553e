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
        "import yoho_tpu_torch; yoho_tpu_torch.load_transcriber\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flax', 'yoho_tpu.', 'transformers', 'safetensors', "
        "'tokenizers')) or m == 'yoho_tpu')))\n")
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
            "yoho_tpu_torch.cli.serve_ws", "yoho_tpu_torch.nn.convert",
            "yoho_tpu_torch.text.gpt2_bpe", "yoho_tpu_torch.load",
            "yoho_tpu_torch.infer.capacity", "yoho_tpu_torch.utils.platform",
            "yoho_tpu_torch.utils.logging", "yoho_tpu_torch.utils.profiling",
            "yoho_tpu_torch.eval.wer", "yoho_tpu_torch.eval.english_normalizer",
            "yoho_tpu_torch.cli.transcribe", "yoho_tpu_torch.cli.align",
            "yoho_tpu_torch.cli.evaluate", "yoho_tpu_torch.cli.doctor",
            "yoho_tpu_torch.cli.finetune", "yoho_tpu_torch.cli.distill",
            "yoho_tpu_torch.cli.__main__", "yoho_tpu_torch.__main__",
            # The YOHO family.
            "yoho_tpu_torch.nn.yoho", "yoho_tpu_torch.nn.voiceprint",
            "yoho_tpu_torch.text.bpe", "yoho_tpu_torch.text.tokenizer",
            "yoho_tpu_torch.infer.speaker_pass", "yoho_tpu_torch.infer.diarize",
            "yoho_tpu_torch.cli.enroll",
            # YOHO scoring, MoE and the session commands.
            "yoho_tpu_torch.nn.moe", "yoho_tpu_torch.eval.diarization",
            "yoho_tpu_torch.cli.score_diarization", "yoho_tpu_torch.cli.summary",
            "yoho_tpu_torch.cli.create_session", "yoho_tpu_torch.cli.run_session",
            # Training stages 2-4 and the corpus tools.
            "yoho_tpu_torch.nn.reconstruction",
            "yoho_tpu_torch.train.stages.stage2_reconstruction",
            "yoho_tpu_torch.train.stages.stage3_voiceprint",
            "yoho_tpu_torch.train.stages.stage4_joint_finetune",
            "yoho_tpu_torch.cli.import_corpus", "yoho_tpu_torch.cli.cache_corpus",
            "yoho_tpu_torch.cli.split_tracks", "yoho_tpu_torch.cli.plot_metrics",
            # Multi-GPU serving on torch.distributed.
            "yoho_tpu_torch.parallel", "yoho_tpu_torch.parallel.mesh",
            "yoho_tpu_torch.parallel.sharding", "yoho_tpu_torch.parallel.ring_attention",
            "yoho_tpu_torch.parallel.long_encoder", "yoho_tpu_torch.parallel.pipeline",
            # Multi-GPU training on torch.distributed.
            "yoho_tpu_torch.train.sharded_checkpoint", "yoho_tpu_torch.dryrun"} \
        <= set(mods)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_training_modules_import_none_of_the_jax_stack():
    """The training slice's modules load no JAX, flax, optax, msgpack,
    safetensors or ml_dtypes (the machine with the card has none of them)
    and nothing of the JAX package."""
    mods = ["yoho_tpu_torch.train.whisper_finetune", "yoho_tpu_torch.train.distill",
            "yoho_tpu_torch.train.trainer", "yoho_tpu_torch.train.checkpoint",
            "yoho_tpu_torch.train.dataloader", "yoho_tpu_torch.train.metrics",
            "yoho_tpu_torch.train.optim", "yoho_tpu_torch.train.msgpack",
            "yoho_tpu_torch.nn.lora", "yoho_tpu_torch.nn.export",
            "yoho_tpu_torch.audio.augment", "yoho_tpu_torch.text.corpus",
            "yoho_tpu_torch.text.standardize", "yoho_tpu_torch.text.langdetect",
            "yoho_tpu_torch.text.numbers", "yoho_tpu_torch.text.lang_corpus",
            # YOHO session training (stages 0-1).
            "yoho_tpu_torch.train.session",
            "yoho_tpu_torch.train.stages.stage0_tokenizer",
            "yoho_tpu_torch.train.stages.stage1_asr_pretrain",
            # Stages 2-4 and the corpus tools (matplotlib only when plotting).
            "yoho_tpu_torch.nn.reconstruction",
            "yoho_tpu_torch.train.stages.stage2_reconstruction",
            "yoho_tpu_torch.train.stages.stage3_voiceprint",
            "yoho_tpu_torch.train.stages.stage4_joint_finetune",
            "yoho_tpu_torch.cli.import_corpus", "yoho_tpu_torch.cli.cache_corpus",
            "yoho_tpu_torch.cli.split_tracks", "yoho_tpu_torch.cli.plot_metrics",
            # Training over a mesh.
            "yoho_tpu_torch.train.sharded_checkpoint", "yoho_tpu_torch.dryrun"]
    assert set(mods) <= set(_modules())
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = ('jax', 'flax', 'optax', 'msgpack', 'safetensors', 'ml_dtypes', 'yoho_tpu',\n"
        "       'matplotlib')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in bad)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
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

    kernels = (mel_kernel.KERNEL, flash_attention.KERNEL, *decode_attention.KERNELS,
               w8a8_dense.KERNEL)
    before = [k.launches for k in kernels]
    mel_kernel.fused_log_mel(torch.zeros(1, 1600))
    flash_attention.flash_attention(*(torch.zeros(1, 4, 1, 8) for _ in range(3)))
    for q in (torch.zeros(1, 1, 1, 8), torch.zeros(1, 1, 5, 8, dtype=torch.bfloat16)):
        decode_attention.fused_decode_attention(
            q, torch.zeros(1, 1, 8, 4, dtype=torch.int8),
            torch.zeros(1, 1, 8, 4, dtype=torch.int8),
            torch.ones(1, 1, 1, 4, dtype=torch.bfloat16),
            torch.ones(1, 1, 1, 4, dtype=torch.bfloat16))
    w8a8_dense.w8a8_dense(torch.zeros(3, 32), torch.zeros(8, 32, dtype=torch.int8),
                          torch.ones(8), activation="gelu_tanh")
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)


def test_yoho_model_and_transcriber_need_device_cpu_without_cuda(monkeypatch):
    from yoho_tpu_torch.core.config import YOHOConfig
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.voiceprint import VoiceprintEncoder
    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.text.bpe import ByteBPE
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer, yoho_special_tokens

    cfg = YOHOConfig(n_mel_bands=8, max_audio_len=8, max_text_len=4, dims=16,
                     n_audio_heads=2, n_audio_blocks=1, n_text_heads=2, n_text_blocks=1)
    tok = YOHOTokenizer(ByteBPE(yoho_special_tokens(8), []), use_native=False)
    model = YOHOModel(cfg, tok.vocab_size, 8, device="cpu")
    _no_cuda(monkeypatch)
    for build in (lambda: YOHOModel(cfg, tok.vocab_size), lambda: VoiceprintEncoder(cfg),
                  lambda: Transcriber(model, family="yoho", tokenizer=tok)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert Transcriber(model, family="yoho", tokenizer=tok, device="cpu").max_len == 4
