"""Whisper architecture hyperparameters and the released-size presets.

A plain dataclass with the same fields, defaults and derived sizes as the
JAX package's ``WhisperConfig`` (``yoho_tpu/core/config.py``), so a preset
names the same model in both packages.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import List, Union


@dataclass(frozen=True)
class WhisperConfig:
    """Whisper architecture hyperparameters (OpenAI naming)."""

    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 512
    n_audio_head: int = 8
    n_audio_layer: int = 6
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 512
    n_text_head: int = 8
    n_text_layer: int = 6

    # Audio frontend constants (fixed across all Whisper sizes).
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    chunk_seconds: float = 30.0

    @property
    def n_samples(self) -> int:
        return int(self.chunk_seconds * self.sample_rate)  # 480_000

    @property
    def n_frames(self) -> int:
        return self.n_samples // self.hop_length  # 3000


def _wcfg(mels, ctx, state, head, layer, vocab=51865, tctx=448,
          text_layer=None) -> WhisperConfig:
    return WhisperConfig(
        n_mels=mels,
        n_audio_ctx=ctx,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_vocab=vocab,
        n_text_ctx=tctx,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=text_layer if text_layer is not None else layer,
    )


WHISPER_PRESETS: dict[str, WhisperConfig] = {
    "tiny": _wcfg(80, 1500, 384, 6, 4),
    "tiny.en": _wcfg(80, 1500, 384, 6, 4, vocab=51864),
    "base": _wcfg(80, 1500, 512, 8, 6),
    "base.en": _wcfg(80, 1500, 512, 8, 6, vocab=51864),
    "small": _wcfg(80, 1500, 768, 12, 12),
    "small.en": _wcfg(80, 1500, 768, 12, 12, vocab=51864),
    "medium": _wcfg(80, 1500, 1024, 16, 24),
    "medium.en": _wcfg(80, 1500, 1024, 16, 24, vocab=51864),
    "large-v2": _wcfg(80, 1500, 1280, 20, 32),
    "large-v3": _wcfg(128, 1500, 1280, 20, 32, vocab=51866),
    # Distilled serving variant: full encoder, 4-layer decoder.
    "large-v3-turbo": _wcfg(128, 1500, 1280, 20, 32, vocab=51866,
                            text_layer=4),
    # distil-whisper family: full teacher encoder, 2-layer decoder.
    "distil-large-v2": _wcfg(80, 1500, 1280, 20, 32, text_layer=2),
    "distil-large-v3": _wcfg(128, 1500, 1280, 20, 32, vocab=51866,
                             text_layer=2),
    "distil-medium.en": _wcfg(80, 1500, 1024, 16, 24, vocab=51864,
                              text_layer=2),
    "distil-small.en": _wcfg(80, 1500, 768, 12, 12, vocab=51864,
                             text_layer=4),
}


# ---------------------------------------------------------------- sessions
# The JAX package's session configuration (``yoho_tpu/core/config.py``:
# ``YOHOConfig``, the per-stage hyperparameters, ``WeightsConfig``,
# ``MeshConfig``, ``SessionConfig``, ``DEFAULT_SESSION_TOML`` and
# ``load_session_config``) as plain dataclasses with the same names,
# defaults and validation errors: the machine with the card has no
# ``pydantic``. The mesh section sizes the trainers' (data, model) mesh
# under a launcher (``train/trainer.py``), and ``seq`` the long-context
# (data, seq) mesh.


def _build(cls, raw, where: str):
    """A dataclass from a TOML table: nested tables build their field's
    dataclass, unknown keys raise (pydantic's default would ignore them;
    an unknown key here is a typo in a session file)."""
    if isinstance(raw, cls):
        return raw
    if not isinstance(raw, dict):
        raise ValueError(f"{where}: expected a table, got {type(raw).__name__}")
    names = {f.name: f for f in fields(cls)}
    unknown = sorted(set(raw) - set(names))
    if unknown:
        raise ValueError(f"{where}: unknown keys {unknown}")
    kw = {}
    for key, val in raw.items():
        sub = _NESTED.get((cls.__name__, key))
        if sub is not None:
            val = _build(sub, val, f"{where}.{key}")
        elif names[key].type in ("Path", Path):
            val = Path(val)
        kw[key] = val
    return cls(**kw)


@dataclass(frozen=True)
class YOHOConfig:
    """Hyperparameters of the YOHO model and its audio frontend, with the
    reference's sample-count identity ``n_samples = n_fft +
    (max_audio_len - 1) * stft_hop`` (default 164,080 samples, about
    10.25 s)."""

    sample_rate: int = 16000
    n_mel_bands: int = 128
    n_fft: int = 400
    stft_hop: int = 160

    # Training context lengths; exceeding them degrades accuracy.
    max_audio_len: int = 1024  # STFT frames fed to the encoder
    max_text_len: int = 256  # decoder tokens

    dims: int = 384

    n_audio_heads: int = 6
    n_audio_blocks: int = 4

    n_text_heads: int = 6
    n_text_blocks: int = 4

    # Mixture-of-Experts (0 = dense): every moe_every_n-th encoder block
    # (and decoder block with moe_in_decoder) carries nn/moe.py's top-k
    # MoE MLP, as in the JAX package.
    n_experts: int = 0
    moe_in_decoder: bool = False
    moe_every_n: int = 2
    moe_top_k: int = 2
    expert_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.n_experts > 0:
            if self.moe_every_n < 1:
                raise ValueError(
                    f"moe_every_n must be >= 1, got {self.moe_every_n}")
            if not 1 <= self.moe_top_k <= self.n_experts:
                raise ValueError(
                    f"moe_top_k ({self.moe_top_k}) must be in "
                    f"[1, n_experts={self.n_experts}]")
            if self.expert_capacity_factor <= 0:
                raise ValueError(
                    "expert_capacity_factor must be > 0, got "
                    f"{self.expert_capacity_factor}")

    @property
    def n_samples(self) -> int:
        return self.n_fft + (self.max_audio_len - 1) * self.stft_hop

    @property
    def max_input_seconds(self) -> float:
        return self.n_samples / self.sample_rate

    @property
    def encoder_positions(self) -> int:
        # The audio encoder halves time once (stride-2 pooling).
        return self.max_audio_len // 2


@dataclass(frozen=True)
class DatasetConfig:
    noisy: Path = Path("./asr_dataset/noisy")
    clean: Path = Path("./asr_dataset/clean")
    finetune: Path = Path("./asr_dataset/finetune")
    ambient: Path = Path("./asr_dataset/ambient")
    speakers: Path = Path("./asr_dataset/speakers")


@dataclass(frozen=True)
class TokenizerHP:
    max_token_length: int = 32
    vocab_size: int = 16000


@dataclass(frozen=True)
class TrainingHP:
    learning_rate: float = 1e-3
    final_learning_rate: float = 1e-5
    batch_size: int = 16
    accumulated_batches: int = 16
    updates: int = 250_000
    warmup_updates: int = 2500
    validation_frequency: int = 25
    validation_samples: int = 8
    remat: bool = False


@dataclass(frozen=True)
class TrainingASRHP(TrainingHP):
    speechless_sample_ratio: float = 0.1
    long_context_factor: int = 1

    def __post_init__(self):
        if self.long_context_factor < 1:
            raise ValueError("long_context_factor must be >= 1")


@dataclass(frozen=True)
class TrainingReconstructionHP(TrainingHP):
    kl_weight: float = 1e-3
    latent_dim: int = 64


@dataclass(frozen=True)
class TrainingVoicePrintsHP(TrainingHP):
    temperature: float = 0.07
    embedding_dim: int = 256


@dataclass(frozen=True)
class Hyperparameters:
    tokenizer: TokenizerHP = field(default_factory=TokenizerHP)
    transcribe_pretrain: TrainingASRHP = field(default_factory=TrainingASRHP)
    reconstruct_pretrain: TrainingReconstructionHP = field(
        default_factory=TrainingReconstructionHP)
    voiceprint_finetune: TrainingVoicePrintsHP = field(
        default_factory=lambda: TrainingVoicePrintsHP(updates=100_000,
                                                      warmup_updates=1000))
    transcribe_finetune: TrainingASRHP = field(default_factory=TrainingASRHP)


@dataclass
class WeightsConfig:
    """Artifact slots per stage."""

    tokenizer: Path = Path("./weights/tokenizer.model")
    asr: Path = Path("./weights/asr.ckpt")
    voice_reconstruction: Path = Path("./weights/voice_reconstruction.ckpt")
    voiceprint: Path = Path("./weights/voiceprint.ckpt")
    yoho: Path = Path("./weights/yoho.ckpt")


@dataclass(frozen=True)
class MeshConfig:
    """The JAX package's device mesh section: the session trainers'
    ``make_mesh(data, model)`` under a launcher, and ``seq`` the ring axis
    of long-context training (``long_context_factor > 1``)."""

    data: int = -1
    model: int = 1
    seq: int = -1
    allowed_mem_fraction: float = 0.9

    def __post_init__(self):
        if self.model < 1:
            raise ValueError("mesh.model must be >= 1")
        if self.seq < 1 and self.seq != -1:
            raise ValueError("mesh.seq must be >= 1 (or -1 = infer)")


@dataclass
class SessionConfig:
    """One training session: the configuration and its artifact tree."""

    name: str = "session"
    yoho: YOHOConfig = field(default_factory=YOHOConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    hyperparameters: Hyperparameters = field(default_factory=Hyperparameters)
    weights: WeightsConfig = field(default_factory=WeightsConfig)
    language_whitelist: List[str] = field(default_factory=lambda: ["en"])
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sessions_root: Path = Path("./sessions")

    @property
    def path(self) -> Path:
        return Path(self.sessions_root) / self.name

    def reroot_weights(self) -> "SessionConfig":
        """Re-root relative weight paths into the session directory
        (idempotent: a path already under it is kept)."""
        base = self.path
        for f in fields(self.weights):
            cur = Path(getattr(self.weights, f.name))
            if not cur.is_absolute() and not cur.is_relative_to(base):
                setattr(self.weights, f.name, base / cur)
        return self


_NESTED = {
    ("SessionConfig", "yoho"): YOHOConfig,
    ("SessionConfig", "dataset"): DatasetConfig,
    ("SessionConfig", "hyperparameters"): Hyperparameters,
    ("SessionConfig", "weights"): WeightsConfig,
    ("SessionConfig", "mesh"): MeshConfig,
    ("Hyperparameters", "tokenizer"): TokenizerHP,
    ("Hyperparameters", "transcribe_pretrain"): TrainingASRHP,
    ("Hyperparameters", "reconstruct_pretrain"): TrainingReconstructionHP,
    ("Hyperparameters", "voiceprint_finetune"): TrainingVoicePrintsHP,
    ("Hyperparameters", "transcribe_finetune"): TrainingASRHP,
}


DEFAULT_SESSION_TOML = """\
language_whitelist = ['en']

[mesh]
data = -1
model = 1
# seq: ring-attention axis for long-context training (-1 = infer);
# used only when a stage sets long_context_factor > 1.
seq = -1
allowed_mem_fraction = 0.90

[yoho]
sample_rate = 16000
n_mel_bands = 128
n_fft = 400
stft_hop = 160
max_audio_len = 1024
max_text_len = 256
dims = 384
n_audio_heads = 6
n_audio_blocks = 4
n_text_heads = 6
n_text_blocks = 4

[dataset]
noisy = './asr_dataset/noisy'
clean = './asr_dataset/clean'
finetune = './asr_dataset/finetune'
ambient = './asr_dataset/ambient'
speakers = './asr_dataset/speakers'

[weights]
tokenizer = './weights/tokenizer.model'
asr = './weights/asr.ckpt'
voice_reconstruction = './weights/voice_reconstruction.ckpt'
voiceprint = './weights/voiceprint.ckpt'
yoho = './weights/yoho.ckpt'

[hyperparameters.tokenizer]
max_token_length = 32
vocab_size = 16000

[hyperparameters.transcribe_pretrain]
learning_rate = 0.001
final_learning_rate = 0.00001
batch_size = 16
accumulated_batches = 16
updates = 250000
warmup_updates = 2500
validation_frequency = 25
validation_samples = 8
speechless_sample_ratio = 0.1
# Gradient-checkpoint every transformer block: exact, ~one extra forward,
# O(depth) less activation memory (any [hyperparameters.*] section).
remat = false
# Train on clips N x the base window via sequence-parallel ring
# attention over the mesh's seq axis (1 = off).
long_context_factor = 1

[hyperparameters.reconstruct_pretrain]
learning_rate = 0.001
final_learning_rate = 0.00001
batch_size = 16
accumulated_batches = 16
updates = 250000
warmup_updates = 2500
validation_frequency = 25
validation_samples = 8
kl_weight = 0.001
latent_dim = 64

[hyperparameters.voiceprint_finetune]
learning_rate = 0.001
final_learning_rate = 0.00001
batch_size = 16
accumulated_batches = 16
updates = 100000
warmup_updates = 1000
validation_frequency = 25
validation_samples = 8
temperature = 0.07
embedding_dim = 256

[hyperparameters.transcribe_finetune]
learning_rate = 0.001
final_learning_rate = 0.00001
batch_size = 16
accumulated_batches = 16
updates = 250000
warmup_updates = 2500
validation_frequency = 25
validation_samples = 8
speechless_sample_ratio = 0.1
"""


def load_session_config(
    name: str, sessions_root: Union[str, Path] = "./sessions"
) -> SessionConfig:
    """Load ``<sessions_root>/<name>/config.toml`` and re-root weight paths."""
    sessions_root = Path(sessions_root)
    path = sessions_root / name
    cfg_file = path / "config.toml"
    if not cfg_file.exists():
        raise FileNotFoundError(
            f"Cannot load session config; session '{name}' does not exist at {path}"
        )
    with open(cfg_file, "rb") as f:
        raw = tomllib.load(f)
    for reserved in ("name", "sessions_root"):
        if reserved in raw:
            raise ValueError(
                f"{cfg_file}: top-level '{reserved}' is reserved (it is "
                "derived from the session directory) — remove it")
    config = _build(SessionConfig, dict(raw, name=name,
                                        sessions_root=sessions_root),
                    str(cfg_file))
    return config.reroot_weights()
