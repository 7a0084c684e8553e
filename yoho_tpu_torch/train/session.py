"""Session scaffolding: ``sessions/<name>/{config.toml, weights/,
stages/}`` (the JAX package's ``train/session.py``)."""

from __future__ import annotations

from pathlib import Path

from yoho_tpu_torch.core.config import DEFAULT_SESSION_TOML, SessionConfig

STAGE_NAMES = {
    0: "tokenizer",
    1: "transcribe_pretrain",
    2: "reconstruct_pretrain",
    3: "voiceprint_finetune",
    4: "transcribe_finetune",
}


def create_session(name: str, sessions_root="./sessions",
                   config_toml: str | None = None) -> Path:
    path = Path(sessions_root) / name
    if path.exists():
        raise FileExistsError(f"Session {name!r} already exists at {path}")
    path.mkdir(parents=True)
    (path / "config.toml").write_text(config_toml or DEFAULT_SESSION_TOML)
    (path / "weights").mkdir()
    (path / "stages").mkdir()
    return path


def stage_dir(config: SessionConfig, stage: int) -> Path:
    d = config.path / "stages" / str(stage)
    d.mkdir(parents=True, exist_ok=True)
    return d
