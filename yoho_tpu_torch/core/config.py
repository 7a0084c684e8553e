"""Whisper architecture hyperparameters and the released-size presets.

A plain dataclass with the same fields, defaults and derived sizes as the
JAX package's ``WhisperConfig`` (``yoho_tpu/core/config.py``), so a preset
names the same model in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass


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
