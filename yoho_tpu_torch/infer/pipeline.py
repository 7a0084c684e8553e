"""High-level transcription API (whisper family): audio in, timed
segments out.

The JAX package's ``infer/pipeline.py::Transcriber`` for batched
transcription of array input: audio is cut into fixed 30 s windows, the
windows of all requests are pooled and decoded ``batch_size`` at a time
(log-mel kernel -> encoder -> cross-K/V -> greedy decode with the
timestamp rules), and segments are stitched back per request. Options of
the JAX class that this port does not have yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from yoho_tpu_torch.core.device import resolve_device
from yoho_tpu_torch.infer.decode_programs import DecodeProgramsMixin
from yoho_tpu_torch.infer.fallback import FallbackLadderMixin
from yoho_tpu_torch.infer.longform import Segment, chunk_audio, stitch_segments
from yoho_tpu_torch.infer.rendering import RenderingMixin
from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel


@dataclass
class TranscriptionResult:
    text: str
    segments: List[Segment]
    language: Optional[str] = None
    language_probability: Optional[float] = None


def _not_ported(feature: str, item: int):
    raise NotImplementedError(
        f"{feature} is not in the PyTorch port yet "
        f"(ROADMAP.md, Queue 1 item {item})")


class Transcriber(DecodeProgramsMixin, FallbackLadderMixin, RenderingMixin):
    """Audio arrays in, timed segments out (whisper family, greedy decode
    with the temperature fallback ladder).

    ``device=None`` runs on CUDA and raises when CUDA is absent; the model
    must already live on the resolved device."""

    def __init__(
        self,
        model,
        *,
        token_table,
        family: str = "whisper",
        batch_size: int = 8,
        beams: int = 0,
        overlap_seconds: float = 5.0,
        cache_dtype=torch.float32,
        language: Optional[str] = "en",
        task: str = "transcribe",
        timestamps: bool = True,
        quantized_cross_kv=False,  # False | True/"int8" | "int4"
        quantized_cache: bool = False,
        no_speech_threshold: float = 0.6,
        logprob_threshold: float = -1.0,
        temperatures: Sequence[float] = (0.0,),
        compression_ratio_threshold: float = 2.4,
        best_of: int = 1,
        initial_prompt: Optional[str] = None,
        suppress_tokens: Sequence[int] = (),
        device=None,
        **unported,
    ):
        if family != "whisper":
            _not_ported(f"family={family!r}", 12)
        if beams and beams > 1:
            _not_ported("beam search (beams > 1)", 8)
        if language is None:
            _not_ported("language auto-detection (language=None)", 3)
        for name, item in (("word_timestamps", 4), ("vad_filter", 5),
                           ("vad_options", 5),
                           ("hallucination_silence_threshold", 5),
                           ("logit_bias", 6), ("hotwords", 6),
                           ("hotword_boost", 6), ("repetition_penalty", 6),
                           ("no_repeat_ngram_size", 6),
                           ("condition_on_previous_text", 7),
                           ("draft_model", 9), ("draft_variables", 9),
                           ("speculative_gamma", 9), ("mesh", 11),
                           ("diarize_encoder", 12), ("diarize_variables", 12),
                           ("enrolled_speakers", 12),
                           ("speaker_threshold", 12)):
            if unported.pop(name, None) not in (None, False, 0):
                _not_ported(name, item)
        if unported:
            raise TypeError(f"unknown arguments {sorted(unported)}")
        if task not in ("transcribe", "translate"):
            raise ValueError(f"unknown task {task!r}")
        self.best_of = int(best_of)
        if self.best_of < 1:
            raise ValueError(f"best_of must be >= 1, got {best_of}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, transcriber on "
                             f"{self.device}")
        if token_table is None:
            raise ValueError("whisper family needs a WhisperTokenTable")

        self.model = model
        self.token_table = token_table
        self.temperatures = tuple(temperatures)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.no_speech_threshold = no_speech_threshold
        self.logprob_threshold = logprob_threshold
        self.quantized_cross_kv = quantized_cross_kv
        self.quantized_cache = quantized_cache
        self.initial_prompt = initial_prompt
        self.suppress_tokens = tuple(int(t) for t in suppress_tokens)
        self.batch_size = int(batch_size)
        self.language = language
        self.task = task
        self.timestamps = timestamps
        self.cache_dtype = cache_dtype

        cfg = model.cfg
        self.sample_rate = cfg.sample_rate
        self.chunk_samples = cfg.n_samples
        self.hop = cfg.hop_length
        self.max_len = cfg.n_text_ctx
        self.eot = token_table.eot
        overlap = min(int(overlap_seconds * self.sample_rate), self.chunk_samples // 2)
        self.stride_samples = self.chunk_samples - overlap
        self._programs = {}

    def _features(self, wins: np.ndarray) -> torch.Tensor:
        audio = torch.as_tensor(wins, dtype=torch.float32, device=self.device)
        return fused_whisper_log_mel(audio, n_mels=self.model.cfg.n_mels)

    def _prepare_audio(self, audio, sample_rate: Optional[int]) -> np.ndarray:
        if not isinstance(audio, np.ndarray):
            _not_ported("audio file input", 5)
        if audio.dtype.kind in "iu":
            # Raw PCM: scale to [-1, 1] (soundfile convention).
            if audio.dtype not in (np.uint8, np.int16, np.int32):
                raise ValueError(
                    f"integer audio dtype {audio.dtype} is not a PCM dtype "
                    "(uint8/int16/int32); pass float samples in [-1, 1]")
            info = np.iinfo(audio.dtype)
            half = float(info.max) + 1.0
            audio = audio.astype(np.float32)
            if info.min == 0:  # unsigned PCM is offset
                audio = (audio - half / 2.0) / (half / 2.0)
            else:
                audio = audio / half
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 2:  # (samples, channels) or (channels, samples)
            audio = audio.mean(axis=1 if audio.shape[0] > audio.shape[1] else 0)
        elif audio.ndim != 1:
            raise ValueError(f"audio must be 1-D mono or 2-D multi-channel, "
                             f"got shape {audio.shape}")
        if sample_rate is not None and sample_rate != self.sample_rate:
            _not_ported("resampling", 5)
        return audio

    def transcribe(self, audio: np.ndarray, sample_rate: Optional[int] = None,
                   language: Optional[str] = None, prompt: Optional[str] = None,
                   temperature: Optional[float] = None) -> TranscriptionResult:
        """Transcribe one audio array of any length."""
        return self.transcribe_many([audio], sample_rate, languages=[language],
                                    prompts=[prompt],
                                    temperatures=[temperature])[0]

    def transcribe_many(
        self,
        audios: Sequence[np.ndarray],
        sample_rate: Optional[int] = None,
        languages: Optional[Sequence[Optional[str]]] = None,
        prompts: Optional[Sequence[Optional[str]]] = None,
        temperatures: Optional[Sequence[Optional[float]]] = None,
    ) -> List[TranscriptionResult]:
        """Transcribe several audio arrays through shared decode batches.

        All requests' 30 s windows are pooled per (prompt length,
        temperature) and decoded ``batch_size`` at a time. ``languages``,
        ``prompts`` and ``temperatures`` are per-request overrides (one
        entry per audio, ``None`` keeps the configuration)."""
        n = len(audios)
        for name, seq in (("languages", languages), ("prompts", prompts),
                          ("temperatures", temperatures)):
            if seq is not None and len(seq) != n:
                raise ValueError(f"{name} has {len(seq)} entries for {n} audios")
        req_langs = [lg or self.language for lg in (languages or [None] * n)]
        req_prompts = list(prompts) if prompts is not None else [None] * n
        req_temps = list(temperatures) if temperatures is not None else [None] * n
        for t in req_temps:
            if t is not None and not 0.0 <= float(t) <= 2.0:
                raise ValueError(f"temperature {t} outside [0, 2]")
        prepared = [self._prepare_audio(a, sample_rate) for a in audios]

        all_starts: List[List[int]] = []
        win_entries: List[tuple] = []  # (window, prompt ids, temperature)
        for audio, lang, ptext, tover in zip(prepared, req_langs, req_prompts,
                                             req_temps):
            if len(audio) == 0:
                all_starts.append([])
                continue
            w, s = chunk_audio(audio, self.chunk_samples, self.stride_samples)
            all_starts.append(s)
            ids = self._request_prompt_ids(lang, ptext)
            tkey = None if tover is None else float(tover)
            win_entries += [(win, ids, tkey) for win in w]
        per_window: List[Optional[List[Segment]]] = [None] * len(win_entries)

        pools: dict = {}
        for gi, (_win, ids, tkey) in enumerate(win_entries):
            pools.setdefault((len(ids), tkey), []).append(gi)

        b = self.batch_size
        for (plen, tkey), idxs in pools.items():
            ladder = None if tkey is None else (tkey,)
            for i in range(0, len(idxs), b):
                chunk = idxs[i: i + b]
                actual = len(chunk)
                batch = np.zeros((b, self.chunk_samples), np.float32)
                batch[:actual] = np.stack([win_entries[g][0] for g in chunk])
                filler = win_entries[chunk[0]][1]
                prompt = np.asarray([win_entries[g][1] for g in chunk]
                                    + [filler] * (b - actual), np.int64)
                mel = self._features(batch)
                tokens, lengths, aux = self._decode_with_fallback(
                    b, mel, prompt, temperatures=ladder)
                silent = self._silent_mask(lengths, aux, n_prompt=plen)
                segs = [[] if silent[j]
                        else self._tokens_to_segments(tokens[j], int(lengths[j]),
                                                      n_prompt=plen)
                        for j in range(actual)]
                self._attach_quality(segs, lengths, aux, n_prompt=plen)
                for j, g in enumerate(chunk):
                    per_window[g] = segs[j]

        results = []
        off = 0
        for starts, lang in zip(all_starts, req_langs):
            k = len(starts)
            segments = stitch_segments(per_window[off: off + k], starts,
                                       self.sample_rate, self.chunk_samples,
                                       self.stride_samples)
            text = " ".join(s.text for s in segments if s.text).strip()
            results.append(TranscriptionResult(text=text, segments=segments,
                                               language=lang))
            off += k
        return results

    def transcribe_batch(self, audios: Sequence[np.ndarray]
                         ) -> List[TranscriptionResult]:
        """Independent clips through shared padded batches
        (:meth:`transcribe_many`)."""
        return self.transcribe_many(audios)
