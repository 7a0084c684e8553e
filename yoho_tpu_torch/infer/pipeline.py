"""High-level transcription API: audio in, timed segments (and, for the
YOHO family, voiceprints and speakers) out.

The JAX package's ``infer/pipeline.py::Transcriber``: audio (an array or a
file path, decoded and resampled on the host by ``audio/io.py``) is cut
into fixed windows (30 s for whisper, 10.25 s for YOHO), the windows of
all requests are pooled and decoded ``batch_size`` at a time (log-mel
kernel -> encoder -> cross-K/V -> greedy, speculative or beam decode with
the logit rules), and segments are stitched back per request. Two token
schemes:

* ``family="whisper"``: OpenAI's (``token_table``, a WhisperTokenTable),
  with the request options: beam search with a length penalty, language
  auto-detection, word timestamps and forced alignment, logit bias and
  hotwords, repetition rules, previous-text conditioning (window by
  window), the host energy VAD (``vad_filter``) with its map back to the
  source timeline, the silence-hallucination filter, speculative decoding
  with a draft model, and diarization by a ``VoiceprintEncoder``
  (``diarize_encoder``);
* ``family="yoho"``: the session tokenizer's (``tokenizer``, a
  YOHOTokenizer): ``<|t-frame|>`` timestamp tokens, and ``<|voiceprint|>``
  slots whose decoder states give speaker embeddings in one teacher-forced
  pass, clustered into speakers and named against enrolled voiceprints
  (``infer/speaker_pass.py``).

A mesh (``mesh=``, ``parallel/mesh.py``) serves the model tensor parallel
over its ``model`` axis (``parallel/sharding.py::shard_params`` cuts the
model and the draft in place, as the JAX class shards their params) and
data parallel over ``data``: every rank runs the same calls on the same
host inputs, a device program takes this rank's rows of each batch and
gathers its results over ``data`` before the host reads them, so every
rank takes the same host branches. The batch must divide by ``data``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from yoho_tpu_torch.audio.io import load_audio_f32, resample
from yoho_tpu_torch.audio.vad import collapse_silence
from yoho_tpu_torch.core.device import resolve_device
from yoho_tpu_torch.infer.decode_programs import DecodeProgramsMixin
from yoho_tpu_torch.infer.fallback import FallbackLadderMixin
from yoho_tpu_torch.infer.longform import Segment, chunk_audio, stitch_segments
from yoho_tpu_torch.infer.rendering import RenderingMixin
from yoho_tpu_torch.infer.speaker_pass import SpeakerPassMixin
from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel, fused_yoho_log_mel


@dataclass
class TranscriptionResult:
    text: str
    segments: List[Segment]
    language: Optional[str] = None
    # Probability of the detected language when it was auto-detected;
    # None when the configuration or the request named it.
    language_probability: Optional[float] = None


_NO_OVERRIDES = ("per-request prompt/temperature overrides don't compose with "
                 "condition_on_previous_text (use initial_prompt/temperatures "
                 "instead)")


class Transcriber(DecodeProgramsMixin, FallbackLadderMixin, RenderingMixin,
                  SpeakerPassMixin):
    """Audio arrays or files in, timed segments out (greedy decode with the
    temperature fallback ladder, speculative greedy decode with a draft
    model, or beam search; see the module doc for the two families).

    ``device=None`` runs on CUDA and raises when CUDA is absent; the model
    must already live on the resolved device.

    ``draft_model``: a smaller port ``Whisper`` of the same vocabulary and
    mel count on the same device. Greedy windows (temperature 0) then
    decode speculatively (``infer/speculative.py``): the draft proposes
    ``speculative_gamma`` tokens and the target verifies them in one step,
    with the target's greedy tokens as the result. The draft's weights live
    in its module, so the JAX class's ``draft_variables`` has no
    counterpart here (``nn.params.load_jax_params`` carries a JAX draft
    tree into it); nor has ``diarize_variables`` (the port's
    ``VoiceprintEncoder`` holds its weights)."""

    def __init__(
        self,
        model,
        *,
        family: str = "whisper",
        tokenizer=None,  # YOHOTokenizer (yoho family)
        token_table=None,  # WhisperTokenTable (whisper family)
        batch_size=8,  # int, or "auto" (infer/capacity.py)
        beams: int = 0,  # 0/1 = greedy
        length_penalty: float = 1.0,  # GNMT beam score normalization
        overlap_seconds: float = 5.0,
        cache_dtype=torch.float32,
        language: Optional[str] = "en",  # None = auto-detect
        task: str = "transcribe",
        timestamps: bool = True,
        quantized_cross_kv=False,  # False | True/"int8" | "int4"
        quantized_cache: bool = False,
        no_speech_threshold: float = 0.6,
        logprob_threshold: float = -1.0,
        word_timestamps: bool = False,
        temperatures: Sequence[float] = (0.0,),
        compression_ratio_threshold: float = 2.4,
        best_of: int = 1,
        initial_prompt: Optional[str] = None,
        condition_on_previous_text: bool = False,
        suppress_tokens: Sequence[int] = (),
        repetition_penalty: Optional[float] = None,  # CTRL-style, > 1 damps
        no_repeat_ngram_size: int = 0,
        logit_bias=None,  # {token_id: delta} added to the decode logits
        hotwords: Optional[str] = None,  # comma-separated boosted phrases
        hotword_boost: float = 4.0,
        vad_filter: bool = False,
        vad_options=None,  # audio.vad.VadOptions
        hallucination_silence_threshold: Optional[float] = None,
        draft_model=None,
        speculative_gamma: int = 4,
        diarize_encoder=None,  # VoiceprintEncoder (whisper-family diarization)
        enrolled_speakers=None,  # {name: voiceprint} for speaker recognition
        speaker_threshold: float = 0.75,  # cosine: cluster merge + naming
        mesh=None,  # parallel.mesh.Mesh, or a "DATAxMODEL" spec
        device=None,
        **unported,
    ):
        if family not in ("whisper", "yoho"):
            raise ValueError(f"unknown family {family!r}")
        if unported:
            raise TypeError(f"unknown arguments {sorted(unported)}")
        if task not in ("transcribe", "translate"):
            raise ValueError(f"unknown task {task!r}")
        self.best_of = int(best_of)
        if self.best_of < 1:
            raise ValueError(f"best_of must be >= 1, got {best_of}")
        if repetition_penalty is not None and repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {repetition_penalty}")
        if no_repeat_ngram_size < 0:
            raise ValueError(
                f"no_repeat_ngram_size must be >= 0, got {no_repeat_ngram_size}")
        if condition_on_previous_text and family != "whisper":
            raise ValueError("condition_on_previous_text is a whisper "
                             "family feature")
        if condition_on_previous_text and beams and beams > 1:
            raise ValueError("condition_on_previous_text currently supports "
                             "greedy (+temperature fallback) decoding only")
        if (hallucination_silence_threshold is not None
                and hallucination_silence_threshold <= 0):
            raise ValueError("hallucination_silence_threshold must be > 0 "
                             f"seconds, got {hallucination_silence_threshold}")
        if mesh is not None:
            from yoho_tpu_torch.parallel.mesh import as_mesh

            mesh = as_mesh(mesh, device)
            device = mesh.device if device is None else device
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"transcriber on {self.device}, mesh rank on {mesh.device}")
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, transcriber on "
                             f"{self.device}")
        if draft_model is not None:
            if beams and beams > 1:
                raise ValueError("speculative decoding is greedy-only "
                                 "(beams must be 0/1)")
            if int(speculative_gamma) < 1:
                raise ValueError(f"speculative_gamma must be >= 1, got "
                                 f"{speculative_gamma}")
            tgt_cfg = model.cfg
            if getattr(tgt_cfg, "n_experts", 0) and getattr(tgt_cfg, "moe_in_decoder", False):
                # A verify step's tokens compete for per-expert capacity,
                # where a one-token greedy step never drops: the committed
                # tokens could differ from the target's own greedy ones.
                raise ValueError(
                    "speculative decoding does not support moe_in_decoder "
                    "targets (S>1 verify changes MoE capacity routing, "
                    "breaking greedy exactness) — serve the MoE decoder "
                    "without a draft model")

            def vocab_mels(m):
                return ((m.cfg.n_vocab, m.cfg.n_mels) if family == "whisper"
                        else (m.vocab_size, m.cfg.n_mel_bands))

            if vocab_mels(draft_model) != vocab_mels(model):
                raise ValueError(f"draft vocab/mels {vocab_mels(draft_model)} "
                                 f"!= target's {vocab_mels(model)}")
            if draft_model.device != self.device:
                raise ValueError(f"draft model is on {draft_model.device}, "
                                 f"transcriber on {self.device}")
        if family == "whisper" and token_table is None:
            raise ValueError("whisper family needs a WhisperTokenTable")
        if family == "yoho" and tokenizer is None:
            raise ValueError("yoho family needs a YOHOTokenizer")
        self.diarize_encoder = diarize_encoder
        self.speaker_threshold = float(speaker_threshold)
        self.enrolled_speakers = dict(enrolled_speakers or {})
        if self.enrolled_speakers:
            # An embedding-space mismatch fails here, not after the decode.
            if family == "whisper":
                if diarize_encoder is None:
                    raise ValueError(
                        "enrolled_speakers on the whisper family needs "
                        "diarize_encoder= (whisper segments carry no "
                        "voiceprints to match otherwise)")
                expected = int(diarize_encoder.embedding_dim)
            else:
                expected = int(model.voiceprint_dim)
            for nm, emb in self.enrolled_speakers.items():
                got = int(np.asarray(emb).shape[-1])
                if got != expected:
                    raise ValueError(
                        f"enrolled speaker {nm!r} has embedding dim {got}, "
                        f"but this transcriber produces dim-{expected} "
                        "voiceprints — re-enroll with the same embedder "
                        "(enroll, same session / --diarize-session)")

        if mesh is not None:
            # Multi-device serving: tensor-parallel layers over ``model``;
            # the draft rides the same mesh, so verify and draft steps
            # share one layout.
            from yoho_tpu_torch.parallel.sharding import shard_params

            shard_params(model, mesh)
            if draft_model is not None:
                shard_params(draft_model, mesh)
        self.model = model
        self.family = family
        self.tokenizer = tokenizer
        self.token_table = token_table
        self.beams = max(0, int(beams))
        self.length_penalty = float(length_penalty)
        self.temperatures = tuple(temperatures)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.no_speech_threshold = no_speech_threshold
        self.logprob_threshold = logprob_threshold
        self.word_timestamps = word_timestamps
        # The YOHO family decodes over float cross K/V and caches: the JAX
        # package ignores the quantization flags for it, and so does this.
        whisper = family == "whisper"
        self.quantized_cross_kv = quantized_cross_kv if whisper else False
        self.quantized_cache = quantized_cache and whisper
        self.initial_prompt = initial_prompt
        self.condition_on_previous_text = condition_on_previous_text
        self.suppress_tokens = tuple(int(t) for t in suppress_tokens)
        self.repetition_penalty = repetition_penalty
        self.no_repeat_ngram_size = int(no_repeat_ngram_size)
        self.language = language
        self.task = task
        self.timestamps = timestamps
        self.cache_dtype = cache_dtype
        self.vad_filter = vad_filter
        self.vad_options = vad_options
        self.hallucination_silence_threshold = hallucination_silence_threshold
        self.draft_model = draft_model
        self.speculative_gamma = int(speculative_gamma)
        # Counts of the speculative decodes (rounds, tokens committed per
        # stream, host syncs), for measurement.
        self.speculative_stats: dict = {}

        cfg = model.cfg
        self.sample_rate = cfg.sample_rate
        self.chunk_samples = cfg.n_samples
        if family == "whisper":
            self.hop = cfg.hop_length
            self.max_len = cfg.n_text_ctx
            self.eot = token_table.eot
        else:
            self.hop = cfg.stft_hop
            self.max_len = cfg.max_text_len
            self.eot = tokenizer.eot_id
        overlap = min(int(overlap_seconds * self.sample_rate), self.chunk_samples // 2)
        self.stride_samples = self.chunk_samples - overlap
        # Fixed per Transcriber: bias -> repetition -> timestamp rules run
        # in every decode program.
        self._logit_bias_entries = self._build_logit_bias(
            logit_bias, hotwords, hotword_boost)
        self._programs = {}
        # The captured greedy programs' buffers, one set per batch size
        # (decode_programs.py::_workspace).
        self._workspaces = {}
        if isinstance(batch_size, str):
            # "auto": the largest batch the device's memory holds under
            # this transcriber's settings (infer/capacity.py).
            if batch_size != "auto":
                raise ValueError("batch_size must be an int or 'auto', "
                                 f"got {batch_size!r}")
            from yoho_tpu_torch.infer.capacity import resolve_auto_batch

            self.batch_size = resolve_auto_batch(self)
        else:
            self.batch_size = int(batch_size)

    def _features(self, wins: np.ndarray) -> torch.Tensor:
        """Log-mel of this rank's rows of a (B, samples) host batch."""
        audio = self._to_device(wins)
        if self.family == "whisper":
            return fused_whisper_log_mel(audio, n_mels=self.model.cfg.n_mels)
        return fused_yoho_log_mel(audio, self.model.cfg)

    def _prepare_audio(self, audio, sample_rate: Optional[int]) -> np.ndarray:
        """A file path (decoded and resampled by ``audio/io.py``) or an
        array (PCM scaled to [-1, 1], channels mixed down, resampled from
        ``sample_rate``) -> mono f32 at the model's rate."""
        if isinstance(audio, (str, Path)):
            return load_audio_f32(audio, self.sample_rate)
        audio = np.asarray(audio)
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
            audio = resample(audio, sample_rate, self.sample_rate)
        return audio

    def _apply_vad(self, audio: np.ndarray, enabled: Optional[bool] = None):
        """Collapse silence (``vad_filter`` on, or ``enabled`` for this
        call); returns (audio, SpeechMap or None)."""
        if not (self.vad_filter if enabled is None else enabled):
            return audio, None
        return collapse_silence(audio, self.sample_rate, self.vad_options)

    def transcribe(self, audio: Union[str, Path, np.ndarray],
                   sample_rate: Optional[int] = None,
                   language: Optional[str] = None, prompt: Optional[str] = None,
                   temperature: Optional[float] = None) -> TranscriptionResult:
        """Transcribe one audio array or file of any length. ``language``,
        ``prompt`` and ``temperature`` override the configuration for this
        call (as ``transcribe_many``'s per-request lists do)."""
        if self.condition_on_previous_text:
            if prompt is not None or temperature is not None:
                raise ValueError(_NO_OVERRIDES)
            return self._transcribe_sequential(
                self._prepare_audio(audio, sample_rate), language=language)
        return self.transcribe_many([audio], sample_rate, languages=[language],
                                    prompts=[prompt],
                                    temperatures=[temperature])[0]

    def _transcribe_sequential(self, audio: np.ndarray,
                               language: Optional[str] = None,
                               vad: Optional[bool] = None,
                               ) -> TranscriptionResult:
        """Window by window with previous-text conditioning.

        Each window's prompt is ``<|startofprev|>`` + the last C generated
        tokens + the SOT sequence, with C a fixed budget (two prompt
        lengths in all, not one per history length); windows before that
        much history use the base prompt. The history resets after a
        fallback rung above 0.5, so a degenerate window is not fed
        forward."""
        tt = self.token_table
        original_audio = audio
        audio, vmap = self._apply_vad(audio, vad)
        if len(audio) == 0:  # nothing left after the VAD
            return TranscriptionResult(text="", segments=[], language=self.language)
        lang = language or self.language
        lang_prob = None
        if lang is None:
            lang, lang_probs = self.detect_language(audio)
            lang_prob = lang_probs.get(lang)
        base_ids = self._prompt_ids(lang)
        sot_seq = tt.sot_sequence(lang, self.task, timestamps=self.timestamps)
        ctx_budget = max(8, self.max_len // 2 - len(sot_seq) - 1)
        init_ctx: List[int] = []
        if self.initial_prompt:
            init_ctx = list(map(int, tt.encode_text(" " + self.initial_prompt.strip())))

        windows, starts = chunk_audio(audio, self.chunk_samples, self.stride_samples)
        history: List[int] = []
        per_window: List[List[Segment]] = []
        for win in windows:
            mel = self._features(win[None])
            xa = self._encode(mel)  # the decode's and the passes' own
            ctx = init_ctx + history
            ids = ([tt.sot_prev] + ctx[-ctx_budget:] + sot_seq
                   if len(ctx) >= ctx_budget else base_ids)
            tokens, lengths, aux = self._decode_with_fallback(
                1, mel, np.asarray([ids], np.int64), xa=xa)
            silent = self._silent_mask(lengths, aux, n_prompt=len(ids))
            segs = ([] if silent[0]
                    else self._tokens_to_segments(tokens[0], int(lengths[0]),
                                                  n_prompt=len(ids)))
            self._attach_quality([segs], lengths, aux, n_prompt=len(ids))
            self._attach_words(mel, tokens, lengths, [segs], n_prompt=len(ids), xa=xa)
            per_window.append(segs)
            if aux["used_temperature"][0] > 0.5:
                history = []  # a degenerate window: do not condition on it
            elif not silent[0]:
                gen = tokens[0, len(ids): int(lengths[0])]
                history += [int(t) for t in gen
                            if t < tt.eot or tt.is_timestamp(int(t))]
                history = history[-4 * ctx_budget:]  # only the tail is used

        return self._finalize_request(per_window, starts, vmap, original_audio,
                                      lang, lang_prob)

    def transcribe_many(
        self,
        audios: Sequence[Union[str, Path, np.ndarray]],
        sample_rate: Optional[int] = None,
        languages: Optional[Sequence[Optional[str]]] = None,
        vad: Optional[Sequence[Optional[bool]]] = None,
        prompts: Optional[Sequence[Optional[str]]] = None,
        temperatures: Optional[Sequence[Optional[float]]] = None,
    ) -> List[TranscriptionResult]:
        """Transcribe several audio arrays or files through shared decode
        batches.

        All requests' 30 s windows are pooled per (prompt length,
        temperature) and decoded ``batch_size`` at a time. ``languages``,
        ``vad``, ``prompts`` and ``temperatures`` are per-request overrides
        (one entry per audio, ``None`` keeps the configuration; with
        ``language=None`` the requests without an override are detected
        in shared batches; ``vad`` overrides ``vad_filter``). With
        ``condition_on_previous_text`` each request runs window by window
        instead."""
        n = len(audios)
        for name, seq in (("languages", languages), ("vad", vad),
                          ("prompts", prompts), ("temperatures", temperatures)):
            if seq is not None and len(seq) != n:
                raise ValueError(f"{name} has {len(seq)} entries for {n} audios")
        overrides = list(languages) if languages is not None else [None] * n
        vad_over = list(vad) if vad is not None else [None] * n
        if self.condition_on_previous_text:
            if any(p is not None for p in (prompts or [])) or \
                    any(t is not None for t in (temperatures or [])):
                raise ValueError(_NO_OVERRIDES)
            return [self._transcribe_sequential(self._prepare_audio(a, sample_rate),
                                                language=lg, vad=v)
                    for a, lg, v in zip(audios, overrides, vad_over)]
        req_prompts = list(prompts) if prompts is not None else [None] * n
        req_temps = list(temperatures) if temperatures is not None else [None] * n
        for t in req_temps:
            if t is not None and not 0.0 <= float(t) <= 2.0:
                raise ValueError(f"temperature {t} outside [0, 2]")
        if self.beams > 1 and any(t is not None and float(t) != 0.0
                                  for t in req_temps):
            raise ValueError(
                f"per-request temperatures are greedy-only; this "
                f"Transcriber runs beam search (beams={self.beams})")
        # The source timeline per request (the hallucination filter reads
        # it); the VAD replaces ``prepared`` by the condensed audio.
        originals = [self._prepare_audio(a, sample_rate) for a in audios]
        pairs = [self._apply_vad(a, v) for a, v in zip(originals, vad_over)]
        prepared = [p[0] for p in pairs]
        vad_maps = [p[1] for p in pairs]

        req_lang_probs: List[Optional[float]] = [None] * n
        if (self.language is None and self.family == "whisper"
                and any(o is None for o in overrides)):
            # Detect only the requests without an override.
            need = [i for i, o in enumerate(overrides) if o is None]
            detected, det_probs = self.detect_language_many(
                [prepared[i] for i in need], return_probs=True)
            req_langs = list(overrides)
            for i, lang, p in zip(need, detected, det_probs):
                req_langs[i] = lang
                req_lang_probs[i] = p
        else:
            req_langs = [o or self.language for o in overrides]

        all_starts: List[List[int]] = []
        win_entries: List[tuple] = []  # (window, prompt ids, temperature)
        for audio, lang, ptext, tover in zip(prepared, req_langs, req_prompts,
                                             req_temps):
            if len(audio) == 0:  # empty, or silent after the VAD
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
                xa = self._encode(mel)  # the decode's and the passes' own
                tokens, lengths, aux = self._decode_with_fallback(
                    b, mel, prompt, temperatures=ladder, xa=xa)
                silent = self._silent_mask(lengths, aux, n_prompt=plen)
                segs = [[] if silent[j]
                        else self._tokens_to_segments(tokens[j], int(lengths[j]),
                                                      n_prompt=plen)
                        for j in range(actual)]
                self._attach_quality(segs, lengths, aux, n_prompt=plen)
                # The full padded batch: only rows with segments are read.
                self._attach_voiceprints(mel, tokens, segs, lengths, xa=xa)
                self._attach_words(mel, tokens, lengths, segs, n_prompt=plen, xa=xa)
                del mel, xa
                for j, g in enumerate(chunk):
                    per_window[g] = segs[j]

        results = []
        off = 0
        for i, starts in enumerate(all_starts):
            k = len(starts)
            results.append(self._finalize_request(
                per_window[off: off + k], starts, vad_maps[i], originals[i],
                req_langs[i], req_lang_probs[i]))
            off += k
        return results

    def _finalize_request(self, per_window: List[List[Segment]],
                          starts: Sequence[int], vmap, original_audio,
                          language: Optional[str],
                          language_probability: Optional[float] = None,
                          ) -> TranscriptionResult:
        """One request's decoded windows -> TranscriptionResult: stitch,
        map VAD-condensed times back to the source, drop silence
        hallucinations, diarize and name speakers, join the text."""
        segments = stitch_segments(per_window, list(starts), self.sample_rate,
                                   self.chunk_samples, self.stride_samples)
        segments = self._remap_segments(segments, vmap)
        segments = self._drop_silence_hallucinations(segments, original_audio)
        self._apply_speaker_passes(segments, original_audio)
        text = " ".join(s.text for s in segments if s.text).strip()
        return TranscriptionResult(text=text, segments=segments, language=language,
                                   language_probability=language_probability)

    def transcribe_batch(self, audios: Sequence[Union[str, Path, np.ndarray]]
                         ) -> List[TranscriptionResult]:
        """Independent clips through shared padded batches
        (:meth:`transcribe_many`)."""
        return self.transcribe_many(audios)
