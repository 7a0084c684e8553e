"""One-call model loading: ``yoho_tpu_torch.load_transcriber``.

The port's counterpart of the JAX package's ``load.py``: the serving
object in one call, the construction the command lines perform
(``yoho_tpu_torch.cli.transcribe``), without argparse:

>>> import yoho_tpu_torch
>>> t = yoho_tpu_torch.load_transcriber(hf="/models/whisper-small", batch=16)
>>> t.transcribe("meeting.wav").text

or, for a trained YOHO session (native voiceprints and diarization):

>>> t = yoho_tpu_torch.load_transcriber(session="main", root="./sessions")

``hf`` is a local checkpoint directory (no hub download). The model runs
on CUDA unless ``device="cpu"`` is passed. ``mesh=`` (``"DxM"`` or a
``parallel.mesh.Mesh``) serves it over a (data, model) mesh of processes,
one per GPU (``torchrun``); ``mesh="1x1"`` runs in one process.
"""

from __future__ import annotations

from typing import Optional


def load_transcriber(
    hf: Optional[str] = None,
    *,
    session: Optional[str] = None,
    root: str = "./sessions",
    batch=8,  # int, or "auto" (device-memory capacity model, infer/capacity.py)
    beams: int = 0,
    language: Optional[str] = "en",  # None = auto-detect
    task: str = "transcribe",
    timestamps: bool = True,
    int8_kv: bool = False,
    int8_weights: bool = False,
    int8_encoder: bool = False,  # W8A8 encoder MLPs
    fast_gelu: bool = False,  # tanh-GELU encoder MLPs
    word_timestamps: bool = False,
    temperature_fallback: bool = False,
    best_of: int = 1,  # sampled candidates per window at temperature>0
    initial_prompt: Optional[str] = None,
    condition_on_previous_text: bool = False,
    vad: bool = False,
    mesh=None,  # "DxM" or a parallel.mesh.Mesh
    diarize_session: Optional[str] = None,
    speakers=None,
    speaker_threshold: float = 0.75,
    draft_hf: Optional[str] = None,
    gamma: int = 4,
    lora: Optional[str] = None,  # adapter dir/file from finetune --lora
    hotwords: Optional[str] = None,  # comma-separated boosted phrases
    hotword_boost: float = 4.0,
    logit_bias=None,  # {token_id: delta} (OpenAI logit_bias semantics)
    repetition_penalty: Optional[float] = None,  # CTRL-style, >1 damps
    no_repeat_ngram: int = 0,  # hard ban on repeating text n-grams
    length_penalty: float = 1.0,  # GNMT beam score normalization
    hallucination_silence_threshold: Optional[float] = None,  # seconds
    device=None,  # None = CUDA (raises without it); "cpu" for the plain path
):
    """Build a ready :class:`yoho_tpu_torch.infer.pipeline.Transcriber`
    from an HF Whisper checkpoint directory (``hf=``) or a trained YOHO
    session (``session=`` + ``root=``). Knobs mirror the
    ``transcribe``/``serve`` flags; see those commands' ``--help``.
    Whisper-only knobs raise on the yoho family instead of being dropped."""
    if (hf is None) == (session is None):
        raise ValueError("pass exactly one of hf= or session=")
    if mesh is not None:
        from yoho_tpu_torch.parallel.mesh import as_mesh

        mesh = as_mesh(mesh, device)
        device = mesh.device
    if language == "auto":  # the CLI sentinel for per-file detection
        language = None
    enrolled = speakers
    if isinstance(speakers, (str, bytes)) or hasattr(speakers, "__fspath__"):
        from yoho_tpu_torch.infer.diarize import load_enrolled

        enrolled = load_enrolled(speakers)
    temps = ((0.0, 0.2, 0.4, 0.6, 0.8, 1.0) if temperature_fallback
             else (0.0,))

    from yoho_tpu_torch.cli.transcribe import (
        build_whisper_transcriber,
        build_yoho_transcriber,
        load_voiceprint_encoder,
    )

    if session is not None:
        for name, val, default in (
            ("task", task, "transcribe"),
            ("language", language, "en"),
            ("timestamps", timestamps, True),
            ("int8_kv", int8_kv, False),
            ("int8_encoder", int8_encoder, False),
            ("fast_gelu", fast_gelu, False),
            ("temperature_fallback", temperature_fallback, False),
            ("best_of", best_of, 1),
            ("initial_prompt", initial_prompt, None),
            ("condition_on_previous_text", condition_on_previous_text, False),
            ("diarize_session", diarize_session, None),
            ("draft_hf", draft_hf, None),
            ("lora", lora, None),
        ):
            if val != default:
                raise ValueError(f"{name}= is a whisper-family option "
                                 "(the yoho family diarizes natively and "
                                 "decodes its own token scheme)")
        return build_yoho_transcriber(
            session, root, beams, batch, int8_weights=int8_weights,
            vad_filter=vad, enrolled_speakers=enrolled,
            speaker_threshold=speaker_threshold,
            word_timestamps=word_timestamps, hotwords=hotwords,
            hotword_boost=hotword_boost, logit_bias=logit_bias,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram, length_penalty=length_penalty,
            hallucination_silence_threshold=hallucination_silence_threshold,
            device=device, mesh=mesh)

    diarize = (load_voiceprint_encoder(diarize_session, root, device)
               if diarize_session else None)
    if enrolled and diarize is None:
        raise ValueError("speakers= on the whisper family needs "
                         "diarize_session= (whisper segments carry no "
                         "voiceprints to match otherwise)")
    return build_whisper_transcriber(
        hf, beams, batch, language, timestamps,
        quantized=int8_kv, int8_weights=int8_weights,
        int8_encoder=int8_encoder, fast_gelu=fast_gelu,
        word_timestamps=word_timestamps, temperatures=temps,
        best_of=best_of, initial_prompt=initial_prompt,
        condition_on_previous_text=condition_on_previous_text,
        task=task, vad_filter=vad, draft_hf=draft_hf,
        speculative_gamma=gamma, lora=lora,
        hotwords=hotwords, hotword_boost=hotword_boost,
        logit_bias=logit_bias, repetition_penalty=repetition_penalty,
        no_repeat_ngram_size=no_repeat_ngram,
        length_penalty=length_penalty,
        hallucination_silence_threshold=hallucination_silence_threshold,
        diarize=diarize, enrolled_speakers=enrolled,
        speaker_threshold=speaker_threshold, device=device, mesh=mesh)
