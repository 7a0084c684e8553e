"""CLI: transcribe audio files with a HuggingFace Whisper checkpoint or a
trained YOHO session.

The port's counterpart of the JAX package's ``cli/transcribe.py``: the
same flags with the same names, defaults and meanings, on the GPU by
default (``--device cpu`` for the plain PyTorch path).

* ``--hf DIR``: a local Whisper checkpoint directory (``nn/convert.py``);
  its text backend comes from the same directory (``text/gpt2_bpe.py``);
  ``--diarize-session`` diarizes with a session's voiceprint encoder;
* ``--session NAME``: a trained YOHO session (``weights.yoho`` or
  ``weights.asr`` with the session tokenizer), with native voiceprints
  and diarization.

``--speakers`` names speakers against an ``enroll`` file; ``--rttm``
writes a diarization RTTM per input (score it with ``score-diarization``).

``--mesh DxM`` serves the model over a (data, model) mesh of processes,
one per GPU: ``torchrun --nproc-per-node N -m yoho_tpu_torch.cli
transcribe --mesh DxM ...`` (``parallel/mesh.py``); ``--mesh 1x1`` runs in
one process without a launcher. Every rank decodes; only rank 0 prints
and writes.

Usage: ``python -m yoho_tpu_torch.cli transcribe file1.wav [file2.wav ...]
          (--hf DIR | --session NAME) [--beams 5] [--batch 8] [--json]``
"""

import argparse
import json as jsonlib
import sys

import torch

from yoho_tpu_torch.parallel.mesh import is_coordinator


def batch_size_arg(value: str):
    """argparse type for ``--batch``: a positive int, or ``auto`` to size
    the batch from the device-memory capacity model (``infer/capacity.py``)."""
    if value == "auto":
        return value
    try:
        batch = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--batch takes a positive integer or 'auto', got {value!r}")
    if batch < 1:
        raise argparse.ArgumentTypeError(
            f"--batch must be >= 1, got {batch}")
    return batch


def load_whisper_model(hf_path: str, device, int8_weights: bool = False,
                       int8_encoder: bool = False, fast_gelu: bool = False,
                       lora=None, dtype=torch.bfloat16):
    """A local HF checkpoint directory -> (cfg, port ``Whisper`` on
    ``device``). A LoRA adapter merges into the float32 weights first, and
    the int8 lanes quantize the float32 weights (as the JAX package
    quantizes its float32 params); then every float leaf is cast to
    ``dtype`` once, by ``load_jax_params``."""
    from yoho_tpu_torch.nn import params as nn_params
    from yoho_tpu_torch.nn.convert import load_hf_whisper
    from yoho_tpu_torch.nn.whisper import Whisper

    cfg, params = load_hf_whisper(hf_path)
    if lora:
        # Merged at load: zero runtime cost, and before int8 quantization
        # so the quantizer sees the adapted weights.
        from yoho_tpu_torch.nn.lora import apply_adapter

        params = apply_adapter(params, lora)
    if int8_weights or int8_encoder:
        from yoho_tpu_torch.nn.quantize import (
            quantize_whisper_decoder,
            quantize_whisper_encoder,
        )

        f32 = nn_params.load_jax_params(
            Whisper(cfg, dtype=torch.float32, device=device), params)
        if int8_weights:
            quantize_whisper_decoder(f32)
        if int8_encoder:
            quantize_whisper_encoder(f32)
        params = nn_params.to_jax_params(f32)
        del f32
    model = Whisper(cfg, dtype=dtype, weights_int8=int8_weights,
                    encoder_int8=int8_encoder, fast_gelu=fast_gelu, device=device)
    nn_params.load_jax_params(model, params)
    return cfg, model


def load_voiceprint_encoder(session: str, root: str, device=None):
    """A session's trained ``VoiceprintEncoder`` (stage 3,
    ``weights.voiceprint``) on ``device``, for whisper-family diarization
    and ``enroll --diarize-session``."""
    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.nn import params as nn_params
    from yoho_tpu_torch.nn.voiceprint import VoiceprintEncoder
    from yoho_tpu_torch.train.checkpoint import load_params

    config = load_session_config(session, root)
    params = load_params(config.weights.voiceprint)
    if params is None:
        raise FileNotFoundError(
            f"No trained voiceprint encoder at {config.weights.voiceprint} "
            "(run stage 3 first)")
    enc = VoiceprintEncoder(
        config.yoho,
        embedding_dim=config.hyperparameters.voiceprint_finetune.embedding_dim,
        device=device)
    return nn_params.load_jax_params(enc, params)


def load_yoho_session(session: str, root: str, device=None,
                      int8_weights: bool = False, dtype=torch.bfloat16):
    """A session's (tokenizer, ``YOHOModel``) on ``device``: the weights of
    ``weights.yoho``, else ``weights.asr``; ``int8_weights`` quantizes the
    float32 decoder (as the JAX package quantizes its float32 params), then
    the float leaves are cast to ``dtype`` once."""
    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.nn import params as nn_params
    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
    from yoho_tpu_torch.train.checkpoint import load_params

    config = load_session_config(session, root)
    tok = YOHOTokenizer.load(config.weights.tokenizer)
    vp_dim = config.hyperparameters.voiceprint_finetune.embedding_dim
    params = None
    for slot in (config.weights.yoho, config.weights.asr):
        params = load_params(slot)
        if params is not None:
            break
    if params is None:
        raise FileNotFoundError(
            f"No trained weights at {config.weights.yoho} or {config.weights.asr}")
    if int8_weights:
        from yoho_tpu_torch.nn.quantize import quantize_yoho_decoder

        f32 = nn_params.load_jax_params(
            YOHOModel(config.yoho, tok.vocab_size, vp_dim, device=device), params)
        params = nn_params.to_jax_params(quantize_yoho_decoder(f32))
        del f32
    model = YOHOModel(config.yoho, tok.vocab_size, vp_dim, dtype=dtype,
                      weights_int8=int8_weights, device=device)
    return tok, nn_params.load_jax_params(model, params)


def build_yoho_transcriber(session: str, root: str, beams: int, batch,
                           int8_weights: bool = False, vad_filter: bool = False,
                           enrolled_speakers=None, speaker_threshold: float = 0.75,
                           word_timestamps: bool = False, hotwords=None,
                           hotword_boost: float = 4.0, logit_bias=None,
                           repetition_penalty=None, no_repeat_ngram_size: int = 0,
                           length_penalty: float = 1.0,
                           hallucination_silence_threshold=None, device=None,
                           mesh=None):
    """The JAX package's ``build_yoho_transcriber`` on the port: bf16
    weights and caches, float cross K/V, on ``device`` (default CUDA;
    raises without it), sharded over ``mesh`` when one is given."""
    from yoho_tpu_torch.core.device import resolve_device
    from yoho_tpu_torch.infer.pipeline import Transcriber

    device = resolve_device(device)
    tok, model = load_yoho_session(session, root, device, int8_weights)
    return Transcriber(model, family="yoho", tokenizer=tok, batch_size=batch,
                       beams=beams, cache_dtype=torch.bfloat16,
                       length_penalty=length_penalty,
                       hallucination_silence_threshold=hallucination_silence_threshold,
                       vad_filter=vad_filter, enrolled_speakers=enrolled_speakers,
                       speaker_threshold=speaker_threshold,
                       word_timestamps=word_timestamps, hotwords=hotwords,
                       hotword_boost=hotword_boost, logit_bias=logit_bias,
                       repetition_penalty=repetition_penalty,
                       no_repeat_ngram_size=no_repeat_ngram_size, device=device,
                       mesh=mesh)


def load_speakers_arg(speakers_path, hf, diarize_session, error):
    """``--speakers`` for the transcribe and serve commands: the enrollment
    file, refusing the whisper-family combination that can never match (no
    voiceprints without a diarize encoder)."""
    if not speakers_path:
        return None
    from yoho_tpu_torch.infer.diarize import load_enrolled

    if hf and not diarize_session:
        error("--speakers on the whisper family needs --diarize-session "
              "(the segments have no voiceprints to match otherwise)")
    return load_enrolled(speakers_path)


def whisper_token_table(cfg, hf_path: str):
    """The token table of a checkpoint (v3 and multilingual from its
    vocabulary size) with the directory's text backend, or none."""
    from yoho_tpu_torch.text.gpt2_bpe import load_text_backend
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    return WhisperTokenTable(multilingual=cfg.n_vocab != 51864,
                             v3=cfg.n_vocab == 51866,
                             text_backend=load_text_backend(hf_path))


def build_whisper_transcriber(hf_path: str, beams: int, batch, language,
                              timestamps: bool, quantized: bool = False,
                              word_timestamps: bool = False,
                              temperatures=(0.0,), best_of: int = 1,
                              int8_weights: bool = False,
                              int8_encoder: bool = False,
                              fast_gelu: bool = False,
                              initial_prompt=None,
                              condition_on_previous_text: bool = False,
                              task: str = "transcribe",
                              vad_filter: bool = False,
                              draft_hf=None, speculative_gamma: int = 4,
                              lora=None, hotwords=None,
                              hotword_boost: float = 4.0, logit_bias=None,
                              repetition_penalty=None,
                              no_repeat_ngram_size: int = 0,
                              length_penalty: float = 1.0,
                              hallucination_silence_threshold=None,
                              diarize=None, enrolled_speakers=None,
                              speaker_threshold: float = 0.75,
                              device=None, mesh=None):
    """The JAX package's ``build_whisper_transcriber`` on the port: bf16
    weights, bf16 caches (int8 K/V with ``quantized``), on ``device``
    (default CUDA; raises without it), sharded over ``mesh`` when one is
    given. ``diarize``: a ``VoiceprintEncoder`` (``load_voiceprint_encoder``)
    for post-pass diarization."""
    from yoho_tpu_torch.core.device import resolve_device
    from yoho_tpu_torch.infer.pipeline import Transcriber

    device = resolve_device(device)
    cfg, model = load_whisper_model(hf_path, device, int8_weights=int8_weights,
                                    int8_encoder=int8_encoder,
                                    fast_gelu=fast_gelu, lora=lora)
    table = whisper_token_table(cfg, hf_path)
    if table.text_backend is None:
        print(f"warning: no tokenizer files found at {hf_path!r} — "
              "transcripts will carry token ids with empty text. Add "
              "vocab.json+merges.txt or tokenizer.json to the checkpoint "
              "dir.", file=sys.stderr)
    draft_model = None
    if draft_hf:
        # Speculative decoding: a small same-vocab draft proposes gamma
        # tokens, the main model verifies them in one step (greedy's
        # tokens; infer/speculative.py).
        from yoho_tpu_torch.nn.convert import hf_config_to_whisper, read_hf_config

        d_cfg = hf_config_to_whisper(read_hf_config(draft_hf))
        if d_cfg.n_vocab != cfg.n_vocab:
            raise ValueError(
                f"draft vocab {d_cfg.n_vocab} != model vocab {cfg.n_vocab} "
                "— speculative verify compares token ids, so the draft "
                "must share the tokenizer (e.g. tiny/base for small..large-v2)")
        # Verify uses the main model, so quantizing the draft (the
        # latency-critical sequential steps) leaves the output unchanged.
        _, draft_model = load_whisper_model(draft_hf, device,
                                            int8_weights=int8_weights)
    return Transcriber(
        model, family="whisper", token_table=table,
        batch_size=batch, beams=beams, language=language,
        length_penalty=length_penalty,
        cache_dtype=torch.bfloat16, timestamps=timestamps,
        quantized_cross_kv=quantized, quantized_cache=quantized,
        word_timestamps=word_timestamps, temperatures=temperatures,
        best_of=best_of, initial_prompt=initial_prompt,
        condition_on_previous_text=condition_on_previous_text,
        task=task, vad_filter=vad_filter,
        hallucination_silence_threshold=hallucination_silence_threshold,
        draft_model=draft_model, speculative_gamma=speculative_gamma,
        hotwords=hotwords, hotword_boost=hotword_boost,
        logit_bias=logit_bias, repetition_penalty=repetition_penalty,
        no_repeat_ngram_size=no_repeat_ngram_size, diarize_encoder=diarize,
        enrolled_speakers=enrolled_speakers, speaker_threshold=speaker_threshold,
        device=device, mesh=mesh,
    )


def _result_payload(f, result) -> dict:
    """The per-file JSON document (--json lines and --output-dir files)."""
    return {
        "file": f,
        "text": result.text,
        "language": result.language,
        "language_probability": result.language_probability,
        "segments": [
            {"start": s.start, "end": s.end, "text": s.text,
             **s.quality_payload(),
             "speaker": s.speaker,
             "speaker_name": s.speaker_name,
             "words": ([{"word": w.word, "start": w.start,
                         "end": w.end, "probability": w.probability}
                        for w in s.words]
                       if s.words else None),
             "voiceprint": (s.voiceprint.tolist()
                            if s.voiceprint is not None else None)}
            for s in result.segments
        ],
    }


def _write_sidecars(f, result, args) -> None:
    """Per-file subtitle and diarization artifacts (--srt/--vtt/--rttm),
    shared by the streaming output path and --output-dir bulk mode."""
    from pathlib import Path

    stem = Path(f).stem
    if args.srt or args.vtt:
        from yoho_tpu_torch.text.srt import (
            compose_srt,
            compose_vtt,
            segments_to_subtitles,
        )

        subs = segments_to_subtitles(result.segments)
        if args.srt:
            out = Path(args.srt) / f"{stem}.srt"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(compose_srt(subs), encoding="utf-8")
        if args.vtt:
            out = Path(args.vtt) / f"{stem}.vtt"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(compose_vtt(subs), encoding="utf-8")
    if args.rttm:
        from yoho_tpu_torch.eval.diarization import compose_rttm, segments_to_turns

        out = Path(args.rttm) / f"{stem}.rttm"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(compose_rttm(segments_to_turns(result.segments), stem),
                       encoding="utf-8")


def _sidecars_from_json(f, doc_path, args) -> None:
    """Rebuild --srt/--vtt/--rttm for a bulk-skipped file from its saved
    JSON (no re-decode): the stored segments carry everything the sidecar
    composers read."""
    if not (args.srt or args.vtt or args.rttm):
        return
    from types import SimpleNamespace

    doc = jsonlib.loads(doc_path.read_text(encoding="utf-8"))
    segments = [
        SimpleNamespace(
            start=s["start"], end=s["end"], text=s["text"],
            speaker=s.get("speaker"), speaker_name=s.get("speaker_name"))
        for s in doc["segments"]
    ]
    _write_sidecars(f, SimpleNamespace(segments=segments), args)


def _bulk_transcribe(t, args) -> int:
    """Resumable corpus transcription (``--output-dir``): one
    ``<stem>.json`` per input, written per decode group — files whose
    output already exists are skipped, so an interrupted overnight job
    re-run picks up where it stopped (at most one group re-decodes).
    """
    from pathlib import Path

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stems = {}
    for f in args.files:
        st = Path(f).stem
        if st in stems and stems[st] != f:
            raise SystemExit(
                f"--output-dir: {stems[st]} and {f} would both write "
                f"{st}.json — rename one or split the job")
        stems[st] = f
    todo, skipped = [], 0
    for f in args.files:
        doc_path = out_dir / (Path(f).stem + ".json")
        if doc_path.exists():
            skipped += 1
            # A resumed run must still produce newly requested sidecars
            # for already-transcribed files — rebuild them from the
            # saved JSON instead of re-decoding.
            if is_coordinator():
                _sidecars_from_json(f, doc_path, args)
        else:
            todo.append(f)
    if skipped and is_coordinator():
        print(f"skipping {skipped} file(s) with existing output in "
              f"{out_dir}", file=sys.stderr)
    # Group size: big enough to keep decode batches full, small enough
    # that a crash loses little work.
    group = max(t.batch_size * 8, 32)  # batch resolved ("auto" -> int)
    done = 0
    for i in range(0, len(todo), group):
        chunk = todo[i : i + group]
        results = t.transcribe_many(chunk)
        if not is_coordinator():  # every rank decodes; rank 0 writes
            continue
        for f, result in zip(chunk, results):
            _write_sidecars(f, result, args)
            payload = jsonlib.dumps(_result_payload(f, result),
                                    ensure_ascii=False)
            if args.json:
                print(payload)
            tmp = out_dir / (Path(f).stem + ".json.tmp")
            tmp.write_text(payload, encoding="utf-8")
            tmp.replace(out_dir / (Path(f).stem + ".json"))
            done += 1
        print(f"{done}/{len(todo)} transcribed -> {out_dir}",
              file=sys.stderr)
    return 0


def main(argv=None):
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(description="Transcribe audio files")
    parser.add_argument("files", nargs="+", type=str)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", type=str, help="HF Whisper checkpoint directory")
    src.add_argument("--session", type=str, help="YOHO training session name")
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--language", type=str, default="en",
                        help='ISO code, or "auto" to detect per file')
    parser.add_argument("--task", type=str, default="transcribe",
                        choices=("transcribe", "translate"),
                        help="translate = X -> English (whisper)")
    parser.add_argument("--beams", type=int, default=0)
    parser.add_argument("--mesh", type=str, default=None, metavar="DxM",
                        help="serving mesh, DATAxMODEL (e.g. 1x4: 4-way "
                             "tensor parallel); run one process per GPU "
                             "under torchrun, or 1x1 in one process")
    parser.add_argument("--batch", type=batch_size_arg, default=8,
                        help="decode batch size, or 'auto' to size it "
                             "from the device-memory capacity model")
    parser.add_argument("--no-timestamps", action="store_true")
    parser.add_argument("--json", action="store_true", help="JSONL output")
    parser.add_argument("--output-dir", type=str, default=None, metavar="DIR",
                        help="resumable bulk mode: write one <stem>.json "
                             "per input into DIR, skipping inputs whose "
                             "output already exists (re-run an interrupted "
                             "corpus job and it picks up where it stopped)")
    parser.add_argument("--int8-kv", action="store_true",
                        help="int8 KV caches (argmax-identical in tests)")
    parser.add_argument("--int8-weights", action="store_true",
                        help="weight-only int8 decoder (near-lossless, not "
                             "bit-exact)")
    parser.add_argument("--int8-encoder", action="store_true",
                        help="W8A8 int8 encoder MLPs (the w8a8 kernel; "
                             "near-lossless, not bit-exact; implies the "
                             "tanh GELU)")
    parser.add_argument("--fast-gelu", action="store_true",
                        help="tanh-GELU in encoder MLPs (near-lossless "
                             "approximation of the exact erf GELU)")
    parser.add_argument("--word-timestamps", action="store_true")
    parser.add_argument("--temperature-fallback", action="store_true",
                        help="retry low-quality windows at higher temperatures")
    parser.add_argument("--best-of", type=int, default=1,
                        help="sampled candidates per window at fallback "
                             "temperatures > 0; the highest-mean-logprob "
                             "candidate wins (OpenAI whisper's best_of)")
    parser.add_argument("--initial-prompt", type=str, default=None,
                        help="context text for <|startofprev|> conditioning "
                             "(spelling/vocabulary steering; whisper only)")
    parser.add_argument("--condition-on-previous-text", action="store_true",
                        help="sequential long-form decoding conditioned on "
                             "prior windows (quality over throughput)")
    parser.add_argument("--vad", action="store_true",
                        help="voice-activity filter: collapse silence on the "
                             "host so the device only decodes speech; "
                             "timestamps stay on the source timeline")
    parser.add_argument("--srt", type=str, default=None, metavar="DIR",
                        help="also write <stem>.srt per input into DIR")
    parser.add_argument("--vtt", type=str, default=None, metavar="DIR",
                        help="also write <stem>.vtt per input into DIR")
    parser.add_argument("--rttm", type=str, default=None, metavar="DIR",
                        help="also write <stem>.rttm diarization per input "
                             "into DIR (score with score-diarization)")
    parser.add_argument("--diarize-session", type=str, default=None,
                        metavar="NAME",
                        help="whisper-family speaker diarization: embed "
                             "segment spans with this session's trained "
                             "voiceprint encoder (stage 3) and cluster")
    parser.add_argument("--speaker-threshold", type=float, default=0.75,
                        help="cosine-similarity floor for diarization "
                             "cluster merging AND enrolled-name matching "
                             "(higher = more distinct speakers, fewer "
                             "matches)")
    parser.add_argument("--speakers", type=str, default=None, metavar="NPZ",
                        help="speaker recognition: match diarized clusters "
                             "against this 'enroll' file and name segments "
                             "(needs voiceprints: a yoho session, or "
                             "--diarize-session with the same encoder used "
                             "for enrollment)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the "
                             "transcription into DIR/trace.json")
    parser.add_argument("--draft-hf", type=str, default=None, metavar="PATH",
                        help="speculative decoding: a small same-vocab HF "
                             "Whisper checkpoint drafts tokens the main "
                             "model verifies (greedy-identical; a "
                             "single-stream latency feature — use --batch 1)")
    parser.add_argument("--lora", type=str, default=None, metavar="PATH",
                        help="merge a LoRA adapter (finetune --lora output "
                             "dir or lora_adapter.msgpack) into the --hf "
                             "base weights at load")
    parser.add_argument("--hotwords", type=str, default=None,
                        metavar="PHRASES",
                        help="comma-separated phrases whose tokens get a "
                             "logit boost (domain names, jargon)")
    parser.add_argument("--hallucination-silence-threshold", type=float,
                        default=None, metavar="SECONDS",
                        help="drop segments whose span is speech-free (by "
                             "the energy VAD) inside a silence run at "
                             "least this long — faster-whisper's "
                             "hallucination filter as a post-pass")
    parser.add_argument("--length-penalty", type=float, default=1.0,
                        help="GNMT length normalization exponent for beam "
                             "scores (--beams); 1.0 = whisper default")
    parser.add_argument("--repetition-penalty", type=float, default=None,
                        help="CTRL-style penalty (>1 damps) on re-emitting "
                             "already-generated text tokens, applied in "
                             "every decode step")
    parser.add_argument("--no-repeat-ngram", type=int, default=0,
                        metavar="N",
                        help="hard-ban completing any text n-gram already "
                             "generated in the window (hallucination-loop "
                             "control; 0 = off)")
    parser.add_argument("--hotword-boost", type=float, default=4.0,
                        help="logit delta added to each hotword token "
                             "(default 4.0; too high forces false "
                             "positives)")
    parser.add_argument("--gamma", type=int, default=4,
                        help="draft tokens proposed per verify step "
                             "(--draft-hf)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = cli_device(args)
    mesh = None
    if args.mesh:
        from yoho_tpu_torch.parallel.mesh import parse_mesh

        mesh = parse_mesh(args.mesh, args.device)
        device = mesh.device
    if args.draft_hf and args.beams:
        parser.error("--draft-hf is greedy-only (speculative verify); "
                     "drop --beams")
    if args.draft_hf and args.gamma < 1:
        parser.error("--gamma must be >= 1")
    if args.best_of < 1:
        parser.error("--best-of must be >= 1")

    if args.draft_hf and not args.hf:
        parser.error("--draft-hf requires --hf (whisper family)")
    if args.best_of > 1 and not args.hf:
        parser.error("--best-of is a whisper-family option (--hf); the "
                     "temperature quality ladder does not run on --session "
                     "models")

    temps = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0) if args.temperature_fallback else (0.0,)
    language = None if args.language == "auto" else args.language
    enrolled = load_speakers_arg(args.speakers, args.hf, args.diarize_session,
                                 parser.error)
    if args.session:
        for flag, on, why in (
                ("--lora", args.lora, "adapters are a whisper fine-tune "
                 "artifact; yoho sessions load their own trained weights"),
                ("--int8-encoder", args.int8_encoder,
                 "W8A8 encoder serving is whisper-family only"),
                ("--fast-gelu", args.fast_gelu,
                 "the yoho family uses SwiGLU, not GELU"),
                ("--diarize-session", args.diarize_session,
                 "the yoho family emits voiceprints in the decode forward "
                 "pass and diarizes natively")):
            if on:
                print(f"warning: {flag} is ignored with --session ({why})",
                      file=sys.stderr)
        t = build_yoho_transcriber(
            args.session, args.root, args.beams, args.batch,
            int8_weights=args.int8_weights, vad_filter=args.vad,
            enrolled_speakers=enrolled, speaker_threshold=args.speaker_threshold,
            word_timestamps=args.word_timestamps, hotwords=args.hotwords,
            hotword_boost=args.hotword_boost,
            repetition_penalty=args.repetition_penalty,
            no_repeat_ngram_size=args.no_repeat_ngram,
            length_penalty=args.length_penalty,
            hallucination_silence_threshold=args.hallucination_silence_threshold,
            device=device, mesh=mesh)
        return _run(t, args)
    diarize = (load_voiceprint_encoder(args.diarize_session, args.root, device)
               if args.diarize_session else None)
    t = build_whisper_transcriber(args.hf, args.beams, args.batch,
                                  language, not args.no_timestamps,
                                  quantized=args.int8_kv,
                                  word_timestamps=args.word_timestamps,
                                  temperatures=temps,
                                  best_of=args.best_of,
                                  int8_weights=args.int8_weights,
                                  int8_encoder=args.int8_encoder,
                                  fast_gelu=args.fast_gelu,
                                  initial_prompt=args.initial_prompt,
                                  condition_on_previous_text=(
                                      args.condition_on_previous_text),
                                  task=args.task, vad_filter=args.vad,
                                  draft_hf=args.draft_hf,
                                  speculative_gamma=args.gamma,
                                  lora=args.lora, hotwords=args.hotwords,
                                  hotword_boost=args.hotword_boost,
                                  repetition_penalty=args.repetition_penalty,
                                  no_repeat_ngram_size=args.no_repeat_ngram,
                                  length_penalty=args.length_penalty,
                                  hallucination_silence_threshold=(
                                      args.hallucination_silence_threshold),
                                  diarize=diarize, enrolled_speakers=enrolled,
                                  speaker_threshold=args.speaker_threshold,
                                  device=device, mesh=mesh)
    return _run(t, args)


def _run(t, args) -> int:
    """Transcribe ``args.files`` with ``t`` and print or write the results
    (rank 0's job under a mesh; every rank transcribes)."""
    from yoho_tpu_torch.utils.profiling import trace

    if args.output_dir:
        with trace(args.profile):
            return _bulk_transcribe(t, args)

    with trace(args.profile):
        # Multiple files pool their 30 s windows into SHARED decode
        # batches (transcribe_many) — a lone short file no longer pads a
        # whole batch while the next file waits.
        if len(args.files) > 1:
            results = t.transcribe_many(args.files)
        else:
            results = [t.transcribe(args.files[0])]
        if not is_coordinator():
            return 0
        for f, result in zip(args.files, results):
            _write_sidecars(f, result, args)
            if args.json:
                print(jsonlib.dumps(_result_payload(f, result),
                                    ensure_ascii=False))
            else:
                print(f"== {f}")
                for s in result.segments:
                    spk = (f" [{s.speaker_name}]" if s.speaker_name
                           else f" [spk{s.speaker}]"
                           if s.speaker is not None else "")
                    print(f"[{s.start:7.2f} - {s.end:7.2f}]{spk} {s.text}")
                    if s.words:
                        print("    " + " ".join(f"{w.word}({w.start:.2f})"
                                                for w in s.words))
                if not result.segments:
                    print(result.text or "(no speech detected)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
