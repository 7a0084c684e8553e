"""CLI: evaluate transcription quality (WER/CER/exact-match) on a dataset.

The port's counterpart of the JAX package's ``cli/evaluate.py``. Dataset
layout (LibriSpeech-style flat dir): ``<dir>/*.wav`` with sibling
``<stem>.txt`` reference transcripts, OR a ``transcripts/*.srt`` +
``audio/*`` corpus (the training layout). ``--stm FILE`` scores
speaker-attributed transcripts instead: cpWER by diarized speaker and
DER, against a NIST STM reference.

Usage: ``python -m yoho_tpu_torch.cli evaluate <dir> --hf DIR
          [--limit N] [--beams 5] [--json]``
"""

import argparse
import json as jsonlib
import sys
from pathlib import Path


def collect_pairs(root: Path, limit=None):
    """-> [(audio_path, reference_text)]."""
    pairs = []
    if (root / "transcripts").exists():
        from yoho_tpu_torch.text.srt import parse_srt
        from yoho_tpu_torch.train.dataloader import AUDIO_SUFFIXES

        for srt_path in sorted((root / "transcripts").iterdir()):
            stem = srt_path.stem
            for suf in AUDIO_SUFFIXES:
                cand = root / "audio" / (stem + suf)
                if cand.exists():
                    subs = list(parse_srt(srt_path.read_text(encoding="utf-8")))
                    pairs.append((cand, " ".join(s.content for s in subs)))
                    break
    else:
        for wav in sorted(root.glob("*.wav")):
            txt = wav.with_suffix(".txt")
            if txt.exists():
                pairs.append((wav, txt.read_text(encoding="utf-8").strip()))
    return pairs[:limit] if limit else pairs


def _resolve_audio(root: Path, fid: str):
    from yoho_tpu_torch.train.dataloader import AUDIO_SUFFIXES

    for base in (root, root / "audio"):
        for suf in AUDIO_SUFFIXES:
            cand = base / (fid + suf)
            if cand.exists():
                return cand
    return None


def _evaluate_stm(t, args, norm) -> int:
    """Speaker-attributed evaluation (cpWER) against an STM reference:
    transcribe each STM file with diarization on, concatenate hypothesis
    text per diarized speaker, and score with the minimum-permutation
    assignment (``eval.wer.cp_wer``); DER from the same run."""
    from yoho_tpu_torch.eval.diarization import (
        DERBreakdown,
        diarization_error_rate,
        parse_stm_turns,
        segments_to_turns,
    )
    from yoho_tpu_torch.eval.wer import (
        EditStats,
        cp_wer,
        parse_stm,
        stm_rows,
        texts_by_speaker,
    )

    rows = stm_rows(Path(args.stm).read_text(encoding="utf-8"))
    per_file = parse_stm(rows)
    ref_turns = parse_stm_turns(rows)
    root = Path(args.dataset)
    files = []
    for fid in sorted(per_file):
        path = _resolve_audio(root, fid)
        if path is None:
            print(f"warning: no audio for STM file id {fid!r} under {root}",
                  file=sys.stderr)
            continue
        files.append((fid, path))
    files = files[: args.limit] if args.limit else files
    if not files:
        print("no (audio, STM reference) pairs found")
        return 1

    results = t.transcribe_many([str(p) for _fid, p in files])
    total = EditStats(0, 0, 0, 0)
    der_total = DERBreakdown(0.0, 0.0, 0.0, 0.0)
    n_ref_speakers = n_hyp_speakers = 0
    for (fid, _path), result in zip(files, results):
        ref = {k: norm(v) for k, v in per_file[fid].items()}
        hyp = {k: norm(v) for k, v in texts_by_speaker(result.segments).items()}
        n_ref_speakers += len(ref)
        n_hyp_speakers += len(hyp)
        _rate, st = cp_wer(ref, hyp, normalize=False)
        total.substitutions += st.substitutions
        total.insertions += st.insertions
        total.deletions += st.deletions
        total.hits += st.hits
        # The same STM carries utterance times: DER from the same run
        # (NIST 0.25 s collar).
        d = diarization_error_rate(ref_turns[fid], segments_to_turns(result.segments),
                                   collar=0.25)
        der_total.missed += d.missed
        der_total.false_alarm += d.false_alarm
        der_total.confusion += d.confusion
        der_total.total_reference += d.total_reference
    report = {
        "files": len(files),
        "cpwer": round(total.rate, 4),
        "der": round(der_total.der, 4),
        "der_missed_s": round(der_total.missed, 2),
        "der_false_alarm_s": round(der_total.false_alarm, 2),
        "der_confusion_s": round(der_total.confusion, 2),
        "ref_speakers": n_ref_speakers,
        "hyp_speakers": n_hyp_speakers,
        "substitutions": total.substitutions,
        "insertions": total.insertions,
        "deletions": total.deletions,
    }
    if args.json:
        print(jsonlib.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k:14s} {v}")
    return 0


def main(argv=None):
    from yoho_tpu_torch.cli.transcribe import (
        batch_size_arg,
        build_whisper_transcriber,
        build_yoho_transcriber,
        load_voiceprint_encoder,
    )
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(description="WER/CER evaluation")
    parser.add_argument("dataset", type=str)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", type=str)
    src.add_argument("--session", type=str, help="YOHO training session name")
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--language", type=str, default="en")
    parser.add_argument("--beams", type=int, default=0)
    parser.add_argument("--batch", type=batch_size_arg, default=8,
                        help="decode batch size, or 'auto' (device-memory "
                             "capacity model)")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--int8-kv", action="store_true",
                        help="evaluate with int8 KV caches")
    parser.add_argument("--int8-weights", action="store_true",
                        help="evaluate with the weight-only int8 decoder "
                             "(measure the quantization quality delta)")
    parser.add_argument("--int8-encoder", action="store_true",
                        help="evaluate with the W8A8 int8 encoder "
                             "(measure the quantization quality delta)")
    parser.add_argument("--fast-gelu", action="store_true",
                        help="evaluate with the tanh-GELU encoder "
                             "(measure the approximation quality delta)")
    parser.add_argument("--vad", action="store_true",
                        help="collapse silence before decoding (measures "
                             "the quality impact of VAD on this corpus)")
    parser.add_argument("--normalizer", choices=("basic", "english"),
                        default="basic",
                        help="'english' applies whisper-style normalization "
                             "(contractions, spelled numbers -> digits) so "
                             "WER is comparable to published numbers")
    parser.add_argument("--stm", type=str, default=None, metavar="FILE",
                        help="speaker-attributed cpWER (and DER) against a "
                             "NIST STM reference; needs diarization")
    parser.add_argument("--diarize-session", type=str, default=None,
                        metavar="NAME",
                        help="whisper-family diarization (a session's "
                             "stage-3 voiceprint encoder)")
    parser.add_argument("--speaker-threshold", type=float, default=0.75)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.stm and args.hf and not args.diarize_session:
        parser.error("--stm cpWER on the whisper family needs "
                     "--diarize-session (no voiceprints otherwise)")
    device = cli_device(args)

    from yoho_tpu_torch.eval.wer import cer, normalize_for_wer, wer

    if args.hf:
        diarize = (load_voiceprint_encoder(args.diarize_session, args.root, device)
                   if args.diarize_session else None)
        t = build_whisper_transcriber(args.hf, args.beams, args.batch,
                                      None if args.language == "auto" else args.language,
                                      True,
                                      quantized=args.int8_kv,
                                      int8_weights=args.int8_weights,
                                      int8_encoder=args.int8_encoder,
                                      fast_gelu=args.fast_gelu,
                                      vad_filter=args.vad, diarize=diarize,
                                      speaker_threshold=args.speaker_threshold,
                                      device=device)
    else:
        t = build_yoho_transcriber(args.session, args.root, args.beams, args.batch,
                                   int8_weights=args.int8_weights,
                                   vad_filter=args.vad,
                                   speaker_threshold=args.speaker_threshold,
                                   device=device)

    if args.normalizer == "english":
        from yoho_tpu_torch.eval.english_normalizer import normalize_english as norm
    else:
        norm = normalize_for_wer

    if args.stm:
        return _evaluate_stm(t, args, norm)

    pairs = collect_pairs(Path(args.dataset), args.limit)
    if not pairs:
        print("no (audio, transcript) pairs found")
        return 1

    refs, hyps, exact = [], [], 0
    # Pool every utterance's windows into shared decode batches — corpus
    # evaluation is exactly the many-short-files shape transcribe_many
    # exists for (a lone 5 s clip would otherwise pad a whole batch).
    results = t.transcribe_many([str(a) for a, _ref in pairs])
    for (_audio_path, ref), result in zip(pairs, results):
        refs.append(norm(ref))
        hyps.append(norm(result.text))
        exact += refs[-1] == hyps[-1]

    # refs/hyps are already normalized above; don't re-normalize inside
    # (the basic pass would split english-normalized decimals like 3.14).
    wer_rate, wst = wer(refs, hyps, normalize=False)
    cer_rate, _ = cer(refs, hyps, normalize=False)
    report = {
        "utterances": len(pairs),
        "wer": round(wer_rate, 4),
        "cer": round(cer_rate, 4),
        "exact_match": round(exact / len(pairs), 4),
        "substitutions": wst.substitutions,
        "insertions": wst.insertions,
        "deletions": wst.deletions,
    }
    if args.json:
        print(jsonlib.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k:14s} {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
