"""CLI: enroll speaker voiceprints for recognition (``yoho-torch enroll``).

The port's counterpart of the JAX package's ``cli/enroll.py``:

1. ``yoho-torch enroll --out speakers.npz alice=a1.wav,a2.wav bob=b.wav``
   embeds each speaker's clips and stores one averaged, L2-normalized
   voiceprint per name (npz);
2. ``yoho-torch transcribe --speakers speakers.npz ...`` / ``serve
   --speakers ...`` match diarized clusters against the enrolled set and
   attach ``speaker_name`` to segments.

Embeddings must come from the embedder used at transcription time:

* ``--diarize-session NAME``: a trained stage-3 ``VoiceprintEncoder``
  (pairs with whisper-family ``--diarize-session`` transcription);
* ``--session NAME``: a trained YOHO session; clips are transcribed and the
  decoder's native per-utterance voiceprints are averaged (pairs with
  YOHO-family transcription).

Runs on the GPU by default (``--device cpu`` for the plain PyTorch path).
"""

import argparse
import sys


def _parse_pairs(pairs):
    """``name=path[,path...]`` positionals -> {name: [paths]}."""
    out = {}
    for pair in pairs:
        name, sep, paths = pair.partition("=")
        name = name.strip()
        if not sep or not name or not paths:
            raise SystemExit(
                f"enroll: bad speaker spec {pair!r} — expected "
                "name=clip.wav[,clip2.wav...]")
        if name in out:
            raise SystemExit(f"enroll: duplicate speaker {name!r}")
        clips = [p for p in paths.split(",") if p]
        if not clips:
            raise SystemExit(
                f"enroll: no clips for {name!r} — expected "
                "name=clip.wav[,clip2.wav...]")
        out[name] = clips
    return out


def _average(embs):
    import numpy as np

    mean = np.mean(np.stack([np.asarray(e, np.float64) for e in embs]),
                   axis=0)
    return (mean / max(np.linalg.norm(mean), 1e-9)).astype(np.float32)


def _enroll_with_encoder(speakers, session, root, device):
    """Embed clips with a trained VoiceprintEncoder (whisper pairing)."""
    from yoho_tpu_torch.audio.io import load_audio_f32
    from yoho_tpu_torch.cli.transcribe import load_voiceprint_encoder
    from yoho_tpu_torch.infer.diarize import embed_clip

    encoder = load_voiceprint_encoder(session, root, device)
    sr = encoder.cfg.sample_rate
    return {name: _average([embed_clip(load_audio_f32(p, sr), encoder)
                            for p in paths])
            for name, paths in speakers.items()}


def _enroll_with_yoho(speakers, session, root, device):
    """Transcribe clips with a yoho session and average the decoder's
    native per-utterance voiceprints (the same embeddings transcription
    attaches to segments)."""
    from yoho_tpu_torch.cli.transcribe import build_yoho_transcriber

    t = build_yoho_transcriber(session, root, beams=0, batch=4, device=device)
    enrolled = {}
    for name, paths in speakers.items():
        embs = []
        for result in t.transcribe_many(paths):
            # Text-bearing segments only: empty (timestamp-only) decode
            # artifacts carry voiceprints of silence, not of the speaker.
            embs.extend(s.voiceprint for s in result.segments
                        if s.voiceprint is not None and s.text)
        if not embs:
            raise SystemExit(
                f"enroll: no voiceprints decoded for {name!r} — the "
                "clips transcribed to no utterances (silence?)")
        enrolled[name] = _average(embs)
    return enrolled


def main(argv=None):
    from yoho_tpu_torch.utils.platform import add_device_arg, cli_device

    parser = argparse.ArgumentParser(
        description="Enroll speaker voiceprints for recognition "
                    "(--speakers in transcribe/serve)")
    parser.add_argument("speakers", nargs="*", type=str,
                        metavar="name=clip.wav[,clip2.wav...]",
                        help="speaker clips; several clips average into "
                             "one voiceprint per name")
    parser.add_argument("--out", type=str, default=None,
                        help="output .npz enrollment file")
    parser.add_argument("--update", action="store_true",
                        help="merge into an existing --out file "
                             "(new names win)")
    parser.add_argument("--list", type=str, default=None, metavar="NPZ",
                        help="print an enrollment file's speakers and exit")
    src = parser.add_mutually_exclusive_group()
    src.add_argument("--session", type=str, default=None,
                     help="yoho session: embed via the decoder's native "
                          "voiceprints (pair with yoho transcription)")
    src.add_argument("--diarize-session", type=str, default=None,
                     help="session with a trained stage-3 voiceprint "
                          "encoder (pair with whisper --diarize-session)")
    parser.add_argument("--root", type=str, default="./sessions")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    if args.list:
        from yoho_tpu_torch.infer.diarize import load_enrolled

        for name, emb in sorted(load_enrolled(args.list).items()):
            print(f"{name}  dim={emb.shape[-1]}")
        return 0

    if not args.speakers:
        parser.error("no speakers given (name=clip.wav ...)")
    if not args.out:
        parser.error("--out is required")
    if not (args.session or args.diarize_session):
        parser.error("pick an embedder: --session (yoho) or "
                     "--diarize-session (voiceprint encoder)")

    speakers = _parse_pairs(args.speakers)
    device = cli_device(args)
    if args.diarize_session:
        enrolled = _enroll_with_encoder(speakers, args.diarize_session,
                                        args.root, device)
    else:
        enrolled = _enroll_with_yoho(speakers, args.session, args.root, device)

    from yoho_tpu_torch.infer.diarize import load_enrolled, save_enrolled

    if args.update:
        try:
            merged = load_enrolled(args.out)
        except FileNotFoundError:
            merged = {}
        merged.update(enrolled)
        enrolled = merged
    save_enrolled(args.out, enrolled)
    print(f"enrolled {len(enrolled)} speaker(s) -> {args.out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
