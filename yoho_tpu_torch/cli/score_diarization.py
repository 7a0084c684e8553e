"""``yoho-torch score-diarization``: score diarization hypotheses against
RTTM references (DER), the JAX package's ``cli/score_diarization.py``.

``yoho-torch transcribe --session NAME --rttm DIR`` writes one hypothesis
RTTM per input file; this tool scores it against a NIST RTTM reference
with the standard collar.

Usage: ``python -m yoho_tpu_torch.cli score-diarization ref.rttm hyp.rttm
          [--collar 0.25] [--json]``

Both arguments may be files or directories of ``*.rttm`` (recordings are
matched by RTTM file id). Prints per-recording DER and the aggregate
(error seconds summed before dividing — the corpus-level DER).
"""

from __future__ import annotations

import argparse
import json as jsonlib
from pathlib import Path

from yoho_tpu_torch.eval.diarization import diarization_error_rate, parse_rttm


def _load(path: Path):
    out = {}
    files = sorted(path.glob("*.rttm")) if path.is_dir() else [path]
    for f in files:
        for file_id, turns in parse_rttm(f.read_text(encoding="utf-8")).items():
            out.setdefault(file_id, []).extend(turns)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="yoho-torch score-diarization",
                                     description="DER scorer (RTTM)")
    parser.add_argument("reference", type=str)
    parser.add_argument("hypothesis", type=str)
    parser.add_argument("--collar", type=float, default=0.25)
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    ref = _load(Path(args.reference))
    hyp = _load(Path(args.hypothesis))
    if not ref:
        print("no reference RTTM turns found")
        return 1
    missing = sorted(set(ref) - set(hyp))
    if missing:
        print(f"warning: no hypothesis for {len(missing)} recording(s): "
              + ", ".join(missing[:5]))

    per_file = {}
    tot_miss = tot_fa = tot_conf = tot_ref = 0.0
    for file_id in sorted(ref):
        out = diarization_error_rate(ref[file_id], hyp.get(file_id, []),
                                     collar=args.collar)
        per_file[file_id] = round(out.der, 4)
        tot_miss += out.missed
        tot_fa += out.false_alarm
        tot_conf += out.confusion
        tot_ref += out.total_reference
    overall = ((tot_miss + tot_fa + tot_conf) / tot_ref if tot_ref
               else (0.0 if tot_fa == 0 else float("inf")))

    report = {
        "der": round(overall, 4),
        "missed_s": round(tot_miss, 2),
        "false_alarm_s": round(tot_fa, 2),
        "confusion_s": round(tot_conf, 2),
        "reference_s": round(tot_ref, 2),
        "collar": args.collar,
        "recordings": per_file,
    }
    if args.json:
        print(jsonlib.dumps(report))
    else:
        for file_id, der in per_file.items():
            print(f"{file_id:30s} DER {der:.4f}")
        print(f"{'OVERALL':30s} DER {report['der']:.4f} "
              f"(miss {report['missed_s']}s, fa {report['false_alarm_s']}s, "
              f"conf {report['confusion_s']}s / {report['reference_s']}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
