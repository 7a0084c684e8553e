"""The port's diarization scoring and session commands against the JAX
package's.

``eval/diarization.py`` is a numpy module in both packages: every
function runs on the same tables in both and must give the same values
(DER breakdowns and EER to 1e-12, turns, RTTM text and verification
trials equal). The commands ``score-diarization``, ``summary`` and
``doctor --session`` run on the trained ``tests/fixtures/sessions/tiny``
fixture and print what the JAX command prints; ``transcribe --rttm`` and
``evaluate --stm`` are held to JAX's in ``tests/test_torch_yoho_pipeline.py``
(on its JAX transcriber of the fixture).
"""

import contextlib
import io
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from yoho_tpu.eval import diarization as jd
from yoho_tpu_torch.eval import diarization as td

ROOT = Path(__file__).parent / "fixtures" / "sessions"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _turns(mod, rows):
    return [mod.SpeakerTurn(*r) for r in rows]


# ------------------------------------------------------------------ tables

DER_CASES = {
    "perfect": ([(0, 5, "A"), (5, 10, "B")], [(0, 5, 1), (5, 10, 2)], 0.0),
    "missed": ([(0, 10, "A")], [(4, 10, "x")], 0.0),
    "false-alarm": ([(0, 10, "A")], [(0, 12, "x")], 0.0),
    "confusion": ([(0, 6, "A"), (6, 10, "B")], [(0, 10, "x")], 0.0),
    "overlap": ([(0, 10, "A"), (5, 10, "B")], [(0, 10, "x"), (6, 9, "y")], 0.0),
    "collar": ([(0, 5, "A"), (5, 10, "B")], [(0, 5.2, "x"), (5.2, 10, "y")], 0.25),
    "empty-ref": ([], [(0, 5, "x")], 0.0),
    "three-speakers": ([(0, 3, "A"), (3, 7, "B"), (7, 9, "C"), (8, 12, "A")],
                       [(0.5, 3.5, "p"), (3.5, 8, "q"), (8, 12, "p")], 0.1),
}


@pytest.mark.parametrize("case", sorted(DER_CASES))
def test_der_matches_jax(case):
    ref, hyp, collar = DER_CASES[case]
    want = jd.diarization_error_rate(_turns(jd, ref), _turns(jd, hyp), collar=collar)
    got = td.diarization_error_rate(_turns(td, ref), _turns(td, hyp), collar=collar)
    for f in ("missed", "false_alarm", "confusion", "total_reference", "der"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), abs=1e-12), f


def test_rttm_and_stm_parsers_match_jax():
    rows = [(0.0, 12.5, "alice"), (12.5, 30.0, "bob"), (28.0, 35.0, "alice")]
    text = td.compose_rttm(_turns(td, rows), "meeting1")
    assert text == jd.compose_rttm(_turns(jd, rows), "meeting1")
    data = text + """;; a comment
SPEAKER fileB 1 1.00 2.00 <NA> <NA> spk9 <NA>
SPKR-INFO fileA 1 <NA> <NA> <NA> unknown spk1 <NA>
"""
    got, want = td.parse_rttm(data), jd.parse_rttm(data)
    assert {k: [(t.start, t.end, t.speaker) for t in v] for k, v in got.items()} == \
        {k: [(t.start, t.end, t.speaker) for t in v] for k, v in want.items()}
    for mod in (td, jd):
        with pytest.raises(ValueError):
            mod.parse_rttm("SPEAKER f 1 0.0 1.0 <NA>")
    stm = ("clip0 1 alice 0.0 1.0 hello world\nclip0 1 bob 1.0 2.5 <o,f0,male> hi\n"
           ";; comment\nclip1 A carol 3.0 4.0 yes\n")
    got, want = td.parse_stm_turns(stm), jd.parse_stm_turns(stm)
    assert {k: [(t.start, t.end, t.speaker) for t in v] for k, v in got.items()} == \
        {k: [(t.start, t.end, t.speaker) for t in v] for k, v in want.items()}


def test_segments_to_turns_matches_jax():
    @dataclass
    class Seg:
        start: float
        end: float
        speaker: object = None
        speaker_name: object = None

    segs = [Seg(0, 1, 2), Seg(1, 2), Seg(2, 3.5, 1, "alice")]
    assert [(t.start, t.end, t.speaker) for t in td.segments_to_turns(segs)] == \
        [(t.start, t.end, t.speaker) for t in jd.segments_to_turns(segs)]


def test_cosine_eer_and_verification_pairs_match_jax():
    g = np.random.default_rng(0)
    a, b = g.standard_normal((50, 8)), g.standard_normal((50, 8))
    np.testing.assert_allclose(td.cosine_scores(a, b), jd.cosine_scores(a, b), atol=1e-12)
    for scores, labels in ((g.standard_normal(400), g.integers(0, 2, 400)),
                           (np.asarray([0.6, 0.4, 0.5, 0.3]), np.asarray([1, 1, 0, 0])),
                           (np.asarray([0.9, 0.8, 0.7, 0.2, 0.1, 0.0]),
                            np.asarray([1, 1, 1, 0, 0, 0]))):
        got, want = td.equal_error_rate(scores, labels), jd.equal_error_rate(scores, labels)
        np.testing.assert_allclose(got, want, atol=1e-12)
    with pytest.raises(ValueError):
        td.equal_error_rate(np.ones(3), np.ones(3))
    emb = g.standard_normal((40, 16))
    ids = [i % 4 for i in range(40)]
    for max_pairs in (10000, 60):  # every positive pair; budget sampling
        got = td.verification_pairs(emb, ids, np.random.default_rng(3), max_pairs)
        want = jd.verification_pairs(emb, ids, np.random.default_rng(3), max_pairs)
        np.testing.assert_allclose(got[0], want[0], atol=1e-12)
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="one speaker"):
        td.verification_pairs(emb, [0] * 40)


# ---------------------------------------------------------------- commands

def _run(main, argv, rc=0) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == rc
    return buf.getvalue()


def test_score_diarization_matches_jax(tmp_path):
    from yoho_tpu.cli.score_diarization import main as jax_main
    from yoho_tpu_torch.cli.__main__ import main as port

    ref, hyp = tmp_path / "ref", tmp_path / "hyp"
    ref.mkdir()
    hyp.mkdir()
    for name, r, h in (("rec1", [(0, 10, "a"), (10, 14, "b")], [(0, 9, "z"), (9, 14, "y")]),
                       ("rec2", [(0, 10, "x")], None)):
        (ref / f"{name}.rttm").write_text(td.compose_rttm(_turns(td, r), name))
        if h:
            (hyp / f"{name}.rttm").write_text(td.compose_rttm(_turns(td, h), name))
    for args in ([str(ref), str(hyp), "--json"], [str(ref), str(hyp), "--collar", "0"],
                 [str(ref / "rec1.rttm"), str(hyp / "rec1.rttm"), "--json"]):
        assert _run(port, ["score-diarization", *args]) == _run(jax_main, args)
    (tmp_path / "empty.rttm").write_text(";; nothing\n")
    empty = [str(tmp_path / "empty.rttm")] * 2
    assert _run(port, ["score-diarization", *empty], rc=1) == _run(jax_main, empty, rc=1)


def test_summary_matches_jax():
    from yoho_tpu.cli.summary import main as jax_main
    from yoho_tpu_torch.cli.__main__ import main as port

    for args in (["--session", "tiny", "--root", str(ROOT)], ["--whisper", "tiny"]):
        assert _run(port, ["summary", *args]) == _run(jax_main, args)


def test_doctor_session_matches_jax(tmp_path):
    from yoho_tpu.cli.doctor import _check_session as jax_check
    from yoho_tpu_torch.cli.doctor import _check_session, main

    assert _check_session("tiny", str(ROOT)) == jax_check("tiny", str(ROOT))
    assert _check_session("nope", str(tmp_path)) == jax_check("nope", str(tmp_path))
    rows = [json.loads(x) for x in _run(main, ["--json", "--no-devices", "--session", "tiny",
                                               "--root", str(ROOT)]).splitlines()]
    status = {r["check"]: r["status"] for r in rows}
    assert status["session"] == status["session:weights.asr"] == "ok"
    assert status["session:weights.voiceprint"] == "warn"
