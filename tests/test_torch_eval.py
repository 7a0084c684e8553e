"""The port's WER/CER and English normalizer (``yoho_tpu_torch/eval``)
equal the JAX package's exactly on a table of strings."""

import importlib

import pytest

from yoho_tpu_torch.eval import english_normalizer as en
from yoho_tpu_torch.eval import wer

# ``yoho_tpu.eval`` re-exports the function ``wer`` over its submodule.
jax_wer = importlib.import_module("yoho_tpu.eval.wer")
jax_en = importlib.import_module("yoho_tpu.eval.english_normalizer")

TEXTS = [
    "",
    "Hello, World!",
    "  the   quick brown\tfox  ",
    "I won't go, it's twenty-five past three o'clock.",
    "Mr. Smith paid $3.50 (about 3 dollars) [laughs] um uh",
    "one hundred and twenty three thousand four hundred fifty six",
    "the first, second and twenty-third of May; 1990.",
    "She said “don’t” & he’s gone; 50% of them.",
    "three point one four one five",
    "Hamlet's let's 'cause 'em y'all gonna wanna",
    "café naïve ÜBER straße ﬁ ligature",
    "Dr St Prof Capt were here hmm mm",
    "numbers 123 and 3.14 and 2026-08-17",
    "eleven twelve thirteen nineteen ninety nine",
    "a million two billion three trillion",
]

PAIRS = [
    ("the cat sat on the mat", "the cat sat on mat"),
    ("the cat sat on the mat", "a cat sat on the mat today"),
    ("hello world", "hello world"),
    ("", "something inserted"),
    ("nothing recognised", ""),
    ("Mr. Smith's 25 apples!", "mister smiths twenty five apples"),
    ("I won't go", "i will not go"),
]


def test_normalizers_equal_jax():
    for t in TEXTS + [p for pair in PAIRS for p in pair]:
        assert wer.normalize_for_wer(t) == jax_wer.normalize_for_wer(t), repr(t)
        assert en.normalize_english(t) == jax_en.normalize_english(t), repr(t)


@pytest.mark.parametrize("normalize", [True, False])
def test_wer_and_cer_equal_jax(normalize):
    refs, hyps = [r for r, _ in PAIRS], [h for _, h in PAIRS]
    for fn, jfn in ((wer.wer, jax_wer.wer), (wer.cer, jax_wer.cer)):
        rate, st = fn(refs, hyps, normalize=normalize)
        jrate, jst = jfn(refs, hyps, normalize=normalize)
        assert rate == jrate
        assert vars(st) == vars(jst)
    for r, h in PAIRS:
        assert vars(wer.edit_distance(r.split(), h.split())) == vars(
            jax_wer.edit_distance(r.split(), h.split()))


def test_cp_wer_and_stm_equal_jax():
    stm = (";; comment\n"
           "mtg 1 alice 0.0 2.0 <o,f0,female> hello there bob\n"
           "mtg 1 bob 2.0 4.0 hi alice how are you\n"
           "mtg 1 alice 4.0 5.5 <unk> fine thanks\n"
           "mtg 1 bob 5.5 6.0 ignore_time_segment_in_scoring\n"
           "other 1 carol 0.0 1.0 solo words here\n")
    assert wer.stm_rows(stm) == jax_wer.stm_rows(stm)
    assert wer.parse_stm(stm) == jax_wer.parse_stm(stm)
    ref = wer.parse_stm(stm)["mtg"]
    hyp = {0: "hi alice how are you", 1: "hello there bob unk fine thanks", 2: "extra"}
    rate, st = wer.cp_wer(ref, hyp)
    jrate, jst = jax_wer.cp_wer(ref, hyp)
    assert rate == jrate and vars(st) == vars(jst)
