"""The port's YOHO tokenizer against the JAX package's.

``ByteBPE`` and ``train_bpe`` give the JAX package's merges, ids and model
file (``YOHOBPE v1``) on the trained fixture's tokenizer and on a freshly
trained one; the C++ backend (``native/bpe.cpp``, built with ``g++``)
equals the pure-Python oracle; ``YOHOTokenizer`` gives the same ids for
text with specials, timestamps and voiceprint slots, and decodes them back
the same way.
"""

from pathlib import Path

import pytest

from yoho_tpu.text import bpe as jbpe
from yoho_tpu.text import tokenizer as jtok
from yoho_tpu_torch.native import get_lib
from yoho_tpu_torch.text import bpe as tbpe
from yoho_tpu_torch.text import tokenizer as ttok

MODEL = Path(__file__).parent / "fixtures" / "sessions" / "tiny" / "weights" / "tokenizer.model"
CORPUS = ["the quick brown fox jumps over the lazy dog",
          "hello hello world, the end of the world",
          "café naïve über  tabs\tand\nnewlines", "aaaa aaaa aaaa bbbb"] * 3
TEXTS = ["hello world", "good morning thank you", "unknown wordsss here",
         "<|startoftranscript|><|t-3|> hello world <|t-9|><|voiceprint|><|endoftranscript|>",
         "  spaces\tand\nlines  ", "café über", "", "<|t-63|><|t-0|>x"]


def test_fixture_tokenizer_matches_jax():
    j, t = jbpe.ByteBPE.load(MODEL), tbpe.ByteBPE.load(MODEL)
    assert t.dump() == j.dump() == MODEL.read_text(encoding="utf-8")
    assert (t.merges, t.n_special, t.vocab_size) == (j.merges, j.n_special, j.vocab_size)
    for text in TEXTS:
        assert t.encode_text(text) == j.encode_text(text)
    assert [t.id_to_piece(i) for i in range(t.vocab_size)] == \
        [j.id_to_piece(i) for i in range(j.vocab_size)]


@pytest.mark.parametrize("backend", ["python", "native"])
def test_train_bpe_matches_jax(backend, tmp_path):
    """The same merges and model text from the same corpus (ties by count,
    then left id, then right id; max_token_length honoured)."""
    if backend == "native" and get_lib() is None:
        pytest.skip("no g++ here: the native backend cannot be built")
    want = jtok.train_tokenizer(CORPUS, 300, max_token_length=4, max_audio_len=16,
                                backend=backend)
    got = ttok.train_tokenizer(CORPUS, 300, max_token_length=4, max_audio_len=16,
                               backend=backend)
    assert got.bpe.dump() == want.bpe.dump()
    assert got.bpe.merges == tbpe.train_bpe(
        CORPUS, 300, 4, ttok.yoho_special_tokens(16)).merges
    got.save(tmp_path / "tok.model")
    assert ttok.load_tokenizer(tmp_path / "tok.model").bpe.dump() == want.bpe.dump()
    with pytest.raises(ValueError, match="too small"):
        tbpe.train_bpe(CORPUS, 10, 4, ttok.yoho_special_tokens(16))


def test_native_encoder_equals_python_backend():
    if get_lib() is None:
        pytest.skip("no g++ here: the native backend cannot be built")
    native = ttok.YOHOTokenizer.load(MODEL)
    python = ttok.YOHOTokenizer(tbpe.ByteBPE.load(MODEL), use_native=False)
    assert native._native is not None and python._native is None
    for text in TEXTS + CORPUS:
        assert native.encode(text) == python.encode(text)


def test_yoho_tokenizer_ids_match_jax():
    j, t = jtok.YOHOTokenizer.load(MODEL), ttok.YOHOTokenizer.load(MODEL)
    assert (t.sot_id, t.eot_id, t.voiceprint_id, t.timestamp_base, t.n_timestamps,
            t.vocab_size) == (j.sot_id, j.eot_id, j.voiceprint_id, j.timestamp_base,
                              j.n_timestamps, j.vocab_size)
    assert (t.sot_id, t.eot_id, t.voiceprint_id, t.timestamp_base) == (0, 1, 2, 3)
    for text in TEXTS:
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode(ids) == j.decode(ids)
    assert [t.timestamp_id(f) for f in (0, 5, 63)] == [j.timestamp_id(f) for f in (0, 5, 63)]
    assert [t.is_timestamp(i) for i in range(70)] == [j.is_timestamp(i) for i in range(70)]
    assert ttok.yoho_special_tokens(4) == jtok.yoho_special_tokens(4)
