"""The port's GPT-2 byte-level BPE (``yoho_tpu_torch/text/gpt2_bpe.py``)
against the JAX package's, on the small tokenizer
``tests/test_gpt2_bpe.py`` trains with HF ``tokenizers``: the same ids,
text and token strings from ``vocab.json`` + ``merges.txt``, from
``tokenizer.json`` and from a tiktoken file.
"""

import base64
import json
import random

import pytest

from yoho_tpu.text import gpt2_bpe as jax_bpe
from yoho_tpu_torch.text import gpt2_bpe

SAMPLES = [
    "Hello world",
    "Hello, world! It's a test.",
    "  leading and   internal   spaces  ",
    "tabs\tand\nnewlines\r\n mixed \n\n ok",
    "numbers 123 and 3.14 and 2026-08-17",
    "don't can't we'll I'm you're they've he'd it's",
    "UPPER lower MiXeD",
    "unicode: café naïve über straße",
    "emoji \U0001f680 rocket and \U0001f1e8\U0001f1ff flags",
    "CJK 你好世界 and 日本語",
    "mixed 一二三 numerals Ⅲ ½ ²",
    "punct !!! ??? ... --- ***(nested [brackets] {braces})",
    "quotes \"double\" 'single' “curly”",
    "a", " ", "", "\n", "   ", "'s", " 's", "x's",
    "url https://example.com/path?q=1&r=2#frag",
    "snake_case camelCase kebab-case dot.case",
    "русский текст greek αβγ",
    "arabic مرحبا hebrew שלום",
    "zero​width and combining é",
    "a \x1cb", "x\x1c\x1c ", "\x1d", " \x1c",
]

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "hello world, it's a beautiful day in the neighborhood",
    "numbers like 123 and 456 are common in text corpora",
    "don't stop believing, hold on to that feeling",
    "café culture and über drivers in the city",
    "speech recognition systems transcribe audio to text",
    "the rain in spain falls mainly on the plain",
] * 4


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    tokenizers = pytest.importorskip("tokenizers")
    d = tmp_path_factory.mktemp("gpt2bpe")
    tok = tokenizers.Tokenizer(tokenizers.models.BPE())
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=500, show_progress=False,
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    tok.model.save(str(d))  # vocab.json + merges.txt
    tok.save(str(d / "tokenizer.json"))
    # tiktoken's serialization of the same vocabulary: base64(bytes) rank.
    inv = jax_bpe.unicode_to_bytes()
    vocab = json.loads((d / "vocab.json").read_text())
    lines = [base64.b64encode(bytes(inv[c] for c in t)) + b" " + str(r).encode()
             for t, r in sorted(vocab.items(), key=lambda kv: kv[1])]
    (d / "tt").mkdir()
    (d / "tt" / "multilingual.tiktoken").write_bytes(b"\n".join(lines) + b"\n")
    return d


def _texts():
    rnd = random.Random(0)
    alphabet = "ab c.é你 12Ⅲ'\n\t!½ \U0001f680_-\"Z9\x1c\x1d"
    fuzz = ["".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 40)))
            for _ in range(200)]
    return SAMPLES + CORPUS + fuzz


def test_tables_and_pretokenizer_equal_jax():
    assert gpt2_bpe.bytes_to_unicode() == jax_bpe.bytes_to_unicode()
    assert gpt2_bpe.unicode_to_bytes() == jax_bpe.unicode_to_bytes()
    for s in _texts():
        assert gpt2_bpe.pretokenize(s) == jax_bpe.pretokenize(s), repr(s)


@pytest.mark.parametrize("source", ["vocab_merges", "tokenizer_json", "tiktoken"])
def test_codec_equals_jax(trained_dir, source):
    if source == "vocab_merges":
        ours, theirs = (m.GPT2BPE.from_files(trained_dir / "vocab.json",
                                             trained_dir / "merges.txt")
                        for m in (gpt2_bpe, jax_bpe))
    elif source == "tokenizer_json":
        ours, theirs = (m.GPT2BPE.from_tokenizer_json(trained_dir / "tokenizer.json")
                        for m in (gpt2_bpe, jax_bpe))
    else:
        ours, theirs = (m.TiktokenBPE.from_file(trained_dir / "tt" / "multilingual.tiktoken")
                        for m in (gpt2_bpe, jax_bpe))
    for s in _texts():
        ids = theirs.encode(s)
        assert ours.encode(s) == ids, repr(s)
        assert ours.decode(ids) == theirs.decode(ids), repr(s)
        assert ours.convert_ids_to_tokens(ids) == theirs.convert_ids_to_tokens(ids), repr(s)
    assert ours.decode([0, 10_000, 5]) == theirs.decode([0, 10_000, 5])  # unknown id


def test_load_text_backend(trained_dir, tmp_path):
    backend = gpt2_bpe.load_text_backend(str(trained_dir))
    assert isinstance(backend, gpt2_bpe.GPT2BPE)
    assert backend.encode("hello world") == jax_bpe.load_text_backend(
        str(trained_dir)).encode("hello world")
    tt = gpt2_bpe.load_text_backend(str(trained_dir / "tt"))
    assert isinstance(tt, gpt2_bpe.TiktokenBPE)
    # No tokenizer files, or a hub id: no backend (no transformers, no download).
    assert gpt2_bpe.load_text_backend(str(tmp_path)) is None
    assert gpt2_bpe.load_text_backend("openai/whisper-small") is None
    assert gpt2_bpe.load_text_backend(str(trained_dir / "nope")) is None


def test_tiktoken_pick_follows_the_vocab(trained_dir, tmp_path):
    """An English-only checkpoint (vocab 51864) reads gpt2.tiktoken when
    both tables ship, as the JAX package picks."""
    src = (trained_dir / "tt" / "multilingual.tiktoken").read_bytes()
    (tmp_path / "multilingual.tiktoken").write_bytes(src)
    (tmp_path / "gpt2.tiktoken").write_bytes(src.splitlines()[0] + b"\n")
    for vocab, name in ((51864, "gpt2"), (51865, "multilingual")):
        (tmp_path / "config.json").write_text(json.dumps({"vocab_size": vocab}))
        ours = gpt2_bpe.load_text_backend(str(tmp_path))
        theirs = jax_bpe.load_text_backend(str(tmp_path))
        assert len(ours.ranks) == len(theirs.ranks) == (1 if name == "gpt2" else len(src.splitlines()))


def test_port_table_renders_text(trained_dir):
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    backend = gpt2_bpe.GPT2BPE.from_dir(trained_dir)
    table = WhisperTokenTable(multilingual=True, text_backend=backend)
    ids = backend.encode("hello world")
    rendered = table.decode_text(
        [table.timestamp_begin] + ids + [table.timestamp_begin + 50, table.eot])
    assert rendered == "<|0.00|>hello world<|1.00|>"
    assert table.encode_text("hello world") == ids
