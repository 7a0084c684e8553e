"""The port's continuous batching against the JAX package's, in float32.

Per-row decode positions through every layer that takes ``pos``, each held
to the JAX package on the same numpy inputs:

* ``KVCache.update`` / ``QuantizedKVCache.update`` with a (B,) ``pos``
  (S = 1 and S = 3, one row written past the horizon, which is dropped)
  are bit-exact with JAX's scatter;
* the plain decode attention with a per-row causal ``pos`` matches JAX's
  ``_attend_quantized`` under ``decode_mask`` (the tolerance of
  ``tests/test_torch_kv_cache.py``: rtol = atol = 1e-5);
* the timestamp rules and the repetition rules with a per-row ``pos`` give
  JAX's logits exactly;
* the slot engine: each window's tokens and length equal JAX's
  ``SlotEngine`` and the port's ``greedy_decode`` under a staggered
  admission schedule with refills (two slots, one admission per chunk),
  with timestamps on and off, float and int8 caches, and on the trained
  ``whisper_tiny`` fixture; ``sum_logprob`` and ``no_speech_prob`` within
  1e-4 (``tests/test_continuous.py``'s bound on the quality signals);
* the speculative slots (a draft of other weights, gamma 1 and 3) equal
  greedy and JAX's speculative slots;
* the ``ContinuousBatcher`` equals ``transcribe`` with the fallback
  ladder and word timestamps, frees the slots of a cancelled request,
  and the engine keeps JAX's refusals.
"""

import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.logit_rules import make_repetition_rules as jax_rep_rules
from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
from yoho_tpu.infer.slot_engine import SlotEngine as JaxSlotEngine
from yoho_tpu.infer.slot_engine import _Window as JaxWindow
from yoho_tpu.infer.whisper_rules import make_timestamp_rules as jax_ts_rules
from yoho_tpu.nn import kv_cache as jkv
from yoho_tpu.nn.layers import decode_mask
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.batching import RequestCancelled
from yoho_tpu_torch.infer.continuous import ContinuousBatcher
from yoho_tpu_torch.infer.logit_rules import make_repetition_rules
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.infer.slot_engine import ContinuousWhisperDecoder, SlotEngine, _Window
from yoho_tpu_torch.infer.whisper_rules import make_timestamp_rules
from yoho_tpu_torch.nn import kv_cache as tkv
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

FIXTURES = Path(__file__).parent / "fixtures"
CFG = dict(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=4, n_audio_layer=1,
           n_vocab=51865, n_text_ctx=24, n_text_state=32, n_text_head=4, n_text_layer=1,
           chunk_seconds=0.32)
DRAFT = dict(CFG, n_text_head=2)
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU: one intra-op thread keeps the eager
    decode loops from oversubscribing it (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(cfg, seed):
    """Flax parameters of a config (``tests/test_continuous.py``'s init) and
    the port model carrying them, in float32."""
    jm = JaxWhisper(JaxConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 8), jnp.float32),
                                    jnp.zeros((1, 4), jnp.int32))["params"])
    return jm, params, load_jax_params(Whisper(WhisperConfig(**cfg), device="cpu"), params)


@pytest.fixture(scope="module")
def setup():
    """The config and five clips of ``tests/test_continuous.py`` in both
    packages, and its draft (other weights, 2 text heads)."""
    jm, params, model = _init(CFG, 0)
    djm, dparams, draft = _init(DRAFT, 7)
    g = np.random.default_rng(0)
    n = WhisperConfig(**CFG).n_samples
    audios = [(0.1 * g.standard_normal(n)).astype(np.float32) for _ in range(5)]
    return SimpleNamespace(jm=jm, variables={"params": params}, model=model, djm=djm,
                           d_variables={"params": dparams}, draft=draft, audios=audios,
                           jtable=JaxTable(multilingual=True),
                           table=WhisperTokenTable(multilingual=True))


class _Words:
    """The fixture's word vocabulary as a text backend: one token a word,
    its piece carrying the leading-space marker (word timestamps)."""

    def __init__(self, word_ids):
        self.word_ids = {k: int(v) for k, v in word_ids.items()}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)

    def convert_ids_to_tokens(self, ids):
        return ["\u0120" + self.id_words.get(int(i), "?") for i in ids]


@pytest.fixture(scope="module")
def tiny():
    """The trained ``whisper_tiny`` fixture in both packages (float32) and
    three tone clips, the ``tests/test_torch_pipeline.py`` pattern."""
    fx = FIXTURES / "whisper_tiny"
    cfg = json.loads((fx / "config.json").read_text())
    jcfg = JaxConfig(**cfg)
    jm = JaxWhisper(jcfg)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, jcfg.n_frames, jcfg.n_mels), jnp.float32),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = jax.device_get(load_params(fx / "params.msgpack", template))
    golden = json.loads((fx / "golden.json").read_text())
    n = WhisperConfig(**cfg).n_samples
    clips = []
    for hz in golden["tones"]:
        audio = (np.random.default_rng(9).standard_normal(n) * 0.002).astype(np.float32)
        tone = 0.4 * np.sin(2 * np.pi * hz * np.arange(4000) / 16000)
        audio[800:4800] += tone.astype(np.float32)
        clips.append(audio)
    model = load_jax_params(Whisper(WhisperConfig(**cfg), device="cpu"), params)
    words = json.loads((fx / "word_vocab.json").read_text())
    return SimpleNamespace(jm=jm, variables={"params": params}, model=model, audios=clips,
                           jtable=JaxTable(multilingual=True),
                           table=WhisperTokenTable(multilingual=True),
                           words=WhisperTokenTable(multilingual=True, text_backend=_Words(words)))


# ------------------------------------------------ caches, reads and rules


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_row_pos_cache_update_is_jax_scatter(kind, s):
    """Rows written at their own offsets; row 3's block runs past the
    128-position horizon and its out-of-range entries are dropped."""
    g = np.random.default_rng(s)
    b, h, d, t = 4, 2, 8, 128
    pos = np.asarray([0, 17, 90, 127], np.int32)
    base = [g.standard_normal((b, h, d, t)).astype(np.float32) for _ in range(2)]
    new = [g.standard_normal((b, h, d, s)).astype(np.float32) for _ in range(2)]
    if kind == "float":
        want = jkv.KVCache(*map(jnp.asarray, base)).update(jnp.asarray(pos), *map(jnp.asarray, new))
        got = tkv.KVCache(*map(torch.tensor, base)).update(torch.tensor(pos), *map(torch.tensor, new))
        pairs = [(got.k, want.k), (got.v, want.v)]
    else:
        jc = jkv.QuantizedKVCache.zeros(b, h, t, d).update(0, *map(jnp.asarray, base))
        tc = tkv.QuantizedKVCache.zeros(b, h, t, d, device="cpu").update(0, *map(torch.tensor, base))
        want = jc.update(jnp.asarray(pos), *map(jnp.asarray, new))
        got = tc.update(torch.tensor(pos), *map(torch.tensor, new))
        pairs = [(getattr(got, n), getattr(want, n)) for n in ("k_q", "v_q", "k_scale", "v_scale")]
    for a, w in pairs:
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("s", [1, 5])
def test_plain_decode_attention_with_row_pos_matches_jax(s):
    g = np.random.default_rng(10 + s)
    b, h, d, t = 3, 2, 8, 128
    pos = np.asarray([0, 40, 122], np.int32)
    k, v = (g.standard_normal((b, h, d, t)).astype(np.float32) for _ in range(2))
    q = (g.standard_normal((b, h, s, d)) * 0.4).astype(np.float32)
    jq = jkv.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    want = jkv._attend_quantized(jnp.asarray(q), jq, decode_mask(t, jnp.asarray(pos), s),
                                 jnp.float32)
    tq = tkv.quantize_kv(torch.tensor(k), torch.tensor(v))
    got = tkv.attend_quantized(torch.tensor(q), tq, pos=torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # Each row equals the scalar-pos read of that row alone.
    for r in range(b):
        one = tkv.QuantizedKV(*(x[r:r + 1] for x in (tq.k_q, tq.v_q, tq.k_scale, tq.v_scale)))
        np.testing.assert_array_equal(got[r:r + 1].numpy(),
                                      tkv.attend_quantized(torch.tensor(q[r:r + 1]), one,
                                                           pos=int(pos[r])).numpy())


def test_rules_with_row_pos_are_exact_against_jax():
    """Timestamp rules (prompt of 3) and both repetition rules at per-row
    positions: the initial position, a lone timestamp, a text run, a
    repeated n-gram."""
    jtable, table = JaxTable(multilingual=True), WhisperTokenTable(multilingual=True)
    ts, p = table.timestamp_begin, 3
    g = np.random.default_rng(5)
    tokens = np.full((4, 24), table.eot, np.int64)
    tokens[:, :p] = [table.sot, table.sot + 1, table.sot + 2]
    tokens[1, 3:5] = [ts + 3, 100]
    tokens[2, 3:8] = [ts + 2, 11, 12, ts + 9, ts + 9]
    tokens[3, 3:12] = [ts, 7, 8, 9, 7, 8, 9, 7, 8]
    pos = np.asarray([3, 5, 8, 12], np.int32)
    logits = (g.standard_normal((4, table.n_vocab)) * 3).astype(np.float32)
    bannable = np.arange(table.n_vocab) < table.eot
    pairs = [(make_timestamp_rules(table, p), jax_ts_rules(jtable, p)),
             (make_repetition_rules(1.3, 3, n_prompt=p, bannable=bannable),
              jax_rep_rules(1.3, 3, n_prompt=p, bannable=bannable))]
    for fn, jfn in pairs:
        got = fn(torch.tensor(logits), torch.tensor(tokens), torch.tensor(pos)).numpy()
        want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(tokens, jnp.int32),
                              jnp.asarray(pos)))
        np.testing.assert_array_equal(got, want)
        for r in range(4):  # and each row equals the scalar-pos rules
            one = fn(torch.tensor(logits[r:r + 1]), torch.tensor(tokens[r:r + 1]), int(pos[r]))
            np.testing.assert_array_equal(got[r:r + 1], one.numpy())


# ------------------------------------------------ the slot engine


def _drive(engine, wins):
    """Admit one window before each chunk while a slot is free (staggered
    admission, refills as slots finish) until every window is reaped."""
    queue, done, chunks = list(wins), [], 0
    while queue or engine.busy:
        if queue and engine.free_slots:
            engine.admit_many(queue[:1])
            queue.pop(0)
            done += engine.reap()
        if engine.busy:
            done += engine.step()
            chunks += 1
        assert chunks < 200
    assert len(done) == len(wins)
    return chunks


def _engine_windows(t, jt, audios, draft=False, chunk_tokens=3):
    """Each clip through the port's and JAX's SlotEngine (two slots, the
    same schedule): [(tokens, length, sum_logprob, no_speech_prob)] x 2."""
    prompt = np.asarray(t._prompt_ids(), np.int64)
    wins = [_Window(a, prompt) for a in audios]
    jwins = [JaxWindow(a, prompt.astype(np.int32)) for a in audios]
    engine = SlotEngine(t, slots=2, chunk_tokens=chunk_tokens)
    _drive(engine, wins)
    _drive(JaxSlotEngine(jt, slots=2, chunk_tokens=chunk_tokens), jwins)
    assert engine.stats["syncs"] == engine.stats["reaps"] >= engine.stats["chunks"]
    return [[(w.tokens, w.length, w.sum_logprob, w.no_speech_prob) for w in ws]
            for ws in (wins, jwins)]


def _greedy_windows(t, audios):
    """The port's batched greedy decode of the same clips (batch 5)."""
    mel = t._features(np.stack(audios))
    tokens, lengths, aux = t._decode_fn(len(audios))(mel)
    return list(zip(tokens, lengths, aux["sum_logprob"], aux["no_speech_prob"]))


def _assert_same_windows(got, want, quality=True):
    for (tok, n, lp, ns), (w_tok, w_n, w_lp, w_ns) in zip(got, want):
        assert n == w_n
        np.testing.assert_array_equal(tok[:n], np.asarray(w_tok)[:n])
        if quality:
            np.testing.assert_allclose([lp, ns], [w_lp, w_ns], **TOL)


@pytest.mark.parametrize("timestamps,quantized", [(True, True), (False, False)])
def test_slot_engine_matches_jax_engine_and_greedy(setup, timestamps, quantized):
    kw = dict(token_table=setup.table, batch_size=2, timestamps=timestamps,
              quantized_cache=quantized, quantized_cross_kv="int8" if quantized else False)
    t = Transcriber(setup.model, device="cpu", **kw)
    jt = JaxTranscriber(setup.jm, setup.variables, family="whisper",
                        **dict(kw, token_table=setup.jtable))
    got, want = _engine_windows(t, jt, setup.audios)
    _assert_same_windows(got, want)
    _assert_same_windows(got, _greedy_windows(t, setup.audios))


def test_slot_engine_on_the_trained_fixture(tiny):
    """whisper_tiny with timestamps and int8 caches: real transcripts
    (several tokens each) through staggered slots, equal to JAX's engine
    and the port's greedy."""
    kw = dict(token_table=tiny.table, batch_size=3, timestamps=True, quantized_cache=True,
              quantized_cross_kv="int8")
    t = Transcriber(tiny.model, device="cpu", **kw)
    jt = JaxTranscriber(tiny.jm, tiny.variables, family="whisper",
                        **dict(kw, token_table=tiny.jtable))
    got, want = _engine_windows(t, jt, tiny.audios, chunk_tokens=4)
    assert min(n for _, n, _, _ in got) > len(t._prompt_ids()) + 2
    _assert_same_windows(got, want)
    _assert_same_windows(got, _greedy_windows(t, tiny.audios))


@pytest.mark.parametrize("gamma", [1, 3])
def test_speculative_slots_equal_greedy(setup, gamma):
    """Per-slot draft-verify rounds (the draft has other weights: partial
    acceptance) commit target greedy's tokens, as JAX's speculative slots
    do."""
    kw = dict(token_table=setup.table, batch_size=2, timestamps=True, quantized_cache=True,
              quantized_cross_kv="int8", speculative_gamma=gamma)
    t = Transcriber(setup.model, draft_model=setup.draft, device="cpu", **kw)
    jt = JaxTranscriber(setup.jm, setup.variables, family="whisper",
                        draft_model=setup.djm, draft_variables=setup.d_variables,
                        **dict(kw, token_table=setup.jtable))
    got, want = _engine_windows(t, jt, setup.audios, chunk_tokens=8)
    _assert_same_windows(got, want)
    greedy = Transcriber(setup.model, device="cpu", **{k: v for k, v in kw.items()
                                                       if k != "speculative_gamma"})
    _assert_same_windows(got, _greedy_windows(greedy, setup.audios))


def test_batcher_matches_transcribe_many_and_frees_cancelled_slots(setup):
    """Requests through the ContinuousBatcher equal transcribe_many; a
    request whose client goes away is cancelled and its slots are freed."""
    t = Transcriber(setup.model, token_table=setup.table, batch_size=2, device="cpu")
    want = t.transcribe_many(setup.audios[:3])
    batcher = ContinuousBatcher(t, max_batch=2, chunk_tokens=2)
    try:
        got = [None] * 3

        def run(i):
            got[i] = batcher.submit(setup.audios[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert [[s.tokens for s in r.segments] for r in got] == \
            [[s.tokens for s in r.segments] for r in want]
        # A long request cancelled while its windows decode.
        gone = threading.Event()
        with pytest.raises(RequestCancelled):
            threading.Timer(0.3, gone.set).start()
            batcher.submit(np.concatenate(setup.audios * 8), cancelled=gone.is_set)
        deadline = time.monotonic() + 60
        while batcher.stats()["requests_cancelled"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        stats = batcher.stats()
        assert stats["requests_cancelled"] == 1 and stats["requests_served"] == 3
        assert batcher.engine.free_slots == 2 and stats["active_slots"] == 0
    finally:
        batcher.close()


def test_batcher_fallback_ladder_and_word_timestamps_equal_transcribe(tiny):
    """The assemble step: windows that fail the quality checks re-decode at
    the next rung (every window fails a logprob threshold of 0), and word
    timestamps come from the alignment pass over the slot count's groups;
    the result equals ``transcribe`` of the same request (5 windows)."""
    kw = dict(token_table=tiny.words, batch_size=2, temperatures=(0.0, 0.4),
              logprob_threshold=0.0, word_timestamps=True, device="cpu")
    audio = np.concatenate(tiny.audios)
    want = Transcriber(tiny.model, **kw).transcribe(audio)
    batcher = ContinuousBatcher(Transcriber(tiny.model, **kw), max_batch=2, chunk_tokens=4)
    try:
        got = batcher.submit(audio)
    finally:
        batcher.close()
    assert {s.temperature for s in want.segments} == {float(np.float32(0.4))}
    assert sum(len(s.words or []) for s in want.segments) >= 3
    assert [(s.tokens, s.start, s.end, s.temperature, s.words) for s in got.segments] == \
        [(s.tokens, s.start, s.end, s.temperature, s.words) for s in want.segments]


def test_slot_engine_keeps_the_jax_refusals(setup):
    base = dict(token_table=setup.table, batch_size=2, device="cpu")
    for kw, match in ((dict(beams=2), "greedy-only"),
                      (dict(temperatures=(0.2, 0.4)), "must start at 0.0"),
                      (dict(condition_on_previous_text=True), "sequential")):
        with pytest.raises(ValueError, match=match):
            SlotEngine(Transcriber(setup.model, **base, **kw))
    t = Transcriber(setup.model, **base)
    with pytest.raises(ValueError, match="chunk_tokens"):
        SlotEngine(t, chunk_tokens=0)
    with pytest.raises(ValueError, match="at least one slot"):
        SlotEngine(t, slots=-1)
    with pytest.raises(ValueError, match="unknown family"):
        SlotEngine(SimpleNamespace(family="other"))
    assert ContinuousWhisperDecoder is SlotEngine
