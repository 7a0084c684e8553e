"""The greedy chunk body that the card captures as a CUDA graph, on the CPU.

``infer/decode.py``'s device-``pos`` body (a per-row position vector, a
token buffer padded by one chunk, every buffer written in place) against
the JAX package's ``greedy_decode`` on the trained fixtures
(``whisper_tiny`` in f32 and on the bf16 lanes with int8 cross-K/V and
cache, and the YOHO session ``tiny``): the same tokens and lengths,
``sum_logprob`` and ``no_speech_prob`` within ``TOL``, at the full horizon
(every row ends early, ``max_len - P`` not a multiple of 8) and at a short
one (rows unfinished at ``max_len``). The same body through a program
(``infer/graphs.py``'s ``ChunkGraph`` with its CUDA surfaces replaced by
CPU ones: the replay runs the body) over reused buffers, on two calls. A
guard makes every host read raise (``item``, ``__bool__``, ``__int__``,
``__float__``, ``__index__``, ``tolist``, ``cpu``, ``numpy``) while a
greedy chunk or a slot-engine chunk runs: the body the card captures reads
nothing back. The slot engine's chunk through ``Transcriber`` equals the
batched greedy decode. The transcriber's encode and cross-K/V in row
chunks equal one pass, and a batch encodes once for its decode and its passes. The launch
accounting of ``ChunkGraph`` with stub kernels: a capture counts nothing
and each replay adds what it recorded.
"""

import contextlib
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.core.config import load_session_config as jax_session
from yoho_tpu.infer.decode import greedy_decode as jax_greedy
from yoho_tpu.infer.decode import make_whisper_step_fn as jax_whisper_step
from yoho_tpu.infer.decode import make_yoho_step_fn as jax_yoho_step
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.nn.yoho import YOHOModel as JaxYOHO
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.cli.transcribe import load_yoho_session
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer import decode as tdecode
from yoho_tpu_torch.infer.graphs import ChunkGraph
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.infer.slot_engine import SlotEngine, _Window
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
from yoho_tpu_torch.train.checkpoint import load_params as session_params

FIXTURES = Path(__file__).parent / "fixtures"
WHISPER = json.loads((FIXTURES / "whisper_tiny" / "config.json").read_text())
SESSIONS = FIXTURES / "sessions"
# The quality signals' bound (tests/test_continuous.py's).
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(n_samples, tones=(440, 880, 1320)):
    """The fixtures' tone clips (tests/test_checkpoint_fixture.py)."""
    clips = []
    for hz in tones:
        audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002).astype(np.float32)
        audio[800:4800] += (0.4 * np.sin(2 * np.pi * hz * np.arange(4000) / 16000)
                            ).astype(np.float32)
        clips.append(audio)
    return clips


@pytest.fixture(scope="module")
def whisper():
    """whisper_tiny in both packages: the flax params, the port model in
    f32 and in bf16, a (3, frames, mels) log-mel of the tone clips."""
    cfg = JaxConfig(**WHISPER)
    template = jax.eval_shape(
        JaxWhisper(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = jax.device_get(load_params(FIXTURES / "whisper_tiny" / "params.msgpack",
                                        template))
    models = {name: load_jax_params(Whisper(WhisperConfig(**WHISPER), dtype=dt,
                                            device="cpu"), params)
              for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    table = WhisperTokenTable(multilingual=True)
    tr = Transcriber(models["f32"], token_table=table, batch_size=3, device="cpu")
    mel = tr._features(np.stack(_clips(cfg.n_samples))).numpy()
    return SimpleNamespace(cfg=cfg, params=params, models=models, table=table, mel=mel)


@pytest.fixture(scope="module")
def yoho():
    """The YOHO session ``tiny`` in float32 in both packages and the log-mel
    of its three tone clips."""
    cfg = jax_session("tiny", str(SESSIONS))
    tok, model = load_yoho_session("tiny", str(SESSIONS), torch.device("cpu"),
                                   dtype=torch.float32)
    tr = Transcriber(model, family="yoho", tokenizer=tok, batch_size=3, device="cpu")
    jm = JaxYOHO(cfg.yoho, tok.vocab_size, voiceprint_dim=256, dtype=jnp.float32)
    mel = tr._features(np.stack(_clips(tr.model.cfg.n_samples))).numpy()
    return SimpleNamespace(tr=tr, jm=jm, variables={"params": session_params(cfg.weights.asr)},
                           mel=mel)


def _whisper_pair(w, lane, n):
    """(JAX step, caches, prompt), (port step, caches, prompt) and the
    decode keywords for ``n`` rows on one lane of the fixture."""
    dtype, quant = {"f32": ("f32", False), "bf16-int8": ("bf16", "int8")}[lane]
    jm = JaxWhisper(w.cfg, dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    v = {"params": w.params}
    mel = w.mel[:n]
    cached = quant is not False
    xa = jm.apply(v, jnp.asarray(mel), method=JaxWhisper.encode_audio)
    jckv = jm.apply(v, xa, quant, method=JaxWhisper.cross_kvs)
    jcaches = jm.apply(v, n, jnp.float32, None, cached, method=JaxWhisper.init_caches)
    tm = w.models[dtype]
    with torch.no_grad():
        tckv = tm.cross_kvs(tm.encode_audio(torch.from_numpy(mel)), quant)
    tcaches = tm.init_caches(n, torch.float32, None, cached)
    prompt = np.asarray([w.table.sot_sequence("en", timestamps=False)] * n, np.int32)
    kw = dict(suppress_ids=tuple(w.table.non_speech_tokens) + tuple(
        range(w.table.timestamp_begin, w.table.n_vocab)), return_aux=True,
        no_speech_id=w.table.no_speech, sot_index=0)
    return ((jax_whisper_step(jm, v, jckv), jcaches, prompt),
            (tdecode.make_whisper_step_fn(tm, tckv), tcaches, prompt), w.table.eot, kw)


def _yoho_pair(y, n):
    tr, jm, v = y.tr, y.jm, y.variables
    mel = y.mel[:n]
    xa = jm.apply(v, jnp.asarray(mel), method=JaxYOHO.encode_audio)
    jckv = jm.apply(v, xa, method=JaxYOHO.cross_kvs)
    jcaches = jm.apply(v, n, jnp.float32, method=JaxYOHO.init_caches)
    tm = tr.model
    with torch.no_grad():
        tckv = tm.cross_kvs(tm.encode_audio(torch.from_numpy(mel)))
    tcaches = tm.init_caches(n, torch.float32)
    prompt = np.asarray([tr._prompt_ids()] * n, np.int32)
    kw = dict(suppress_ids=tr._suppress_ids(), return_aux=True)
    return ((jax_yoho_step(jm, v, jckv), jcaches, prompt),
            (tdecode.make_yoho_step_fn(tm, tckv), tcaches, prompt), tr.eot, kw)


def _run_jax(j, max_len, eot, kw):
    step, caches, prompt = j
    fn = jax.jit(lambda c, p: jax_greedy(step, c, p, max_len, eot, **kw))
    tokens, lengths, aux = fn(caches, jnp.asarray(prompt))
    return np.asarray(tokens), np.asarray(lengths), {k: np.asarray(x) for k, x in aux.items()}


def _run_port(t, max_len, eot, kw, program=None):
    step, caches, prompt = t
    with torch.no_grad():
        tokens, lengths, aux = tdecode.greedy_decode(
            step, caches, torch.from_numpy(prompt).long(), max_len, eot, program=program,
            **kw)
    return tokens.numpy(), lengths.numpy(), {k: x.numpy() for k, x in aux.items()}


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], **TOL)


def _tail_case(lengths, max_len, p, short):
    """The case a horizon exercises: ``max_len - P`` not a multiple of 8 at
    both; at the short one some row is unfinished at ``max_len``, at the
    full horizon every row ends before it."""
    assert (max_len - p) % tdecode._SYNC_EVERY
    if short:
        assert (lengths == max_len).any()
    else:
        assert (lengths < max_len).all()


@pytest.mark.parametrize("max_len", [32, 7], ids=["horizon", "short"])
@pytest.mark.parametrize("lane", ["f32", "bf16-int8"])
def test_whisper_body_matches_jax(whisper, lane, max_len):
    j, t, eot, kw = _whisper_pair(whisper, lane, 3)
    got = _run_port(t, max_len, eot, kw)
    _assert_same(got, _run_jax(j, max_len, eot, kw))
    _tail_case(got[1], max_len, t[2].shape[1], short=max_len < 32)


def _eot_after(stops, eot):
    """The same rule in both packages: EOT forced from buffer index
    ``stops[row]`` on (the YOHO fixture's tone clips run to its 16-token
    horizon without one), so each row ends at its own step."""
    j_stop, t_stop = jnp.asarray(stops), torch.tensor(stops)

    def jax_fn(logits, tokens, pos):
        force = (pos >= j_stop)[:, None] & (jnp.arange(logits.shape[1]) == eot)[None]
        return jnp.where(force, 1e4, logits)

    def port_fn(logits, tokens, pos):
        force = (pos >= t_stop)[:, None] & (torch.arange(logits.shape[1]) == eot)[None]
        return torch.where(force, 1e4, logits)

    return jax_fn, port_fn


@pytest.mark.parametrize("max_len", [16, 4], ids=["horizon", "short"])
def test_yoho_body_matches_jax(yoho, max_len):
    """At the horizon every row ends early (EOT forced at 5, 9 and 12, in
    three different chunks); at 4 each row is cut unfinished."""
    j, t, eot, kw = _yoho_pair(yoho, 3)
    j_kw, t_kw = dict(kw), dict(kw)
    if max_len == 16:
        j_kw["logits_fn"], t_kw["logits_fn"] = _eot_after([5, 9, 12], eot)
    got = _run_port(t, max_len, eot, t_kw)
    _assert_same(got, _run_jax(j, max_len, eot, j_kw))
    _tail_case(got[1], max_len, t[2].shape[1], short=max_len < 16)


class _CpuGraph(ChunkGraph):
    """A ``ChunkGraph`` whose CUDA surfaces are the CPU's. The warm-up runs
    the body. A capture on the card runs the Python and launches nothing:
    here it runs the body (``capture_runs``: the launch test, where the
    body only counts) or skips it (the decode tests, where running it would
    advance the state). A replay runs the body again (``replay_runs``:
    standing in for the device's work) or does nothing."""

    def __init__(self, *a, capture_runs=False, replay_runs=True, **kw):
        super().__init__(*a, **kw)
        self.capture_runs, self.replay_runs = capture_runs, replay_runs

    def _warm_up(self):
        self.body()

    def _new_graph(self):
        return SimpleNamespace(replay=self.body if self.replay_runs else (lambda: None))

    @contextlib.contextmanager
    def _capturing(self, graph, stream):
        body = self.body
        if not self.capture_runs:
            self.body = lambda: None
        try:
            yield
        finally:
            self.body = body

    def _reserved(self):
        return 0


def test_program_reuses_its_buffers_over_two_calls(whisper):
    """Two calls through one program over one set of caches and cross-K/V
    (written in place by ``cross_kvs(out=...)``) give each call's eager
    result: the body built at the first call serves the second."""
    tm = whisper.models["f32"]
    table = whisper.table
    n, max_len = 2, 32
    prompt = torch.tensor([table.sot_sequence("en", timestamps=False)] * n)
    kw = dict(suppress_ids=tuple(table.non_speech_tokens), return_aux=True,
              no_speech_id=table.no_speech, sot_index=0)
    program = _CpuGraph(state=tdecode.GreedyState.empty(n, max_len, "cpu"), kernels=[])
    caches, ckv = tm.init_caches(n, torch.float32), None
    with torch.no_grad():
        for rows in ((0, 1), (2, 0)):
            xa = tm.encode_audio(torch.from_numpy(whisper.mel[list(rows)]))
            ckv = tm.cross_kvs(xa, out=ckv)
            got = tdecode.greedy_decode(tdecode.make_whisper_step_fn(tm, ckv), caches,
                                        prompt, max_len, table.eot, program=program, **kw)
            want = tdecode.greedy_decode(tdecode.make_whisper_step_fn(tm, tm.cross_kvs(xa)),
                                         tm.init_caches(n, torch.float32), prompt, max_len,
                                         table.eot, **kw)
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
            for k in want[2]:
                np.testing.assert_array_equal(got[2][k].numpy(), want[2][k].numpy())
    assert program.captures == 1 and program.replays >= 1


_HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
               "__index__")


@contextlib.contextmanager
def _no_host_reads():
    """Every way a tensor's value reaches the host raises inside."""
    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"host read Tensor.{name} inside a captured chunk")
        return read

    saved = {n: torch.Tensor.__dict__.get(n) for n in _HOST_READS}
    for n in _HOST_READS:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            if f is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, f)


class _Guarded(_CpuGraph):
    """Runs every chunk (warm-up, capture, replays) under the guard."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.chunks = 0

    def __call__(self):
        with _no_host_reads():
            super().__call__()
        self.chunks += 1


@pytest.mark.parametrize("family", ["whisper", "yoho"])
def test_greedy_chunk_reads_nothing_back(whisper, yoho, family):
    """The whisper lane with the logit bias, the repetition rules and the
    timestamp rules (the rules read ``pos`` per row; EOT biased away so
    that every row runs to the horizon), and YOHO: every chunk runs under
    the guard, and the tokens equal the unguarded run's."""
    if family == "whisper":
        tr = Transcriber(whisper.models["bf16"], token_table=whisper.table, batch_size=3,
                         quantized_cross_kv="int8", quantized_cache=True,
                         cache_dtype=torch.bfloat16, repetition_penalty=1.1,
                         no_repeat_ngram_size=3, logit_bias={whisper.table.eot: -100.0},
                         device="cpu")
        mel = whisper.mel
    else:
        tr, mel = yoho.tr, yoho.mel
    p = len(tr._prompt_ids())
    ref = tr._decode_fn(3)(torch.from_numpy(mel))
    with torch.no_grad():
        ckv = tr.model.cross_kvs(tr.model.encode_audio(torch.from_numpy(mel)),
                                 tr.quantized_cross_kv)
        program = _Guarded(state=tdecode.GreedyState.empty(3, tr.max_len, "cpu"), kernels=[])
        tokens, lengths, aux = tdecode.greedy_decode(
            tr._make_step(ckv), tr.model.init_caches(3, tr.cache_dtype, None,
                                                      tr.quantized_cache),
            torch.tensor([tr._prompt_ids()] * 3), tr.max_len, tr.eot,
            suppress_ids=tr._suppress_ids(), logits_fn=tr._logits_fn(p), return_aux=True,
            no_speech_id=tr._no_speech_id(), sot_index=tr._sot_index(p), program=program)
    assert (lengths == tr.max_len).all()
    assert program.chunks == -(-(tr.max_len - 1 - p) // tdecode._SYNC_EVERY) >= 2
    np.testing.assert_array_equal(tokens.numpy(), ref[0])
    np.testing.assert_array_equal(lengths.numpy(), ref[1])
    np.testing.assert_array_equal(aux["sum_logprob"].numpy(), ref[2]["sum_logprob"])


def _slot_windows(t, chunk_tokens, guard=False):
    """The tone clips through a SlotEngine of two slots, one admission
    before each chunk while a slot is free; with ``guard`` every chunk
    runs under the host-read guard."""
    engine = SlotEngine(t, slots=2, chunk_tokens=chunk_tokens)
    if guard:
        chunk = engine._chunk

        def guarded(state):
            with _no_host_reads():
                chunk(state)

        engine._chunk = guarded
    prompt = np.asarray(t._prompt_ids(), np.int64)
    wins = [_Window(a, prompt) for a in _clips(t.chunk_samples)]
    queue, done = list(wins), []
    while queue or engine.busy:
        if queue and engine.free_slots:
            engine.admit_many(queue[:1])
            queue.pop(0)
            done += engine.reap()
        if engine.busy:
            done += engine.step()
    assert len(done) == len(wins) and engine.stats["chunks"] >= 3
    return [(w.tokens, w.length, w.sum_logprob, w.no_speech_prob) for w in wins]


@pytest.mark.parametrize("family", ["whisper", "yoho"])
def test_slot_chunk_reads_nothing_back_and_equals_greedy(whisper, yoho, family):
    """The slot engine's chunk body through ``Transcriber`` (whisper with
    timestamps and int8 caches; YOHO), every chunk under the guard: each
    window's tokens, length and quality signals equal the batched greedy
    decode of the same clips."""
    if family == "whisper":
        t = Transcriber(whisper.models["f32"], token_table=whisper.table, batch_size=3,
                        timestamps=True, quantized_cache=True, quantized_cross_kv="int8",
                        device="cpu")
    else:
        t = yoho.tr
    got = _slot_windows(t, chunk_tokens=3, guard=True)
    tokens, lengths, aux = t._decode_fn(3)(t._features(np.stack(_clips(t.chunk_samples))))
    for (tok, n, lp, ns), w_tok, w_n, w_lp, w_ns in zip(
            got, tokens, lengths, aux["sum_logprob"], aux["no_speech_prob"]):
        assert n == w_n
        np.testing.assert_array_equal(tok[:n], w_tok[:n])
        np.testing.assert_allclose([lp, ns], [w_lp, w_ns], **TOL)


def _counted_encodes(monkeypatch, model):
    """The row counts of each ``encode_audio`` call ``model`` makes."""
    rows, encode = [], model.encode_audio
    monkeypatch.setattr(model, "encode_audio",
                        lambda mel: rows.append(mel.shape[0]) or encode(mel))
    return rows


@pytest.mark.parametrize("family", ["whisper", "yoho"])
def test_encode_in_row_chunks_equals_one_encode(whisper, yoho, family, monkeypatch):
    """``Transcriber._encode`` hands the encoder an eighth of a large batch
    at a time and no fewer than 16 rows: 40 rows go in chunks of 16, 16
    and 8, and equal one encode of the 40 within 1e-5; 16 rows are one
    call."""
    if family == "whisper":
        t = Transcriber(whisper.models["f32"], token_table=whisper.table, batch_size=3,
                        device="cpu")
        mel = whisper.mel
    else:
        t, mel = yoho.tr, yoho.mel
    mel = torch.from_numpy(np.concatenate([mel] * 14)[:40])
    with torch.inference_mode():
        want = t.model.encode_audio(mel)
    rows = _counted_encodes(monkeypatch, t.model)
    got = t._encode(mel)
    assert rows == [16, 16, 8]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    rows.clear()
    t._encode(mel[:16])
    assert rows == [16]


def _layer_tensors(layer):
    return ([getattr(layer, n) for n in ("k_q", "v_q", "k_scale", "v_scale")]
            if hasattr(layer, "k_q") else list(layer))


@pytest.mark.parametrize("lane", ["f32", "int8", "int4", "yoho"])
def test_cross_kvs_in_row_chunks_equal_one_pass(whisper, yoho, lane):
    """``cross_kvs(rows=16)`` over 40 rows (parts of 16, 16 and 8), new and
    written into an earlier result (``out``), equals one pass over the 40:
    float K/V within 1e-5, int8 and int4 codes within one step and their
    scales within 1e-5."""
    if lane == "yoho":
        model, mel, quant = yoho.tr.model, yoho.mel, False
    else:
        model, mel = whisper.models["f32"], whisper.mel
        quant = {"f32": False, "int8": "int8", "int4": "int4"}[lane]
    with torch.inference_mode():
        xa = model.encode_audio(torch.from_numpy(np.concatenate([mel] * 14)[:40]))
        want = model.cross_kvs(xa, quant)
        got = model.cross_kvs(xa, quant, rows=16)
        out = model.cross_kvs(xa.flip(0), quant)
        into = model.cross_kvs(xa, quant, out=out, rows=16)
    assert all(a is b for a, b in zip(into, out, strict=True))  # written in place
    for layers in (got, into):
        for g_layer, w_layer in zip(layers, want, strict=True):
            for g, w in zip(_layer_tensors(g_layer), _layer_tensors(w_layer), strict=True):
                assert g.shape == w.shape and g.dtype == w.dtype
                if g.dtype.is_floating_point:
                    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
                elif lane == "int4":  # two nibbles a byte: compare each
                    for shift in (0, 4):
                        gn, wn = (((t.int() >> shift) & 15) for t in (g, w))
                        assert (gn - wn).abs().max() <= 1
                else:
                    assert (g.int() - w.int()).abs().max() <= 1


def test_a_batch_encodes_once_for_its_decode_and_passes(yoho, monkeypatch):
    """A YOHO ``transcribe_many`` batch encodes once: the decode and the
    speaker pass read the same encoder output, handed to each by the
    caller. The voiceprints equal those of a speaker pass that encodes
    the log-mel again."""
    t = yoho.tr
    clips = _clips(t.chunk_samples)
    rows = _counted_encodes(monkeypatch, t.model)
    got = t.transcribe_many(clips)
    assert rows == [3]
    attach = t._attach_voiceprints
    monkeypatch.setattr(t, "_attach_voiceprints",
                        lambda *a, xa=None, **k: attach(*a, **k))
    rows.clear()
    want = t.transcribe_many(clips)
    assert rows == [3, 3]
    segs = [(g, w) for r, q in zip(got, want) for g, w in zip(r.segments, q.segments)]
    assert len(segs) == sum(len(q.segments) for q in want)
    assert any(w.voiceprint is not None for _, w in segs)
    for g, w in segs:
        assert g.tokens == w.tokens
        if w.voiceprint is None:
            assert g.voiceprint is None
        else:
            np.testing.assert_array_equal(g.voiceprint, w.voiceprint)


class _Stub:
    """A kernel wrapper's count, without a kernel."""

    def __init__(self, name):
        self.name, self.launches = name, 0

    def launch(self):
        self.launches += 1


def test_launch_deltas_count_replays_not_the_capture():
    a, b = _Stub("a"), _Stub("b")

    def body():
        a.launch()
        a.launch()
        b.launch()

    graph = _CpuGraph(body, kernels=[a, b], capture_runs=True, replay_runs=False)
    for _ in range(4):  # the warm-up chunk, then three replays
        graph()
    assert (graph.captures, graph.replays) == (1, 3)
    assert graph.launches_per_replay() == {"a": 2, "b": 1}
    assert (a.launches, b.launches) == (8, 4)  # four chunks run eagerly
    a.launches = b.launches = 0
    graph()  # a second call captures nothing
    assert (graph.captures, a.launches, b.launches) == (1, 2, 1)

    # A capture that fails raises and leaves the counts where they stood
    # after the warm-up chunk; no graph is kept.
    def failing():
        body()
        if a.launches > 2:
            raise RuntimeError("capture failed")

    a.launches = b.launches = 0
    bad = _CpuGraph(failing, kernels=[a, b], capture_runs=True, replay_runs=False)
    with pytest.raises(RuntimeError, match="capture failed"):
        bad()
    assert (a.launches, b.launches, bad.graph, bad.captures) == (2, 1, None, 0)
    with pytest.raises(RuntimeError, match="before its body"):
        _CpuGraph(kernels=[])()
