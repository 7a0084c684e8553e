"""The port's multi-process serving (``yoho_tpu_torch.parallel``) over a
real process group: four gloo ranks on the CPU.

One group runs every scenario (``tests/_torch_parallel_worker.py``, which
imports torch and the port only); this file makes the inputs and the JAX
package's results on the same weights (its faked 8-device mesh), starts
the ranks once per module and compares. Tolerances are the JAX tests'
(``tests/test_distributed.py``, ``tests/test_pipeline_parallel.py``):
tokens exact, ring attention 2e-5 in f32 and 0.05 with bf16 inputs, the
long encoder and the pipeline 2e-5.
"""

import json
import os
from functools import partial
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from yoho_tpu.core.config import WhisperConfig, YOHOConfig
from yoho_tpu.infer.decode import greedy_decode, make_whisper_step_fn
from yoho_tpu.infer.pipeline import Transcriber
from yoho_tpu.nn.whisper import Whisper
from yoho_tpu.nn.yoho import YOHOModel
from yoho_tpu.parallel.long_encoder import yoho_encode_long
from yoho_tpu.parallel.mesh import make_mesh, shard_batch
from yoho_tpu.parallel.sharding import WHISPER_RULES, shard_params
from yoho_tpu.text.whisper_tokens import WhisperTokenTable

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "_torch_parallel_worker.py"
RANKS = 4
SESSION_GOLDEN = json.loads((TESTS / "fixtures" / "sessions" / "tiny" / "golden.json")
                            .read_text())
WHISPER_GOLDEN = json.loads((TESTS / "fixtures" / "whisper_tiny" / "golden.json").read_text())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _tiny_whisper():
    """tests/test_distributed.py's model and mel."""
    cfg = dict(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=4, n_audio_layer=2,
               n_vocab=64, n_text_ctx=16, n_text_state=32, n_text_head=4, n_text_layer=2)
    model = Whisper(WhisperConfig(**cfg))
    mel = np.random.default_rng(0).standard_normal((4, 32, 8)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(mel[:1]),
                           jnp.zeros((1, 4), jnp.int32))
    return cfg, model, variables, mel


def _jax_greedy(model, variables, mel):
    def run(variables, mel):
        xa = model.apply(variables, mel, method=Whisper.encode_audio)
        ckv = model.apply(variables, xa, method=Whisper.cross_kvs)
        caches = model.apply(variables, 4, jnp.float32, method=Whisper.init_caches)
        step = make_whisper_step_fn(model, variables, ckv)
        return greedy_decode(step, caches, jnp.ones((4, 2), jnp.int32), 12, eot_id=63)

    return [np.asarray(x) for x in jax.jit(run)(variables, mel)]


def _quantized_case():
    """tests/test_distributed.py's sharded quantized serving model."""
    cfg = dict(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=4, n_audio_layer=1,
               n_vocab=51865, n_text_ctx=16, n_text_state=32, n_text_head=4,
               n_text_layer=1, chunk_seconds=0.32)
    jcfg = WhisperConfig(**cfg)
    model = Whisper(jcfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 8), jnp.float32),
                           jnp.zeros((1, 4), jnp.int32))
    audio = (0.1 * np.random.default_rng(1).standard_normal(jcfg.n_samples * 2)
             ).astype(np.float32)
    kw = dict(family="whisper", token_table=WhisperTokenTable(multilingual=True),
              batch_size=2, quantized_cross_kv="int8", quantized_cache=True)
    res = Transcriber(model, variables, **kw).transcribe(audio)
    return (dict(cfg=cfg, params=_host(variables["params"]), audio=audio),
            dict(tokens=[[[int(t) for t in s.tokens] for s in res.segments]],
                 starts=[[round(s.start, 3) for s in res.segments]]))


def _yoho_tiny(n_blocks=2, vocab=300):
    cfg = dict(n_mel_bands=8, max_audio_len=32, max_text_len=8, dims=32, n_audio_heads=4,
               n_audio_blocks=n_blocks, n_text_heads=4, n_text_blocks=1)
    model = YOHOModel(YOHOConfig(**cfg), vocab_size=vocab)
    init = jax.jit(partial(model.init, method=YOHOModel.forward_with_voiceprints))
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                     jnp.zeros((1, 32, 8), jnp.float32))
    return cfg, model, variables


def _session_clip(s: int, n_samples: int) -> np.ndarray:
    """tests/test_torch_yoho_pipeline.py's clips."""
    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * (440, 880, 1320)[s] * np.arange(4000) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


def _whisper_fixture_dir(root: Path) -> dict:
    """The whisper_tiny fixture as an HF directory with a word BPE and its
    golden clips as WAV files (tests/test_torch_cli.py's layout)."""
    from yoho_tpu.nn.export import export_hf_whisper
    from yoho_tpu.train.checkpoint import load_params

    from test_torch_cli import FIXTURE, WORDS, _tone_clip, _wav, write_word_bpe

    cfg = WhisperConfig(**json.loads((FIXTURE / "config.json").read_text()))
    template = jax.eval_shape(
        Whisper(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    hf = root / "hf"
    export_hf_whisper(load_params(FIXTURE / "params.msgpack", template), cfg, hf)
    write_word_bpe(hf, WORDS)
    wavs = [_wav(root / f"tone{i}.wav", _tone_clip(i, cfg.n_samples)) for i in range(3)]
    return dict(hf=str(hf), wavs=wavs)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Inputs, the JAX results on the same weights, and the four ranks'
    outputs."""
    case = tmp_path_factory.mktemp("parallel")
    inputs, want = {}, {}

    cfg, model, variables, mel = _tiny_whisper()
    ref = _jax_greedy(model, variables, jnp.asarray(mel))
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    sharded = {"params": shard_params(variables["params"], mesh, WHISPER_RULES)}
    inputs["whisper_greedy"] = dict(cfg=cfg, params=_host(variables["params"]), mel=mel)
    want["whisper_greedy"] = dict(tokens=ref, mesh=_jax_greedy(model, sharded,
                                                                shard_batch(mesh, mel)))

    inputs["quantized"], want["quantized"] = _quantized_case()

    from yoho_tpu_torch.core.config import load_session_config

    root = TESTS / "fixtures" / "sessions"
    n = load_session_config("tiny", str(root)).yoho.n_samples
    inputs["yoho_session"] = dict(root=str(root), clips=[_session_clip(s, n) for s in range(3)])

    rng = np.random.default_rng(5)
    base = dict(n_mel_bands=8, max_audio_len=32, max_text_len=8, n_audio_blocks=2,
                n_text_blocks=2)
    inputs["yoho_models"] = dict(
        mel=rng.standard_normal((4, 32, 8)).astype(np.float32),
        configs={"kv3": dict(base, dims=48, n_audio_heads=6, n_text_heads=6),
                 "moe": dict(base, dims=32, n_audio_heads=4, n_text_heads=4, n_experts=4,
                             moe_every_n=1, moe_in_decoder=True)})

    ring = {}
    g = np.random.default_rng(0)
    ring["f32"] = tuple(g.standard_normal((2, 3, 64, 16)).astype(np.float32)
                        for _ in range(3)) + ("float32",)
    g = np.random.default_rng(1)
    ring["bf16_gqa"] = (g.standard_normal((1, 4, 32, 8)).astype(np.float32),
                        g.standard_normal((1, 2, 32, 8)).astype(np.float32),
                        g.standard_normal((1, 2, 32, 8)).astype(np.float32), "bfloat16")
    inputs["ring"] = ring

    ycfg, ymodel, yvars = _yoho_tiny()
    long_mel = np.random.default_rng(0).standard_normal((2, 128, 8)).astype(np.float32)
    seq = Mesh(np.array(jax.devices()[:4]), ("seq",))
    inputs["long_encoder"] = dict(cfg=ycfg, params=_host(yvars["params"]), mel=long_mel)
    want["long_encoder"] = np.asarray(yoho_encode_long(ymodel, yvars, jnp.asarray(long_mel),
                                                       seq))

    pcfg, pmodel, pvars = _yoho_tiny(n_blocks=4, vocab=64)
    pmel = np.random.default_rng(0).standard_normal((4, 32, 8)).astype(np.float32)
    inputs["pipeline"] = dict(cfg=pcfg, params=_host(pvars["params"]), mel=pmel)
    want["pipeline"] = np.asarray(pmodel.apply(pvars, jnp.asarray(pmel),
                                               method=YOHOModel.encode_audio))

    inputs["whisper_fixture"] = _whisper_fixture_dir(case)

    (case / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(TESTS.parent),
                                                      os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(case)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    outs = [pickle.loads((case / f"out{r}.pkl").read_bytes()) for r in range(RANKS)]
    return inputs, want, outs


def _result(group, name, rank=0):
    out = group[2][rank][name]
    assert "error" not in out, out.get("error")
    return out


def test_meshes_and_batch_placement_over_four_ranks(group):
    """``parse_mesh`` at a world of 4: the JAX package's specs and errors;
    each rank's coordinates and rows."""
    got = [_result(group, "parse", r) for r in range(RANKS)]
    assert got[0]["shapes"] == {"2x2": {"data": 2, "model": 2}, "-1x2": {"data": 2, "model": 2},
                                "1x4": {"data": 1, "model": 4}, "-1x4": {"data": 1, "model": 4},
                                "4x1": {"data": 4, "model": 1}}
    (e8, e222, e33, e13, e24) = got[0]["errors"]
    assert e8[0] == e222[0] == "ValueError" and "DATAxMODEL" in e8[1] and "DATAxMODEL" in e222[1]
    assert e33 == e13 == ("ValueError", "model axis size 3 does not divide device count 4")
    assert e24 == ("ValueError", "mesh 2x4 != 4 devices")
    assert [g["coord"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [g["shard"] for g in got] == [(r, 4) for r in range(RANKS)]
    assert [g["coordinator"] for g in got] == [True, False, False, False]
    assert {g["local"] for g in got} == {4}
    assert [g["rows"] for g in got] == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2
    assert got[0]["bad_rows"][0][0] == "ValueError"


def test_tp_dp_whisper_decodes_the_jax_tokens(group):
    """The JAX test's tiny whisper at data 2 x model 2 gives the tokens of
    JAX's make_mesh(2, 2) run and of both packages' unsharded runs; heads,
    vocabulary rows and the collectives are this rank's share."""
    want = group[1]["whisper_greedy"]
    for r in range(RANKS):
        got = _result(group, "whisper_greedy", r)
        np.testing.assert_array_equal(got["tokens"], want["tokens"][0])
        np.testing.assert_array_equal(got["lengths"], want["tokens"][1])
        np.testing.assert_array_equal(want["mesh"][0], want["tokens"][0])
        np.testing.assert_array_equal(got["plain"][0], want["tokens"][0])
        assert got["heads"] == 2 and got["q_rows"] == (16, 32) and got["vocab_rows"] == 32
        # Both layers' row-parallel out/fc2 reduce over model; the vocab
        # is sharded (lookup reduced, logits gathered); tokens and lengths
        # gathered over data once each.
        assert got["counts"]["all_gather/data"] == 2
        assert got["counts"]["all_reduce/model"] > got["counts"]["all_gather/model"] > 0


def test_quantized_transcriber_shards_cross_kv_by_heads(group):
    """``Transcriber(mesh=...)`` on the int8 cross-K/V and cache lane: the
    JAX Transcriber's tokens and segment starts (which its own mesh
    reproduces: tests/test_distributed.py), and each rank's cross K/V
    holds H/M heads of its rows."""
    want = group[1]["quantized"]
    for r in range(RANKS):
        got = _result(group, "quantized", r)
        assert got["tokens"] == got["plain"] == want["tokens"]
        assert got["starts"] == want["starts"]
        assert got["mel_rows"] == 2
        for shapes in got["ckv_shapes"]:
            assert shapes["k_q"] == shapes["v_q"] == (2, 2, 8, 128)
            assert shapes["k_scale"] == shapes["v_scale"] == (2, 2, 1, 128)


def test_yoho_session_over_the_mesh_gives_the_golden_text(group):
    """The trained YOHO fixture (4 heads on 2 KV heads, a 400-id
    vocabulary: both sharded over model 2) through
    ``load_transcriber(mesh=...)``: golden.json's text and the unsharded
    segment tokens. (Speaker labels are not held: in bf16 each rank rounds
    its partial sums, so the voiceprints move in their fourth decimal.)"""
    got = _result(group, "yoho_session")
    assert got["texts"] == [g["text"] for g in SESSION_GOLDEN]
    assert got["tokens"] == got["plain"]


@pytest.mark.parametrize("name", ["kv3", "moe"])
def test_yoho_models_shard_as_the_rules_say(group, name):
    """3 KV heads on a model axis of 2 keep attention whole (q, k, v and
    out) while the MLPs and the vocabulary shard; MoE shards its experts.
    Greedy tokens equal the unsharded model's."""
    for r in range(RANKS):
        got = _result(group, "yoho_models", r)[name]
        np.testing.assert_array_equal(got["tokens"][0], got["plain"][0])
        np.testing.assert_array_equal(got["tokens"][1], got["plain"][1])
        assert got["vocab_rows"] == 150
        if name == "kv3":
            assert got["heads"] == (6, 3, 6, 3) and not got["sharded_attn"]
            assert got["hidden"] == 48 * 3 // 2
        else:
            assert got["heads"] == (2, 1, 2, 1) and got["sharded_attn"]
            assert got["experts"] == 2 and got["hidden"] == 2


def _softmax_attention(q, k, v):
    g = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    scores = np.einsum("bhsd,bhtd->bhst", q * q.shape[-1] ** -0.5, k)
    w = np.exp(scores - scores.max(-1, keepdims=True))
    return np.einsum("bhst,bhtd->bhsd", w / w.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("name,tol", [("f32", dict(atol=2e-5)),
                                      ("bf16_gqa", dict(atol=0.05, rtol=0.05))])
def test_ring_attention_matches_full_softmax(group, name, tol):
    """Ring attention over seq 4 is full softmax attention: 2e-5 in f32;
    bf16 inputs (GQA, 4 query heads on 2) keep f32 statistics, 0.05. Three
    fold+send steps: 2 sends and 2 receives each."""
    q, k, v, dtype = group[0]["ring"][name]
    for r in range(RANKS):
        got = _result(group, "ring", r)[name]
        assert got["dtype"] == f"torch.{dtype}"
        np.testing.assert_allclose(got["out"], _softmax_attention(q, k, v), **tol)
        assert got["counts"] == {"send/seq": 6, "recv/seq": 6}


def test_long_encoder_matches_jax_and_the_unsharded_encode(group):
    """``yoho_encode_long`` at seq 4 on 4x the trained window equals JAX's
    (its ring over 4 faked devices) and the port's unsharded encode of the
    whole sequence; a length the axis cannot split and an MoE config
    raise."""
    want = group[1]["long_encoder"]
    for r in range(RANKS):
        got = _result(group, "long_encoder", r)
        assert got["out"].shape == want.shape == (2, 64, 32)
        np.testing.assert_allclose(got["out"], want, atol=2e-5)
        np.testing.assert_allclose(got["out"], got["plain"], atol=2e-5)
        (div, moe) = got["errors"]
        assert div[0] == moe[0] == "ValueError"
        assert "must divide" in div[1] and "MoE" in moe[1]


def test_pipeline_encode_matches_the_sequential_stack(group):
    """GPipe at pipe 2 (2 blocks a stage, 2 microbatches) and at data 2 x
    pipe 2 equal JAX's encode_audio; stage 0 sends and stage 1 receives
    each microbatch once, and the last stage broadcasts."""
    want = group[1]["pipeline"]
    for r in range(RANKS):
        got = _result(group, "pipeline", r)
        np.testing.assert_allclose(got["pipe"], want, atol=2e-5)
        np.testing.assert_allclose(got["dp"], want, atol=2e-5)
        stage = r % 2
        assert got["counts"] == {("send/pipe" if stage == 0 else "recv/pipe"): 2,
                                 "broadcast/pipe": 1}
        (blocks, micro) = got["errors"]
        assert blocks[0] == micro[0] == "ValueError"
        assert "pipeline stages" in blocks[1] and "microbatches" in micro[1]


def test_whisper_fixture_loads_and_transcribes_over_the_mesh(group):
    """The trained whisper_tiny fixture (bf16, int8 K/V) at data 2 x
    model 2: ``load_transcriber(mesh="2x2")`` and ``transcribe --mesh
    2x2`` give golden.json's text and the unsharded tokens; only rank 0
    prints."""
    for r in range(RANKS):
        got = _result(group, "whisper_fixture", r)
        assert got["texts"] == WHISPER_GOLDEN["sentences"]
        assert got["tokens"] == got["plain"]
        assert got["cli_rc"] == 0
        assert got["cli_texts"] == (WHISPER_GOLDEN["sentences"] if r == 0 else [])
