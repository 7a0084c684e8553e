"""The port's mesh helpers and partition rules against the JAX package's,
in this process (a group of one; the multi-rank paths are
``tests/test_torch_parallel.py``).

``parse_mesh`` takes the JAX package's specs and raises its errors;
``partition_specs`` gives the JAX table (with ``_mesh_fit``) on the same
trees, for whisper (odd and even vocabularies, the int8 lanes), YOHO with
3 KV heads and MoE YOHO, and the port's own model paths map to the same
specs; the pipelined encoder's stacking round-trips as JAX's; at a mesh of
one a sharded Transcriber decodes the unsharded tokens with the predicted
collectives; the capacity model takes the mesh axes.
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxWhisperConfig
from yoho_tpu.core.config import YOHOConfig as JaxYOHOConfig
from yoho_tpu.nn.quantize import quantize_whisper_decoder, quantize_whisper_encoder
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.nn.yoho import YOHOModel as JaxYOHO
from yoho_tpu.parallel import mesh as jax_mesh
from yoho_tpu.parallel import pipeline as jax_pipeline
from yoho_tpu.parallel import sharding as jax_sharding
from yoho_tpu_torch.core.config import WhisperConfig, YOHOConfig
from yoho_tpu_torch.nn.params import init_random
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.nn.yoho import YOHOModel
from yoho_tpu_torch.parallel import mesh as pm
from yoho_tpu_torch.parallel import pipeline as port_pipeline
from yoho_tpu_torch.parallel import sharding

WHISPER = dict(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=4, n_audio_layer=2,
               n_vocab=64, n_text_ctx=16, n_text_state=32, n_text_head=4, n_text_layer=2)
YOHO_KV3 = dict(n_mel_bands=8, max_audio_len=32, max_text_len=8, dims=48, n_audio_heads=6,
                n_audio_blocks=2, n_text_heads=6, n_text_blocks=2)
YOHO_MOE = dict(n_mel_bands=8, max_audio_len=32, max_text_len=8, dims=32, n_audio_heads=4,
                n_audio_blocks=2, n_text_heads=4, n_text_blocks=2, n_experts=4,
                moe_every_n=2, moe_in_decoder=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield "/".join(prefix + (str(k),)), v


def _shapes(init, *args):
    """A params tree of zeros from ``jax.eval_shape`` (no compile)."""
    tree = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)


def _jax_trees():
    w = JaxWhisper(JaxWhisperConfig(**WHISPER))
    mel, tok = jnp.zeros((1, 32, 8), jnp.float32), jnp.zeros((1, 4), jnp.int32)
    whisper = _shapes(w.init, mel, tok)
    odd = _shapes(JaxWhisper(JaxWhisperConfig(**dict(WHISPER, n_vocab=51865))).init, mel, tok)
    int8 = quantize_whisper_encoder(quantize_whisper_decoder({"params": whisper}))["params"]
    trees = dict(whisper=whisper, whisper_51865=odd, whisper_int8=jax.device_get(int8))
    for name, cfg in (("yoho_kv3", YOHO_KV3), ("yoho_moe", YOHO_MOE)):
        m = JaxYOHO(JaxYOHOConfig(**cfg), vocab_size=300, voiceprint_dim=16)
        trees[name] = _shapes(partial(m.init, method=JaxYOHO.forward_with_voiceprints),
                              jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 32, 8)))
    return trees


TREES = _jax_trees()


@pytest.mark.parametrize("model", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(TREES))
def test_partition_specs_equal_the_jax_table(name, model):
    """The same rules, rank fit and mesh fallback as the JAX package: whisper's
    51,865-row embedding and YOHO's 3 KV heads stay replicated on an even
    model axis, the int8 leaves match no sharding rule."""
    tree = TREES[name]
    jmesh = jax_mesh.make_mesh(data=1, model=model, devices=jax.devices()[:model])
    want = dict(_flat(jax_sharding.partition_specs(tree, mesh=jmesh)))
    got = dict(_flat(sharding.partition_specs(tree, mesh=SimpleNamespace(
        shape={"data": 1, "model": model}))))
    assert sorted(got) == sorted(want)
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    unfitted = dict(_flat(jax_sharding.partition_specs(tree)))
    assert {k: tuple(v) for k, v in _flat(sharding.partition_specs(tree))} == \
        {k: tuple(v) for k, v in unfitted.items()}
    if name == "yoho_kv3" and model == 2:
        assert tuple(got["decoder/blocks_0/attn/k_proj/kernel"]) == ()
        assert tuple(got["decoder/blocks_0/attn/q_proj/kernel"]) == (None, "model")
    if name == "whisper_51865" and model == 2:
        assert tuple(got["decoder/token_embedding/embedding"]) == ()


@pytest.mark.parametrize("name", ["whisper", "yoho_kv3", "yoho_moe"])
def test_port_model_paths_give_the_jax_specs(name):
    """``model_specs`` reads the port model's own parameters (their flax
    paths and JAX-layout shapes) and gives the JAX table of the same
    model."""
    if name == "whisper":
        model = Whisper(WhisperConfig(**WHISPER), device="cpu")
    else:
        cfg = YOHOConfig(**(YOHO_KV3 if name == "yoho_kv3" else YOHO_MOE))
        model = YOHOModel(cfg, 300, 16, device="cpu")
    jmesh = jax_mesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    want = {k: tuple(v) for k, v in _flat(jax_sharding.partition_specs(TREES[name],
                                                                        mesh=jmesh))}
    got = sharding.model_specs(model, SimpleNamespace(shape={"data": 1, "model": 2}))
    assert {k: tuple(v) for k, v in got.items()} == want


def test_parse_mesh_specs_and_errors_at_a_world_of_one():
    """The JAX package's spec grammar and error messages, at the one
    process of a run without a launcher."""
    assert dict(pm.parse_mesh("1x1", "cpu").shape) == {"data": 1, "model": 1}
    assert dict(pm.parse_mesh("-1x1", "cpu").shape) == {"data": 1, "model": 1}
    for spec in ("8", "2x2x2", "ax1"):
        with pytest.raises(ValueError) as got:
            pm.parse_mesh(spec, "cpu")
        with pytest.raises(ValueError) as want:
            jax_mesh.parse_mesh(spec)
        assert str(got.value) == str(want.value) and "DATAxMODEL" in str(got.value)
    with pytest.raises(ValueError, match="^model axis size 3 does not divide device count 1$"):
        pm.parse_mesh("3x3", "cpu")
    with pytest.raises(ValueError, match=r"^mesh 2x1 != 1 devices$"):
        pm.parse_mesh("2x1", "cpu")
    with pytest.raises(TypeError, match="must be a yoho_tpu_torch.parallel.mesh.Mesh"):
        pm.as_mesh(object())
    mesh = pm.make_mesh(device="cpu")
    assert pm.as_mesh(mesh) is mesh and pm.as_mesh("1x1", "cpu") is mesh
    assert pm.process_shard() == (0, 1) and pm.is_coordinator()
    pm.reset_counts()
    pm.barrier("probe")
    assert pm.COUNTS == {"barrier/probe": 1}
    assert pm.local_batch_size(4) == 4
    x = np.arange(6).reshape(3, 2)
    rows = pm.shard_batch(mesh, {"a": x, "b": [x]})
    np.testing.assert_array_equal(rows["b"][0], x)
    host = pm.fetch_to_host(mesh, {"w": torch.ones(2, 3)}, {"w": sharding.P(None, "model")})
    np.testing.assert_array_equal(host["w"], np.ones((2, 3)))


def test_stack_and_unstack_round_trip_as_jax():
    """``stack_block_params`` equals the JAX package's on a flax encoder
    tree and round-trips, on numpy leaves and on tensors; a stack mixing
    dense and MoE blocks is refused."""
    enc = jax.tree_util.tree_map(
        lambda z: np.random.default_rng(z.size).standard_normal(z.shape).astype(np.float32),
        TREES["yoho_kv3"]["encoder"])
    got = port_pipeline.stack_block_params(enc, 2)
    want = jax.device_get(jax_pipeline.stack_block_params(enc, 2))
    assert sorted(k for k, _ in _flat(got)) == sorted(k for k, _ in _flat(want))
    for k, v in _flat(want):
        np.testing.assert_array_equal(dict(_flat(got))[k], np.asarray(v), err_msg=k)
    back = dict(_flat(port_pipeline.unstack_block_params(got, 2)))
    assert back.keys() == {k for k, _ in _flat(enc) if k.startswith("blocks_")}
    for k, v in back.items():
        np.testing.assert_array_equal(v, dict(_flat(enc))[k])
    tensors = jax.tree_util.tree_map(torch.from_numpy, enc)
    stacked = port_pipeline.stack_block_params(tensors, 2)
    assert all(isinstance(v, torch.Tensor) and v.shape[0] == 2 for _, v in _flat(stacked))
    with pytest.raises(ValueError, match="homogeneous"):
        port_pipeline._check_homogeneous(YOHOConfig(**YOHO_MOE))


def test_mesh_of_one_decodes_the_unsharded_tokens_with_the_predicted_collectives():
    """``Transcriber(mesh="1x1")`` on the int8 lanes: the unsharded tokens,
    the sharded layers holding every head, and the collectives the design
    predicts: per batch 2 all-reduces a block for the encoder and one data
    gather per result array; per decode step 3 a layer (self, cross, MLP)
    and, as 51,865 rows divide a model axis of 1, the sharded embedding's
    lookup reduce and logits gather."""
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    cfg = WhisperConfig(**dict(WHISPER, n_vocab=51865, chunk_seconds=0.32))

    def build():
        return init_random(Whisper(cfg, device="cpu"), seed=0, std=0.3)

    audio = (0.1 * np.random.default_rng(1).standard_normal(cfg.n_samples * 2)
             ).astype(np.float32)
    kw = dict(token_table=WhisperTokenTable(multilingual=True), batch_size=2,
              quantized_cross_kv="int8", quantized_cache=True, device="cpu")
    want = Transcriber(build(), **kw).transcribe(audio)
    t = Transcriber(build(), mesh="1x1", **kw)
    assert t.mesh.shape == {"data": 1, "model": 1}
    steps, encodes = [], []
    step, encode = t.model.decode_step, t.model.encode_audio
    t.model.decode_step = lambda *a, **k: steps.append(1) or step(*a, **k)
    t.model.encode_audio = lambda *a, **k: encodes.append(1) or encode(*a, **k)
    pm.reset_counts()
    got = t.transcribe(audio)
    assert [s.tokens for s in got.segments] == [s.tokens for s in want.segments]
    assert t.model.decoder.blocks[0].attn.n_head == 4
    assert len(encodes) == 2  # 3 windows in batches of 2
    assert dict(pm.COUNTS) == {
        "all_reduce/model": (2 * cfg.n_audio_layer * len(encodes)
                             + (3 * cfg.n_text_layer + 1) * len(steps)),
        "all_gather/model": len(steps),
        # tokens, lengths, sum_logprob, no_speech_prob
        "all_gather/data": 4 * len(encodes)}
    with pytest.raises(ValueError, match="already sharded"):
        sharding.shard_params(t.model, SimpleNamespace(shape={"data": 1}))


def test_capacity_takes_the_mesh_axes():
    """The batch times ``data``; the analytic weights and the K/V terms
    over ``model`` (each rank holds its heads of the cross K/V and the
    cache), the audio, log-mel, encoder output and staging whole."""
    from yoho_tpu_torch.infer import capacity

    cfg = WhisperConfig(**dict(WHISPER, n_vocab=51865))
    base = dict(device_bytes=2 ** 31, weight_bytes=None, quantum=1, max_batch=10 ** 6)
    one = capacity.suggest_batch_size(cfg, **base)
    two = capacity.suggest_batch_size(cfg, data_shards=3, model_shards=2, **base)
    weights = 2 * capacity.whisper_param_count(cfg)
    terms = capacity.stream_terms(cfg)
    kv = terms["cross_kv"] + terms["self_cache"]
    rest = sum(terms.values()) - kv
    budget = 2 ** 31 - capacity.RESERVE_BYTES
    assert one == (budget - weights) // (kv + rest)
    assert two == 3 * ((budget - weights // 2) // (-(-kv // 2) + rest))


def test_yoho_session_at_a_mesh_of_one_counts_the_predicted_collectives():
    """The trained YOHO fixture through ``load_transcriber(mesh="1x1")``:
    the unsharded tokens, and per batch, with every attention, MLP and the
    vocabulary sharded over an axis of 1: the encoder's 2 all-reduces a
    block; per decode step 3 a block plus the embedding's lookup reduce
    and one logits gather; the teacher-forced voiceprint pass (decoder
    and embedding over the decode's encoder output; it makes no logits,
    so no gather) once; 4 data gathers from the decode and one from the
    voiceprint pass."""
    from pathlib import Path

    from yoho_tpu_torch.load import load_transcriber

    root = str(Path(__file__).parent / "fixtures" / "sessions")
    kw = dict(session="tiny", root=root, batch=3, device="cpu")
    want = load_transcriber(**kw)
    t = load_transcriber(mesh="1x1", **kw)
    rng = np.random.default_rng(2)
    clips = [(0.1 * rng.standard_normal(t.chunk_samples)).astype(np.float32)
             for _ in range(3)]
    steps = []
    step = t.model.decode_step
    t.model.decode_step = lambda *a, **k: steps.append(1) or step(*a, **k)
    pm.reset_counts()
    got = t.transcribe_many(clips)
    assert [[s.tokens for s in r.segments] for r in got] == \
        [[s.tokens for s in r.segments] for r in want.transcribe_many(clips)]
    cfg = t.model.cfg
    enc, dec = 2 * cfg.n_audio_blocks, 3 * cfg.n_text_blocks + 1
    assert dict(pm.COUNTS) == {"all_reduce/model": enc + dec * len(steps) + dec,
                               "all_gather/model": len(steps),
                               "all_gather/data": 5}
