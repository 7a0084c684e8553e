"""The port's YOHO layers and models against the JAX package's.

The same numpy inputs and the same flax params tree (carried across with
``load_jax_params``) go through both packages, in f32, at atol 2e-4 (the
bound ``tests/test_torch_whisper.py`` pins): RMSNorm, SwiGLU, RoPE (both
variants, per-row tables), grouped-query attention in every mode
(``groups`` = 2), the ``YOHOModel`` (encoder, cached decode steps with
scalar and per-row positions, ``forward_with_voiceprints``,
``cross_attention_map``), the ``VoiceprintEncoder`` and ``nt_xent_loss``,
the params round trips and the session configuration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core import config as jcfg
from yoho_tpu.nn import layers as jl
from yoho_tpu.nn.voiceprint import VoiceprintEncoder as JaxVoiceprint
from yoho_tpu.nn.voiceprint import nt_xent_loss as jax_nt_xent
from yoho_tpu.nn.yoho import YOHOModel as JaxYOHO
from yoho_tpu_torch.core import config as tcfg
from yoho_tpu_torch.nn import layers as tl
from yoho_tpu_torch.nn.params import init_random, load_jax_params, to_jax_params
from yoho_tpu_torch.nn.voiceprint import VoiceprintEncoder, nt_xent_loss
from yoho_tpu_torch.nn.yoho import YOHOModel

ATOL = 2e-4
SMALL = dict(n_mel_bands=16, max_audio_len=32, max_text_len=12, dims=64,
             n_audio_heads=4, n_audio_blocks=2, n_text_heads=4, n_text_blocks=2)
VOCAB = 120


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jit(fn, **static):
    """``fn(*args, **static)`` compiled once: flax's op-by-op dispatch on
    the CPU costs seconds a call."""
    return jax.jit(lambda *a: fn(*a, **static))


# ------------------------------------------------------------------ layers

def test_rmsnorm_and_swiglu_match_flax():
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(np.float32)
    norm = jl.nn.RMSNorm()
    p = _np(norm.init(jax.random.PRNGKey(0), x))
    p["params"]["scale"] = np.random.default_rng(1).uniform(0.5, 1.5, 64).astype(np.float32)
    want = norm.apply(p, x)
    got = load_jax_params(tl.RMSNorm(64), p["params"])(_t(x))
    _close(got, want)
    mlp = jl.SwiGLU(96)
    p = _np(mlp.init(jax.random.PRNGKey(2), x))
    got = load_jax_params(tl.SwiGLU(64, 96), p["params"])(_t(x))
    _close(got, mlp.apply(p, x))


@pytest.mark.parametrize("variant", ["standard", "decade"])
def test_rope_matches_jax(variant):
    """Interleaved even/odd pairs, (S, D/2) and per-row (B, S, D/2) tables."""
    x = np.random.default_rng(3).standard_normal((2, 7, 4, 16)).astype(np.float32)
    for pos in (np.arange(7), np.asarray([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 15]])):
        jc, js = jl.rope_angles(jnp.asarray(pos), 16, variant)
        tc, ts = tl.rope_angles(_t(pos), 16, variant)
        _close(tc, jc, 1e-6)
        _close(ts, js, 1e-6)
        _close(tl.apply_rope(_t(x), tc, ts), jl.apply_rope(jnp.asarray(x), jc, js), 1e-5)
    with pytest.raises(ValueError, match="unknown rope variant"):
        tl.rope_angles(torch.arange(3), 16, "nope")


@pytest.fixture(scope="module")
def gqa():
    """A GQA layer of 4 query heads on 2 KV heads (groups 2), head dim 16,
    with random flax params, in both packages."""
    jm = jl.GroupedQueryAttention(q_heads=4, dims=64, kv_heads=2)
    x = np.random.default_rng(4).standard_normal((2, 6, 64)).astype(np.float32)
    xa = np.random.default_rng(5).standard_normal((2, 9, 64)).astype(np.float32)
    params = _np(_jit(jm.init)(jax.random.PRNGKey(6), x, xa))["params"]
    tm = load_jax_params(tl.GroupedQueryAttention(4, 64, 2), params)
    return jm, {"params": params}, tm, x, xa


def test_gqa_full_causal_and_cross(gqa):
    jm, v, tm, x, xa = gqa
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(v, x))
        _close(tm(_t(x), causal=True), jm.apply(v, x, mask=jl.causal_mask(6, 6)))
        _close(tm(_t(x), xa=_t(xa)), jm.apply(v, x, xa=xa))
        _close(tm.attention_map(_t(x), _t(xa)),
               jm.apply(v, x, xa, method=jl.GroupedQueryAttention.attention_map))


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "per_row_pos"])
def test_gqa_cached_self_and_cross(gqa, per_row):
    """The cached modes: a 3-token prefill then single steps of the self
    cache, and the rotated cross K/V read at the decode position."""
    from yoho_tpu.nn.kv_cache import KVCache as JaxCache
    from yoho_tpu_torch.nn.kv_cache import KVCache

    jm, v, tm, x, xa = gqa
    jcache = JaxCache.zeros(2, 2, 128, 16, jnp.float32)
    tcache = KVCache.zeros(2, 2, 128, 16, torch.float32)
    jkv = jm.apply(v, xa, method=jl.GroupedQueryAttention.kv)
    self_step = jax.jit(lambda v, x, c, p: jm.apply(v, x, cache=c, pos=p))
    cross_step = jax.jit(lambda v, x, kv, p: jm.apply(v, x, cross_kv=kv, pos=p))
    with torch.no_grad():
        tkv = tm.kv(_t(xa))
        for a, b in zip(tkv, jkv):
            _close(a, b)
        for p0, p1 in ((0, 3), (3, 4), (4, 5)):
            jp = jnp.asarray([p0, p0]) if per_row else p0
            tp = torch.tensor([p0, p0]) if per_row else p0
            jo, jcache = self_step(v, x[:, p0:p1], jcache, jp)
            to, tcache = tm(_t(x[:, p0:p1]), cache=tcache, pos=tp)
            _close(to, jo)
            _close(tm(_t(x[:, p0:p1]), cross_kv=tkv, pos=tp),
                   cross_step(v, x[:, p0:p1], jkv, jp))


def test_gqa_beam_folded_cross(gqa):
    """Beams (B*K query rows) against the untiled (B, ...) cross K/V fold
    into the query axis after the rotation."""
    jm, v, tm, x, xa = gqa
    xb = np.repeat(x[:, :1], 3, axis=0)  # 2 streams x 3 beams
    jkv = jm.apply(v, xa, method=jl.GroupedQueryAttention.kv)
    with torch.no_grad():
        got = tm(_t(xb), cross_kv=tm.kv(_t(xa)), pos=5)
    _close(got, jm.apply(v, xb, cross_kv=jkv, pos=5))


# ------------------------------------------------------------------ models

@pytest.fixture(scope="module")
def yoho():
    jc = jcfg.YOHOConfig(**SMALL)
    jm = JaxYOHO(jc, VOCAB, voiceprint_dim=32)
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, jc.max_audio_len, jc.n_mel_bands)).astype(np.float32)
    tok = rng.integers(0, VOCAB, (2, jc.max_text_len)).astype(np.int32)
    params = _np(_jit(jm.init, method=JaxYOHO.forward_with_voiceprints)(
        jax.random.PRNGKey(8), jnp.asarray(tok), jnp.asarray(mel)))["params"]
    tm = load_jax_params(YOHOModel(tcfg.YOHOConfig(**SMALL), VOCAB, 32, device="cpu"),
                         params)
    return jm, {"params": params}, tm, mel, tok


def test_yoho_encoder_voiceprints_and_alignment_match_jax(yoho):
    jm, v, tm, mel, tok = yoho
    xa = _jit(jm.apply, method=JaxYOHO.encode_audio)(v, mel)
    logits, vp = _jit(jm.apply, method=JaxYOHO.forward_with_voiceprints)(v, tok, mel)
    amap, probs = _jit(jm.apply, method=JaxYOHO.cross_attention_map, with_probs=True)(
        v, tok, xa)
    with torch.no_grad():
        txa = tm.encode_audio(_t(mel))
        tlog, tvp = tm.forward_with_voiceprints(_t(tok).long(), _t(mel))
        tamap, tprobs = tm.cross_attention_map(_t(tok).long(), txa, True)
        _close(txa, xa)
        _close(tm(_t(tok).long(), _t(mel)), _jit(jm.apply)(v, tok, mel))
    assert tlog.dtype == torch.float32 and txa.shape == (2, 16, 64)
    _close(tlog, logits)
    _close(tvp, vp)
    np.testing.assert_allclose(np.linalg.norm(tvp.numpy(), axis=-1), 1.0, atol=1e-5)
    _close(tamap, amap)
    _close(tprobs, probs)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "per_row_pos"])
def test_yoho_decode_steps_match_jax(yoho, per_row):
    """init_caches (a horizon aligned to 128) and decode_step: a 3-token
    prefill then single steps, logits and voiceprints."""
    jm, v, tm, mel, tok = yoho
    xa = _jit(jm.apply, method=JaxYOHO.encode_audio)(v, mel)
    jckv = _jit(jm.apply, method=JaxYOHO.cross_kvs)(v, xa)
    jcaches = jm.apply(v, 2, jnp.float32, method=JaxYOHO.init_caches)
    step = _jit(jm.apply, method=JaxYOHO.decode_step)
    with torch.no_grad():
        txa = tm.encode_audio(_t(mel))
        tckv, tcaches = tm.cross_kvs(txa), tm.init_caches(2, torch.float32)
        assert tcaches[0].k.shape == (2, 2, 16, 128)
        for p0, p1 in ((0, 3), (3, 4), (4, 5)):
            jp = jnp.asarray([p0, p0]) if per_row else p0
            tp = torch.tensor([p0, p0]) if per_row else p0
            jl_, jvp, jcaches = step(v, tok[:, p0:p1], jcaches, jckv, jp)
            tl_, tvp, tcaches = tm.decode_step(_t(tok[:, p0:p1]).long(), tcaches, tckv, tp)
            _close(tl_, jl_)
            _close(tvp, jvp)


def test_voiceprint_encoder_and_nt_xent_match_jax():
    jc = jcfg.YOHOConfig(**SMALL)
    jm = JaxVoiceprint(jc, embedding_dim=24)
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((3, jc.max_audio_len, jc.n_mel_bands)).astype(np.float32)
    mask = np.zeros((3, jc.max_audio_len), np.float32)
    mask[0, :20], mask[1, :7], mask[2] = 1, 1, 1
    params = _np(_jit(jm.init)(jax.random.PRNGKey(10), mel, mask))["params"]
    tm = load_jax_params(VoiceprintEncoder(tcfg.YOHOConfig(**SMALL), 24, device="cpu"), params)
    with torch.no_grad():
        _close(tm(_t(mel), _t(mask)), _jit(jm.apply)({"params": params}, mel, mask))
        emb = tm(_t(mel))
    _close(emb, _jit(jm.apply)({"params": params}, mel))
    ids = np.asarray([0, 1, 0])
    _close(nt_xent_loss(emb, _t(ids)), jax_nt_xent(jnp.asarray(emb.numpy()), jnp.asarray(ids)),
           1e-5)


def test_params_round_trip(yoho):
    """to_jax_params inverts load_jax_params for the YOHO model (the
    DenseGeneral (in, H, D) kernels, conv kernels, RMSNorm scales) and for
    its int8 decoder form; shapes and values exact."""
    from yoho_tpu_torch.nn.quantize import quantize_yoho_decoder

    _, v, tm, _, _ = yoho
    want = jax.tree_util.tree_leaves_with_path(v["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(tm)))
    assert {k for k, _ in want} == set(got)
    for k, w in want:
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k
    q = quantize_yoho_decoder(load_jax_params(
        YOHOModel(tcfg.YOHOConfig(**SMALL), VOCAB, 32, device="cpu"), v["params"]))
    tree = to_jax_params(q)
    assert tree["decoder"]["blocks_0"]["attn"]["q_proj"]["kernel_q"].shape == (64, 4, 16)
    again = load_jax_params(YOHOModel(tcfg.YOHOConfig(**SMALL), VOCAB, 32, weights_int8=True,
                                      device="cpu"), tree)
    for (k, a), (_, b) in zip(sorted(q.state_dict().items()),
                              sorted(again.state_dict().items())):
        assert torch.equal(a, b), k


# ------------------------------------------------------------------ config

def test_session_config_matches_jax(tmp_path):
    from pathlib import Path

    root = Path(__file__).parent / "fixtures" / "sessions"
    j, t = jcfg.load_session_config("tiny", root), tcfg.load_session_config("tiny", root)
    for f in ("yoho", "dataset", "hyperparameters", "weights", "mesh"):
        want = getattr(j, f).model_dump()
        got = _asdict(getattr(t, f))
        assert got == want, f
    assert (t.name, t.path, t.language_whitelist) == (j.name, j.path, j.language_whitelist)
    assert t.reroot_weights().weights.asr == j.weights.asr  # idempotent
    assert t.yoho.n_samples == j.yoho.n_samples and t.yoho.encoder_positions == 32
    d = tcfg.YOHOConfig()
    assert (d.n_samples, d.max_input_seconds, d.encoder_positions) == (164080, 10.255, 512)
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "config.toml").write_text(tcfg.DEFAULT_SESSION_TOML)
    assert _asdict(tcfg.load_session_config("s", tmp_path).hyperparameters) == \
        jcfg.load_session_config("s", tmp_path).hyperparameters.model_dump()
    (tmp_path / "s" / "config.toml").write_text('name = "x"\n')
    with pytest.raises(ValueError, match="reserved"):
        tcfg.load_session_config("s", tmp_path)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tcfg.load_session_config("missing", tmp_path)


@pytest.mark.parametrize("kw,match", [
    (dict(n_experts=4, moe_every_n=0), "moe_every_n must be >= 1"),
    (dict(n_experts=4, moe_top_k=5), r"moe_top_k \(5\) must be in"),
    (dict(n_experts=4, expert_capacity_factor=0), "expert_capacity_factor must be > 0"),
])
def test_moe_validation_raises_as_jax_and_the_model_refuses_experts(kw, match):
    """Invalid MoE settings raise in both packages; a valid MoE config now
    builds its experts in every moe_every_n-th encoder block
    (``tests/test_torch_moe.py`` holds the MoE model to JAX)."""
    from yoho_tpu_torch.nn.moe import MoESwiGLU

    with pytest.raises(ValueError, match=match):
        jcfg.YOHOConfig(**kw)
    with pytest.raises(ValueError, match=match):
        tcfg.YOHOConfig(**kw)
    m = YOHOModel(tcfg.YOHOConfig(**SMALL, n_experts=2), VOCAB, device="cpu")
    assert [type(b.mlp) is MoESwiGLU for b in m.encoder.blocks] == [False, True]
    assert not any(isinstance(b.mlp, MoESwiGLU) for b in m.decoder.blocks)


def test_init_random_is_seeded_and_unit_norms():
    a = init_random(YOHOModel(tcfg.YOHOConfig(**SMALL), VOCAB, 32, device="cpu"), seed=3)
    b = init_random(YOHOModel(tcfg.YOHOConfig(**SMALL), VOCAB, 32, device="cpu"), seed=3)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert torch.equal(a.decoder.ln.scale, torch.ones(64))
    assert torch.equal(a.encoder.conv1.bias, torch.zeros(64))


def _asdict(obj):
    from dataclasses import fields, is_dataclass

    if is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in fields(obj)}
    return obj
