"""The port's Mixture-of-Experts and its YOHO models at head dims 8, 32,
48, 96 and 128, against the JAX package's.

The same numpy inputs and the same flax params tree (carried across with
``load_jax_params``) go through both packages. Tolerances: ``moe_dispatch``
dispatch and ``kept`` equal, combine and aux loss at 1e-6; ``MoESwiGLU``
and the YOHO models' logits at 2e-4 in float32 (the bound
``tests/test_torch_yoho.py`` pins); the YOHO models in bfloat16 at a
relative error (norm of the difference over the norm) of 5e-2, the YOHO
family's bf16 logit tolerance of ``chip_smoke.py``'s e2e-yoho.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core import config as jcfg
from yoho_tpu.nn import moe as jmoe
from yoho_tpu.nn.yoho import YOHOModel as JaxYOHO
from yoho_tpu_torch.core import config as tcfg
from yoho_tpu_torch.nn import moe as tmoe
from yoho_tpu_torch.nn.params import init_random, load_jax_params, to_jax_params
from yoho_tpu_torch.nn.yoho import YOHOModel

ATOL = 2e-4
BF16_REL = 5e-2
VOCAB = 120
SMALL = dict(n_mel_bands=16, max_audio_len=32, max_text_len=12, dims=64,
             n_audio_heads=4, n_audio_blocks=2, n_text_heads=4, n_text_blocks=2)
# Every other block of both stacks is MoE (blocks_1), 4 experts, top-2.
MOE = dict(SMALL, n_experts=4, moe_in_decoder=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0)


def _jit(fn, **static):
    return jax.jit(lambda *a: fn(*a, **static))


# ---------------------------------------------------------------- dispatch

@pytest.mark.parametrize("top_k,capacity", [(1, 16), (2, 16), (1, 3), (2, 3)],
                         ids=["top1-ample", "top2-ample", "top1-tight", "top2-tight"])
def test_moe_dispatch_matches_jax(top_k, capacity):
    """Slots by token order, later choices after earlier ones, drops past
    capacity, Mixtral renormalization, the Switch loss and ``kept``."""
    logits = np.random.default_rng(top_k * 10 + capacity).standard_normal((3, 16, 4))
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1))
    want = jax.vmap(lambda g: jmoe.moe_dispatch(g, top_k, capacity))(jnp.asarray(gates))
    got = tmoe.moe_dispatch(_t(gates), top_k, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _close(got[1], want[1], 1e-6)
    _close(got[2], want[2], 1e-6)
    if capacity == 3:
        assert (got[3].numpy() < top_k).any()  # the tight case drops tokens


@pytest.fixture(scope="module")
def moe_layer():
    jm = jmoe.MoESwiGLU(n_experts=4, hidden_dim=48, top_k=2, capacity_factor=1.0)
    x = np.random.default_rng(1).standard_normal((3, 10, 32)).astype(np.float32)
    params = _np(_jit(jm.init)(jax.random.PRNGKey(2), x))["params"]
    tm = load_jax_params(tmoe.MoESwiGLU(32, 4, 48, top_k=2, capacity_factor=1.0), params)
    return jm, params, tm, x


def test_moe_swiglu_matches_jax_with_aux_and_drops(moe_layer):
    """The layer's output, its sown aux loss and dropped fraction, and the
    params round trip (router, stacked expert kernels in flax's layout)."""
    jm, params, tm, x = moe_layer
    out, st = jax.jit(lambda p, x: jm.apply({"params": p}, x, mutable=["intermediates"]))(
        params, x)
    with torch.no_grad():
        got = tm(_t(x))
    _close(got, out)
    inter = st["intermediates"]
    _close(tmoe.collect_aux_losses(tm), jmoe.collect_aux_losses(inter), 1e-6)
    assert tmoe.dropped_fraction(tm) == pytest.approx(
        float(inter["moe_dropped_fraction"][0]), abs=1e-6)
    assert tmoe.dropped_fraction(tm) > 0  # capacity factor 1 drops at top-2
    tree = to_jax_params(tm)
    assert tree["experts"]["gate"]["kernel"].shape == (4, 32, 48)
    for k in ("gate", "up", "down"):
        np.testing.assert_array_equal(tree["experts"][k]["kernel"], params["experts"][k]["kernel"])
    np.testing.assert_array_equal(tree["router"]["kernel"], params["router"]["kernel"])


def test_moe_is_batch_invariant_under_drops(moe_layer):
    """Per-sample capacity: a row's output does not depend on its batch,
    also where tokens are dropped."""
    _, _, tm, x = moe_layer
    with torch.no_grad():
        batched = tm(_t(x))
        for r in range(len(x)):
            _close(tm(_t(x[r:r + 1]))[0], batched[r].numpy(), 1e-6)


def test_collect_aux_losses_is_zero_without_moe():
    assert float(tmoe.collect_aux_losses(torch.nn.Linear(2, 2))) == 0.0


# ------------------------------------------------------------------ models

def _params(kw, seed):
    """Seeded random weights (the port's ``init_random``, std 0.1) as a flax
    params tree, and inputs: no JAX ``init`` to compile."""
    jc = jcfg.YOHOConfig(**kw)
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((2, jc.max_audio_len, jc.n_mel_bands)).astype(np.float32)
    tok = rng.integers(0, VOCAB, (2, jc.max_text_len)).astype(np.int32)
    model = YOHOModel(tcfg.YOHOConfig(**kw), VOCAB, 32, device="cpu")
    return to_jax_params(init_random(model, seed=seed, std=0.1)), mel, tok


def _models(kw, params, dtype=torch.float32, jdtype=jnp.float32):
    """The JAX and the port model of one flax params tree (f32 leaves)."""
    jm = JaxYOHO(jcfg.YOHOConfig(**kw), VOCAB, voiceprint_dim=32, dtype=jdtype)
    tm = load_jax_params(YOHOModel(tcfg.YOHOConfig(**kw), VOCAB, 32, dtype=dtype,
                                   device="cpu"), params)
    return jm, {"params": params}, tm


def _decode_steps(jm, v, tm, mel, tok, n=4):
    """JAX's and the port's cached steps (a 2-token prefill then single
    tokens): a list of (JAX logits, port logits) per step."""
    xa = _jit(jm.apply, method=JaxYOHO.encode_audio)(v, mel)
    jckv = _jit(jm.apply, method=JaxYOHO.cross_kvs)(v, xa)
    jcaches = jm.apply(v, 2, jnp.float32, method=JaxYOHO.init_caches)
    step = _jit(jm.apply, method=JaxYOHO.decode_step)
    out = []
    with torch.no_grad():
        txa = tm.encode_audio(_t(mel))
        tckv, tcaches = tm.cross_kvs(txa), tm.init_caches(2, torch.float32)
        for p0, p1 in [(0, 2)] + [(i, i + 1) for i in range(2, n)]:
            jl_, _, jcaches = step(v, tok[:, p0:p1], jcaches, jckv, p0)
            tl_, _, tcaches = tm.decode_step(_t(tok[:, p0:p1]).long(), tcaches, tckv, p0)
            out.append((np.asarray(jl_), tl_))
    return out


@pytest.fixture(scope="module")
def moe_yoho():
    params, mel, tok = _params(MOE, 8)
    return (*_models(MOE, params), mel, tok)


def test_moe_yoho_model_matches_jax(moe_yoho):
    """MoE in encoder and decoder: logits and voiceprints of the
    teacher-forced forward, the cached decode steps, and the cached steps
    equal to the teacher-forced forward (capacity S: no drops)."""
    jm, v, tm, mel, tok = moe_yoho
    assert isinstance(tm.encoder.blocks[1].mlp, tmoe.MoESwiGLU)
    assert isinstance(tm.decoder.blocks[1].mlp, tmoe.MoESwiGLU)
    logits, vp = _jit(jm.apply, method=JaxYOHO.forward_with_voiceprints)(v, tok, mel)
    with torch.no_grad():
        tlog, tvp = tm.forward_with_voiceprints(_t(tok).long(), _t(mel))
    _close(tlog, logits)
    _close(tvp, vp)
    steps = _decode_steps(jm, v, tm, mel, tok)
    for i, (want, got) in enumerate(steps):
        _close(got, want)
        pos = [0, 1] if i == 0 else [i + 1]
        _close(got, tlog[:, pos].numpy())


def test_moe_int8_and_speculative_refusals(moe_yoho):
    """An MoE decoder has no weight-only int8 lane and no speculative
    decoding, as in the JAX package; an MoE encoder alone keeps both."""
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.quantize import quantize_yoho_decoder

    _, _, tm, _, _ = moe_yoho
    with pytest.raises(ValueError, match="does not support MoE decoder blocks"):
        quantize_yoho_decoder(tm)
    with pytest.raises(ValueError, match="does not support MoE decoder blocks"):
        YOHOModel(tcfg.YOHOConfig(**MOE), VOCAB, weights_int8=True, device="cpu")
    with pytest.raises(ValueError, match="does not support moe_in_decoder"):
        Transcriber(tm, family="yoho", draft_model=tm, device="cpu")
    enc_only = YOHOModel(tcfg.YOHOConfig(**dict(MOE, moe_in_decoder=False)), VOCAB,
                         device="cpu")
    assert not isinstance(quantize_yoho_decoder(enc_only).decoder.blocks[1].mlp,
                          tmoe.MoESwiGLU)


def test_moe_capacity_counts_the_experts(moe_yoho):
    from yoho_tpu_torch.infer.capacity import yoho_param_count

    _, _, tm, _, _ = moe_yoho
    assert yoho_param_count(tm.cfg, VOCAB, 32) == sum(p.numel() for p in tm.parameters())


# ------------------------------------------- head dims 8, 32, 48, 96, 128, 264
# Every model has KV heads on half its query heads. 8 is the JAX package's
# tests' dims 32 on 4 heads; 48 and 96 run padded to the kernels' widths 64
# and 128 on the card, 264 (dims 528 on 2 heads over 1) in slices of 256.

HEAD_DIMS = {8: dict(SMALL, dims=32),
             32: dict(SMALL, n_audio_heads=2, n_text_heads=2),
             48: dict(SMALL, dims=96, n_audio_heads=2, n_text_heads=2),
             96: dict(SMALL, dims=192, n_audio_heads=2, n_text_heads=2),
             128: dict(SMALL, dims=256, n_audio_heads=2, n_text_heads=2),
             264: dict(SMALL, dims=528, n_audio_heads=2, n_text_heads=2)}


# The bf16 comparison stops at 128: at dims 528 bf16's rounding alone moves
# both packages' logits 8.5% (in norm) from their f32 ones, so two bf16
# models of the same weights differ by more than BF16_REL whatever the head
# dim; D = 264 is held in f32.
BF16_HEAD_DIMS = [d for d in sorted(HEAD_DIMS) if d <= 128]


@pytest.fixture(scope="module", params=sorted(HEAD_DIMS))
def head_dim(request):
    """One flax params tree per head dim, shared by the f32 and bf16 models."""
    d = request.param
    return (d, *_params(HEAD_DIMS[d], d))


def test_yoho_head_dims_32_and_128_match_jax_in_f32(head_dim):
    """Head dims whose scale is not a power of two (8, 32 to 128, and 264,
    past the kernels' widest width) on 4 query heads over 2 KV heads (D =
    8) or 2 over 1: the teacher-forced logits and the cached decode steps
    (a prefill and a step) at 2e-4."""
    d, params, mel, tok = head_dim
    jm, v, tm = _models(HEAD_DIMS[d], params)
    assert tm.decoder.blocks[0].attn.head_dim == d
    with torch.no_grad():
        got = tm(_t(tok).long(), _t(mel))
    _close(got, _jit(jm.apply)(v, tok, mel))
    for want, step in _decode_steps(jm, v, tm, mel, tok, n=3):
        _close(step, want)


@pytest.mark.parametrize("head_dim", BF16_HEAD_DIMS, indirect=True)
def test_yoho_head_dims_32_and_128_match_jax_in_bf16(head_dim):
    """bf16 models of the same weights: JAX scales q in bf16 before it
    attends, and so does the port at these head dims (all but 16 and 64)."""
    d, params, mel, tok = head_dim
    jm, v, tm = _models(HEAD_DIMS[d], params, torch.bfloat16, jnp.bfloat16)
    with torch.no_grad():
        got = tm(_t(tok).long(), _t(mel))
    want = np.asarray(_jit(jm.apply)(v, tok, mel), np.float32)
    assert got.dtype == torch.float32
    assert np.linalg.norm(got.numpy() - want) <= BF16_REL * np.linalg.norm(want)
