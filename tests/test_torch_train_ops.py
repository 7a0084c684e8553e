"""The port's training pieces against the JAX package's, on the same numpy
inputs:

* the flash attention gradient (dq, dk, dv through the port's
  ``FlashAttentionFunction``, the same Function the card runs) against
  ``jax.vjp`` of the JAX ``flash_attention`` (Pallas in interpret mode)
  within ``tests/test_ops.py``'s 1e-4, non-causal, causal and cross with
  padded keys;
* the optimizer (``train/optim.py``) against optax: the warmup-cosine
  schedule at every update within 1e-7 relative, and AdamW, Adafactor,
  MultiSteps over 2 mini-batches and the encoder freeze for 5 updates of
  the same gradients within 1e-6 relative;
* the files: the msgpack codec reads the ``whisper_tiny`` params leaf for
  leaf as flax does and writes the same bytes; ``save_params`` output
  read by the JAX ``load_params``; a checkpoint of the JAX package refused;
  LoRA adapters and their merge; the augmentation's audio for a seed;
* the losses: ``masked_ce_loss``, ``distill_kl_loss`` and the masked
  agreement within 1e-5.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yoho_tpu.ops.flash_attention import flash_attention as jax_flash
from yoho_tpu.train import checkpoint as jck
from yoho_tpu_torch.ops import flash_attention as tfa
from yoho_tpu_torch.train import checkpoint as tck
from yoho_tpu_torch.train import msgpack as tmp_codec
from yoho_tpu_torch.train import optim

FIXTURE = Path(__file__).parent / "fixtures" / "whisper_tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------ flash gradient
@pytest.mark.parametrize("case", ["self", "causal", "cross_padded", "gqa_causal"])
def test_flash_gradient_matches_jax_vjp(case):
    """dq, dk, dv of a weighted sum of the output; the padded cross case
    masks keys from ``kv_len`` on in the port and hands JAX the first
    ``kv_len`` keys (the masked keys get zero gradient). The grouped case
    gives the port 2 KV heads for 6 query heads and JAX their repeated
    copies (``jnp.repeat`` inside the differentiated function): dk and dv
    come back in the unrepeated shape, summed over each group."""
    g = np.random.default_rng(3)
    b, h, d = 2, 2, 64
    tq, tk, kv_len = {"self": (160, 160, None), "causal": (160, 160, None),
                      "cross_padded": (96, 200, 150), "gqa_causal": (160, 160, None)}[case]
    causal = case in ("causal", "gqa_causal")
    hkv = h
    if case == "gqa_causal":
        h, hkv, d = 6, 2, 32
    q = g.standard_normal((b, tq, h, d)).astype(np.float32)
    k, v = (g.standard_normal((b, tk, hkv, d)).astype(np.float32) for _ in range(2))
    w = g.standard_normal((b, tq, h, d)).astype(np.float32)
    n = tk if kv_len is None else kv_len

    def jax_loss(q, k, v):
        k, v = (jnp.repeat(x, h // hkv, axis=2) for x in (k, v))
        out = jax_flash(q, k, v, causal=causal, block_q=128, block_k=128)
        return jnp.sum(out * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]))
    leaves = [_t(x, True) for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, kv_len=kv_len)
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(torch.sum(out * _t(w)), leaves)
    for name, a, b_ in zip("qkv", got, want):
        a = a.numpy()
        np.testing.assert_allclose(a[:, :n] if name != "q" else a, np.asarray(b_),
                                   atol=2e-5 if case == "gqa_causal" else 1e-4,
                                   err_msg=f"d{name}")
        if name != "q":
            assert not a[:, n:].any(), f"masked keys got a d{name}"


def test_flash_without_gradient_keeps_the_plain_call():
    """No input requires a gradient: the forward is the plain call, with
    no autograd node."""
    x = torch.randn(1, 8, 2, 16)
    assert tfa.flash_attention(x, x, x).grad_fn is None
    with torch.no_grad():
        assert tfa.flash_attention(x.requires_grad_(True), x, x).grad_fn is None


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("warmup,total,final", [(0, 5, 0.0), (2, 6, 1e-7), (10, 120, 1e-7),
                                                (50, 1000, 1e-7)])
def test_schedule_matches_optax(warmup, total, final):
    ours = optim.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, total, final)
    ref = optax.schedules.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, total, final)
    for count in range(total + 3):
        want = float(ref(count))
        assert ours(count) == pytest.approx(want, rel=1e-7, abs=1e-12), count
    assert ours(0) == 0.0 if warmup else True


def _tree():
    """A params tree with every factoring case of Adafactor: a factored
    (in, out) kernel of each orientation, a conv kernel, a square kernel,
    a small unfactored one, biases and a LayerNorm scale."""
    g = np.random.default_rng(5)
    shapes = {"encoder": {"conv1": {"kernel": (3, 16, 160), "bias": (160,)},
                          "ln": {"scale": (160,), "bias": (160,)}},
              "decoder": {"fc1": {"kernel": (160, 256), "bias": (256,)},
                          "fc2": {"kernel": (256, 130)},
                          "sq": {"kernel": (144, 144)},
                          "small": {"kernel": (8, 96)}}}

    def make(node):
        return {k: make(v) if isinstance(v, dict) else
                (g.standard_normal(v) * 0.1).astype(np.float32) for k, v in node.items()}
    return make(shapes)


@pytest.mark.parametrize("name,freeze", [("adamw", False), ("adafactor", False),
                                         ("adamw", True)])
def test_optimizer_matches_optax(name, freeze):
    """5 updates of MultiSteps(2) over the same 10 gradient trees."""
    params = _tree()
    g = np.random.default_rng(11)
    grads = [jax.tree_util.tree_map(lambda p: (g.standard_normal(p.shape) * 0.01)
                                    .astype(np.float32), params) for _ in range(10)]
    sched = optax.schedules.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-7)
    inner = optax.adamw(sched) if name == "adamw" else optax.adafactor(sched)
    if freeze:
        inner = optax.multi_transform(
            {"train": inner, "freeze": optax.set_to_zero()},
            param_labels=lambda p: {k: "freeze" if k == "encoder" else "train" for k in p})
    tx = optax.MultiSteps(inner, 2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)

    @jax.jit
    def step(gr, state, jp):
        upd, state = tx.update(gr, state, jp)
        return state, optax.apply_updates(jp, upd)

    for gr in grads:
        state, jp = step(jax.tree_util.tree_map(jnp.asarray, gr), state, jp)

    ours_sched = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-7)
    ours_inner = optim.AdamW(ours_sched) if name == "adamw" else optim.Adafactor(ours_sched)
    ours = optim.MultiSteps(ours_inner, 2)
    leaves = {"/".join(k): _t(v) for k, v in _flat(params)}
    frozen = (lambda k: k.startswith("encoder/")) if freeze else (lambda k: False)
    trained = optim.trainable(leaves, frozen)
    st = ours.init(trained)
    emitted = 0
    for gr in grads:
        flat = {"/".join(k): _t(v) for k, v in _flat(gr)}
        upd = ours.update({k: flat[k] for k in trained}, st, trained)
        if upd is not None:
            optim.apply_updates(trained, upd)
            emitted += 1
    assert emitted == 5 and st["gradient_step"] == 5 and st["format"] == optim.STATE_FORMAT
    for k, want in _flat(jax.device_get(jp)):
        got = leaves["/".join(k)].numpy()
        want = np.asarray(want)
        if frozen("/".join(k)):
            assert np.array_equal(got, params[k[0]][k[1]][k[2]]), k
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale, err_msg=str(k))


# ------------------------------------------------------------ files
def _fixture_bytes():
    return (FIXTURE / "params.msgpack").read_bytes()


def test_codec_reads_the_fixture_as_flax_does_and_writes_its_bytes():
    from flax import serialization

    raw = _fixture_bytes()
    ours, ref = tmp_codec.loads(raw), serialization.msgpack_restore(raw)
    a, b = dict(_flat(ours)), dict(_flat(ref))
    assert a.keys() == b.keys()
    for k in a:
        assert str(a[k].dtype).replace("torch.", "") == str(b[k].dtype), k
        assert np.array_equal(_f32(a[k]), np.asarray(b[k], np.float32)), k
    assert tmp_codec.dumps(ours) == raw
    tree = {"step": 7, "neg": -70000, "big": 2 ** 40, "f": 1.5, "s": "x" * 40, "n": None,
            "b": True, "l": [1, [2, 3]], "i8": np.arange(6, dtype=np.int8).reshape(2, 3),
            "scalar": np.float32(2.5)}
    assert tmp_codec.dumps(tree) == serialization.msgpack_serialize(tree)
    back = tmp_codec.loads(serialization.msgpack_serialize(tree))
    assert back["l"] == [1, [2, 3]] and back["scalar"] == np.float32(2.5)
    assert np.array_equal(back["i8"], tree["i8"])


def test_codec_chunks_leaves_as_flax(monkeypatch):
    """A leaf over the chunk size writes flax's chunked form; flax and the
    port read each other's chunked files."""
    from flax import serialization

    monkeypatch.setattr(tmp_codec, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(50, dtype=np.float32).reshape(5, 10)}
    assert tmp_codec.dumps(tree) == serialization.msgpack_serialize(tree)
    assert np.array_equal(tmp_codec.loads(serialization.msgpack_serialize(tree))["w"], tree["w"])


def test_save_params_is_read_by_the_jax_package(tmp_path):
    tree = tmp_codec.loads(_fixture_bytes())
    path = tmp_path / "params.msgpack"
    tck.save_params(path, tree)
    template = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                      {k: v for k, v in _f32_tree(tree).items()})
    got = jck.load_params(path, template)
    for k, v in _flat(tree):
        assert np.array_equal(np.asarray(dict(_flat(got))[k], np.float32), _f32(v)), k
    assert tck.load_params(tmp_path / "absent.msgpack") is None
    back = tck.load_params(path, _f32_tree(tree))
    assert dict(_flat(back)).keys() == dict(_flat(tree)).keys()
    # As flax's from_state_dict: saved keys the template lacks are ignored,
    # a template key the saved tree lacks raises.
    assert tck.load_params(path, {"encoder": {}}) == {"encoder": {}}
    with pytest.raises(ValueError, match="keys"):
        tck.load_params(path, {"encoder": {}, "absent": {}})


def _f32_tree(tree):
    return {k: _f32_tree(v) if isinstance(v, dict) else _f32(v) for k, v in tree.items()}


def test_checkpoints_resume_only_in_their_own_package(tmp_path):
    params = {"a": {"kernel": np.ones((2, 3), np.float32)}}
    jck.save_checkpoint(tmp_path / "jax.msgpack", 3, params,
                        optax.adamw(1e-3).init(jax.tree_util.tree_map(jnp.asarray, params)))
    with pytest.raises(ValueError, match="not written by the PyTorch port"):
        tck.load_checkpoint(tmp_path / "jax.msgpack", params)
    opt = optim.MultiSteps(optim.AdamW(lambda c: 1e-3), 2)
    leaves = {"a/kernel": torch.ones(2, 3)}
    state = opt.init(leaves)
    tck.save_checkpoint(tmp_path / "port.msgpack", 5, params, state)
    step, got, saved = tck.load_checkpoint(tmp_path / "port.msgpack", params)
    assert step == 5 and np.array_equal(got["a"]["kernel"], params["a"]["kernel"])
    assert saved["format"] == optim.STATE_FORMAT and saved["mini_step"] == 0
    with pytest.raises(ValueError):  # flax refuses the port's optimizer state
        jck.load_checkpoint(tmp_path / "port.msgpack", params,
                            optax.adamw(1e-3).init(jax.tree_util.tree_map(jnp.asarray, params)))


def test_async_checkpointer_writes_the_newest_and_joins(tmp_path):
    ck = tck.AsyncCheckpointer(tmp_path / "c.msgpack")
    state = {"format": optim.STATE_FORMAT, "x": torch.zeros(2)}
    for step in range(1, 4):
        ck.save(step, {"w": torch.full((2,), float(step))}, state)
    ck.close()
    assert not ck._thread.is_alive()
    step, params, _ = tck.load_checkpoint(tmp_path / "c.msgpack", {"w": np.zeros(2)})
    assert step == 3 and np.array_equal(params["w"], [3.0, 3.0])
    assert not (tmp_path / "c.msgpack.tmp").exists()


# ------------------------------------------------------------ LoRA
@pytest.fixture(scope="module")
def tiny_tree():
    return _f32_tree(tmp_codec.loads(_fixture_bytes()))


def test_lora_targets_merge_and_files_match_jax(tiny_tree, tmp_path):
    from yoho_tpu.nn import lora as jl
    from yoho_tpu_torch.nn import lora as tl

    assert tl.select_lora_targets(tiny_tree) == sorted(jl.select_lora_targets(tiny_tree))
    adapters = jax.device_get(jl.init_lora(jax.random.PRNGKey(0), tiny_tree, 4))
    g = np.random.default_rng(2)
    adapters = {p: {"a": ab["a"], "b": (g.standard_normal(ab["b"].shape) * 0.1)
                    .astype(np.float32)} for p, ab in adapters.items()}
    want = jax.device_get(jl.merge_lora(tiny_tree, adapters, jl.lora_scale(4)))
    got = tl.merge_lora(tiny_tree, adapters, tl.lora_scale(4))
    for k, v in _flat(want):
        np.testing.assert_allclose(dict(_flat(got))[k], np.asarray(v), rtol=0, atol=1e-6)
    # The adapter files are the same both ways.
    tl.save_adapter(tmp_path / "port", adapters, rank=4, alpha=None, targets=tl.DEFAULT_TARGETS)
    jl.save_adapter(tmp_path / "jax", adapters, rank=4, alpha=None, targets=jl.DEFAULT_TARGETS)
    assert (tmp_path / "port" / tl.ADAPTER_FILE).read_bytes() == \
        (tmp_path / "jax" / jl.ADAPTER_FILE).read_bytes()
    assert json.loads((tmp_path / "port" / tl.ADAPTER_META_FILE).read_text()) == \
        json.loads((tmp_path / "jax" / jl.ADAPTER_META_FILE).read_text())
    merged = tl.apply_adapter(tiny_tree, tmp_path / "jax")
    for k, v in _flat(want):
        np.testing.assert_allclose(dict(_flat(merged))[k], np.asarray(v), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="matched no"):
        tl.select_lora_targets(tiny_tree, "nothing_here$")


def test_lora_parametrization_merges_in_the_module(tiny_tree):
    """``attach_lora`` on a model gives the merged weights of
    ``merge_lora`` on its tree, leaves the base untouched, and gradients
    reach only the adapters."""
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.nn import lora as tl
    from yoho_tpu_torch.nn.params import load_jax_params, to_jax_params
    from yoho_tpu_torch.nn.whisper import Whisper

    cfg = WhisperConfig(**json.loads((FIXTURE / "config.json").read_text()))
    model = load_jax_params(Whisper(cfg, device="cpu"), tiny_tree)
    assert to_jax_params(model).keys() == tiny_tree.keys()
    for k, v in _flat(to_jax_params(model)):
        assert np.array_equal(v, dict(_flat(tiny_tree))[k]), k
    gen = torch.Generator().manual_seed(0)
    adapters = tl.init_lora(gen, model, 2)
    for ab in adapters.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.1
    leaves = tl.attach_lora(model, adapters, tl.lora_scale(2))
    want = tl.merge_lora(tiny_tree, {p: {k: t.numpy() for k, t in ab.items()}
                                     for p, ab in adapters.items()}, tl.lora_scale(2))
    for k, v in _flat(to_jax_params(model)):
        np.testing.assert_allclose(v, dict(_flat(want))[k], rtol=0, atol=1e-6, err_msg=str(k))
    mel = torch.randn(1, cfg.n_frames, cfg.n_mels)
    loss = model(mel, torch.tensor([[1, 2, 3]])).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert any(bool(g.abs().sum() > 0) for g in grads)
    assert not any(p.requires_grad for n, p in model.named_parameters()
                   if "parametrizations.weight.original" in n or ".a" not in n and ".b" not in n
                   and "parametrizations" not in n)
    tl.detach_lora(model)
    for k, v in _flat(to_jax_params(model)):
        assert np.array_equal(v, dict(_flat(tiny_tree))[k]), k


# ------------------------------------------------------------ augment, losses
def test_augmenter_gives_the_jax_packages_audio_for_a_seed():
    from yoho_tpu.audio.augment import augmenter as jax_aug
    from yoho_tpu_torch.audio.augment import augmenter

    audio = (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(np.float32)
    for seed in range(6):
        a = augmenter(audio.copy(), 16000, np.random.default_rng(seed))
        b = jax_aug(audio.copy(), 16000, np.random.default_rng(seed))
        assert a.dtype == b.dtype and np.array_equal(a, b), seed


def test_losses_match_jax():
    from yoho_tpu.train.distill import distill_kl_loss as jax_kl
    from yoho_tpu.train.trainer import masked_ce_loss as jax_ce
    from yoho_tpu_torch.train.distill import distill_kl_loss, masked_agreement
    from yoho_tpu_torch.train.trainer import masked_ce_loss

    g = np.random.default_rng(4)
    t_logits = (g.standard_normal((3, 12, 300)) * 3).astype(np.float32)
    s_logits = (g.standard_normal((3, 12, 300)) * 3).astype(np.float32)
    s_logits[0, :4] = t_logits[0, :4]  # some agreement
    tokens = g.integers(0, 300, (3, 12)).astype(np.int32)
    mask = (g.uniform(size=(3, 12)) < 0.7).astype(np.uint8)
    ce = float(masked_ce_loss(_t(s_logits), torch.from_numpy(tokens), torch.from_numpy(mask)))
    assert ce == pytest.approx(float(jax_ce(s_logits, tokens, mask)), rel=1e-5)
    for tau in (1.0, 2.0):
        kl = float(distill_kl_loss(_t(t_logits), _t(s_logits), torch.from_numpy(mask), tau))
        assert kl == pytest.approx(float(jax_kl(t_logits, s_logits, mask, tau)), rel=1e-5)
    same = np.argmax(t_logits[:, :-1], -1) == np.argmax(s_logits[:, :-1], -1)
    m = mask[:, 1:].astype(np.float32)
    want = float((same * m).sum() / max(m.sum(), 1.0))
    got = float(masked_agreement(_t(t_logits), _t(s_logits), torch.from_numpy(mask)))
    assert got == pytest.approx(want, abs=1e-6)
    empty = np.zeros_like(mask)
    assert float(masked_ce_loss(_t(s_logits), torch.from_numpy(tokens),
                                torch.from_numpy(empty))) == 0.0
