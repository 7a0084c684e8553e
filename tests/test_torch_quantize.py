"""The port's int8 serving lanes against the JAX package's.

Same numpy inputs and weights through both packages:

* quantization codes and scales are bit-exact with ``quantize_dense_params``
  / ``quantize_embed_params``, and quantizing a port model gives the tensors
  ``load_jax_params`` carries across from the JAX-quantized tree;
* the plain ``w8a8_dense`` matches JAX's ``w8a8_dense`` (Pallas, interpret
  mode) and ``Int8Dense`` within ``tests/test_ops.py``'s tolerance: one
  weight step x max|x| x 1.1 (a 1-ulp scale difference can flip an int8
  round on an exact half), and >= 98% of bf16 outputs identical;
* the ``encoder_int8`` encoder output within ``tests/test_ops.py``'s
  rtol/atol 0.05, and the ``weights_int8`` f32 logits (teacher-forced and
  cached steps) at atol 2e-4 (``tests/test_torch_whisper.py``'s bound);
* the ``whisper_tiny`` goldens exact for ``encoder_int8`` and ``fast_gelu``,
  and the ``whisper_quality`` held-out WER of all six lanes equal to
  ``spec.json`` within 1e-4 (``tests/test_quality_fixture.py``).
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.decode import make_whisper_step_fn as jax_step_fn
from yoho_tpu.nn import quantize as jq
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.decode import make_whisper_step_fn
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.nn import quantize as tq
from yoho_tpu_torch.nn.layers import Int8Dense, QuantizedDense, quantize_act_rows
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.ops import w8a8_dense as w8
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

FIXTURES = Path(__file__).parent / "fixtures"
SMALL = dict(n_mels=8, n_audio_ctx=16, n_audio_state=128, n_audio_head=4,
             n_audio_layer=2, n_vocab=128, n_text_ctx=24, n_text_state=128,
             n_text_head=4, n_text_layer=2)


def _t(a, dtype=None):
    """A torch copy of a numpy array: torch never shares memory with an array
    that JAX was given or made."""
    t = torch.tensor(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------- codes


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(96, 384), (64, 32), (1280, 40)])
def test_quantize_params_bit_exact(dtype, shape):
    g = np.random.default_rng(11)
    kernel = g.standard_normal(shape).astype(np.float32) * 0.05
    # Exact halves: a column of absmax 127 has scale 1, so 2.5 and -3.5
    # round half to even.
    kernel[:4, 0] = [127.0, 2.5, -3.5, 0.5]
    kernel[:, 1] = 0.0  # an all-zero channel takes the 1e-12 floor
    bias = g.standard_normal(shape[1]).astype(np.float32)
    if dtype == "bf16":
        kernel = np.asarray(jnp.asarray(kernel, jnp.bfloat16), np.float32)
    want = jq.quantize_dense_params({"kernel": kernel, "bias": bias})
    got = tq.quantize_dense_params(_t(kernel.T), _t(bias))
    assert got["weight_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["weight_q"].numpy(), np.asarray(want["kernel_q"]).T)
    np.testing.assert_array_equal(got["weight_scale"].numpy(),
                                  np.asarray(want["kernel_scale"])[0])
    np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(want["bias"]))
    assert got["weight_q"][0, 1:4].tolist() == [2, -4, 0]

    emb = kernel.T  # (V, D): one scale per row
    want = jq.quantize_embed_params({"embedding": emb})
    got = tq.quantize_embed_params(_t(emb))
    np.testing.assert_array_equal(got["weight_q"].numpy(), np.asarray(want["embedding_q"]))
    np.testing.assert_array_equal(got["weight_scale"].numpy(),
                                  np.asarray(want["embedding_scale"])[:, 0])


def _small_params():
    cfg = JaxConfig(**SMALL)
    g = np.random.default_rng(0)
    mel = g.standard_normal((2, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)
    tokens = g.integers(0, cfg.n_vocab, size=(2, 5)).astype(np.int32)
    variables = JaxWhisper(cfg).init(jax.random.PRNGKey(0), jnp.asarray(mel),
                                     jnp.asarray(tokens))
    return jax.device_get(variables["params"]), mel, tokens


LANES = {"decoder": (dict(weights_int8=True), ("decoder",)),
         "encoder": (dict(encoder_int8=True), ("encoder",)),
         "both": (dict(weights_int8=True, encoder_int8=True), ("encoder", "decoder"))}


def _jax_quantized(params, parts):
    for part in parts:
        params = {"encoder": jq.quantize_whisper_encoder,
                  "decoder": jq.quantize_whisper_decoder}[part](params)
    return jax.device_get(params)


def _port_quantized(model, parts):
    for part in parts:
        {"encoder": tq.quantize_whisper_encoder,
         "decoder": tq.quantize_whisper_decoder}[part](model)
    return model


@pytest.mark.parametrize("lane", sorted(LANES))
def test_quantize_whisper_equals_loaded_jax_tree(lane):
    """Quantizing the port's float model gives, tensor for tensor and type
    for type, what ``load_jax_params`` makes of the JAX-quantized tree."""
    flags, parts = LANES[lane]
    params, _, _ = _small_params()
    got = _port_quantized(load_jax_params(
        Whisper(WhisperConfig(**SMALL), device="cpu"), params), parts)
    want = load_jax_params(Whisper(WhisperConfig(**SMALL), device="cpu", **flags),
                           _jax_quantized(params, parts))
    assert (got.weights_int8, got.encoder_int8) == (
        flags.get("weights_int8", False), flags.get("encoder_int8", False))
    a, b = got.state_dict(), want.state_dict()
    assert sorted(a) == sorted(b)
    n_int8 = 0
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        n_int8 += a[k].dtype == torch.int8
    assert n_int8 == {"decoder": 21, "encoder": 4, "both": 25}[lane]
    with pytest.raises(ValueError, match="quantized already"):
        _port_quantized(got, parts)


def test_load_jax_params_keeps_int8_and_refuses_floats_for_codes():
    params, _, _ = _small_params()
    q = _jax_quantized(params, ("decoder",))
    model = load_jax_params(Whisper(WhisperConfig(**SMALL), weights_int8=True,
                                    device="cpu"), q)
    fc1 = model.decoder.blocks[0].mlp.fc1
    assert isinstance(fc1, QuantizedDense) and fc1.weight_q.dtype == torch.int8
    np.testing.assert_array_equal(
        fc1.weight_q.numpy(), np.asarray(q["decoder"]["blocks_0"]["mlp"]["fc1"]["kernel_q"]).T)
    q["decoder"]["blocks_0"]["mlp"]["fc1"]["kernel_q"] = np.zeros(
        fc1.weight_q.T.shape, np.float32)
    with pytest.raises(TypeError, match="kernel_q"):
        load_jax_params(model, q)


# ---------------------------------------------------------------- w8a8


def _w8a8_inputs(k, n, m_shape, seed):
    g = np.random.default_rng(seed)
    kernel = g.standard_normal((k, n)).astype(np.float32) * 0.05
    bias = g.standard_normal((n,)).astype(np.float32)
    x = np.asarray(jnp.asarray(g.standard_normal((*m_shape, k)).astype(np.float32) * 0.7,
                               jnp.bfloat16), np.float32)
    return kernel, bias, x


def _tie_codes(x):
    """Per row of x (..., K), a mask of the int8 codes that a one-ulp change of
    the row's scale flips: the values on an exact half (x / xs = k + 1/2,
    common with bf16 inputs). Two compilations of the same quantization may
    disagree there and nowhere else (yoho_tpu/nn/layers.py, Int8Dense: "a
    1-ulp scale difference between compilations can flip an int8 round")."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float32)
    xs = np.maximum(np.abs(xf).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    lo, hi = np.nextafter(xs, np.float32(0)), np.nextafter(xs, np.float32(np.inf))
    codes = [np.clip(np.rint(xf / s), -127, 127) for s in (lo, xs, hi)]
    return (codes[0] != codes[1]) | (codes[2] != codes[1])


def _assert_w8a8_close(got, want, kernel, x, what):
    """tests/test_ops.py:302-311: one weight step x max|x| x 1.1 in f32, and
    >= 98% identical entries once both are rounded to bf16. A failure says
    which comparison, the largest error against its limit and the share of
    identical bf16 outputs."""
    step = (np.abs(kernel).max(axis=0) / 127.0).max()
    err = np.abs(got - want)
    limit = step * np.abs(x).max() * 1.1 + 1e-5
    gb = np.asarray(jnp.asarray(got).astype(jnp.bfloat16), np.float32)
    wb = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)
    same = (gb == wb).mean()
    report = (f"{what}: max err {err.max():.6g} (limit {limit:.6g}) at "
              f"{np.unravel_index(err.argmax(), err.shape)}; {same:.6f} of the bf16 "
              "outputs identical (need > 0.98)")
    assert err.max() <= limit, report
    assert same > 0.98, report


def _w8a8_stages(x, w_q, w_scale, bias, activation):
    """The plain version's intermediate values, recomputed step by step:
    the row codes and scales, the float64 product, and the f32 output
    before and after the activation."""
    n, k = w_q.shape
    xq, xs = w8.quantize_rows(_t(x, torch.bfloat16).reshape(-1, k))
    acc = xq.double() @ w_q.double().T
    y = acc.float() * xs * w_scale.reshape(1, n).float()
    if bias is not None:
        y = y + bias.float()
    out = w8.gelu_tanh(y) if activation == "gelu_tanh" else y
    return dict(codes=xq, row_scales=xs, acc=acc, y=y, activated=out)


def _same_rounding(x, tp, activation, got, got_bf16, snapshot):
    """The bf16 output is the f32 output rounded once. A failure says how
    many outputs differ, where, their values, what a third call of each
    output type gives on the same inputs, and which intermediate value
    (the row codes and scales, the float64 product, the output before and
    after the activation) moves: each is recomputed twice from the inputs
    as they are and once from their copies taken before the first call
    (``snapshot``: a changed input means memory was written after the
    first call). The first call's output is held against the
    recomputation, with the rows and columns where it differs: a fault in
    a row's codes or scale shows along rows, one in the product scatters."""
    rounded = got.to(torch.bfloat16)
    diff = got_bf16 != rounded
    if not bool(diff.any()):
        return
    idx = [tuple(i) for i in diff.nonzero()[:8].tolist()]
    again = w8.w8a8_dense(_t(x, torch.bfloat16), tp["weight_q"], tp["weight_scale"],
                          tp["bias"], activation=activation, out_dtype=torch.float32)
    again_bf16 = w8.w8a8_dense(_t(x, torch.bfloat16), tp["weight_q"], tp["weight_scale"],
                               tp["bias"], activation=activation)
    now = [_w8a8_stages(x, tp["weight_q"], tp["weight_scale"], tp["bias"], activation)
           for _ in range(2)]
    before = _w8a8_stages(snapshot["x"], snapshot["weight_q"], snapshot["weight_scale"],
                          snapshot["bias"], activation)
    stages = [f"{name}: {'same' if torch.equal(a, now[1][name]) else 'differs'} twice, "
              f"{'same' if torch.equal(a, before[name]) else 'differs'} from the copies"
              for name, a in now[0].items()]
    off = got.reshape(now[0]["activated"].shape) != now[0]["activated"]
    rows, cols = off.any(dim=1).nonzero().flatten(), off.any(dim=0).nonzero().flatten()
    unchanged = {k: bool(torch.equal(v, snapshot[k])) for k, v in tp.items()}
    unchanged["x"] = bool(np.array_equal(x, snapshot["x"]))
    raise AssertionError(
        f"out_dtype: {int(diff.sum())} of {diff.numel()} bf16 outputs differ from the "
        f"f32 output rounded, at {idx}: f32 {[float(got[i]) for i in idx]}, bf16 "
        f"{[float(got_bf16[i]) for i in idx]}; a third call: f32 "
        f"{[float(again[i]) for i in idx]} (equal to the first everywhere: "
        f"{bool(torch.equal(again, got))}), bf16 {[float(again_bf16[i]) for i in idx]} "
        f"(equal to the second everywhere: {bool(torch.equal(again_bf16, got_bf16))}); "
        f"recomputed stages: {'; '.join(stages)}; the first call's output differs from "
        f"the recomputation at {int(off.sum())} outputs, in {len(rows)} rows "
        f"{rows[:8].tolist()} and {len(cols)} columns {cols[:8].tolist()}; inputs equal "
        f"to their copies from before the first call: {unchanged}; "
        f"torch threads {torch.get_num_threads()}")


@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
@pytest.mark.parametrize("n", [384, 512, 768, 1280])
def test_w8a8_plain_matches_jax_kernel_and_int8_dense(activation, n):
    """Ragged M (3 x 70 = 210 rows, no tile multiple), K = 96."""
    from yoho_tpu.nn.layers import Int8Dense as JaxInt8Dense
    from yoho_tpu.nn.layers import quantize_act_rows as jax_quantize_act_rows
    from yoho_tpu.ops.w8a8_dense import w8a8_dense as jax_w8a8

    kernel, bias, x = _w8a8_inputs(96, n, (3, 70), seed=n)
    # The port's two outputs first, each copied out of torch's memory before
    # any JAX call: the arrays JAX reads or makes are never torch's own.
    tp = tq.quantize_dense_params(_t(kernel.T), _t(bias))
    snapshot = dict({k: v.clone() for k, v in tp.items()}, x=x.copy())
    got = w8.w8a8_dense(_t(x, torch.bfloat16), tp["weight_q"], tp["weight_scale"],
                        tp["bias"], activation=activation, out_dtype=torch.float32)
    got_bf16 = w8.w8a8_dense(_t(x, torch.bfloat16), tp["weight_q"], tp["weight_scale"],
                             tp["bias"], activation=activation)
    assert got.shape == (3, 70, n) and got.dtype == torch.float32
    assert got_bf16.dtype == torch.bfloat16
    # out_dtype changes only the last rounding: bf16 is the f32 output rounded once.
    _same_rounding(x, tp, activation, got, got_bf16, snapshot)
    got = got.numpy().copy()

    qp = jq.quantize_dense_params({"kernel": kernel, "bias": bias})
    xj = jnp.asarray(x, jnp.bfloat16)
    want_kernel = np.array(jax_w8a8(xj, qp["kernel_q"], qp["kernel_scale"], qp["bias"],
                                    activation=activation, out_dtype=jnp.float32))
    assert os.environ.get("YOHO_W8A8_KERNEL", "auto") != "on"  # the XLA composition
    want_dense = np.array(JaxInt8Dense(n, dtype=jnp.float32, activation=activation)
                          .apply({"params": qp}, xj))
    # The activation codes agree with JAX's everywhere but on exact halves.
    codes_t = w8.quantize_rows(_t(x, torch.bfloat16).reshape(-1, 96))[0].numpy()
    codes_j = np.asarray(jax_quantize_act_rows(xj.reshape(-1, 96))[0])
    off_tie = (codes_t != codes_j) & ~_tie_codes(x)
    assert not off_tie.any(), (f"{int(off_tie.sum())} activation codes differ from JAX's "
                               f"off an exact half, first at {np.argwhere(off_tie)[:4]}")
    _assert_w8a8_close(got, want_kernel, kernel, x, "against JAX's w8a8_dense")
    _assert_w8a8_close(got, want_dense, kernel, x, "against JAX's Int8Dense")


def test_w8a8_plain_is_the_hand_written_math():
    """Per-row absmax codes, exact integer accumulation past 2^24 (K =
    5120), f32 rescale in the reference's order (tests/test_quantize.py's
    manual reference, bit for bit)."""
    g = np.random.default_rng(3)
    k, n = 5120, 16
    w_q = g.integers(-127, 128, size=(n, k)).astype(np.int8)
    w_q[0] = 127
    w_scale = (g.random(n) * 0.01 + 1e-3).astype(np.float32)
    x = (g.standard_normal((5, k)) * 3).astype(np.float32)
    x[0] = g.uniform(1.5, 3.0, k)  # row 0 x channel 0 sums to ~6e7, past 2^24
    a_scale = np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127.0),
                         np.float32(1e-12)).astype(np.float32)
    a_q = np.clip(np.round(x / a_scale), -127, 127).astype(np.int64)
    acc = a_q @ w_q.astype(np.int64).T
    assert np.abs(acc).max() > 2 ** 24
    want = acc.astype(np.float32) * a_scale * w_scale[None, :]
    got = w8.w8a8_dense(_t(x), _t(w_q), _t(w_scale), out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    q, s = quantize_act_rows(_t(x))
    np.testing.assert_array_equal(q.numpy(), a_q.astype(np.int8))
    np.testing.assert_array_equal(s.numpy(), a_scale)


def test_w8a8_wrapper_checks_shapes():
    w = torch.zeros((8, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="disagree"):
        w8.w8a8_dense(torch.zeros(2, 16), w, torch.ones(8))
    with pytest.raises(ValueError, match="unknown activation"):
        w8.w8a8_dense(torch.zeros(2, 32), w, torch.ones(8), activation="relu")
    with pytest.raises(ValueError, match="match N"):
        w8.w8a8_dense(torch.zeros(2, 32), w, torch.ones(4))


@pytest.mark.parametrize("layer", ["int8", "weight_only"])
def test_int8_layers_match_jax(layer):
    """Int8Dense and QuantizedDense with the same params tree, f32."""
    from yoho_tpu.nn import layers as jl

    kernel, bias, x = _w8a8_inputs(64, 96, (2, 5), seed=4)
    x = x * 3
    qp = jq.quantize_dense_params({"kernel": kernel, "bias": bias})
    jcls, tcls = {"int8": (jl.Int8Dense, Int8Dense),
                  "weight_only": (jl.QuantizedDense, QuantizedDense)}[layer]
    want = np.asarray(jcls(96, dtype=jnp.float32).apply({"params": qp}, jnp.asarray(x)))
    mod = tcls(64, 96)
    for name, val in tq.quantize_dense_params(_t(kernel.T), _t(bias)).items():
        setattr(mod, name, val)
    got = mod(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------- models


def test_encoder_int8_output_matches_jax():
    """Whisper(encoder_int8=True), f32, 128 wide (tests/test_ops.py:336-372's
    model): within rtol/atol 0.05; the measured max error is ~1e-6."""
    params, mel, _ = _small_params()
    q = _jax_quantized(params, ("encoder",))
    want = np.asarray(JaxWhisper(JaxConfig(**SMALL), encoder_int8=True).apply(
        {"params": q}, jnp.asarray(mel), method=JaxWhisper.encode_audio))
    model = load_jax_params(Whisper(WhisperConfig(**SMALL), encoder_int8=True,
                                    device="cpu"), q)
    with torch.no_grad():
        got = model.encode_audio(_t(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    assert np.abs(got - want).max() < 1e-4  # what it measures: f32 rounding only


@pytest.fixture(scope="module")
def tiny():
    """(config dict, flax params as numpy, golden, word vocab)."""
    fx = FIXTURES / "whisper_tiny"
    cfg = json.loads((fx / "config.json").read_text())
    jcfg = JaxConfig(**cfg)
    template = jax.eval_shape(
        JaxWhisper(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jcfg.n_frames, jcfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = jax.device_get(load_params(fx / "params.msgpack", template))
    return (cfg, params, json.loads((fx / "golden.json").read_text()),
            json.loads((fx / "word_vocab.json").read_text()))


def _tone_clip(hz: float, n_samples: int) -> np.ndarray:
    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002
             ).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * hz * np.arange(int(0.25 * 16000)) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


def _step_logits(step, tokens, caches):
    logits, caches = step(tokens[:, :3], caches, 0)
    out = [np.asarray(logits)]
    for p in range(3, tokens.shape[1]):
        logits, caches = step(tokens[:, p:p + 1], caches, p)
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def test_weights_int8_logits_match_jax(tiny):
    """The trained whisper_tiny fixture quantized in JAX and carried across:
    teacher-forced and cached-step f32 logits at atol 2e-4."""
    cfg, params, golden, _ = tiny
    q = _jax_quantized(params, ("decoder",))
    jm = JaxWhisper(JaxConfig(**cfg), weights_int8=True)
    variables = {"params": q}
    n = WhisperConfig(**cfg).n_samples
    clips = np.stack([_tone_clip(hz, n) for hz in golden["tones"][:2]])
    from yoho_tpu.audio.frontend import whisper_log_mel

    mel = np.array(whisper_log_mel(jnp.asarray(clips)))
    tokens = np.array([[50258, 50259, 50359, 50363, 1000, 1001],
                       [50258, 50259, 50359, 50363, 1002, 1003]], np.int32)
    want = np.asarray(jm.apply(variables, jnp.asarray(mel), jnp.asarray(tokens)))
    xa = jm.apply(variables, jnp.asarray(mel), method=JaxWhisper.encode_audio)
    ckv = jm.apply(variables, xa, "int8", method=JaxWhisper.cross_kvs)
    caches = jm.apply(variables, 2, jnp.float32, None, True, method=JaxWhisper.init_caches)
    want_step = _step_logits(jax_step_fn(jm, variables, ckv), jnp.asarray(tokens), caches)

    tm = load_jax_params(Whisper(WhisperConfig(**cfg), weights_int8=True, device="cpu"), q)
    with torch.no_grad():
        got = tm(_t(mel), _t(tokens).long()).numpy()
        t_ckv = tm.cross_kvs(tm.encode_audio(_t(mel)), "int8")
        got_step = _step_logits(make_whisper_step_fn(tm, t_ckv), _t(tokens).long(),
                                tm.init_caches(2, quantized=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got_step, want_step, atol=2e-4)


class _WordBackend:
    def __init__(self, word_ids):
        self.word_ids = {k: int(v) for k, v in word_ids.items()}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)


@pytest.mark.parametrize("lane", ["encoder_int8", "fast_gelu"])
def test_tiny_golden_transcripts_int8_encoder_and_fast_gelu(tiny, lane):
    """tests/test_whisper_fixture.py:100-133: transcripts stay exact on the
    trained fixture's margins."""
    cfg, params, golden, words = tiny
    model = load_jax_params(Whisper(WhisperConfig(**cfg), dtype=torch.bfloat16,
                                    fast_gelu=lane == "fast_gelu", device="cpu"), params)
    kw = {}
    if lane == "encoder_int8":
        tq.quantize_whisper_encoder(model)
        kw = dict(quantized_cross_kv="int8", quantized_cache=True)
    table = WhisperTokenTable(multilingual=True, text_backend=_WordBackend(words))
    t = Transcriber(model, token_table=table, batch_size=1, timestamps=False,
                    device="cpu", **kw)
    n = WhisperConfig(**cfg).n_samples
    texts = [t.transcribe(_tone_clip(hz, n)).text for hz in golden["tones"]]
    assert texts == golden["texts"]["bf16"] == golden["sentences"]


# ---------------------------------------------------------------- quality

QUALITY = FIXTURES / "whisper_quality"


@pytest.fixture(scope="module")
def quality():
    from test_quality_fixture import WordBackend, synth

    spec = json.loads((QUALITY / "spec.json").read_text())
    cfg_dict = json.loads((QUALITY / "config.json").read_text())
    cfg = JaxConfig(**cfg_dict)
    template = jax.eval_shape(
        JaxWhisper(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.n_frames, cfg.n_mels), jnp.float32),
        jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating)
                            else s.dtype), template)
    params = jax.device_get(load_params(QUALITY / "params.msgpack", template))
    rng = np.random.default_rng(spec["eval_seed"])
    audio = [synth(s, spec["words"], spec["base_hz"], spec["word_sec"], rng,
                   spec["noise"], cfg.n_samples) for s in spec["eval_sentences"]]
    table = WhisperTokenTable(multilingual=True, text_backend=WordBackend(spec["word_ids"]))
    return spec, cfg_dict, params, table, audio


QUALITY_LANES = {
    "bf16": ({}, (), {}),
    "int8-kv": ({}, (), dict(quantized_cross_kv="int8", quantized_cache=True)),
    "int4-kv": ({}, (), dict(quantized_cross_kv="int4", quantized_cache=True)),
    "int8-weights": ({}, ("decoder",), dict(quantized_cross_kv="int8",
                                            quantized_cache=True)),
    "int8-encoder": ({}, ("encoder",), dict(quantized_cross_kv="int8",
                                            quantized_cache=True)),
    "fast-gelu": (dict(fast_gelu=True), (), dict(quantized_cross_kv="int8",
                                                 quantized_cache=True)),
}


@pytest.mark.parametrize("lane", list(QUALITY_LANES))
def test_quality_lane_wer_matches_recorded(quality, lane):
    """tests/test_quality_fixture.py:87-133 through the port: each lane's
    held-out WER equals the recorded value within 1e-4."""
    from yoho_tpu.eval.wer import wer

    spec, cfg_dict, params, table, audio = quality
    mkw, parts, tkw = QUALITY_LANES[lane]
    model = _port_quantized(load_jax_params(
        Whisper(WhisperConfig(**cfg_dict), dtype=torch.bfloat16, device="cpu", **mkw),
        params), parts)
    t = Transcriber(model, token_table=table, batch_size=8, timestamps=False,
                    device="cpu", **tkw)
    hyps = [r.text for r in t.transcribe_many(audio)]
    rate, _ = wer(spec["eval_sentences"], hyps, normalize=False)
    assert float(rate) == pytest.approx(spec["wer"][lane], abs=1e-4), lane
