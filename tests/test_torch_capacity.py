"""The port's capacity model (``yoho_tpu_torch/infer/capacity.py``) and
``Transcriber(batch_size="auto")``.

The byte terms are the port's own buffers, so they are checked against
the caches the port allocates (on the ``meta`` device: shapes and types,
no memory), not against the JAX package's TPU constants.
"""

import pytest
import torch

from yoho_tpu_torch.core.config import WHISPER_PRESETS, WhisperConfig
from yoho_tpu_torch.infer import capacity
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.nn.params import init_random
from yoho_tpu_torch.nn.quantize import quantize_whisper_decoder
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

SMALL = WHISPER_PRESETS["small"]
GB = 10 ** 9


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj)
    return sum(_nbytes(v) for v in vars(obj).values() if isinstance(v, torch.Tensor))


@pytest.fixture(scope="module")
def meta_small():
    return Whisper(SMALL, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("mode", ["int8", "int4", None])
def test_cross_kv_term_is_the_allocation(meta_small, mode):
    xa = torch.empty(1, SMALL.n_audio_ctx, SMALL.n_audio_state,
                     dtype=torch.bfloat16, device="meta")
    ckv = meta_small.cross_kvs(xa, mode or False)
    if mode:
        assert ckv[0].k_q.shape[-1] == 1536 and ckv[0].kv_len == 1500
        assert ckv[0].k_scale.dtype == torch.bfloat16
    terms = capacity.stream_terms(SMALL, cross_kv=mode)
    assert terms["cross_kv"] == _nbytes(ckv)
    assert terms["encoder_out"] == _nbytes(xa)


@pytest.mark.parametrize("quantized,dtype", [(True, torch.bfloat16), (False, torch.bfloat16),
                                             (False, torch.float32)])
def test_self_cache_term_is_the_allocation(meta_small, quantized, dtype):
    caches = meta_small.init_caches(1, dtype, None, quantized)
    assert caches[0].max_len == 512
    terms = capacity.stream_terms(SMALL, cache_quantized=quantized,
                                  cache_itemsize=torch.empty((), dtype=dtype).element_size())
    assert terms["self_cache"] == _nbytes(caches)
    # Beams keep one cache each; the cross K/V stay one per stream.
    beams = capacity.stream_terms(SMALL, cache_quantized=quantized, beams=5,
                                  cache_itemsize=torch.empty((), dtype=dtype).element_size())
    assert beams["self_cache"] == 5 * terms["self_cache"]
    assert beams["cross_kv"] == terms["cross_kv"]


def test_the_cache_arithmetic_of_small_and_turbo():
    """whisper-small int8: 2 x 12 x 768 x 1536 B of cross codes, 9.4 MB of
    self cache with its scales; turbo: 15.7 + 5.2 MB of codes."""
    t = capacity.stream_terms(SMALL)
    assert t["cross_kv"] == 2 * 12 * 768 * 1536 + 2 * 12 * 12 * 1536 * 2
    assert t["self_cache"] == 2 * 12 * 768 * 512 + 2 * 12 * 12 * 512 * 2
    turbo = capacity.stream_terms(WHISPER_PRESETS["large-v3-turbo"])
    assert turbo["cross_kv"] == 2 * 4 * 1280 * 1536 + 2 * 4 * 20 * 1536 * 2
    assert turbo["mel"] == 3000 * 128 * 4


def test_suggestion_is_monotonic_in_memory_and_capped():
    prev = 0
    for gb in (1, 2, 4, 8, 16, 24, 40, 80, 160):
        b = capacity.suggest_batch_size(SMALL, device_bytes=gb * GB)
        assert b >= prev and (b < 8 or b % 8 == 0)
        prev = b
    assert capacity.suggest_batch_size(SMALL, device_bytes=80 * GB) == 512
    assert capacity.suggest_batch_size(SMALL, device_bytes=1 * GB) == 1
    per = capacity.stream_bytes(SMALL)
    fixed = capacity.whisper_param_count(SMALL) * 2 + capacity.RESERVE_BYTES
    assert capacity.suggest_batch_size(SMALL, device_bytes=fixed + 13 * per) == 8
    assert capacity.suggest_batch_size(SMALL, device_bytes=fixed + 7 * per) == 7


def test_beams_and_a_draft_shrink_it():
    dev = 8 * GB
    base = capacity.suggest_batch_size(SMALL, device_bytes=dev, quantum=1)
    beams = capacity.suggest_batch_size(SMALL, device_bytes=dev, quantum=1, beams=5)
    terms = capacity.stream_terms(SMALL)
    fixed = capacity.whisper_param_count(SMALL) * 2 + capacity.RESERVE_BYTES
    assert beams == (dev - fixed) // (sum(terms.values()) + 4 * terms["self_cache"]) < base
    tiny = WHISPER_PRESETS["tiny"]
    draft = capacity.suggest_batch_size(
        SMALL, device_bytes=dev, quantum=1,
        extra_fixed_bytes=capacity.whisper_param_count(tiny) * 2,
        extra_stream_bytes=capacity.stream_bytes(tiny))
    assert draft < base


def test_int8_weights_count_the_bf16_encoder():
    """``quantize_whisper_decoder`` leaves the encoder in the model's type:
    the fixed cost counts it at 2 bytes a parameter, the decoder at about
    one."""
    model = Whisper(SMALL, dtype=torch.bfloat16, device="meta")
    bf16 = capacity.module_bytes(model)
    enc = capacity.module_bytes(model.encoder)
    enc_params = sum(p.numel() for p in model.encoder.parameters())
    dec_params = sum(p.numel() for p in model.decoder.parameters())
    quantize_whisper_decoder(model)
    int8 = capacity.module_bytes(model)
    assert capacity.module_bytes(model.encoder) == enc >= 2 * enc_params
    assert enc < int8 < bf16
    assert int8 - enc < 1.1 * dec_params


TINY = WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=4,
                     n_audio_layer=1, n_vocab=51865, n_text_ctx=32, n_text_state=32,
                     n_text_head=4, n_text_layer=1, chunk_seconds=0.32)


@pytest.fixture(scope="module")
def tiny_model():
    return init_random(Whisper(TINY, device="cpu"), seed=0)


def test_transcriber_auto_batch_resolves(tiny_model, monkeypatch):
    table = WhisperTokenTable(multilingual=True)
    t = Transcriber(tiny_model, token_table=table, batch_size="auto", device="cpu")
    assert isinstance(t.batch_size, int) and t.batch_size >= 1
    # From a given memory: the suggestion under the transcriber's lanes
    # (float K/V in f32, an f32 cache, f32 weights as stored).
    per = capacity.stream_bytes(TINY, cross_kv=None, cache_quantized=False,
                                cache_itemsize=4, act_itemsize=4)
    weights = capacity.module_bytes(tiny_model)
    monkeypatch.setattr(capacity, "device_memory_bytes",
                        lambda dev: capacity.RESERVE_BYTES + weights + 21 * per)
    t = Transcriber(tiny_model, token_table=table, batch_size="auto", device="cpu",
                    cache_dtype=torch.float32)
    assert t.batch_size == 16
    t = Transcriber(tiny_model, token_table=table, batch_size="auto", device="cpu",
                    quantized_cross_kv=True, quantized_cache=True)
    assert t.batch_size > 16  # int8 K/V: smaller streams
    # A draft model adds its weights and per-stream buffers.
    t = Transcriber(tiny_model, token_table=table, batch_size="auto", device="cpu",
                    cache_dtype=torch.float32, draft_model=tiny_model)
    assert t.batch_size < 16


def test_transcriber_rejects_an_unknown_batch_string(tiny_model):
    with pytest.raises(ValueError, match="'auto'"):
        Transcriber(tiny_model, token_table=WhisperTokenTable(), batch_size="big",
                    device="cpu")


def test_device_memory_reads():
    assert capacity.device_memory_bytes("cpu") > 1 * GB
    with pytest.raises(ValueError, match="meta"):
        capacity.device_memory_bytes("meta")
