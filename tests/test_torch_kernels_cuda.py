"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode.
The file imports no JAX (the machine with the card has none), so it runs
there without the JAX package's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances: the JAX package's for each kernel (``tests/test_ops.py``):
1e-4 (whisper) and 1e-3/2e-3 (scipy) for the mel kernel, 2e-5 for flash
in f32 and 1e-2 in bf16 (one bf16 ulp of the output), rtol 0.05 / atol
0.02 for decode attention, one weight step x max|x| x 1.1 and >= 98%
identical outputs for w8a8 (which is also held bit for bit to its plain
version).
"""

import numpy as np
import pytest
import torch

from yoho_tpu_torch.audio import frontend
from yoho_tpu_torch.nn import kv_cache
from yoho_tpu_torch.ops import decode_attention, flash_attention, mel_kernel, w8a8_dense

pytestmark = pytest.mark.cuda


def _decode_launches():
    """Decode-attention launches on both routes (FMA and tensor cores)."""
    return sum(k.launches for k in decode_attention.KERNELS)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


MEL = {"whisper": (dict(mel_scale="slaney", convention="whisper", log_floor=1e-10,
                        n_mels=80), dict(rtol=1e-4, atol=1e-4)),
       "whisper128": (dict(mel_scale="slaney", convention="whisper", log_floor=1e-10,
                           n_mels=128), dict(rtol=1e-4, atol=1e-4)),
       "scipy": (dict(mel_scale="htk", convention="scipy", log_floor=1e-13,
                      n_mels=32), dict(rtol=1e-3, atol=2e-3))}


@pytest.mark.parametrize("convention", ["whisper", "whisper128", "scipy"])
@pytest.mark.parametrize("n", [48_000, 12_345])
def test_mel_kernel_matches_plain(gen, convention, n):
    kw, tol = MEL[convention]
    audio = torch.randn((3, n), generator=gen, device="cuda") * 0.2
    before = mel_kernel.KERNEL.launches
    got = mel_kernel.fused_log_mel(audio, **kw)
    assert mel_kernel.KERNEL.launches == before + 1
    want = frontend.log_mel_spectrogram(audio, sample_rate=16000, n_fft=400,
                                        hop=160, **kw)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("convention", ["whisper", "whisper128", "scipy"])
@pytest.mark.parametrize("n", [100, 5_000, 100_000])
def test_mel_kernel_edges(gen, convention, n):
    """One row (B = 1); audio shorter than one 64-frame tile (100 and 5,000
    samples: 1 and 31 frames); a frame count (625) that is not a multiple
    of the tile; 80 and 128 mels; both conventions."""
    kw, tol = MEL[convention]
    audio = torch.randn((1, n), generator=gen, device="cuda") * 0.2
    got = mel_kernel.fused_log_mel(audio, **kw)
    want = frontend.log_mel_spectrogram(audio, sample_rate=16000, n_fft=400, hop=160, **kw)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,t,kv_len,heads", [
    (False, 1500, 1500, None, 3), (True, 300, 300, None, 3), (False, 77, 77, None, 3),
    (False, 1536, 1536, 1500, 3), (False, 300, 300, 129, 3), (True, 256, 256, 200, 3),
    (False, 6, 1500, None, 3), (False, 1500, 1500, None, 20), (False, 1500, 1500, 129, 3),
    (True, 1500, 1500, None, 2)])
def test_flash_kernel_matches_plain(gen, dtype, causal, tq, t, kv_len, heads):
    """The bf16 route (wgmma + TMA, 128-row query and key tiles) at its
    edges: turbo's 20 heads, kv_len inside a tile, Tq != Tk, causal, the
    ragged T = 1500; the f32 route on the same cases."""
    q, k, v = (torch.randn((2, n, heads, 64), generator=gen, device="cuda").to(dtype)
               for n in (tq, t, t))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    want = flash_attention.attention_reference(q, k, v, causal, 64 ** -0.5, kv_len)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_unaligned_view(gen):
    """A bf16 view that starts 2 bytes into its allocation: the TMA loads
    need 16-byte aligned bases, so the wrapper copies it first."""
    base = torch.randn((2 * 300 * 3 * 64 + 1,), generator=gen, device="cuda").to(torch.bfloat16)
    q = base[1:].view(2, 300, 3, 64)
    got = flash_attention.flash_attention(q, q, q)
    want = flash_attention.attention_reference(q, q, q, False, 64 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("s,pos", [(1, None), (3, None), (1, 200), (5, 0), (1, 0), (1, 447)])
@pytest.mark.parametrize("t,kv_len", [(333, 300), (1500, 1500), (1536, 1500), (512, 512),
                                      (8192, 8000)])
def test_decode_kernel_matches_plain(gen, kind, s, pos, t, kv_len):
    """Every load branch: T = 333 (rows copied element by element), 1500
    (4-byte words: rows not 16-byte aligned), the padded cross read (1536,
    kv_len 1500) and the cache (512) through TMA, and a T whose chunks
    outnumber the blocks of a cluster (8192), at S = 1, 3, 5 and pos from
    0 to 447."""
    k, v = (torch.randn((2, 4, 64, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((2, 4, s, 64), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    if kind == "bf16":
        args, packing = (q, k, v, None, None), 1
    else:
        qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
        args, packing = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), qkv.packing
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len,
                                                  packing=packing)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(*args, pos=pos, kv_len=kv_len,
                                                       packing=packing)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("pos", [None, 0, 200])
@pytest.mark.parametrize("s", [33, 64, 224, 1120])
def test_decode_kernel_long_query_runs(gen, kind, pos, s):
    """More than 32 queries (a prompt's prefill, beams folded into the query
    axis) run on the tensor-core route in one launch."""
    t, kv_len = 1536, 1500
    k, v = (torch.randn((2, 4, 64, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((2, 4, s, 64), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    if kind == "bf16":
        args, packing = (q, k, v, None, None), 1
    else:
        qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
        args, packing = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), qkv.packing
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len,
                                                  packing=packing)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(*args, pos=pos, kv_len=kv_len,
                                                       packing=packing)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_folded_beam_read_matches_tiled_plain_read(gen, kind):
    """Beam search's cross read: 4 streams x 5 beams folded into 5 queries
    of each stream's untiled K/V, against the plain read of K/V tiled to
    20 rows."""
    from yoho_tpu_torch.infer.beam import tile_beams
    from yoho_tpu_torch.nn.layers import _fold_queries

    b, k_beams, t = 4, 5, 1500
    kb, vb = (torch.randn((b, 12, 64, t), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    q = (torch.randn((b * k_beams, 12, 1, 64), generator=gen, device="cuda") * 0.3
         ).to(torch.bfloat16)
    if kind == "int8":
        qkv = kv_cache.quantize_kv(kb, vb, pad_to=128)
        kv = (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)
        kv_len = qkv.kv_len
    else:
        kv, kv_len = (kb, vb, None, None), None
    got = decode_attention.fused_decode_attention(_fold_queries(q, k_beams), *kv,
                                                  kv_len=kv_len)
    assert got.shape == (b, k_beams, 12, 64)
    want = decode_attention.decode_attention_reference(
        q, *tile_beams(list(kv[:2]), k_beams),
        *(tile_beams(list(kv[2:]), k_beams) if kind == "int8" else kv[2:]), kv_len=kv_len)
    torch.testing.assert_close(got.reshape(b * k_beams, 1, 12, 64).float(), want.float(),
                               rtol=0.05, atol=0.02)


@pytest.mark.parametrize("heads,s,pos,t,kv_len", [
    (12, 5, 200, 512, 512), (12, 5, 447, 512, 512), (12, 5, None, 1536, 1500),
    (6, 2, 199, 512, 512), (6, 2, None, 1536, 1500), (6, 1, 300, 512, 512),
    (6, 3, 0, 512, 512)])
def test_speculative_reads_match_plain(gen, heads, s, pos, t, kv_len):
    """Speculative decoding's reads at batch 16, int8: the target's verify
    step of gamma + 1 = 5 queries, causal on the cache at a non-zero pos and
    over the padded cross K/V; whisper-tiny's draft steps at 6 heads (S = 2
    at c - 2, S = 1, the prompt's prefill)."""
    k, v = (torch.randn((16, heads, 64, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((16, heads, s, 64), generator=gen, device="cuda") * 0.35
         ).to(torch.bfloat16)
    qkv = kv_cache.quantize_kv(k, v)
    args = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(*args, pos=pos, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


ROW_POS = {"spread": [0, 3, 61, 64, 127, 200, 255, 300, 383, 384, 400, 420, 430, 440, 446, 447],
           "all 200": [200] * 16, "all 0": [0] * 16}


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("rows", sorted(ROW_POS))
@pytest.mark.parametrize("s", [1, 2, 5, 40])
def test_decode_kernel_per_row_pos(gen, kind, rows, s):
    """Continuous batching's causal reads: every row of 16 at its own
    position in a 512-position cache (12 heads), S = 1, the draft's 2, the
    verify's 5 and 40, each one launch. Rows at pos 0 leave most of their cluster
    with nothing to read: those blocks combine as empty states (no NaN).
    The scalar launch at the same position gives the same answer."""
    t = 512
    k, v = (torch.randn((16, 12, 64, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((16, 12, s, 64), generator=gen, device="cuda") * 0.35).to(torch.bfloat16)
    if kind == "bf16":
        args = (q, k, v, None, None)
        packing = 1
    else:
        qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
        args, packing = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), qkv.packing
    pos = torch.tensor(ROW_POS[rows], dtype=torch.int32, device="cuda")
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(*args, pos=pos, packing=packing)
    assert _decode_launches() == before + 1
    assert torch.isfinite(got.float()).all()
    want = decode_attention.decode_attention_reference(*args, pos=pos, packing=packing)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)
    if rows != "spread":
        same = decode_attention.fused_decode_attention(*args, pos=int(ROW_POS[rows][0]),
                                                       packing=packing)
        torch.testing.assert_close(got.float(), same.float(), rtol=0.05, atol=0.02)


def test_per_row_cache_write_drops_past_the_horizon_on_the_card(gen):
    """A per-row block write past the cache's end is dropped on the card
    (no device-side assert), and the cache equals the CPU write."""
    k, v = (torch.randn((4, 2, 64, 128), generator=gen, device="cuda") for _ in range(2))
    new = [torch.randn((4, 2, 64, 5), generator=gen, device="cuda") for _ in range(2)]
    pos = torch.tensor([0, 60, 124, 127], dtype=torch.int32, device="cuda")
    for cls in (kv_cache.KVCache, kv_cache.QuantizedKVCache):
        if cls is kv_cache.KVCache:
            gpu, cpu = cls(k.clone(), v.clone()), cls(k.cpu(), v.cpu())
        else:
            gpu = cls.zeros(4, 2, 128, 64, device="cuda").update(0, k, v)
            cpu = cls.zeros(4, 2, 128, 64, device="cpu").update(0, k.cpu(), v.cpu())
        gpu.update(pos, *new)
        cpu.update(pos.cpu(), *(x.cpu() for x in new))
        torch.cuda.synchronize()
        for a, b in zip(vars(gpu).values(), vars(cpu).values()):
            assert torch.equal(a.cpu(), b)


def test_flash_kernel_whisper_tiny_encoder(gen):
    """The draft's encoder self-attention: whisper-tiny's 6 heads at batch 16."""
    q, k, v = (torch.randn((16, 1500, 6, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    got = flash_attention.flash_attention(q, k, v)
    want = flash_attention.attention_reference(q, k, v, False, 64 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("draft_kind", ["independent", "perfect"])
def test_speculative_decode_on_the_card_equals_greedy(gen, draft_kind):
    """Speculative greedy decoding through the kernels equals greedy
    decoding through them, in f32 (int8 cross K/V, float caches), with
    random weights at head dim 64."""
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.infer.decode import greedy_decode, make_whisper_step_fn
    from yoho_tpu_torch.infer.speculative import speculative_greedy_decode
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper

    kw = dict(n_mels=80, n_audio_ctx=64, n_vocab=512, n_text_ctx=64)
    target = init_random(Whisper(WhisperConfig(
        n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_text_state=128,
        n_text_head=2, n_text_layer=2, **kw)), seed=0, std=0.3)
    draft = target if draft_kind == "perfect" else init_random(Whisper(WhisperConfig(
        n_audio_state=64, n_audio_head=1, n_audio_layer=1, n_text_state=64,
        n_text_head=1, n_text_layer=1, **kw)), seed=1, std=0.3)
    mel = torch.randn((4, 128, 80), generator=gen, device="cuda")
    prompt = torch.tensor([[1, 2, 3]] * 4, device="cuda")
    with torch.inference_mode():
        ckvs = [m.cross_kvs(m.encode_audio(mel), "int8") for m in (target, draft)]
        want, want_len = greedy_decode(make_whisper_step_fn(target, ckvs[0]),
                                       target.init_caches(4), prompt, 64, 7)
        stats = {}
        got, got_len = speculative_greedy_decode(
            make_whisper_step_fn(target, ckvs[0]), make_whisper_step_fn(draft, ckvs[1]),
            target.init_caches(4, None, 64 + 4 + 2), draft.init_caches(4, None, 64 + 4 + 2),
            prompt, 64, 7, gamma=4, stats=stats)
    assert torch.equal(got, want) and torch.equal(got_len, want_len)
    assert stats["syncs"] == stats["rounds"]


def test_beam_reorder_and_top_k_on_the_card(gen):
    """The beam cache reorder and the tie-ordered top-k give on the card
    what they give on the CPU."""
    from yoho_tpu_torch.infer.beam import _gather_beams, top_k

    src = torch.tensor([[2, 0, 0], [1, 1, 2]], device="cuda")
    caches = [kv_cache.QuantizedKVCache.zeros(6, 4, 512, 64, device="cuda")]
    caches[0].k_q.copy_(torch.randint(-127, 128, caches[0].k_q.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
    caches[0].k_scale.copy_(torch.rand(caches[0].k_scale.shape, generator=gen,
                                       device="cuda"))
    cpu = [kv_cache.QuantizedKVCache(*(x.cpu() for x in (
        caches[0].k_q, caches[0].v_q, caches[0].k_scale, caches[0].v_scale)))]
    _gather_beams(caches, src)
    _gather_beams(cpu, src.cpu())
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        assert torch.equal(getattr(caches[0], name).cpu(), getattr(cpu[0], name)), name
    x = torch.randint(0, 3, (16, 5 * 51865), generator=gen, device="cuda").float()
    for got, want in zip(top_k(x, 5), top_k(x.cpu(), 5)):
        assert torch.equal(got.cpu(), want)


def test_decode_kernel_gqa_and_f32(gen):
    q = torch.randn((2, 6, 2, 64), generator=gen, device="cuda") * 0.3
    k, v = (torch.randn((2, 3, 64, 200), generator=gen, device="cuda") for _ in range(2))
    got = decode_attention.fused_decode_attention(q, k, v, pos=50, groups=2)
    want = decode_attention.decode_attention_reference(q, k, v, pos=50, groups=2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int8", "int4", "float"])
@pytest.mark.parametrize("t,kv_len", [(1536, 1500), (200, 200)])
def test_decode_kernel_groups(gen, q_dtype, kind, t, kv_len):
    """groups = 2 (head h reads kv head h // 2) for every K/V kind and both
    query types, prefill-sized S = 3."""
    q = (torch.randn((2, 6, 3, 64), generator=gen, device="cuda") * 0.3).to(q_dtype)
    k, v = (torch.randn((2, 3, 64, t), generator=gen, device="cuda").to(q_dtype)
            for _ in range(2))
    if kind == "float":
        args, packing = (q, k, v, None, None), 1
    else:
        qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
        args, packing = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), qkv.packing
    got = decode_attention.fused_decode_attention(*args, kv_len=kv_len, groups=2,
                                                  packing=packing)
    want = decode_attention.decode_attention_reference(*args, kv_len=kv_len, groups=2,
                                                       packing=packing)
    tol = (1e-4, 1e-5) if kind == "float" and q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


WHISPER_WIDTHS = (384, 512, 768, 1024, 1280)  # tiny .. large


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
@pytest.mark.parametrize("k,n", [(d, 4 * d) for d in WHISPER_WIDTHS]
                         + [(4 * d, d) for d in WHISPER_WIDTHS])
def test_w8a8_kernel_matches_plain(gen, k, n, activation, out_dtype):
    """Every whisper MLP shape (fc1 d -> 4d, fc2 4d -> d) at a ragged M of
    333 rows. The tolerance is the JAX package's pin (tests/test_ops.py):
    one weight step x max|x| x 1.1, plus one rounding of a bf16 output,
    and >= 98% of outputs identical."""
    x = (torch.randn((3, 111, k), generator=gen, device="cuda") * 0.7).to(torch.bfloat16)
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.05
    bias = torch.randn((n,), generator=gen, device="cuda")
    w_q, w_scale = w8a8_dense.quantize_rows(w)
    w_scale = w_scale[:, 0]
    args = (x, w_q, w_scale, bias)
    before = w8a8_dense.KERNEL.launches
    got = w8a8_dense.w8a8_dense(*args, activation=activation, out_dtype=out_dtype)
    assert w8a8_dense.KERNEL.launches == before + 1
    want = w8a8_dense.w8a8_dense_reference(*args, activation=activation,
                                           out_dtype=out_dtype)
    assert got.shape == (3, 111, n) and got.dtype == out_dtype
    step = float(w_scale.max())
    atol = step * float(x.float().abs().max()) * 1.1 + 1e-5
    rtol = 2.0 ** -8 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert _same_in_bf16(got, want) > 0.98
    assert torch.equal(got, want)


def _same_in_bf16(got, want) -> float:
    """The share of outputs identical once both are rounded to bf16."""
    return float((got.to(torch.bfloat16) == want.to(torch.bfloat16)).float().mean())


def _w8a8_case(gen, m, k, n, x_dtype, out_dtype, activation, bias=True):
    x = (torch.randn((m, k), generator=gen, device="cuda") * 0.7).to(x_dtype)
    w_q, w_scale = w8a8_dense.quantize_rows(torch.randn((n, k), generator=gen, device="cuda") * 0.05)
    b = torch.randn((n,), generator=gen, device="cuda") if bias else None
    args = (x, w_q, w_scale[:, 0], b)
    before = w8a8_dense.KERNEL.launches
    got = w8a8_dense.w8a8_dense(*args, activation=activation, out_dtype=out_dtype)
    assert w8a8_dense.KERNEL.launches == before + 1
    want = w8a8_dense.w8a8_dense_reference(*args, activation=activation, out_dtype=out_dtype)
    assert got.shape == (m, n) and got.dtype == out_dtype
    # Bit for bit with the plain version (exact integer sums, the rescale and
    # GELU in the reference's order), which is inside the JAX pin.
    assert torch.equal(got, want)
    atol = float(w_scale.max()) * float(x.float().abs().max()) * 1.1 + 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=atol)


@pytest.mark.parametrize("m", [1, 63, 64, 65, 333, 24_000])
@pytest.mark.parametrize("k", [32, 96, 5120, 8192])
def test_w8a8_kernel_edges_m_k(gen, m, k):
    """The wgmma route's edges: M from one row to a batch of 16 windows
    (ragged 64- and 128-row tiles through TMA's zero fill and clipped
    stores), K of one k-slice (32), shorter than a stage (96), and the
    widest (8192), at a ragged N = 136."""
    _w8a8_case(gen, m, k, 136, torch.bfloat16, torch.bfloat16, "gelu_tanh")


@pytest.mark.parametrize("n", [8, 136, 5120])
@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.bfloat16, torch.float32),
                                               (torch.float32, torch.bfloat16),
                                               (torch.float32, torch.float32)])
@pytest.mark.parametrize("bias", [True, False])
def test_w8a8_kernel_edges_n_types(gen, n, x_dtype, out_dtype, bias):
    """N of one 8-column group, a ragged 136 and turbo's 5120, every pair
    of input and output types, with and without bias."""
    _w8a8_case(gen, 333, 96, n, x_dtype, out_dtype, None if bias else "gelu_tanh", bias)


def test_w8a8_kernel_f32_input_and_no_bias(gen):
    x = torch.randn((2, 1500, 768), generator=gen, device="cuda")
    w_q, w_scale = w8a8_dense.quantize_rows(
        torch.randn((3072, 768), generator=gen, device="cuda") * 0.05)
    got = w8a8_dense.w8a8_dense(x, w_q, w_scale[:, 0], out_dtype=torch.float32)
    want = w8a8_dense.w8a8_dense_reference(x, w_q, w_scale[:, 0], out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=float(w_scale.max()) * float(x.abs().max()) * 1.1)
    assert _same_in_bf16(got, want) > 0.98


def test_quantizers_are_bit_exact_on_the_card(gen):
    """The int8/int4 codes and scales the card computes equal the CPU's,
    which equal JAX's (tests/test_torch_kv_cache.py, test_torch_quantize.py):
    every scale is a true division, as in JAX."""
    x = torch.randn((4, 6, 64, 700), generator=gen, device="cuda") * 3
    for got, want in ((w8a8_dense.quantize_rows(x), w8a8_dense.quantize_rows(x.cpu())),
                      (w8a8_dense.quantize_rows(x.bfloat16()),
                       w8a8_dense.quantize_rows(x.bfloat16().cpu()))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    k, v = x.bfloat16(), (x * 0.5).bfloat16()
    for fn in (kv_cache.quantize_kv, kv_cache.quantize_kv4):
        got, want = fn(k, v), fn(k.cpu(), v.cpu())
        for name in ("k_q", "v_q", "k_scale", "v_scale"):
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    caches = [kv_cache.QuantizedKVCache.zeros(4, 6, 16, 64, device=d) for d in ("cuda", "cpu")]
    for c in caches:
        c.update(3, k[..., :5].to(c.k_q.device), v[..., :5].to(c.k_q.device))
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        assert torch.equal(getattr(caches[0], name).cpu(), getattr(caches[1], name)), name


def test_wrappers_raise_instead_of_falling_back(gen):
    q = torch.randn((1, 2, 1, 64), generator=gen, device="cuda").to(torch.float16)
    k = torch.zeros((1, 2, 64, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        decode_attention.fused_decode_attention(q, k, k)
    with pytest.raises(TypeError):  # fp16: the flash kernel takes f32 or bf16
        flash_attention.flash_attention(*(torch.zeros((1, 8, 1, 264), device="cuda",
                                                      dtype=torch.float16) for _ in range(3)))
    packed = torch.zeros((1, 2, 48, 16), device="cuda", dtype=torch.uint8)
    scale = torch.ones((1, 2, 1, 16), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # int4 K/V at an odd head dim
        decode_attention.fused_decode_attention(
            torch.zeros((1, 2, 1, 97), device="cuda", dtype=torch.bfloat16), packed, packed,
            scale, scale, packing=2)
    w_q = torch.zeros((8, 48), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # K % 32 != 0
        w8a8_dense.w8a8_dense(torch.zeros((2, 48), device="cuda"), w_q,
                              torch.ones(8, device="cuda"))
    with pytest.raises(TypeError):  # fp16 x
        w8a8_dense.w8a8_dense(torch.zeros((2, 48), device="cuda", dtype=torch.float16),
                              w_q, torch.ones(8, device="cuda"))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,t,kv_len,causal", [(300, 300, None, False), (300, 300, None, True),
                                               (130, 400, 333, False)])
def test_flash_gradient_on_the_card(gen, dtype, tol, s, t, kv_len, causal):
    """The flash ``autograd.Function`` on the card: the forward launches the
    kernel once, and dq, dk, dv (the plain recompute) equal the gradient
    through the plain version in f32 within ``tol`` of the largest entry
    (f32: 1e-4, ``tests/test_ops.py``'s; bf16: 2%, the bf16 recompute)."""
    q = torch.randn((2, s, 3, 64), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, t, 3, 64), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    g = torch.randn((2, s, 3, 64), generator=gen, device="cuda").to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = flash_attention.KERNEL.launches
    out = flash_attention.flash_attention(*leaves, causal=causal, kv_len=kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(
        flash_attention.attention_reference(*ref_leaves, causal, 64 ** -0.5, kv_len),
        ref_leaves, g.float())
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        err = float((a.float() - b).abs().max())
        assert err <= tol * float(b.abs().max()), f"d{name}: {err}"


def test_bf16_train_step_on_the_card(gen, tmp_path):
    """One bf16 train step of a whisper-tiny-width model (remat on) through
    ``WhisperFinetuner``: mel and flash launch, the loss is finite, the
    parameters move, and the step's loss is close to the f32 step's."""
    import datetime as dt
    import wave

    import numpy as np

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.nn.params import init_random, to_jax_params
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.srt import Subtitle, compose_srt
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
    from yoho_tpu_torch.train.whisper_finetune import WhisperFinetuner

    class Words:
        def encode(self, text, add_special_tokens=False):
            return [100 + ["house", "water", "people"].index(w) for w in text.split()]

        def decode(self, ids):
            return " ".join(["house", "water", "people"][int(i) - 100] for i in ids
                            if 100 <= int(i) < 103)

    root = tmp_path / "corpus"
    (root / "transcripts").mkdir(parents=True)
    (root / "audio").mkdir()
    rng = np.random.default_rng(0)
    for f in range(2):
        audio = (rng.standard_normal(16000 * 12) * 0.003).astype(np.float32)
        subs = []
        for u, word in enumerate(["house", "water", "people"]):
            start = 1.0 + 3.0 * u
            audio[int(start * 16000):int(start * 16000) + 4000] += (0.4 * np.sin(
                2 * np.pi * (300 + 100 * u) * np.arange(4000) / 16000)).astype(np.float32)
            subs.append(Subtitle(u + 1, dt.timedelta(seconds=start),
                                 dt.timedelta(seconds=start + 0.25), word))
        (root / "transcripts" / f"t{f}.srt").write_text(compose_srt(subs))
        with wave.open(str(root / "audio" / f"t{f}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.clip(audio * 32768, -32768, 32767).astype("<i2").tobytes())
    cfg = WHISPER_PRESETS["tiny"]
    table = WhisperTokenTable(multilingual=True, text_backend=Words())
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_random(Whisper(cfg, torch.float32), seed=0)
        tuner = WhisperFinetuner(cfg, model, table, root, tmp_path / str(dtype), batch_size=2,
                                 updates=2, warmup_updates=1, learning_rate=1e-4,
                                 augment=False, validation_frequency=0, remat=True,
                                 compute_dtype=dtype, language_whitelist=["en"])
        before = to_jax_params(model)
        counts = (mel_kernel.KERNEL.launches, flash_attention.KERNEL.launches)
        batch = tuner._place(tuner.train_dataloader.get_batch(0))
        losses[dtype] = float(tuner._train_step(*batch))
        tuner._train_step(*tuner._place(tuner.train_dataloader.get_batch(1)))
        assert mel_kernel.KERNEL.launches > counts[0]
        assert flash_attention.KERNEL.launches >= counts[1] + 2 * 3 * cfg.n_audio_layer
        after = dict(_flat(to_jax_params(model)))
        assert any(not np.array_equal(a, after[k]) for k, a in _flat(before))
    assert np.isfinite(losses[torch.bfloat16])
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) <= 0.02 * losses[torch.float32]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------- head dim 16
# The trained YOHO fixture (tests/fixtures/sessions/tiny) has dims 64 on 4
# heads: head dim 16 in both attention kernels, at the tolerances above.

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,t,kv_len,heads", [
    (False, 32, 32, None, 4), (True, 16, 16, None, 4), (False, 16, 32, None, 4),
    (False, 300, 300, 129, 3), (True, 256, 256, 200, 2), (False, 1500, 1500, None, 6)])
def test_flash_kernel_head_dim_16(gen, dtype, causal, tq, t, kv_len, heads):
    """Head dim 16 (bf16 on wgmma at width 16, f32 on FMAs): the fixture's encoder (32
    positions), its teacher-forced causal and cross passes, kv_len inside a
    tile, and a long ragged sequence."""
    q, k, v = (torch.randn((3, n, heads, 16), generator=gen, device="cuda").to(dtype)
               for n in (tq, t, t))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    want = flash_attention.attention_reference(q, k, v, causal, 16 ** -0.5, kv_len)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16", "f32"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s,pos", [(1, None), (3, None), (1, 10), (5, 0), (1, 200)])
@pytest.mark.parametrize("t,kv_len", [(32, 32), (128, 128), (333, 300), (512, 512)])
def test_decode_kernel_head_dim_16(gen, kind, groups, s, pos, t, kv_len):
    """Head dim 16 for every K/V kind, with and without GQA groups: the
    fixture's cross K/V (32 positions) and cache (128), element and word
    copies (333), TMA tiles (512)."""
    if pos is not None and pos + s > kv_len:
        pos = kv_len - s
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    k, v = (torch.randn((2, 2, 16, t), generator=gen, device="cuda").to(q_dtype)
            for _ in range(2))
    q = (torch.randn((2, 2 * groups, s, 16), generator=gen, device="cuda") * 0.5).to(q_dtype)
    if kind in ("bf16", "f32"):
        args, packing = (q, k, v, None, None), 1
    else:
        qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
        args, packing = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), qkv.packing
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len,
                                                  groups=groups, packing=packing)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(*args, pos=pos, kv_len=kv_len,
                                                       groups=groups, packing=packing)
    tol = (1e-4, 1e-5) if kind == "f32" else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


def test_decode_kernel_head_dim_16_per_row_pos(gen):
    """Per-row positions at head dim 16 on the bf16 cache."""
    k, v = (torch.randn((4, 2, 16, 128), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((4, 4, 1, 16), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    pos = torch.tensor([0, 5, 60, 127], dtype=torch.int32, device="cuda")
    got = decode_attention.fused_decode_attention(q, k, v, pos=pos, groups=2)
    want = decode_attention.decode_attention_reference(q, k, v, pos=pos, groups=2)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


# -------------------------------------------------------- head dims 32, 128
# YOHO sessions of dims 384 on 12 heads (32) or 512 on 4 heads (128): the
# flash kernel (bf16 on wgmma, f32 on FMAs), float K/V in the decode kernel.

@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,t,kv_len,heads", [
    (False, 512, 512, None, 4), (True, 256, 256, None, 4), (False, 256, 512, None, 2),
    (False, 300, 300, 129, 3), (True, 256, 256, 200, 2), (False, 77, 77, None, 3)])
def test_flash_kernel_head_dims_32_128(gen, d, dtype, causal, tq, t, kv_len, heads):
    """Head dims 32 and 128 (bf16 on wgmma): the YOHO encoder (512), teacher-forced
    causal (256) and cross (256 x 512) passes, kv_len inside a tile, ragged
    lengths."""
    q, k, v = (torch.randn((3, n, heads, d), generator=gen, device="cuda").to(dtype)
               for n in (tq, t, t))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    want = flash_attention.attention_reference(q, k, v, causal, d ** -0.5, kv_len)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s,pos", [(1, None), (4, None), (32, None), (1, 200), (4, 0),
                                   (32, 100)])
@pytest.mark.parametrize("t,kv_len", [(256, 256), (333, 300), (512, 512)])
def test_decode_kernel_head_dims_32_128(gen, d, q_dtype, groups, s, pos, t, kv_len):
    """Float K/V at head dims 32 and 128, S = 1, 4 and 32 (every query
    instantiation), groups 1 and 2, every load branch (TMA tiles, words,
    element copies), scalar causal positions."""
    if pos is not None and pos + s > kv_len:
        pos = kv_len - s
    k, v = (torch.randn((2, 2, d, t), generator=gen, device="cuda").to(q_dtype)
            for _ in range(2))
    q = (torch.randn((2, 2 * groups, s, d), generator=gen, device="cuda") * d ** -0.5
         ).to(q_dtype)
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(q, k, v, pos=pos, kv_len=kv_len,
                                                  groups=groups)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(q, k, v, pos=pos, kv_len=kv_len,
                                                       groups=groups)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4, 32])
def test_decode_kernel_head_dims_32_128_per_row_pos(gen, d, q_dtype, s):
    """Per-row positions at head dims 32 and 128 on a float cache of 256."""
    k, v = (torch.randn((4, 2, d, 256), generator=gen, device="cuda").to(q_dtype)
            for _ in range(2))
    q = (torch.randn((4, 4, s, d), generator=gen, device="cuda") * d ** -0.5).to(q_dtype)
    pos = torch.tensor([0, 5, 60, 256 - s], dtype=torch.int32, device="cuda")
    got = decode_attention.fused_decode_attention(q, k, v, pos=pos, groups=2)
    want = decode_attention.decode_attention_reference(q, k, v, pos=pos, groups=2)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


def test_other_head_dims_raise(gen):
    """The one head dim the kernels refuse on the card, never falling back:
    int4 K/V at an odd head dim (its bytes hold dims r and r + D/2; the JAX
    package's ``quantize_kv4`` cannot pack one either), below and above
    256, on both routes. Every other head dim runs (the split route above
    256: ``test_flash_kernel_split_head_dims``, ``test_decode_split_head_dims``)."""
    for d in (97, 263):
        for s in (1, 5):
            qd = torch.zeros((1, 2, s, d), device="cuda", dtype=torch.bfloat16)
            packed = torch.zeros((1, 2, d // 2, 128), device="cuda", dtype=torch.uint8)
            scale = torch.ones((1, 2, 1, 128), device="cuda", dtype=torch.bfloat16)
            before = _decode_launches()
            with pytest.raises(ValueError, match=f"head dim {d}"):
                decode_attention.fused_decode_attention(qd, packed, packed, scale, scale,
                                                        packing=2)
            assert _decode_launches() == before


# ------------------------------------------- wgmma at widths 16, 32 and 128
# bf16 at every multiple of 8 up to 128 runs wgmma + TMA at the width 16,
# 32, 64 or 128 that holds it, grouped K/V read once per KV head: each
# width at its own head dim and a padded one, groups 1, 2 and 3.

WGMMA_DIMS = (8, 16, 24, 32, 72, 96, 120, 128)


@pytest.mark.parametrize("d", WGMMA_DIMS)
@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("causal,tq,t,kv_len", [
    (False, 300, 300, None), (True, 300, 300, None), (False, 300, 300, 129),
    (True, 256, 256, 200), (False, 6, 1500, None), (False, 1500, 1500, None)])
def test_flash_kernel_wgmma_widths(gen, d, groups, causal, tq, t, kv_len):
    """The wgmma route at every width: causal and not, kv_len inside a
    tile, Tq != Tk, the ragged T = 1500, 2 KV heads for 2, 4 or 6 query
    heads."""
    assert flash_attention.kernel_route(d, torch.bfloat16) == "wgmma"
    q = torch.randn((2, tq, 2 * groups, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((2, t, 2, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    assert got.shape == q.shape
    want = flash_attention.attention_reference(q, k, v, causal, d ** -0.5, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("d", WGMMA_DIMS)
@pytest.mark.parametrize("groups", [1, 3])
def test_flash_kernel_wgmma_unaligned_view(gen, d, groups):
    """A q view that starts 2 bytes into its allocation (copied for TMA's
    16-byte bases), and K as the first d dims of a wider tensor (not
    contiguous), grouped."""
    h = 2 * groups
    base = torch.randn((2 * 300 * h * d + 1,), generator=gen, device="cuda").to(torch.bfloat16)
    q = base[1:].view(2, 300, h, d)
    wide = torch.randn((2, 300, 2, d + 8), generator=gen, device="cuda").to(torch.bfloat16)
    k = wide[..., :d]
    v = torch.randn((2, 300, 2, d), generator=gen, device="cuda").to(torch.bfloat16)
    got = flash_attention.flash_attention(q, k, v)
    want = flash_attention.attention_reference(q, k, v, False, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("d", [12, 136, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("causal,tq,t,kv_len", [
    (False, 300, 300, None), (True, 256, 256, 200), (False, 77, 512, None)])
def test_flash_kernel_fma_head_dims(gen, d, dtype, groups, causal, tq, t, kv_len):
    """The head dims TMA cannot take run FMAs in both types: 12 (not a
    multiple of 8) at width 16, 136 and 256 at width 256."""
    assert flash_attention.kernel_route(d, dtype) == "fma"
    q = torch.randn((2, tq, 2 * groups, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, t, 2, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    want = flash_attention.attention_reference(q, k, v, causal, d ** -0.5, kv_len)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [12, 100])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s,pos", [(1, None), (4, None), (32, 100), (1, "rows")])
@pytest.mark.parametrize("t,kv_len", [(256, 256), (333, 300), (1500, 1500)])
def test_decode_kernel_float_kv_any_head_dim(gen, d, q_dtype, groups, s, pos, t, kv_len):
    """Float K/V at head dims that are not a multiple of 8 (12 at width 16,
    100 at width 128): every query instantiation, every load branch, scalar
    and per-row positions."""
    if pos == "rows":
        pos = torch.tensor([0, kv_len - s], dtype=torch.int32, device="cuda")
    elif pos is not None and pos + s > kv_len:
        pos = kv_len - s
    k, v = (torch.randn((2, 2, d, t), generator=gen, device="cuda").to(q_dtype)
            for _ in range(2))
    q = (torch.randn((2, 2 * groups, s, d), generator=gen, device="cuda") * d ** -0.5
         ).to(q_dtype)
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(q, k, v, pos=pos, kv_len=kv_len,
                                                  groups=groups)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(q, k, v, pos=pos, kv_len=kv_len,
                                                       groups=groups)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


# ------------------------------------------------------ padded head dims
# Every other head dim runs at the smallest instantiated width that holds
# it: global rows of D, shared memory zero-padded to the width. On the
# wgmma route TMA zero-fills the columns past D.

PADDED_DIMS = (8, 24, 40, 48, 56, 80, 96, 120)


@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,t,kv_len,heads", [
    (False, 300, 300, None, 3), (True, 300, 300, None, 3), (False, 300, 300, 129, 3),
    (True, 256, 256, 200, 2), (False, 6, 1500, None, 3), (False, 512, 512, None, 8)])
def test_flash_kernel_padded_head_dims(gen, d, dtype, causal, tq, t, kv_len, heads):
    """Padded head dims on both routes: causal and not, kv_len inside a
    tile and below T, Tq != Tk, the YOHO encoder's 512 positions."""
    q, k, v = (torch.randn((2, n, heads, d), generator=gen, device="cuda").to(dtype)
               for n in (tq, t, t))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    assert got.shape == q.shape
    want = flash_attention.attention_reference(q, k, v, causal, d ** -0.5, kv_len)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", PADDED_DIMS)
def test_flash_kernel_padded_unaligned_view(gen, d):
    """bf16 at a padded head dim: a view that starts 2 bytes into its
    allocation (copied for TMA's 16-byte bases), and the first d dims of a
    wider tensor (not contiguous), each written with rows of d."""
    base = torch.randn((2 * 300 * 3 * d + 1,), generator=gen, device="cuda").to(torch.bfloat16)
    q = base[1:].view(2, 300, 3, d)
    wide = torch.randn((2, 300, 3, d + 8), generator=gen, device="cuda").to(torch.bfloat16)
    k = wide[..., :d]
    got = flash_attention.flash_attention(q, k, q)
    want = flash_attention.attention_reference(q, k, q, False, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s,pos", [(1, None), (4, None), (32, None), (1, 200), (4, 0),
                                   (32, 100)])
@pytest.mark.parametrize("t,kv_len", [(256, 256), (333, 300), (1500, 1500)])
def test_decode_kernel_padded_head_dims(gen, d, q_dtype, groups, s, pos, t, kv_len):
    """Float K/V at padded head dims: S = 1, 4 and 32, groups 1 and 2, every
    load branch (TMA tiles at 256 in bf16, 4- or 8-byte words at 1500 and f32,
    element copies at 333), scalar causal positions."""
    if pos is not None and pos + s > kv_len:
        pos = kv_len - s
    k, v = (torch.randn((2, 2, d, t), generator=gen, device="cuda").to(q_dtype)
            for _ in range(2))
    q = (torch.randn((2, 2 * groups, s, d), generator=gen, device="cuda") * d ** -0.5
         ).to(q_dtype)
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(q, k, v, pos=pos, kv_len=kv_len,
                                                  groups=groups)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(q, k, v, pos=pos, kv_len=kv_len,
                                                       groups=groups)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4, 32])
def test_decode_kernel_padded_head_dims_per_row_pos(gen, d, q_dtype, s):
    """Per-row positions at padded head dims on a float cache of 256."""
    k, v = (torch.randn((4, 2, d, 256), generator=gen, device="cuda").to(q_dtype)
            for _ in range(2))
    q = (torch.randn((4, 4, s, d), generator=gen, device="cuda") * d ** -0.5).to(q_dtype)
    pos = torch.tensor([0, 5, 60, 256 - s], dtype=torch.int32, device="cuda")
    got = decode_attention.fused_decode_attention(q, k, v, pos=pos, groups=2)
    want = decode_attention.decode_attention_reference(q, k, v, pos=pos, groups=2)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("d", [8, 24, 32, 48])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s,pos", [(1, None), (3, None), (1, 200), (5, 0), (32, 100),
                                   (1, "rows")])
@pytest.mark.parametrize("t,kv_len", [(333, 300), (512, 512), (1536, 1500)])
def test_decode_kernel_padded_integer_kv(gen, d, kind, q_dtype, groups, s, pos, t, kv_len):
    """int8 and int4 K/V at padded head dims (widths 16 and 64; int4 keeps
    its stored split at D / 2): element copies (333), the cache (512) and
    the padded cross K/V (1536, kv_len 1500) through TMA, scalar and
    per-row positions."""
    if pos == "rows":
        pos = torch.tensor([0, kv_len - s], dtype=torch.int32, device="cuda")
    elif pos is not None and pos + s > kv_len:
        pos = kv_len - s
    k, v = (torch.randn((2, 2, d, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((2, 2 * groups, s, d), generator=gen, device="cuda") * d ** -0.5
         ).to(q_dtype)
    qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
    args = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale)
    before = _decode_launches()
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len,
                                                  groups=groups, packing=qkv.packing)
    assert _decode_launches() == before + 1
    want = decode_attention.decode_attention_reference(*args, pos=pos, kv_len=kv_len,
                                                       groups=groups, packing=qkv.packing)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


# ------------------------------------------ several queries on tensor cores
# bf16 reads of S >= 2 queries (a prompt's prefill, folded beams, a
# speculative verify) run decode_attention_mq.cu, one launch at any S; the
# FMA route keeps single queries and f32 q, at every head dim to 256.

MQ_KINDS = ("int8", "int4", "bf16")


def _kv(gen, kind, b, hkv, d, t, dtype=torch.bfloat16):
    """(k, v, k_scale, v_scale, packing): random K/V of ``kind`` (floats in
    ``dtype``)."""
    k, v = (torch.randn((b, hkv, d, t), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    if kind in ("bf16", "float"):
        return k, v, None, None, 1
    qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(
        k.to(torch.bfloat16), v.to(torch.bfloat16))
    return qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale, qkv.packing


def _row_pos(b, end):
    """b per-row positions spread from 0 to ``end``, on the card."""
    return torch.tensor([round(end * i / max(b - 1, 1)) for i in range(b)], dtype=torch.int32,
                        device="cuda")


def _mq_case(gen, kind, groups, d, s, t, pos, kv_len=None, b=2, hkv=2):
    """One bf16 read of s queries: one launch of the tensor-core route (none
    of the FMA route), finite, against the plain version."""
    k, v, ks, vs, packing = _kv(gen, kind, b, hkv, d, t)
    q = (torch.randn((b, hkv * groups, s, d), generator=gen, device="cuda") * d ** -0.5
         ).to(torch.bfloat16)
    if pos == "rows":
        pos = _row_pos(b, (kv_len or t) - s)
    args = (q, k, v, ks, vs)
    kw = dict(pos=pos, kv_len=kv_len, groups=groups, packing=packing)
    assert decode_attention.kernel_route(s, q.dtype) == "mma"
    before = (decode_attention.KERNEL_MQ.launches, decode_attention.KERNEL.launches)
    got = decode_attention.fused_decode_attention(*args, **kw)
    assert (decode_attention.KERNEL_MQ.launches, decode_attention.KERNEL.launches) == \
        (before[0] + 1, before[1])
    assert got.shape == (b, s, hkv * groups, d) and torch.isfinite(got.float()).all()
    want = decode_attention.decode_attention_reference(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("kind", MQ_KINDS)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("pos", [None, 100, "rows"])
@pytest.mark.parametrize("s", [2, 5, 8, 16, 32, 33, 224, 1120])
def test_decode_mq_route_matches_plain(gen, kind, groups, pos, s):
    """S = 2 to 1120 (one, two and four 16-row tiles a block, several
    blocks of rows) at head dim 64 over the padded cross K/V (T 1536,
    kv_len 1500, through TMA): no pos, a scalar causal pos and per-row
    positions, groups 1 and 2."""
    _mq_case(gen, kind, groups, 64, s, 1536, pos, kv_len=1500)


@pytest.mark.parametrize("kind", MQ_KINDS)
@pytest.mark.parametrize("s,pos", [(3, None), (5, 0), (224, 0), (40, "rows")])
@pytest.mark.parametrize("t,kv_len", [(333, 300), (1500, 1500), (512, 512), (8192, 8000)])
def test_decode_mq_route_load_branches(gen, kind, s, pos, t, kv_len):
    """Every load branch of the ring on the tensor-core route: element
    copies (333), 4-byte words (bf16 rows of 1500), TMA tiles (512), and a T
    whose chunks outnumber a cluster's blocks (8192); a causal prefill at
    pos 0, whose first rows read a chunk or two."""
    _mq_case(gen, kind, 1, 64, s, t, pos, kv_len=kv_len, b=3, hkv=3)


@pytest.mark.parametrize("d", [16, 48, 64, 96, 128, 200, 256])
@pytest.mark.parametrize("kind", MQ_KINDS)
@pytest.mark.parametrize("s,pos", [(5, None), (5, "rows"), (224, 0)])
@pytest.mark.parametrize("t,kv_len", [(512, 512), (333, 300)])
def test_decode_mq_route_head_dims(gen, d, kind, s, pos, t, kv_len):
    """The tensor-core route at every width and padded head dims (48 at 64,
    96 at 128, 200 at 256; int4 split at D/2), grouped, through TMA tiles
    and element copies."""
    _mq_case(gen, kind, 2, d, s, t, pos, kv_len=kv_len)


@pytest.mark.parametrize("d", [24, 96, 100, 136, 200, 256])
@pytest.mark.parametrize("kind", ["int8", "int4", "float"])
@pytest.mark.parametrize("q_dtype,s,pos", [
    (torch.bfloat16, 1, None), (torch.bfloat16, 1, 200), (torch.bfloat16, 1, "rows"),
    (torch.float32, 1, None), (torch.float32, 4, 100), (torch.float32, 5, "rows"),
    (torch.float32, 32, None)])
@pytest.mark.parametrize("t,kv_len", [(333, 300), (512, 512)])
def test_decode_fma_route_wide_head_dims(gen, d, kind, q_dtype, s, pos, t, kv_len):
    """The FMA route at the widths it gained (32, 128 and 256 for int8 and
    int4, 256 for floats) and padded head dims there: single queries in bf16
    and f32, and f32 runs of 4, 5 and 32 queries (chunks of 32, of 4 at
    width 256)."""
    k, v, ks, vs, packing = _kv(gen, kind, 2, 2, d, t, q_dtype)
    q = (torch.randn((2, 4, s, d), generator=gen, device="cuda") * d ** -0.5).to(q_dtype)
    if pos == "rows":
        pos = _row_pos(2, kv_len - s)
    args = (q, k, v, ks, vs)
    kw = dict(pos=pos, kv_len=kv_len, groups=2, packing=packing)
    assert decode_attention.kernel_route(s, q_dtype) == "fma"
    chunk = decode_attention.MAX_QUERIES if d <= 128 else decode_attention.MAX_QUERIES_256
    before = (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches)
    got = decode_attention.fused_decode_attention(*args, **kw)
    assert (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches) == \
        (before[0] + -(-s // chunk), before[1])
    want = decode_attention.decode_attention_reference(*args, **kw)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("heads", [2, 3])
def test_whisper_with_wide_head_dims_decodes_on_the_card(gen, heads):
    """A whisper model at head dim 200 (dims 400 on 2 heads) or 136 (dims
    408 on 3) constructs on the card and decodes there over the int8 cross
    K/V and cache: the prompt's prefill (3 queries: the tensor-core route)
    and a step (one query: the FMA route), logits finite and within 5e-2
    (relative norm) of the CPU's plain path in f32 with the same weights."""
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper

    dims = 400 if heads == 2 else 408
    cfg = WhisperConfig(n_mels=16, n_audio_ctx=64, n_audio_state=dims, n_audio_head=heads,
                        n_audio_layer=1, n_vocab=300, n_text_ctx=32, n_text_state=dims,
                        n_text_head=heads, n_text_layer=2)
    model = init_random(Whisper(cfg, dtype=torch.bfloat16, device="cuda"), seed=0)
    ref = Whisper(cfg, dtype=torch.float32, device="cpu")
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    mel = torch.randn((2, 2 * cfg.n_audio_ctx, cfg.n_mels), generator=gen, device="cuda")
    prompt, step = torch.tensor([[1, 2, 3]] * 2), torch.tensor([[4]] * 2)

    def run(m, dev, quantized):
        xa = m.encode_audio(mel.to(dev, m.dtype))
        caches = m.init_caches(2, None, None, quantized)
        ckv = m.cross_kvs(xa, "int8" if quantized else False)
        first = m.decode_step(prompt.to(dev), caches, ckv, 0)[0]
        return first, m.decode_step(step.to(dev), caches, ckv, 3)[0]

    before = (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches)
    with torch.inference_mode():
        got = run(model, "cuda", True)
        want = run(ref, "cpu", False)
    # Per layer a self and a cross read: the prefill's on tensor cores, the
    # step's on FMAs.
    assert (decode_attention.KERNEL.launches - before[0],
            decode_attention.KERNEL_MQ.launches - before[1]) == (4, 4)
    for g, w in zip(got, want):
        g = g.float().cpu()
        assert torch.isfinite(g).all()
        assert float((g - w).norm() / w.norm()) < 5e-2


# ------------------------------------------- head dims above 256: the split
# Both kernels cut the output dims into slices (flash: 256 and the rest's
# width; decode: 256 each) and sum the scores over all of D in every slice.

SPLIT_DIMS = (257, 264, 300, 384, 512, 1024)


@pytest.mark.parametrize("d", SPLIT_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,t,kv_len,heads,kvh", [
    (False, 200, 200, None, 2, 2), (True, 130, 130, None, 2, 1), (False, 77, 333, 300, 4, 2),
    (False, 64, 128, 100, 3, 1), (True, 256, 256, 200, 2, 1)])
def test_flash_kernel_split_head_dims(gen, d, dtype, causal, tq, t, kv_len, heads, kvh):
    """The split route at D = 257 (256 + a 1-dim slice at width 16), 264,
    300, 384 (+ 64, + 128), 512 and 1,024 (whole slices): one call (one
    count), causal, kv_len inside a tile, Tq != Tk, GQA on unexpanded K/V,
    against the plain version at the FMA route's tolerances."""
    assert flash_attention.kernel_route(d, dtype) == "split"
    q = torch.randn((2, tq, heads, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, t, kvh, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = d ** -0.5
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal, scale, kv_len)
    assert flash_attention.KERNEL.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    want = flash_attention.attention_reference(q, k, v, causal, scale, kv_len)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_flash_gradient_at_head_dim_264(gen, dtype, tol):
    """The flash ``autograd.Function`` at D = 264, GQA 4 on 2, causal: the
    forward is the split kernel (one count), dq, dk, dv the plain recompute
    against ``torch.autograd.grad`` through the plain version in f32, at
    ``test_flash_gradient_on_the_card``'s tolerances."""
    q = torch.randn((2, 130, 4, 264), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, 130, 2, 264), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    g = torch.randn((2, 130, 4, 264), generator=gen, device="cuda").to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = flash_attention.KERNEL.launches
    out = flash_attention.flash_attention(*leaves, causal=True)
    assert flash_attention.KERNEL.launches == before + 1
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(
        flash_attention.attention_reference(*ref_leaves, True, 264 ** -0.5), ref_leaves,
        g.float())
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == dtype and a.shape == b.shape and bool(torch.isfinite(a).all())
        err = float((a.float() - b).abs().max())
        assert err <= tol * float(b.abs().max()), f"d{name}: {err}"


@pytest.mark.parametrize("d", [264, 512])
@pytest.mark.parametrize("kind", ["int8", "int4", "float"])
@pytest.mark.parametrize("q_dtype,s,pos", [
    (torch.bfloat16, 1, None), (torch.bfloat16, 1, 200), (torch.bfloat16, 1, "rows"),
    (torch.float32, 1, None), (torch.float32, 5, 100), (torch.float32, 5, "rows"),
    (torch.bfloat16, 5, None), (torch.bfloat16, 5, 100), (torch.bfloat16, 5, "rows"),
    (torch.bfloat16, 224, 0), (torch.bfloat16, 224, None)])
@pytest.mark.parametrize("t,kv_len", [(333, 300), (512, 512)])
def test_decode_split_head_dims(gen, d, kind, q_dtype, s, pos, t, kv_len):
    """Both decode routes above 256 (slices of 256; int4 in byte rows of
    128, dims r and r + D/2 each): one bf16 query and f32 q on FMAs (f32 in
    chunks of 4), several bf16 queries on tensor cores in one launch; every
    K/V kind, no, scalar and per-row pos, groups 2, through element copies
    (333) and TMA tiles (512), against the plain version."""
    assert decode_attention.kernel_slices(d, kind) == (256,) * (d // 256 + (d % 256 > 0))
    k, v, ks, vs, packing = _kv(gen, kind, 2, 2, d, t, q_dtype)
    q = (torch.randn((2, 4, s, d), generator=gen, device="cuda") * d ** -0.5).to(q_dtype)
    if pos == "rows":
        pos = _row_pos(2, kv_len - s)
    args = (q, k, v, ks, vs)
    kw = dict(pos=pos, kv_len=kv_len, groups=2, packing=packing)
    route = decode_attention.kernel_route(s, q_dtype)
    launches = 1 if route == "mma" else -(-s // decode_attention.MAX_QUERIES_256)
    before = (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches)
    got = decode_attention.fused_decode_attention(*args, **kw)
    after = (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches)
    assert after == ((before[0], before[1] + 1) if route == "mma"
                     else (before[0] + launches, before[1]))
    assert got.shape == (2, s, 4, d) and torch.isfinite(got.float()).all()
    want = decode_attention.decode_attention_reference(*args, **kw)
    tol = (1e-4, 1e-5) if q_dtype == torch.float32 else (0.05, 0.02)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0], atol=tol[1])


def _decode_on_card_and_cpu(model, ref, mel, quantized):
    """The prompt's prefill (3 queries: the tensor-core route) and a step
    (one query: the FMA route) of ``model`` on the card and ``ref`` on the
    CPU: the logits of both, and the decode launches on the card by route."""
    prompt, step = torch.tensor([[1, 2, 3]] * 2), torch.tensor([[4]] * 2)

    def run(m, dev):
        xa = m.encode_audio(mel.to(dev, m.dtype))
        caches = m.init_caches(2, None, None, quantized and dev == "cuda")
        kvs = m.cross_kvs(xa, "int8" if quantized and dev == "cuda" else False)
        first = m.decode_step(prompt.to(dev), caches, kvs, 0)[0]
        return first, m.decode_step(step.to(dev), caches, kvs, 3)[0]

    before = (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches)
    with torch.inference_mode():
        got = run(model, "cuda")
        launched = (decode_attention.KERNEL.launches - before[0],
                    decode_attention.KERNEL_MQ.launches - before[1])
        want = run(ref, "cpu")
    return got, want, launched


def test_head_dim_264_models_decode_on_the_card(gen):
    """Whisper at D = 264 (dims 528 on 2 heads; int8 cross K/V and cache)
    and YOHO at D = 264 (dims 1,056 on 4 heads over 2; bf16 caches, float
    cross K/V) construct on the card and decode there through the split
    route: the prefill's reads on tensor cores, the step's on FMAs, a self
    and a cross read per layer each; logits finite and within 5e-2
    (relative norm, ``test_whisper_with_wide_head_dims_decodes_on_the_card``'s)
    of the CPU's plain path in f32 with the same weights."""
    from yoho_tpu_torch.core.config import WhisperConfig, YOHOConfig
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.nn.yoho import YOHOModel

    wcfg = WhisperConfig(n_mels=16, n_audio_ctx=64, n_audio_state=528, n_audio_head=2,
                         n_audio_layer=1, n_vocab=300, n_text_ctx=32, n_text_state=528,
                         n_text_head=2, n_text_layer=2)
    ycfg = YOHOConfig(n_mel_bands=16, max_audio_len=64, max_text_len=32, dims=1056,
                      n_audio_heads=4, n_audio_blocks=1, n_text_heads=4, n_text_blocks=2)
    cases = (
        ("whisper", lambda dev, dt: Whisper(wcfg, dtype=dt, device=dev), wcfg.n_mels,
         2 * wcfg.n_audio_ctx, True),
        ("yoho", lambda dev, dt: YOHOModel(ycfg, 300, voiceprint_dim=32, dtype=dt, device=dev),
         ycfg.n_mel_bands, ycfg.max_audio_len, False))
    for name, build, n_mels, frames, quantized in cases:
        model = init_random(build("cuda", torch.bfloat16), seed=0)
        assert model.decoder.blocks[0].attn.head_dim == 264
        ref = build("cpu", torch.float32)
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        mel = torch.randn((2, frames, n_mels), generator=gen, device="cuda")
        before = flash_attention.KERNEL.launches
        got, want, launched = _decode_on_card_and_cpu(model, ref, mel, quantized)
        assert flash_attention.KERNEL.launches > before, name  # the encoder's split flash
        assert launched == (4, 4), (name, launched)
        for g, w in zip(got, want):
            g = g.float().cpu()
            assert torch.isfinite(g).all(), name
            assert float((g - w).norm() / w.norm()) < 5e-2, name


# ------------------------------------------------- the YOHO serving shapes

def test_mel_kernel_yoho_window(gen):
    """The YOHO frontend's kernel call: scipy framing, HTK, 128 mels, a
    164,080-sample window -> 1,024 frames, then the standardization."""
    from yoho_tpu_torch.core.config import YOHOConfig

    cfg = YOHOConfig()
    audio = torch.randn((4, cfg.n_samples), generator=gen, device="cuda") * 0.2
    got = mel_kernel.fused_yoho_log_mel(audio, cfg)
    want = frontend.yoho_log_mel(audio, cfg)
    assert got.shape == (4, 1024, 128)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


def test_flash_kernel_yoho_encoder_gqa(gen):
    """The full-width YOHO encoder's attention: (16, 512, 6, 64) queries on
    3 KV heads, unexpanded as the model hands them over (head h reads KV
    head h // 2), bf16 on wgmma; bit for bit the kernel on the expanded
    copies."""
    q = torch.randn((16, 512, 6, 64), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((16, 512, 3, 64), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    got = flash_attention.flash_attention(q, k, v, scale=0.125)
    want = flash_attention.attention_reference(q, k, v, False, 0.125)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    expanded = flash_attention.flash_attention(q, k.repeat_interleave(2, dim=2),
                                               v.repeat_interleave(2, dim=2), scale=0.125)
    assert torch.equal(got, expanded)


@pytest.mark.parametrize("t,pos", [(512, None), (256, 200)])
def test_decode_kernel_yoho_reads(gen, t, pos):
    """The full-width YOHO decode reads: the bf16 cross K/V (T 512) and the
    causal bf16 self cache (T 256 at position 200), 6 query heads on 3 KV
    heads (groups 2), batch 16."""
    k, v = (torch.randn((16, 3, 64, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((16, 6, 1, 64), generator=gen, device="cuda") * 0.125).to(torch.bfloat16)
    got = decode_attention.fused_decode_attention(q, k, v, pos=pos, groups=2)
    want = decode_attention.decode_attention_reference(q, k, v, pos=pos, groups=2)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


def test_yoho_fixture_on_the_card(gen):
    """The trained fixture (head dim 16) transcribes its three tone clips on
    the card to golden.json's text, with the tokens of the same transcriber
    on the CPU."""
    import json
    from pathlib import Path

    from yoho_tpu_torch.load import load_transcriber

    root = Path(__file__).parent / "fixtures" / "sessions"
    golden = json.loads((root / "tiny" / "golden.json").read_text())
    cards = load_transcriber(session="tiny", root=str(root), batch=3)
    cpu = load_transcriber(session="tiny", root=str(root), batch=3, device="cpu")
    n = cards.model.cfg.n_samples
    clips = [_tone_clip(s, n) for s in range(3)]
    got = cards.transcribe_many(clips)
    want = cpu.transcribe_many(clips)
    for r, w, g in zip(got, want, golden):
        assert r.text == g["text"] == w.text
        assert [s.tokens for s in r.segments] == [s.tokens for s in w.segments]


def _tone_clip(s: int, n_samples: int) -> np.ndarray:
    """tests/test_checkpoint_fixture.py's clips (that file imports JAX)."""
    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * (440, 880, 1320)[s] * np.arange(int(0.25 * 16000)) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


# --------------------------- batch x heads above a grid axis (65,535 blocks)
# The FMA decode route puts B x Hq blocks on the grid's y axis, the
# tensor-core route B x Hkv on z, flash's FMA and split kernels B x H on
# y: each holds at most 65,535, so a larger batch launches in runs of rows
# (``ops/_build.py::row_chunks``), one count each. Small shapes but the
# batch x heads axis.

def _decode_case(gen, kind, b, hq, hkv, s, t=64, d=64):
    k, v = (torch.randn((b, hkv, d, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((b, hq, s, d), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    pos = torch.randint(0, t - s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "bf16":
        return (q, k, v, None, None), 1, pos
    qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
    return (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), qkv.packing, pos


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_fma_route_past_the_grid_axis(gen, kind):
    """One query a row (a beam step's self read) at B x Hq = 3,280 x 20 =
    65,600 blocks, per-row pos: two launches of 3,276 and 4 rows, against
    the plain version."""
    args, packing, pos = _decode_case(gen, kind, 3280, 20, 20, 1)
    before = (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches)
    got = decode_attention.fused_decode_attention(*args, pos=pos, packing=packing)
    assert (decode_attention.KERNEL.launches - before[0],
            decode_attention.KERNEL_MQ.launches - before[1]) == (2, 0)
    want = decode_attention.decode_attention_reference(*args, pos=pos, packing=packing)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("groups", [1, 2])
def test_decode_mq_route_past_the_grid_axis(gen, kind, groups):
    """Five queries a row (a verify step, folded beams) on tensor cores at
    B x Hkv = 3,300 x 20 = 66,000 blocks (groups 1 and 2), per-row pos: two
    launches, against the plain version."""
    args, packing, pos = _decode_case(gen, kind, 3300, 20 * groups, 20, 5)
    before = (decode_attention.KERNEL.launches, decode_attention.KERNEL_MQ.launches)
    got = decode_attention.fused_decode_attention(*args, pos=pos, groups=groups,
                                                  packing=packing)
    assert (decode_attention.KERNEL.launches - before[0],
            decode_attention.KERNEL_MQ.launches - before[1]) == (0, 2)
    want = decode_attention.decode_attention_reference(*args, pos=pos, groups=groups,
                                                       packing=packing)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("dtype,b,t,h,kvh,d,causal", [
    (torch.float32, 4100, 16, 16, 8, 64, False),   # FMAs: 65,600 blocks
    (torch.float32, 4100, 16, 16, 16, 64, True),
    (torch.bfloat16, 8200, 8, 8, 4, 264, False),   # split: 65,600 blocks a slice
    (torch.float32, 8200, 8, 8, 8, 264, True)])
def test_flash_fma_and_split_past_the_grid_axis(gen, dtype, b, t, h, kvh, d, causal):
    """Flash's FMA kernel (f32) and split route (D = 264) at B x H above
    65,535: two launches, against the plain version at the FMA route's
    tolerances."""
    assert flash_attention.kernel_route(d, dtype) != "wgmma"
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, t, kvh, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.KERNEL.launches == before + 2
    want = flash_attention.attention_reference(q, k, v, causal, d ** -0.5)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_beam_search_at_656_windows_of_20_heads_on_the_card(gen):
    """Beam search over 656 windows x 5 beams of a 20-head whisper (dims
    160, one layer each, 8 audio positions, weights at std 0.1 so that
    every window decodes its own tokens) in f32 on the card: each step's
    self read is 3,280 x 20 = 65,600 blocks on the FMA route (two launches
    a read). The tokens equal the CPU's plain path in f32 with the same
    weights (cuDNN's TF32 off for the convolution stem)."""
    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.infer.beam import beam_search
    from yoho_tpu_torch.infer.decode import make_whisper_step_fn
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper

    cfg = WhisperConfig(n_mels=16, n_audio_ctx=8, n_audio_state=160, n_audio_head=20,
                        n_audio_layer=1, n_vocab=300, n_text_ctx=16, n_text_state=160,
                        n_text_head=20, n_text_layer=1)
    b, beams = 656, 5
    model = init_random(Whisper(cfg, dtype=torch.float32, device="cuda"), seed=0, std=0.1)
    ref = Whisper(cfg, dtype=torch.float32, device="cpu")
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    mel = torch.randn((b, 2 * cfg.n_audio_ctx, cfg.n_mels), generator=gen, device="cuda")
    prompt = torch.tensor([[1, 2, 3]] * b)

    def run(m, dev):
        with torch.inference_mode():
            ckv = m.cross_kvs(m.encode_audio(mel.to(dev)), False)
            caches = m.init_caches(b * beams, torch.float32, None, False)
            return beam_search(make_whisper_step_fn(m, ckv), caches, prompt.to(dev),
                               cfg.n_text_ctx, cfg.n_vocab - 1, beams=beams)[0]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = decode_attention.KERNEL.launches
        got = run(model, "cuda").cpu()
        launched = decode_attention.KERNEL.launches - before
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = run(ref, "cpu")
    # Per step a self read in two launches (3,276 + 4 rows) and the folded
    # cross read (656 x 20 blocks) in one, f32 q on FMAs throughout.
    steps = cfg.n_text_ctx - 3
    assert launched == 3 * steps, launched
    assert len({tuple(r) for r in want.tolist()}) > b // 4  # windows decode apart
    assert torch.equal(got, want), int((got != want).any(1).sum())


# ------------------------------------------- the captured decode programs
# On one card the greedy chunk runs as a CUDA graph (infer/graphs.py):
# captured once per program, replayed chunk by chunk. The replay is held
# bit for bit to the same chunk body run eagerly, and its launch counts to
# the eager run's.

def _tiny_whisper_transcriber(batch, **kw):
    """The trained ``whisper_tiny`` fixture on the card in bf16 with the
    int8 lanes and timestamps, EOT biased away so that every row runs to
    the 32-token horizon (four chunks)."""
    import json
    from pathlib import Path

    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import load_jax_params
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
    from yoho_tpu_torch.train.checkpoint import load_params

    fx = Path(__file__).parent / "fixtures" / "whisper_tiny"
    cfg = WhisperConfig(**json.loads((fx / "config.json").read_text()))
    model = load_jax_params(Whisper(cfg, dtype=torch.bfloat16),
                            load_params(fx / "params.msgpack"))
    table = WhisperTokenTable(multilingual=True)
    return Transcriber(model, token_table=table, batch_size=batch, quantized_cross_kv="int8",
                       quantized_cache=True, cache_dtype=torch.bfloat16,
                       logit_bias={table.eot: -100.0}, **kw)


def _tiny_yoho_transcriber(batch):
    from pathlib import Path

    from yoho_tpu_torch.load import load_transcriber

    return load_transcriber(session="tiny", root=str(Path(__file__).parent / "fixtures"
                                                      / "sessions"), batch=batch)


def _windows_of(tr, n):
    """``n`` windows: the three tone clips, then noise from a seed."""
    rng = np.random.default_rng(3)
    wins = [_tone_clip(s % 3, tr.chunk_samples) for s in range(3)]
    wins += [(0.05 * rng.standard_normal(tr.chunk_samples)).astype(np.float32)
             for _ in range(n - 3)]
    return np.stack(wins)


def _counted(fn):
    kernels = [mel_kernel.KERNEL, flash_attention.KERNEL, *decode_attention.KERNELS,
               w8a8_dense.KERNEL]
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in kernels}


@pytest.mark.parametrize("family,temperature", [("whisper", 0.0), ("yoho", 0.0),
                                                ("whisper", 0.6)])
def test_captured_greedy_equals_the_eager_body_at_batch_16(gen, family, temperature):
    """Batch 16 of the fixtures: the captured program's tokens, lengths,
    sum_logprob and no_speech_prob equal the eager body's bit for bit, with
    the same launches per kernel; a second call captures nothing and gives
    the same again. Above temperature 0 (the fallback ladder's rung) the
    draws come from the generator registered with the graph, seeded as the
    eager body's."""
    from yoho_tpu_torch.infer.graphs import sampling_capturable

    if temperature > 0 and not sampling_capturable():
        pytest.skip("this PyTorch cannot capture a generator")
    tr = _tiny_whisper_transcriber(16) if family == "whisper" else _tiny_yoho_transcriber(16)
    p = len(tr._prompt_ids())
    mel = tr._features(_windows_of(tr, 16))
    eager = tr._build_decode_fn(16, temperature, p, captured=False)
    want, want_n = _counted(lambda: eager(mel, seed=3))
    got, got_n = _counted(lambda: tr._decode_fn(16, temperature)(mel, seed=3))
    program = tr._workspaces[16].graphs[(temperature, p)]
    assert program.captures == 1 and program.replays >= 1
    again, again_n = _counted(lambda: tr._decode_fn(16, temperature)(mel, seed=3))
    assert program.captures == 1
    for out, n in ((got, got_n), (again, again_n)):
        for a, b in zip(out[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert out[2].keys() == want[2].keys()
        for k in want[2]:
            np.testing.assert_array_equal(out[2][k], want[2][k])
        assert n == want_n, (n, want_n)
    assert (want[1] == tr.max_len).any()  # rows that run to the horizon
    assert len({tuple(r) for r in want[0]}) > 1


@pytest.mark.parametrize("case", ["int8-cross", "int8-self-row-pos"])
def test_captured_decode_read_sees_new_contents(gen, case):
    """One S = 1 decode read captured (the FMA route: TMA maps built at
    capture, cluster launch) and replayed after its inputs' contents
    change: the output is the plain version's on the new contents, and
    equals the kernel run eagerly on them."""
    from yoho_tpu_torch.infer.graphs import ChunkGraph

    b, h, d = 16, 12, 64
    t, kv_len = (1536, 1500) if case == "int8-cross" else (512, 512)

    def fill():
        k, v = (torch.randn((b, h, d, t), generator=gen, device="cuda") for _ in range(2))
        qkv = kv_cache.quantize_kv(k, v)
        q = (torch.randn((b, h, 1, d), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
        pos = torch.randint(0, 448, (b,), generator=gen, device="cuda", dtype=torch.int32)
        return q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale, pos

    static = fill()
    out = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device="cuda")

    def read(q, k, v, ks, vs, pos):
        return decode_attention.fused_decode_attention(
            q, k, v, ks, vs, pos=None if case == "int8-cross" else pos, kv_len=kv_len)

    graph = ChunkGraph(lambda: out.copy_(read(*static)))
    graph()  # warm-up + capture
    assert graph.launches_per_replay() == {"decode_attention": 1}
    for _ in range(2):
        new = fill()
        for s, n in zip(static, new):
            s.copy_(n)
        before = decode_attention.KERNEL.launches
        graph()
        torch.cuda.synchronize()
        assert decode_attention.KERNEL.launches == before + 1
        q, k, v, ks, vs, pos = new
        want = decode_attention.decode_attention_reference(
            q, k, v, ks, vs, pos=None if case == "int8-cross" else pos, kv_len=kv_len)
        torch.testing.assert_close(out.float(), want.float(), rtol=0.05, atol=0.02)
        assert torch.equal(out, read(*new))
    assert graph.replays == 2 and graph.captures == 1
