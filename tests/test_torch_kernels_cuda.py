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

import pytest
import torch

from yoho_tpu_torch.audio import frontend
from yoho_tpu_torch.nn import kv_cache
from yoho_tpu_torch.ops import decode_attention, flash_attention, mel_kernel, w8a8_dense

pytestmark = pytest.mark.cuda


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
    before = decode_attention.KERNEL.launches
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len,
                                                  packing=packing)
    assert decode_attention.KERNEL.launches == before + 1
    want = decode_attention.decode_attention_reference(*args, pos=pos, kv_len=kv_len,
                                                       packing=packing)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("pos", [None, 0, 200])
@pytest.mark.parametrize("s", [33, 64, 224, 1120])
def test_decode_kernel_long_query_runs(gen, kind, pos, s):
    """More than 32 queries (a prompt's prefill, beams folded into the query
    axis) run through the kernel in chunks of 32, one launch each, a causal
    chunk at pos + its first query."""
    t, kv_len = 1536, 1500
    k, v = (torch.randn((2, 4, 64, t), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn((2, 4, s, 64), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    if kind == "bf16":
        args, packing = (q, k, v, None, None), 1
    else:
        qkv = (kv_cache.quantize_kv if kind == "int8" else kv_cache.quantize_kv4)(k, v)
        args, packing = (q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale), qkv.packing
    before = decode_attention.KERNEL.launches
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len,
                                                  packing=packing)
    assert decode_attention.KERNEL.launches == before + -(-s // decode_attention.MAX_QUERIES)
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
    before = decode_attention.KERNEL.launches
    got = decode_attention.fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    assert decode_attention.KERNEL.launches == before + 1
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
    verify's 5 and a chunked 40. Rows at pos 0 leave most of their cluster
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
    before = decode_attention.KERNEL.launches
    got = decode_attention.fused_decode_attention(*args, pos=pos, packing=packing)
    assert decode_attention.KERNEL.launches == before + -(-s // decode_attention.MAX_QUERIES)
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
    with pytest.raises(ValueError):
        flash_attention.flash_attention(*(torch.zeros((1, 8, 1, 12), device="cuda")
                                          for _ in range(3)))
    w_q = torch.zeros((8, 48), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # K % 32 != 0
        w8a8_dense.w8a8_dense(torch.zeros((2, 48), device="cuda"), w_q,
                              torch.ones(8, device="cuda"))
    with pytest.raises(TypeError):  # fp16 x
        w8a8_dense.w8a8_dense(torch.zeros((2, 48), device="cuda", dtype=torch.float16),
                              w_q, torch.ones(8, device="cuda"))
