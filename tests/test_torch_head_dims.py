"""The head dims the port's attention kernels take, on the CPU.

Flash takes every head dim D >= 1: bf16 at a multiple of 8 up to 128 on
the wgmma route at the smallest of widths 16, 32, 64 and 128 that holds D;
f32, and every other bf16 head dim up to 256, on the FMA route at the
smallest of 16, 32, 64, 128 and 256; every D above 256 on the split route,
in output slices of width 256 and a rest at the smallest FMA width that
holds it. Decode takes every D >= 1 for float and int8 K/V and every even
D for int4, up to 256 at the smallest of the same five widths that holds
D, above in slices of 256, on either of its routes (FMA: one query, f32 q;
tensor cores: several bf16 queries). The only head dim refused is int4 at
an odd D, which the JAX package's ``quantize_kv4`` cannot pack either.
``kernel_route``, ``kernel_slices`` and ``kernel_width`` of each ops module
are the one statement of that set: the wrappers call them before a
launch, ``doctor --session`` for its rows. The kernels themselves run only
on the card (``tests/test_torch_kernels_cuda.py``); on the CPU every
wrapper runs its plain version, which takes any head dim.
"""

import json
from pathlib import Path

import pytest
import torch

from yoho_tpu_torch.cli import doctor
from yoho_tpu_torch.core.config import WhisperConfig, YOHOConfig
from yoho_tpu_torch.nn import layers
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.nn.yoho import YOHOModel
from yoho_tpu_torch.ops import decode_attention, flash_attention

SESSIONS = Path(__file__).parent / "fixtures" / "sessions"
# The instantiated widths of each kernel, route and K/V kind (csrc/*.cu),
# and the route each width runs today.
WGMMA_WIDTHS = (16, 32, 64, 128)
FMA_WIDTHS = (16, 32, 64, 128, 256)
DECODE_WIDTHS = (16, 32, 64, 128, 256)
TODAY = {(16, torch.float32): "fma", (32, torch.float32): "fma", (64, torch.float32): "fma",
         (128, torch.float32): "fma", (256, torch.float32): "fma",
         (16, torch.bfloat16): "wgmma", (32, torch.bfloat16): "wgmma",
         (64, torch.bfloat16): "wgmma", (128, torch.bfloat16): "wgmma",
         (256, torch.bfloat16): "fma"}


def _expected(d, widths, multiple=1, low=1):
    """The smallest width holding d, or None where the set refuses d."""
    if d % multiple or d < low or d > widths[-1]:
        return None
    return min(w for w in widths if w >= d)


def _flash_slices(d):
    """The split route's slices: 256 per 256 dims, then the rest's FMA width."""
    full, rest = divmod(d, 256)
    return (256,) * full + ((_expected(rest, FMA_WIDTHS),) if rest else ())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_width_table(dtype):
    for d in range(1, 1101):
        if d > 256:
            assert flash_attention.kernel_route(d, dtype) == "split", d
            assert flash_attention.kernel_slices(d, dtype) == _flash_slices(d), d
            assert flash_attention.kernel_width(d, dtype) == 256, d
            continue
        wgmma = dtype == torch.bfloat16 and d % 8 == 0 and d <= 128
        want = _expected(d, WGMMA_WIDTHS if wgmma else FMA_WIDTHS)
        assert flash_attention.kernel_route(d, dtype) == ("wgmma" if wgmma else "fma"), d
        assert flash_attention.kernel_width(d, dtype) == want, d
        assert flash_attention.kernel_slices(d, dtype) == (want,), d
    for w in FMA_WIDTHS:  # the widths map to themselves, on today's routes
        assert flash_attention.kernel_width(w, dtype) == w
        assert flash_attention.kernel_route(w, dtype) == TODAY[(w, dtype)]
    # The slices of the edges: 257 and 264 (256 + 16), 300 (+ 64), 384 (+
    # 128), 512 and 1024 (whole slices), 1100 (+ 128).
    assert flash_attention.kernel_slices(257, dtype) == (256, 16)
    assert flash_attention.kernel_slices(264, dtype) == (256, 16)
    assert flash_attention.kernel_slices(300, dtype) == (256, 64)
    assert flash_attention.kernel_slices(384, dtype) == (256, 128)
    assert flash_attention.kernel_slices(512, dtype) == (256, 256)
    assert flash_attention.kernel_slices(1024, dtype) == (256,) * 4
    assert flash_attention.kernel_slices(1100, dtype) == (256,) * 4 + (128,)
    with pytest.raises(ValueError, match="head dim 0 "):
        flash_attention.kernel_route(0, dtype)
    # Sessions serve in bf16: the default type.
    assert flash_attention.kernel_route(16) == "wgmma"
    assert flash_attention.kernel_width(12) == 16


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_decode_kernel_width_table(kind):
    widths = DECODE_WIDTHS
    assert decode_attention.WIDTHS == widths
    for d in range(1, 1101):
        if kind == "int4" and d % 2:
            with pytest.raises(ValueError, match=f"head dim {d} .*{kind} K/V"):
                decode_attention.kernel_width(d, kind)
            with pytest.raises(ValueError, match=f"head dim {d} .*{kind} K/V"):
                decode_attention.kernel_slices(d, kind)
            continue
        if d > 256:
            assert decode_attention.kernel_slices(d, kind) == (256,) * -(-d // 256), d
            assert decode_attention.kernel_width(d, kind) == 256, d
        else:
            want = _expected(d, widths)
            assert decode_attention.kernel_width(d, kind) == want, d
            assert decode_attention.kernel_slices(d, kind) == (want,), d
    for w in widths:
        assert decode_attention.kernel_width(w, kind) == w
    accepted = [d for d in range(1, 1101) if not (kind == "int4" and d % 2)]
    assert accepted == (list(range(2, 1101, 2)) if kind == "int4" else list(range(1, 1101)))
    assert decode_attention.kernel_slices(264, kind) == (256, 256)
    assert decode_attention.kernel_slices(512, kind) == (256, 256)
    assert decode_attention.kernel_slices(1024, kind) == (256,) * 4
    with pytest.raises(ValueError, match="head dim 0 "):
        decode_attention.kernel_width(0, kind)


@pytest.mark.parametrize("d,kind,width", [
    (136, "float", 256), (200, "float", 256), (256, "float", 256), (96, "int8", 128),
    (136, "int8", 256), (200, "int4", 256), (12, "int4", 16), (40, "int8", 64)])
def test_decode_kernel_width_past_the_old_set(d, kind, width):
    """Head dims the decode kernels refused before their widths reached 256
    for every kind: float K/V past 128, int8 and int4 past 64 or off the
    multiples of 8. Each runs at its width in one slice, on both routes."""
    assert decode_attention.kernel_width(d, kind) == width
    assert decode_attention.kernel_slices(d, kind) == (width,)
    assert decode_attention.kernel_route(1) == "fma"
    assert decode_attention.kernel_route(5) == "mma"
    assert decode_attention.kernel_route(5, torch.float32) == "fma"


def test_models_check_head_dims_on_cuda_only():
    """Construction refuses no head dim any more, on any device: the
    check that refused D > 256 on CUDA is gone (both kernels take every
    head dim), and models at the new edges build: YOHO at D = 264 (dims
    1,056 on 4 heads over 2, the example that used to raise on the card)
    and 300 (dims 600 on 2 heads), whisper at D = 264 (dims 528 on 2) and
    257; each stack's flash route is the split one, and so is the old
    smallest case, D = 12."""
    assert not hasattr(layers, "check_head_dims")
    for dims, heads in ((1056, 4), (600, 2), (48, 4)):  # KV heads: half the query heads
        yoho = YOHOModel(YOHOConfig(n_mel_bands=16, max_audio_len=32, max_text_len=12,
                                    dims=dims, n_audio_heads=heads, n_audio_blocks=1,
                                    n_text_heads=heads, n_text_blocks=1), 64,
                         voiceprint_dim=32, device="cpu")
        d = dims // heads
        assert yoho.decoder.blocks[0].attn.head_dim == d
        assert flash_attention.kernel_route(d) == ("split" if d > 256 else "fma")
    for state, heads in ((528, 2), (514, 2), (24, 2)):
        whisper = Whisper(WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=state,
                                        n_audio_head=heads, n_audio_layer=1, n_vocab=100,
                                        n_text_ctx=8, n_text_state=state, n_text_head=heads,
                                        n_text_layer=1), device="cpu")
        assert whisper.decoder.blocks[0].attn.head_dim == state // heads
    assert decode_attention.kernel_slices(257) == (256, 256)


def _session(root, name, dims, audio_heads, text_heads):
    src = (SESSIONS / "tiny" / "config.toml").read_text()
    for old, new in (("dims = 64", f"dims = {dims}"),
                     ("n_audio_heads = 4", f"n_audio_heads = {audio_heads}"),
                     ("n_text_heads = 4", f"n_text_heads = {text_heads}")):
        assert old in src
        src = src.replace(old, new)
    (root / name).mkdir()
    (root / name / "config.toml").write_text(src)


def test_doctor_session_head_dim_rows(tmp_path, capsys):
    """``doctor --session``: one row per stack with its head dim, route
    and widths; every head dim is ``ok``, above 256 split into slices."""
    _session(tmp_path, "d48", 384, 8, 4)    # D 48 and D 96
    _session(tmp_path, "d12", 48, 4, 2)     # D 12 and D 24
    _session(tmp_path, "d136", 272, 2, 4)   # D 136 and D 68
    _session(tmp_path, "d264", 528, 2, 4)   # D 264 and D 132
    _session(tmp_path, "d512", 1024, 2, 4)  # D 512 and D 256
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d48", str(tmp_path))}
    assert rows == {
        "session:head_dim.encoder": ("ok", "D 48: flash wgmma padded to width 64; decode "
                                           "padded to width 64"),
        "session:head_dim.decoder": ("ok", "D 96: flash wgmma padded to width 128; decode "
                                           "padded to width 128")}
    tiny = doctor._check_head_dims("tiny", str(SESSIONS))
    assert [r[2] for r in tiny] == ["D 16: flash wgmma at width 16; decode at width 16"] * 2
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d12", str(tmp_path))}
    assert rows == {
        "session:head_dim.encoder": ("ok", "D 12: flash fma padded to width 16; decode "
                                           "padded to width 16"),
        "session:head_dim.decoder": ("ok", "D 24: flash wgmma padded to width 32; decode "
                                           "padded to width 32")}
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d136", str(tmp_path))}
    assert rows == {
        "session:head_dim.encoder": ("ok", "D 136: flash fma padded to width 256; decode "
                                           "padded to width 256"),
        "session:head_dim.decoder": ("ok", "D 68: flash fma padded to width 128; decode "
                                           "padded to width 128")}
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d264", str(tmp_path))}
    assert rows == {
        "session:head_dim.encoder": ("ok", "D 264: flash split into 2 slices at widths "
                                           "256 + 16; decode split into 2 slices at widths "
                                           "256 + 256"),
        "session:head_dim.decoder": ("ok", "D 132: flash fma padded to width 256; decode "
                                           "padded to width 256")}
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d512", str(tmp_path))}
    assert rows["session:head_dim.encoder"] == (
        "ok", "D 512: flash split into 2 slices at widths 256 + 256; decode split "
              "into 2 slices at widths 256 + 256")
    assert rows["session:head_dim.decoder"] == ("ok", "D 256: flash fma at width 256; decode "
                                                      "at width 256")
    assert doctor._check_head_dims("nope", str(tmp_path)) == []
    assert doctor.main(["--json", "--no-devices", "--session", "d264", "--root",
                        str(tmp_path)]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert {r["check"]: r["status"] for r in out}["session:head_dim.encoder"] == "ok"


@pytest.mark.parametrize("rows,per_row,runs", [
    (16, 12, [(0, 16)]),                       # whisper-small's batch: one launch
    (3276, 20, [(0, 3276)]),                   # 65,520 blocks: still one
    (3277, 20, [(0, 3276), (3276, 3277)]),     # 65,540: two
    (3280, 20, [(0, 3276), (3276, 3280)]),     # 656 windows x 5 beams x 20 heads
    (65_535, 1, [(0, 65_535)]),
    (200_000, 64, [(0, 1023), (1023, 2046)] + [(r, min(r + 1023, 200_000))
                                               for r in range(2046, 200_000, 1023)]),
    (0, 8, [(0, 0)])])
def test_row_chunks_cover_the_batch_within_the_grid_axis(rows, per_row, runs):
    """The attention wrappers' row planner (``_build.row_chunks``): runs of
    rows in order, each at most 65,535 blocks on the grid axis, together
    the whole batch; one run (the whole call) when it fits."""
    from yoho_tpu_torch.ops._build import GRID_YZ_MAX, row_chunks

    got = row_chunks(rows, per_row)
    assert got == runs
    assert all((b1 - b0) * per_row <= GRID_YZ_MAX for b0, b1 in got)
    assert [b for r in got for b in range(*r)] == list(range(rows))


@pytest.mark.parametrize("per_row", [0, 65_536])
def test_row_chunks_raise_when_one_row_is_over_the_axis(per_row):
    from yoho_tpu_torch.ops._build import row_chunks

    with pytest.raises(ValueError, match="blocks a row"):
        row_chunks(4, per_row)
