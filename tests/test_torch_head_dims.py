"""The head dims the port's attention kernels take, on the CPU.

Flash takes every head dim D from 1 to 256: bf16 at a multiple of 8 up to
128 on the wgmma route at the smallest of widths 16, 32, 64 and 128 that
holds D; f32, and every other bf16 head dim, on the FMA route at the
smallest of 16, 32, 64, 128 and 256. Decode takes every D from 1 to 256
for float and int8 K/V and every even D to 256 for int4, at the smallest
of the same five widths that holds D, on either of its routes (FMA: one
query, f32 q; tensor cores: several bf16 queries). ``kernel_width`` (and flash's ``kernel_route``)
of each ops module is the one statement of that set: the wrappers call it
before a launch, the models at construction on a CUDA device, ``doctor
--session`` for its rows. The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``); on the CPU every wrapper runs its
plain version, which takes any head dim.
"""

import json
from pathlib import Path

import pytest
import torch

from yoho_tpu_torch.cli import doctor
from yoho_tpu_torch.core.config import WhisperConfig, YOHOConfig
from yoho_tpu_torch.nn.layers import check_head_dims
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_width_table(dtype):
    for d in range(1, 301):
        if d > 256:
            for fn in (flash_attention.kernel_width, flash_attention.kernel_route):
                with pytest.raises(ValueError, match=f"head dim {d} "):
                    fn(d, dtype)
            continue
        wgmma = dtype == torch.bfloat16 and d % 8 == 0 and d <= 128
        want = _expected(d, WGMMA_WIDTHS if wgmma else FMA_WIDTHS)
        assert flash_attention.kernel_route(d, dtype) == ("wgmma" if wgmma else "fma"), d
        assert flash_attention.kernel_width(d, dtype) == want, d
    for w in FMA_WIDTHS:  # the widths map to themselves, on today's routes
        assert flash_attention.kernel_width(w, dtype) == w
        assert flash_attention.kernel_route(w, dtype) == TODAY[(w, dtype)]
    # Sessions serve in bf16: the default type.
    assert flash_attention.kernel_route(16) == "wgmma"
    assert flash_attention.kernel_width(12) == 16


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_decode_kernel_width_table(kind):
    widths = DECODE_WIDTHS
    rule = dict(multiple=2, low=2) if kind == "int4" else dict(multiple=1, low=1)
    assert decode_attention.WIDTHS == widths
    for d in range(1, 301):
        want = _expected(d, widths, **rule)
        if want is None:
            with pytest.raises(ValueError, match=f"head dim {d} .*{kind} K/V"):
                decode_attention.kernel_width(d, kind)
        else:
            assert decode_attention.kernel_width(d, kind) == want, d
    for w in widths:
        assert decode_attention.kernel_width(w, kind) == w
    accepted = [d for d in range(1, 301) if _expected(d, widths, **rule) is not None]
    assert accepted == (list(range(2, 257, 2)) if kind == "int4" else list(range(1, 257)))


@pytest.mark.parametrize("d,kind,width", [
    (136, "float", 256), (200, "float", 256), (256, "float", 256), (96, "int8", 128),
    (136, "int8", 256), (200, "int4", 256), (12, "int4", 16), (40, "int8", 64)])
def test_decode_kernel_width_past_the_old_set(d, kind, width):
    """Head dims the decode kernels refused before their widths reached 256
    for every kind: float K/V past 128, int8 and int4 past 64 or off the
    multiples of 8. Each runs at its width, on both routes, and a model of
    that head dim passes the construction check."""
    assert decode_attention.kernel_width(d, kind) == width
    assert decode_attention.kernel_route(1) == "fma"
    assert decode_attention.kernel_route(5) == "mma"
    assert decode_attention.kernel_route(5, torch.float32) == "fma"
    check_head_dims({"encoder": d, "decoder": d}, torch.device("cuda"))


def test_models_check_head_dims_on_cuda_only():
    """The construction check: a CUDA device refuses a stack outside the
    set, naming it and its head dim (past 256 both kernels refuse it, flash
    named first); the CPU takes any head dim (a model at D = 12 builds
    there, and so it does on CUDA now)."""
    cuda = torch.device("cuda")  # a device object only: nothing is allocated
    with pytest.raises(ValueError, match="encoder: flash kernel head dim 264 "):
        check_head_dims({"encoder": 264, "decoder": 48}, cuda)
    with pytest.raises(ValueError, match="decoder: flash kernel head dim 257 "):
        check_head_dims({"encoder": 8, "decoder": 257}, cuda)
    for d in (8, 12, 24, 48, 96, 100, 128, 136, 200, 256):
        check_head_dims({"encoder": d, "decoder": d}, cuda)
    check_head_dims({"encoder": 264, "decoder": 300}, torch.device("cpu"))
    yoho = YOHOModel(YOHOConfig(n_mel_bands=16, max_audio_len=32, max_text_len=12, dims=48,
                                n_audio_heads=4, n_audio_blocks=1, n_text_heads=4,
                                n_text_blocks=1), 64, voiceprint_dim=32, device="cpu")
    assert yoho.decoder.blocks[0].attn.head_dim == 12
    whisper = Whisper(WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=24, n_audio_head=2,
                                    n_audio_layer=1, n_vocab=100, n_text_ctx=8,
                                    n_text_state=24, n_text_head=2, n_text_layer=1),
                      device="cpu")
    assert whisper.decoder.blocks[0].attn.head_dim == 12


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
    """``doctor --session``: one row per stack with its head dim, route and
    width; FAIL outside the set when CUDA is present, warn without it."""
    _session(tmp_path, "d48", 384, 8, 4)    # D 48 and D 96
    _session(tmp_path, "d12", 48, 4, 2)     # D 12 and D 24
    _session(tmp_path, "d136", 272, 2, 4)   # D 136 and D 68
    _session(tmp_path, "d264", 528, 2, 4)   # D 264 and D 132
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d48", str(tmp_path), True)}
    assert rows == {
        "session:head_dim.encoder": ("ok", "D 48: flash wgmma padded to width 64; decode "
                                           "padded to width 64"),
        "session:head_dim.decoder": ("ok", "D 96: flash wgmma padded to width 128; decode "
                                           "padded to width 128")}
    tiny = doctor._check_head_dims("tiny", str(SESSIONS), True)
    assert [r[2] for r in tiny] == ["D 16: flash wgmma at width 16; decode at width 16"] * 2
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d12", str(tmp_path), True)}
    assert rows == {
        "session:head_dim.encoder": ("ok", "D 12: flash fma padded to width 16; decode "
                                           "padded to width 16"),
        "session:head_dim.decoder": ("ok", "D 24: flash wgmma padded to width 32; decode "
                                           "padded to width 32")}
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d136", str(tmp_path), True)}
    assert rows == {
        "session:head_dim.encoder": ("ok", "D 136: flash fma padded to width 256; decode "
                                           "padded to width 256"),
        "session:head_dim.decoder": ("ok", "D 68: flash fma padded to width 128; decode "
                                           "padded to width 128")}
    rows = {n: (st, det) for n, st, det in doctor._check_head_dims("d264", str(tmp_path), True)}
    assert rows["session:head_dim.encoder"][0] == "FAIL"
    assert "D 264 (dims 528 / 2 heads): flash kernel head dim 264 " in \
        rows["session:head_dim.encoder"][1]
    assert rows["session:head_dim.decoder"] == ("ok", "D 132: flash fma padded to width 256; "
                                                      "decode padded to width 256")
    cpu = dict((n, st) for n, st, _ in doctor._check_head_dims("d264", str(tmp_path), False))
    assert cpu["session:head_dim.encoder"] == "warn"
    assert doctor._check_head_dims("nope", str(tmp_path), True) == []
    assert doctor.main(["--json", "--no-devices", "--session", "d264", "--root",
                        str(tmp_path)]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert {r["check"]: r["status"] for r in out}["session:head_dim.encoder"] == "warn"
