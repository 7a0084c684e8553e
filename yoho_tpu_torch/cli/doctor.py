"""``yoho-torch doctor`` — environment self-check for the PyTorch port.

The port's counterpart of the JAX package's ``cli/doctor.py``. A GPU
serving deployment has its own ways to be subtly broken: no CUDA device
visible, no ``nvcc`` (the port's kernels build from source at first use),
a kernel that no longer compiles, host decoders that fell back to pure
Python, missing system codecs, an HF checkpoint directory without weights
or tokenizer files. This command probes each and prints one line per
check; exit code 0 means no hard failures.

The CUDA probe runs in a SUBPROCESS with a timeout: a driver or a card in
a bad state can block initialization indefinitely, and a diagnostic tool
must diagnose that state, not reproduce it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

OK, WARN, FAIL = "ok", "warn", "FAIL"


def _check_package() -> list:
    import yoho_tpu_torch

    root = Path(yoho_tpu_torch.__file__).parent
    return [("package", OK, f"yoho_tpu_torch at {root} "
             f"(python {sys.version.split()[0]})")]


def _check_deps() -> list:
    rows = []
    for mod in ("torch", "numpy", "scipy"):
        try:
            m = __import__(mod)
            rows.append((f"dep:{mod}", OK, getattr(m, "__version__", "?")))
        except Exception as e:  # pragma: no cover - deps are baked in
            rows.append((f"dep:{mod}", FAIL, f"import failed: {e}"))
    return rows


def _check_native() -> list:
    from yoho_tpu_torch import native

    rows = []
    lib = native.get_lib()
    if lib is not None:
        rows.append(("native:core", OK, "C++ wav/flac library loaded"))
    else:
        rows.append(("native:core", WARN,
                     "C++ library unavailable (g++ missing?) — "
                     "pure-Python fallbacks active (slower, same results)"))
    av = native.get_av_lib()
    rows.append(("native:libav", OK if av is not None else WARN,
                 "in-process libav decode (m4a/aac/opus/anything)"
                 if av is not None else
                 "libav headers/libs not found — m4a/aac/opus decode "
                 "falls back to an ffmpeg binary if present"))
    return rows


def _check_codecs() -> list:
    from yoho_tpu_torch.audio import codecs

    rows = []
    for name, fn in (("mp3 (libmpg123)", codecs.mp3_available),
                     ("ogg (libvorbisfile)", codecs.ogg_available)):
        try:
            avail = bool(fn())
        except Exception:
            avail = False
        rows.append((f"codec:{name.split()[0]}",
                     OK if avail else WARN,
                     f"{name}: {'available' if avail else 'not found'}"))
    ff = shutil.which("ffmpeg")
    rows.append(("codec:ffmpeg", OK if ff else WARN,
                 f"last-resort ffmpeg binary: {ff or 'absent'} "
                 "(wav/flac/npy are decoded natively either way)"))
    return rows


_PROBE = r"""
import json, torch
info = {"torch": torch.__version__, "cuda": torch.version.cuda,
        "available": torch.cuda.is_available(), "count": 0}
if info["available"]:
    info["count"] = torch.cuda.device_count()
    info["kind"] = torch.cuda.get_device_name(0)
    info["memory_bytes"] = int(torch.cuda.mem_get_info(0)[1])
    info["capability"] = list(torch.cuda.get_device_capability(0))
print(json.dumps(info))
"""


def _nvidia_smi(timeout: float) -> str:
    smi = shutil.which("nvidia-smi")
    if not smi:
        return ""
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""


def _check_devices(timeout: float) -> list:
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE],
                             capture_output=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return [("devices", FAIL,
                 f"CUDA init blocked for {timeout:.0f}s — a driver or card in "
                 "a bad state, or the card claimed by another process")]
    if out.returncode != 0:
        tail = (out.stderr or b"").decode(errors="replace").strip()
        return [("devices", FAIL,
                 f"torch probe failed: {tail.splitlines()[-1] if tail else out.returncode}")]
    try:
        info = json.loads(out.stdout.decode().strip().splitlines()[-1])
    except (ValueError, IndexError):
        return [("devices", FAIL,
                 f"unparseable probe output: {out.stdout[:200]!r}")]
    if not info["available"]:
        return [("devices", WARN,
                 f"torch {info['torch']}: CUDA not available — every command "
                 "needs --device cpu (the plain PyTorch path)")]
    mem = info["memory_bytes"]
    smi = _nvidia_smi(timeout)
    rows = [("devices", OK,
             f"{info['count']} x {info['kind']} (sm_{''.join(map(str, info['capability']))}, "
             f"{mem / 1e9:.1f} GB; torch {info['torch']}, CUDA {info['cuda']})"
             + (f"; nvidia-smi: {smi}" if smi else ""))]
    if info["capability"] != [9, 0]:
        rows.append(("devices:arch", FAIL,
                     f"the kernels are built for sm_90a (Hopper); this card is "
                     f"sm_{''.join(map(str, info['capability']))}"))
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.capacity import suggest_batch_size

    sizes = {n: suggest_batch_size(WHISPER_PRESETS[n], device_bytes=mem)
             for n in ("small", "large-v3")}
    rows.append(("devices:capacity", OK,
                 "batch_size='auto' (bf16 weights, int8 K/V and cache, "
                 "448-token horizon): "
                 + ", ".join(f"{k}={v}" for k, v in sizes.items())))
    return rows


def _check_kernels(cuda: bool) -> list:
    from yoho_tpu_torch.ops import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        return [("kernels", FAIL if cuda else WARN, str(e))]
    try:
        built = _build.build()
    except RuntimeError as e:
        return [("kernels", FAIL, str(e).splitlines()[0] + " (logs in "
                 f"{_build.BUILD_DIR})")]
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    detail = (f"{len(sources)} kernels of {_build.CSRC.name}/ built for sm_90a "
              f"with {nvcc}: " + (", ".join(f"{s} {built[s]:.1f} s" for s in sorted(built))
                                  if built else "all up to date"))
    return [("kernels", OK, detail)]


def _check_hf(path: str) -> list:
    p = Path(path)
    if not p.is_dir():
        return [("hf", FAIL, f"{path}: not a local checkpoint directory "
                 "(the PyTorch port loads local directories only)")]
    rows = []
    weights = [f for f in ("model.safetensors", "model.safetensors.index.json",
                           "pytorch_model.bin") if (p / f).exists()]
    rows.append(("hf:weights", OK if weights else FAIL,
                 ", ".join(weights) if weights else
                 "no model.safetensors / model.safetensors.index.json / "
                 "pytorch_model.bin found"))
    has_config = (p / "config.json").exists()
    rows.append(("hf:config", OK if has_config else FAIL,
                 "config.json" if has_config else "config.json missing"))
    has_text = ((p / "tokenizer.json").exists()
                or ((p / "vocab.json").exists() and (p / "merges.txt").exists())
                or any(p.glob("*.tiktoken")))
    rows.append(("hf:tokenizer", OK if has_text else WARN,
                 "text backend files present (tokenizer.json, vocab.json+"
                 "merges.txt or *.tiktoken)" if has_text else
                 "no tokenizer files — transcripts would be token ids "
                 "with empty text"))
    return rows


def _check_session(name: str, root: str) -> list:
    from yoho_tpu_torch.core.config import load_session_config

    try:
        config = load_session_config(name, root)
    except FileNotFoundError as e:
        return [("session", FAIL, str(e))]
    except Exception as e:
        return [("session", FAIL, f"config.toml invalid: {e}")]
    rows = [("session", OK, f"{root}/{name}/config.toml parses")]
    for slot in ("tokenizer", "asr", "voice_reconstruction",
                 "voiceprint", "yoho"):
        path = getattr(config.weights, slot, None)
        if path is None:
            continue
        exists = Path(path).exists()
        rows.append((f"session:weights.{slot}", OK if exists else WARN,
                     f"{path} ({'present' if exists else 'not trained yet'})"))
    return rows


def _check_head_dims(name: str, root: str) -> list:
    """One row per stack of the session's model: its head dim and the route
    and widths the attention kernels run it at (sessions serve in bf16).
    The kernels take every head dim, above 256 in slices, so every row is
    ``ok``, with a card or without."""
    import torch

    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.ops import decode_attention, flash_attention

    try:
        cfg = load_session_config(name, root).yoho
    except Exception:  # _check_session reports the config
        return []
    rows = []
    for stack, heads in (("encoder", cfg.n_audio_heads), ("decoder", cfg.n_text_heads)):
        d = cfg.dims // heads
        at = []
        for slices in (flash_attention.kernel_slices(d, torch.bfloat16),
                       decode_attention.kernel_slices(d)):
            if len(slices) > 1:
                at.append(f"split into {len(slices)} slices at widths "
                          + " + ".join(str(w) for w in slices))
            else:
                at.append(f"padded to width {slices[0]}" if slices[0] != d
                          else f"at width {d}")
        route = flash_attention.kernel_route(d, torch.bfloat16)
        flash = at[0] if route == "split" else f"{route} {at[0]}"
        rows.append((f"session:head_dim.{stack}", OK, f"D {d}: flash {flash}; decode {at[1]}"))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="yoho-torch doctor",
        description="Check this environment for serving/training readiness")
    parser.add_argument("--hf", type=str, default=None, metavar="DIR",
                        help="also validate a local HF Whisper checkpoint "
                             "directory (weights/config/tokenizer files)")
    parser.add_argument("--session", type=str, default=None, metavar="NAME",
                        help="also validate a training session's config "
                             "and weight artifacts")
    parser.add_argument("--root", type=str, default="./sessions")
    parser.add_argument("--device-timeout", type=float, default=30.0,
                        metavar="SECONDS",
                        help="max wait for CUDA init in the device probe "
                             "subprocess (a card in a bad state can block "
                             "forever; the probe must not)")
    parser.add_argument("--no-devices", action="store_true",
                        help="skip the device probe and the kernel build "
                             "(e.g. on a build host)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output, one JSON per check")
    args = parser.parse_args(argv)
    rows = _check_package() + _check_deps() + _check_native() + _check_codecs()
    if not args.no_devices:
        dev = _check_devices(args.device_timeout)
        rows += dev + _check_kernels(cuda=dev[0][1] == OK)
    if args.hf:
        rows += _check_hf(args.hf)
    if args.session:
        rows += _check_session(args.session, args.root)
        rows += _check_head_dims(args.session, args.root)

    failed = False
    for name, status, detail in rows:
        failed |= status == FAIL
        if args.json:
            print(json.dumps({"check": name, "status": status,
                              "detail": detail}))
        else:
            print(f"[{status:>4}] {name:<24} {detail}")
    if not args.json:
        print("doctor:", "FAIL (fix the failed checks above)" if failed
              else "all checks passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
