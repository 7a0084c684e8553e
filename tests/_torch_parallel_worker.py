"""One rank of ``tests/test_torch_parallel.py``'s process group.

Started four times (gloo, ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT`` in the environment) with a case directory: reads
``inputs.pkl`` (numpy params, inputs and paths the test wrote), runs every
scenario of the port's ``parallel`` package in the one group, and writes
``out<rank>.pkl`` (each scenario's results, or its traceback). Imports
torch and the port only, never JAX.
"""

import contextlib
import io
import json
import os
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)

from yoho_tpu_torch.core.config import WhisperConfig, YOHOConfig  # noqa: E402
from yoho_tpu_torch.infer.decode import (  # noqa: E402
    greedy_decode,
    make_whisper_step_fn,
    make_yoho_step_fn,
)
from yoho_tpu_torch.infer.pipeline import Transcriber  # noqa: E402
from yoho_tpu_torch.nn.params import init_random, load_jax_params  # noqa: E402
from yoho_tpu_torch.nn.whisper import Whisper  # noqa: E402
from yoho_tpu_torch.nn.yoho import YOHOModel  # noqa: E402
from yoho_tpu_torch.parallel import mesh as pm  # noqa: E402
from yoho_tpu_torch.parallel.sharding import shard_params  # noqa: E402
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable  # noqa: E402

CPU = "cpu"


def _np(t):
    return t.detach().float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


def _mesh():
    return pm.make_mesh(2, 2, device=CPU)


def _tokens(results):
    return [[[int(t) for t in s.tokens] for s in r.segments] for r in results]


def _errors(fn, *cases):
    """(exception type, message) of each failing call."""
    out = []
    for case in cases:
        try:
            fn(*case)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the test reads the type
            out.append((type(e).__name__, str(e)))
    return out


def parse(inp):
    shapes = {spec: dict(pm.parse_mesh(spec, CPU).shape)
              for spec in ("2x2", "-1x2", "1x4", "-1x4", "4x1")}
    errors = _errors(lambda s: pm.parse_mesh(s, CPU), ("8",), ("2x2x2",), ("3x3",),
                     ("1x3",), ("2x4",))
    mesh = _mesh()
    return dict(shapes=shapes, errors=errors, coord=(mesh.index("data"), mesh.index("model")),
                shard=pm.process_shard(), coordinator=pm.is_coordinator(),
                local=pm.local_batch_size(8, mesh), rows=pm.shard_batch(mesh, np.arange(8)).tolist(),
                bad_rows=_errors(lambda: pm.shard_batch(mesh, np.arange(3)), ()))


def _whisper_greedy(model, mel, mesh=None):
    if mesh is not None:
        mel = pm.shard_batch(mesh, mel)
    b = mel.shape[0]
    xa = model.encode_audio(mel)
    ckv = model.cross_kvs(xa)
    caches = model.init_caches(b, torch.float32)
    tokens, lengths = greedy_decode(make_whisper_step_fn(model, ckv), caches,
                                    torch.ones((b, 2), dtype=torch.long), 12, eot_id=63)
    if mesh is not None:
        tokens, lengths = pm.gather_batch(mesh, tokens), pm.gather_batch(mesh, lengths)
    return _np(tokens), _np(lengths)


@torch.inference_mode()
def whisper_greedy(inp):
    """The JAX test's tiny whisper at data 2 x model 2: greedy tokens."""
    cfg = WhisperConfig(**inp["cfg"])
    mel = torch.from_numpy(inp["mel"])
    plain = load_jax_params(Whisper(cfg, device=CPU), inp["params"])
    model = shard_params(load_jax_params(Whisper(cfg, device=CPU), inp["params"]), _mesh())
    pm.reset_counts()
    tokens, lengths = _whisper_greedy(model, mel, _mesh())
    counts = dict(pm.COUNTS)
    attn = model.decoder.blocks[0].attn
    return dict(tokens=tokens, lengths=lengths, plain=_whisper_greedy(plain, mel),
                counts=counts, heads=attn.n_head, q_rows=tuple(attn.q_proj.weight.shape),
                vocab_rows=model.decoder.token_embedding.weight.shape[0])


def quantized(inp):
    """The int8 cross-K/V and cache lane through ``Transcriber(mesh=...)``."""
    cfg = WhisperConfig(**inp["cfg"])
    table = WhisperTokenTable(multilingual=True)
    kw = dict(family="whisper", token_table=table, batch_size=2, device=CPU,
              quantized_cross_kv="int8", quantized_cache=True)
    plain = Transcriber(load_jax_params(Whisper(cfg, device=CPU), inp["params"]), **kw)
    mesh = _mesh()
    sharded = Transcriber(load_jax_params(Whisper(cfg, device=CPU), inp["params"]),
                          mesh=mesh, **kw)
    got, want = sharded.transcribe_many([inp["audio"]]), plain.transcribe_many([inp["audio"]])
    with torch.inference_mode():
        mel = sharded._features(np.zeros((4, cfg.n_samples), np.float32))
        ckvs = sharded.model.cross_kvs(sharded.model.encode_audio(mel), "int8")
    return dict(tokens=_tokens(got), plain=_tokens(want),
                starts=[[round(s.start, 3) for s in r.segments] for r in got],
                ckv_shapes=[{n: tuple(getattr(c, n).shape)
                             for n in ("k_q", "v_q", "k_scale", "v_scale")} for c in ckvs],
                mel_rows=mel.shape[0])


def yoho_session(inp):
    """The trained YOHO fixture session through ``load_transcriber(mesh=...)``."""
    from yoho_tpu_torch.load import load_transcriber

    kw = dict(session="tiny", root=inp["root"], batch=4, device=CPU)
    got = load_transcriber(mesh=_mesh(), **kw).transcribe_many(inp["clips"])
    want = load_transcriber(**kw).transcribe_many(inp["clips"])
    return dict(texts=[r.text for r in got], tokens=_tokens(got), plain=_tokens(want))


def _yoho_greedy(model, mel, mesh=None):
    if mesh is not None:
        mel = pm.shard_batch(mesh, mel)
    b = mel.shape[0]
    ckv = model.cross_kvs(model.encode_audio(mel))
    tokens, lengths = greedy_decode(make_yoho_step_fn(model, ckv), model.init_caches(b),
                                    torch.ones((b, 1), dtype=torch.long), 8, eot_id=2)
    if mesh is not None:
        tokens, lengths = pm.gather_batch(mesh, tokens), pm.gather_batch(mesh, lengths)
    return _np(tokens), _np(lengths)


@torch.inference_mode()
def yoho_models(inp):
    """YOHO models at data 2 x model 2: 3 KV heads (attention whole, the
    MLPs and the vocabulary sharded) and MoE in both stacks (experts
    sharded)."""
    out = {}
    mel = torch.from_numpy(inp["mel"])
    for name, kw in inp["configs"].items():
        cfg = YOHOConfig(**kw)

        def build():
            return init_random(YOHOModel(cfg, 300, 16, device=CPU), seed=3, std=0.3)

        model = shard_params(build(), _mesh())
        enc, dec = model.encoder.blocks[0], model.decoder.blocks[0]
        out[name] = dict(
            tokens=_yoho_greedy(model, mel, _mesh()), plain=_yoho_greedy(build(), mel),
            heads=(enc.attn.q_heads, enc.attn.kv_heads, dec.attn.q_heads, dec.attn.kv_heads),
            sharded_attn=getattr(enc.attn, "tp", None) is not None,
            experts=getattr(enc.mlp, "local_experts", None),
            hidden=(enc.mlp.experts.gate.kernel.shape[0] if hasattr(enc.mlp, "experts")
                    else enc.mlp.gate.out_features),
            vocab_rows=model.decoder.token_embedding.weight.shape[0])
    return out


@torch.inference_mode()
def ring(inp):
    """``ring_attention`` over a 4-way ``seq`` axis."""
    from yoho_tpu_torch.parallel.ring_attention import ring_attention

    mesh = pm.init_mesh({"seq": 4}, CPU)
    i, out = mesh.index("seq"), {}
    for name, (q, k, v, dtype) in inp.items():
        s = q.shape[2] // 4
        part = [torch.from_numpy(x[:, :, i * s:(i + 1) * s]).to(getattr(torch, dtype))
                for x in (q, k, v)]
        pm.reset_counts()
        got = ring_attention(*part, mesh, "seq")
        counts = dict(pm.COUNTS)
        out[name] = dict(out=_np(pm.all_gather(got, mesh, "seq", 2)), dtype=str(got.dtype),
                         counts=counts)
    return out


@torch.inference_mode()
def long_encoder(inp):
    """``yoho_encode_long`` at seq 4 on 4x the trained window, and its
    guards."""
    from yoho_tpu_torch.parallel.long_encoder import yoho_encode_long

    cfg = YOHOConfig(**inp["cfg"])
    model = load_jax_params(YOHOModel(cfg, 300, device=CPU), inp["params"])
    mesh = pm.init_mesh({"seq": 4}, CPU)
    mel = torch.from_numpy(inp["mel"])
    got = yoho_encode_long(model, mel, mesh)
    moe = YOHOModel(YOHOConfig(**dict(inp["cfg"], n_experts=2)), 300, device=CPU)
    errors = _errors(lambda m, x: yoho_encode_long(m, x, mesh),
                     (model, torch.zeros((1, cfg.max_audio_len + 2, cfg.n_mel_bands))),
                     (moe, mel))
    return dict(out=_np(got), plain=_np(model.encode_audio(mel)), errors=errors)


@torch.inference_mode()
def pipeline(inp):
    """``pipeline_encode`` at pipe 2 (two replicas) and at data 2 x pipe 2,
    and its guards."""
    from yoho_tpu_torch.parallel.pipeline import pipeline_encode

    cfg = YOHOConfig(**inp["cfg"])
    model = load_jax_params(YOHOModel(cfg, 64, device=CPU), inp["params"])
    mel = torch.from_numpy(inp["mel"])
    pipe = pm.init_mesh({"replica": 2, "pipe": 2}, CPU)
    dp = pm.init_mesh({"data": 2, "pipe": 2}, CPU)
    pm.reset_counts()
    got = pipeline_encode(model, mel, pipe, n_microbatches=2)
    counts = dict(pm.COUNTS)
    got_dp = pipeline_encode(model, mel, dp, n_microbatches=2)
    three = YOHOModel(YOHOConfig(**dict(inp["cfg"], n_audio_blocks=3)), 64, device=CPU)
    errors = _errors(lambda m, x: pipeline_encode(m, x, pipe, n_microbatches=2),
                     (three, mel), (model, mel[:3]))
    return dict(pipe=_np(got), dp=_np(got_dp), counts=counts, errors=errors)


def whisper_fixture(inp):
    """The trained whisper_tiny fixture (an HF directory) at data 2 x
    model 2 through ``load_transcriber(mesh=...)`` and ``transcribe
    --mesh``."""
    from yoho_tpu_torch.cli import transcribe
    from yoho_tpu_torch.load import load_transcriber

    kw = dict(hf=inp["hf"], batch=4, int8_kv=True, timestamps=False, device=CPU)
    got = load_transcriber(mesh="2x2", **kw).transcribe_many(inp["wavs"])
    want = load_transcriber(**kw).transcribe_many(inp["wavs"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = transcribe.main([*inp["wavs"], "--hf", inp["hf"], "--mesh", "2x2", "--batch",
                              "4", "--int8-kv", "--no-timestamps", "--json", "--device", CPU])
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    return dict(texts=[r.text for r in got], tokens=_tokens(got), plain=_tokens(want),
                cli_rc=rc, cli_texts=[d["text"] for d in lines])


SCENARIOS = (parse, whisper_greedy, quantized, yoho_session, yoho_models, ring,
             long_encoder, pipeline, whisper_fixture)


def main() -> None:
    case = Path(sys.argv[1])
    rank = int(os.environ["RANK"])
    inp = pickle.loads((case / "inputs.pkl").read_bytes())
    out = {}
    for fn in SCENARIOS:
        print(f"rank {rank}: {fn.__name__}", flush=True)
        try:
            out[fn.__name__] = fn(inp.get(fn.__name__))
        except Exception:  # noqa: BLE001 - the test reports it
            out[fn.__name__] = {"error": traceback.format_exc()}
    (case / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
