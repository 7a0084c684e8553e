"""The port's serving over a mesh (continuous batching, the micro-batcher,
the speculative slot engine and ``serve --mesh``) over a real process
group: four gloo ranks on the CPU.

One group runs every scenario (``tests/_torch_parallel_serve_worker.py``,
which imports torch and the port only): rank 0 takes the requests and
broadcasts the schedule, the other ranks follow it. This file makes the
inputs and the JAX package's results on the same weights (one unsharded
``Transcriber`` and one ``ContinuousBatcher`` over its faked devices'
``make_mesh(1, 4)``), starts the ranks once per module and compares.
Tolerances are the JAX tests' (``tests/test_distributed.py``): tokens
exact.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yoho_tpu.core.config import WhisperConfig
from yoho_tpu.infer.continuous import ContinuousBatcher
from yoho_tpu.infer.pipeline import Transcriber
from yoho_tpu.nn.whisper import Whisper
from yoho_tpu.parallel.mesh import make_mesh
from yoho_tpu.text.whisper_tokens import WhisperTokenTable

from test_torch_parallel import (
    SESSION_GOLDEN,
    WHISPER_GOLDEN,
    _free_port,
    _host,
    _session_clip,
    _whisper_fixture_dir,
)

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "_torch_parallel_serve_worker.py"
RANKS = 4
# tests/test_distributed.py's continuous tensor-parallel model, and the JAX
# dry run's draft (__graft_entry__.py).
CFG = dict(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=4, n_audio_layer=1,
           n_vocab=51865, n_text_ctx=24, n_text_state=32, n_text_head=4, n_text_layer=1,
           chunk_seconds=0.32)
DRAFT_CFG = dict(CFG, n_audio_state=16, n_audio_head=2, n_text_state=16, n_text_head=2)


def _init(cfg: dict, seed: int):
    model = Whisper(WhisperConfig(**cfg))
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 8), jnp.float32),
                             jnp.zeros((1, 4), jnp.int32))


def _tokens(results):
    return [[[int(t) for t in s.tokens] for s in r.segments] for r in results]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Inputs, the JAX results on the same weights, and the four ranks'
    outputs."""
    case = tmp_path_factory.mktemp("parallel_serve")
    model, variables = _init(CFG, 0)
    _dmodel, dvars = _init(DRAFT_CFG, 4)
    g = np.random.default_rng(1)
    n = WhisperConfig(**CFG).n_samples
    audios = [(0.1 * g.standard_normal(n)).astype(np.float32) for _ in range(3)]
    kw = dict(family="whisper", token_table=WhisperTokenTable(multilingual=True),
              timestamps=True, quantized_cross_kv="int8", quantized_cache=True, batch_size=2)
    want = dict(plain=_tokens(Transcriber(model, variables, **kw).transcribe_many(audios)))
    sharded = Transcriber(model, variables, mesh=make_mesh(1, 4, devices=jax.devices()[:4]),
                          **kw)
    batcher = ContinuousBatcher(sharded, max_batch=2, chunk_tokens=4)
    try:
        want["mesh"] = _tokens([batcher.submit(a) for a in audios])
    finally:
        batcher.close()

    from yoho_tpu_torch.core.config import load_session_config

    root = TESTS / "fixtures" / "sessions"
    n_yoho = load_session_config("tiny", str(root)).yoho.n_samples
    fixture = _whisper_fixture_dir(case)
    inputs = dict(cfg=CFG, params=_host(variables["params"]), draft_cfg=DRAFT_CFG,
                  draft_params=_host(dvars["params"]), audios=audios, root=str(root),
                  clips=[_session_clip(s, n_yoho) for s in range(3)], hf=fixture["hf"],
                  wav=fixture["wavs"][0])
    (case / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(TESTS.parent),
                                                      os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(case)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    outs = [pickle.loads((case / f"out{r}.pkl").read_bytes()) for r in range(RANKS)]
    return inputs, want, outs


def _result(group, name, rank=0):
    out = group[2][rank][name]
    assert "error" not in out, out.get("error")
    return out


@pytest.mark.parametrize("spec", ["1x4", "2x2"])
def test_continuous_batching_over_the_mesh_decodes_the_jax_tokens(group, spec):
    """tests/test_distributed.py's int8 whisper, 3 requests submitted at
    once on rank 0 (2 slots, chunks of 4): the tokens of JAX's unsharded
    transcribe_many, of JAX's ContinuousBatcher on make_mesh(1, 4) and of
    the port's unsharded ContinuousBatcher."""
    want = group[1]
    got = _result(group, "continuous")
    assert want["plain"] == want["mesh"] == got["plain"]
    assert got[spec]["tokens"] == want["plain"]


@pytest.mark.parametrize("spec", ["1x4", "2x2"])
def test_followers_engine_stats_equal_the_leaders(group, spec):
    """Every rank ran the leader's chunks, occupancy and reaps, on its own
    share of the slots (2 over data 1, 1 a rank over data 2), one
    schedule broadcast a tick."""
    outs = [_result(group, "continuous", r)[spec] for r in range(RANKS)]
    assert outs[0]["stats"]["chunks"] > 0
    assert all(o["stats"] == outs[0]["stats"] for o in outs)
    assert all(o["ticks"] == outs[0]["ticks"] for o in outs)
    assert {o["local_slots"] for o in outs} == {2 // int(spec[0])}


def test_cancel_frees_the_slot_at_one_chunk_on_every_rank(group):
    """A client gone mid-decode: RequestCancelled on rank 0, its slot
    freed at the same chunk on every rank, and the other request keeps the
    unsharded tokens."""
    outs = [_result(group, "cancel", r) for r in range(RANKS)]
    lead = outs[0]
    assert lead["cancelled_is_request"], lead["first"]
    assert len(lead["freed"]) == 1 and lead["freed"][0][1] == 1
    assert all(o["freed"] == lead["freed"] for o in outs)
    assert all(o["stats"] == lead["stats"] for o in outs)
    assert lead["second"] == group[1]["plain"][1]
    assert lead["counters"]["requests_cancelled"] == 1
    assert lead["counters"]["requests_served"] == 1


def test_a_device_error_on_one_rank_resets_every_rank(group):
    """A device call failing on rank 1 alone: the ranks agree at the tick's
    end, rank 0's request fails naming another rank, every rank resets its
    slots at the same chunk, and the next request gets the unsharded
    tokens."""
    outs = [_result(group, "device_error", r) for r in range(RANKS)]
    lead = outs[0]
    assert "failed on another rank" in lead["first"]
    assert lead["second"] == group[1]["plain"][1]
    assert all(o["stats"] == lead["stats"] and not o["busy"] for o in outs)
    assert lead["counters"]["requests_failed"] == 1
    assert lead["counters"]["requests_served"] == 1


def test_speculative_slots_over_the_mesh_give_the_greedy_tokens(group):
    """The speculative slot engine at 2x2 (the JAX dry run's 16-wide,
    2-head draft, gamma 2): each slot commits its own accepted length and
    the committed streams are the greedy tokens; every rank ran the same
    chunks."""
    outs = [_result(group, "speculative", r) for r in range(RANKS)]
    assert outs[0]["gamma"] == 2
    assert outs[0]["tokens"] == group[1]["plain"]
    assert all(o["stats"] == outs[0]["stats"] for o in outs)


def test_microbatcher_over_the_mesh_with_beams_and_a_prompt(group):
    """The MicroBatcher at 2x2, beams 2 and a per-request prompt on one of
    the three requests: the unsharded transcribe_many's tokens; the
    followers took the leader's batches."""
    got = _result(group, "micro")
    assert got["tokens"] == got["plain"]
    assert got["batches"] >= 1
    assert all(_result(group, "micro", r)["ticks"] == got["ticks"] for r in range(RANKS))


def test_yoho_session_continuous_over_the_mesh_gives_the_golden_text(group):
    """The trained YOHO fixture session served continuously at 2x2:
    golden.json's text."""
    got = _result(group, "yoho_session")
    assert got["texts"] == [g["text"] for g in SESSION_GOLDEN]
    assert all(_result(group, "yoho_session", r)["stats"] == got["stats"]
               for r in range(RANKS))


def test_serve_mesh_command_serves_drains_and_exits(group):
    """``serve --mesh 2x2 --continuous`` in the group: rank 0 alone binds
    and prints; after an idle pause longer than the schedule's interval
    its /transcribe and /stream answer with the fixture's golden text; on
    SIGTERM (every rank gets it) rank 0 drains and every rank exits 0."""
    lead = _result(group, "serve_command")
    assert "error" not in lead, lead.get("error")
    assert lead["rc"] == 0 and "serving on http://127.0.0.1:" in lead["stdout"]
    assert lead["transcribe"] == WHISPER_GOLDEN["sentences"][0]
    assert lead["stream"] == WHISPER_GOLDEN["sentences"][0]
    for r in range(1, RANKS):
        got = _result(group, "serve_command", r)
        assert got["rc"] == 0 and got["stdout"] == "" and got["sigterm_sent"]


def test_indivisible_slots_and_follower_submit_raise(group):
    """3 slots on a data axis of 2 raise shard_batch's ValueError; submit
    on a follower raises, naming rank 0."""
    for r in range(RANKS):
        got = _result(group, "errors", r)
        assert got["indivisible"] == ("batch of 3 rows does not divide over the data axis "
                                      "of 2: pass a batch divisible by 2")
        if r:
            assert "rank 0" in got["micro"] and "rank 0" in got["continuous"]


def test_batch_auto_sizes_the_slots_a_rank_holds(group):
    """``batch_size="auto"`` over 2x2 on a device of 8 MiB above the
    reserve: the capacity model's batch for one rank's bytes (the model
    cut over model 2) times the data axis; each rank holds batch / 2
    slots, the second data rank's from its first."""
    for r in range(RANKS):
        got = _result(group, "errors", r)["auto"]
        assert 1 < got["per_rank"] < 512  # the bytes decide, not the cap
        assert got["batch"] == 2 * got["per_rank"] and got["local_slots"] == got["per_rank"]
        assert got["first_slot"] == (r // 2) * got["per_rank"]
