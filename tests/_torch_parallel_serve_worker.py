"""One rank of ``tests/test_torch_parallel_serve.py``'s process group.

Started four times (gloo, ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT`` in the environment) with a case directory: reads
``inputs.pkl`` (numpy params, clips and paths the test wrote), runs every
serving-over-a-mesh scenario in the one group (rank 0 submits, the other
ranks follow its schedule), and writes ``out<rank>.pkl`` (each scenario's
results, or its traceback). Imports torch and the port only, never JAX.
"""

import contextlib
import io
import json
import os
import pickle
import signal
import socket
import struct
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)

from yoho_tpu_torch.core.config import WhisperConfig  # noqa: E402
from yoho_tpu_torch.infer.batching import MicroBatcher, RequestCancelled  # noqa: E402
from yoho_tpu_torch.infer.continuous import ContinuousBatcher  # noqa: E402
from yoho_tpu_torch.infer.pipeline import Transcriber  # noqa: E402
from yoho_tpu_torch.infer.slot_engine import SlotEngine  # noqa: E402
from yoho_tpu_torch.nn.params import load_jax_params  # noqa: E402
from yoho_tpu_torch.nn.whisper import Whisper  # noqa: E402
from yoho_tpu_torch.parallel import mesh as pm  # noqa: E402
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable  # noqa: E402

CPU = "cpu"
RANK = int(os.environ["RANK"])
LEAD = RANK == 0


class _CharText:
    """A text backend for per-request prompts: one id a character."""

    def encode(self, text, add_special_tokens=False):
        return [100 + ord(c) % 200 for c in text]

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _tokens(results):
    return [[[int(t) for t in s.tokens] for s in r.segments] for r in results]


def _transcriber(inp, mesh=None, draft=False, **kw):
    """The JAX test's tiny int8 whisper (test_distributed.py) on this rank."""
    cfg = WhisperConfig(**inp["cfg"])
    extra = {}
    if draft:
        extra = dict(draft_model=load_jax_params(Whisper(WhisperConfig(**inp["draft_cfg"]),
                                                         device=CPU), inp["draft_params"]),
                     speculative_gamma=2)
    args = dict(family="whisper", token_table=WhisperTokenTable(multilingual=True),
                batch_size=2, timestamps=True, quantized_cross_kv="int8",
                quantized_cache=True, device=CPU, mesh=mesh, **extra)
    args.update(kw)
    return Transcriber(load_jax_params(Whisper(cfg, device=CPU), inp["params"]), **args)


def _concurrently(fns):
    """Runs each of ``fns`` in its own thread at once; their results (or
    the exceptions they raised) in order."""
    out = [None] * len(fns)

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 - the test reads the type
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _serve_slots(batcher, audios, **kw):
    """Rank 0 submits ``audios`` from one thread each, then closes; the
    other ranks follow. Returns the results on rank 0 (None elsewhere)."""
    if not LEAD:
        batcher.join()
        return None
    try:
        return _concurrently([lambda a=a: batcher.submit(a, **kw) for a in audios])
    finally:
        batcher.close()


def continuous(inp):
    """The 3 requests through a ContinuousBatcher at 1x4 and at 2x2 (2
    slots, chunks of 4 tokens), submitted at once; every rank's engine
    stats; the port's unsharded batcher on rank 0."""
    out = {}
    for spec in ("1x4", "2x2"):
        b = ContinuousBatcher(_transcriber(inp, pm.parse_mesh(spec, CPU)), max_batch=2,
                              chunk_tokens=4)
        got = _serve_slots(b, inp["audios"])
        out[spec] = dict(tokens=None if got is None else _tokens(got),
                         stats=dict(b.engine.stats), ticks=b.schedule.ticks,
                         local_slots=b.engine.local_slots)
    if LEAD:
        plain = ContinuousBatcher(_transcriber(inp), max_batch=2, chunk_tokens=4)
        try:
            out["plain"] = _tokens(_concurrently([lambda a=a: plain.submit(a)
                                                  for a in inp["audios"]]))
        finally:
            plain.close()
    return out


def cancel(inp):
    """Two requests at 2x2 (one slot a data rank); rank 0's client of the
    first goes away once a chunk has run with it in a slot:
    RequestCancelled, its slot freed at one chunk on every rank, the other
    request's tokens unchanged. Each chunk is slowed on every rank so that
    the cancel lands mid-decode."""
    b = ContinuousBatcher(_transcriber(inp, pm.parse_mesh("2x2", CPU)), max_batch=2,
                          chunk_tokens=4)
    engine, freed, ran = b.engine, [], []
    chunk, release = engine._chunk, engine.release
    target = inp["audios"][0]

    def slow(state):
        time.sleep(0.3)
        chunk(state)
        if any(w is not None and w.req is not None and w.req.audio is target
               for w in engine._occupied):
            ran.append(engine.stats["chunks"])

    def recorded(pred):
        n = release(pred)
        if n:
            freed.append((engine.stats["chunks"], n))
        return n

    engine._chunk, engine.release = slow, recorded
    if not LEAD:
        b.join()
        return dict(freed=freed, stats=dict(engine.stats))
    try:
        got = _concurrently([
            lambda: b.submit(target, cancelled=lambda: bool(ran)),
            lambda: b.submit(inp["audios"][1])])
    finally:
        b.close()
    return dict(freed=freed, stats=dict(engine.stats),
                first=type(got[0]).__name__, cancelled_is_request=isinstance(
                    got[0], RequestCancelled), second=_tokens([got[1]])[0],
                counters=b.stats())


def device_error(inp):
    """A device call that fails on rank 1 alone, at the host sync of a
    chunk's reap (where an asynchronous device error surfaces, after the
    collectives): every rank fails the tick's requests and resets its
    slots together, then serves the next request with the unsharded
    tokens."""
    b = ContinuousBatcher(_transcriber(inp, pm.parse_mesh("2x2", CPU)), max_batch=2,
                          chunk_tokens=4)
    engine, reap, fired = b.engine, b.engine.reap, []

    def failing():
        got = reap()
        if RANK == 1 and engine.stats["chunks"] == 2 and not fired:
            fired.append(True)
            raise RuntimeError("injected device error")
        return got

    engine.reap = failing
    if not LEAD:
        b.join()
        return dict(stats=dict(engine.stats), busy=engine.busy)
    try:
        first = _concurrently([lambda: b.submit(inp["audios"][0])])[0]
        second = b.submit(inp["audios"][1])
    finally:
        b.close()
    return dict(first=repr(first), second=_tokens([second])[0], stats=dict(engine.stats),
                busy=engine.busy, counters=b.stats())


def speculative(inp):
    """The speculative slot engine at 2x2 with the JAX dry run's draft
    (16 wide, 2 heads, gamma 2)."""
    b = ContinuousBatcher(_transcriber(inp, pm.parse_mesh("2x2", CPU), draft=True),
                          max_batch=2, chunk_tokens=4)
    got = _serve_slots(b, inp["audios"])
    return dict(tokens=None if got is None else _tokens(got), stats=dict(b.engine.stats),
                gamma=b.engine.gamma)


def micro(inp):
    """The MicroBatcher at 2x2 with beams 2 and a per-request prompt on the
    second request, against the unsharded transcribe_many on rank 0."""
    table = dict(token_table=WhisperTokenTable(multilingual=True, text_backend=_CharText()),
                 beams=2)
    b = MicroBatcher(_transcriber(inp, pm.parse_mesh("2x2", CPU), **table), max_batch=3,
                     max_wait_ms=200.0)
    prompts = [None, "hello there", None]
    if not LEAD:
        b.join()
        return dict(ticks=b.schedule.ticks)
    try:
        got = _concurrently([lambda a=a, p=p: b.submit(a, prompt=p)
                             for a, p in zip(inp["audios"], prompts)])
    finally:
        b.close()
    want = _transcriber(inp, **table).transcribe_many(inp["audios"], prompts=prompts)
    return dict(tokens=_tokens(got), plain=_tokens(want), ticks=b.schedule.ticks,
                batches=b.batches_dispatched)


def yoho_session(inp):
    """The trained YOHO fixture session served continuously at 2x2."""
    from yoho_tpu_torch.load import load_transcriber

    t = load_transcriber(session="tiny", root=inp["root"], batch=4,
                         mesh=pm.parse_mesh("2x2", CPU), device=CPU)
    b = ContinuousBatcher(t, max_batch=4, chunk_tokens=4)
    got = _serve_slots(b, inp["clips"])
    return dict(texts=None if got is None else [r.text for r in got],
                stats=dict(b.engine.stats))


def _stream(port: int, audio: np.ndarray) -> dict:
    """One /stream session: the audio in frames of 0.1 s, then end; the
    final message."""
    from yoho_tpu_torch.utils import websocket as ws

    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    s.sendall(("GET /stream HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               "Connection: Upgrade\r\nSec-WebSocket-Key: AAAAAAAAAAAAAAAAAAAAAA==\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    mask = b"\x0a\x0b\x0c\x0d"

    def send(payload, opcode):
        n = len(payload)
        hdr = (bytes([0x80 | opcode, 0x80 | n]) if n < 126 else
               bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", n))
        m = np.frombuffer(mask * (n // 4 + 1), np.uint8)[:n]
        s.sendall(hdr + mask + (np.frombuffer(payload, np.uint8) ^ m).tobytes())

    try:
        for i in range(0, len(audio), 1600):
            send(audio[i:i + 1600].astype("<f4").tobytes(), ws.OP_BINARY)
        send(b'{"op": "end"}', ws.OP_TEXT)
        rfile, wfile = s.makefile("rb"), s.makefile("wb")
        while True:
            msg = ws.read_message(rfile, wfile)
            if msg is None:
                return {"error": "closed before the final message"}
            body = json.loads(msg[1])
            if "error" in body or body.get("final"):
                return body
    finally:
        s.close()


class _Lines(io.StringIO):
    """stdout of ``serve.main``; the bound port once it prints it."""

    def __init__(self):
        super().__init__()
        self.port = threading.Event()

    def write(self, text):
        n = super().write(text)
        if "serving on http://" in self.getvalue() and not self.port.is_set():
            self.bound = int(self.getvalue().split("serving on http://")[1]
                             .split()[0].rsplit(":", 1)[1])
            self.port.set()
        return n


def serve_command(inp):
    """``serve --mesh 2x2 --continuous`` in the group: rank 0 binds port 0,
    a thread on it pauses longer than the schedule's idle interval, POSTs
    the fixture's WAV to /transcribe, streams it over /stream, then sends
    this process SIGTERM (rank 0 drains); the followers get SIGTERM too
    while they follow, and leave at rank 0's last tick."""
    from yoho_tpu_torch.cli import serve

    out = _Lines()
    client = {}

    def leader_client():
        if not out.port.wait(300):
            return
        try:
            time.sleep(2.5 * pm.SCHEDULE_IDLE_S)
            body = Path(inp["wav"]).read_bytes()
            req = urllib.request.Request(f"http://127.0.0.1:{out.bound}/transcribe", data=body,
                                         headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=120) as r:
                client["transcribe"] = json.load(r)["text"]
            from yoho_tpu_torch.audio.io import load_audio_f32

            client["stream"] = _stream(out.bound, load_audio_f32(inp["wav"], 16000)).get("text")
        except Exception:  # noqa: BLE001 - the test reports it
            client["error"] = traceback.format_exc()
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    def follower_term():
        # SIGTERM once this rank follows (its handler installed), as a
        # launcher forwards it to every rank.
        while signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)
        client["sigterm_sent"] = True

    th = threading.Thread(target=leader_client if LEAD else follower_term, daemon=True)
    th.start()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--hf", inp["hf"], "--mesh", "2x2", "--port", "0", "--batch", "2",
                         "--continuous", "--chunk-tokens", "4", "--int8-kv", "--device", CPU,
                         "--drain-timeout", "10"])
    th.join(30)
    return dict(rc=rc, stdout=out.getvalue(), **client)


def errors(inp):
    """Slots that do not divide over data (3 on 2x2) raise shard_batch's
    ValueError; a follower's submit raises naming rank 0; --batch auto over
    the mesh gives each rank batch / D slots sized by its own bytes."""
    from yoho_tpu_torch.infer import capacity

    mesh = pm.parse_mesh("2x2", CPU)
    out = {}
    try:
        SlotEngine(_transcriber(inp, mesh, batch_size=3))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # One batcher over a mesh at a time: two would share the schedule.
    for name, cls in (("micro", MicroBatcher), ("continuous", ContinuousBatcher)):
        batcher = cls(_transcriber(inp, mesh), max_batch=2)
        if LEAD:
            batcher.close()
            continue
        try:
            batcher.submit(inp["audios"][0])
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
        batcher.join()
    # A device of 8 MiB above the reserve, so that the bytes size the batch
    # (the host's RAM would give the cap).
    capacity.device_memory_bytes = lambda _device: capacity.RESERVE_BYTES + (8 << 20)
    t = _transcriber(inp, mesh, batch_size="auto")
    engine = SlotEngine(t, chunk_tokens=4)
    per_rank = capacity.suggest_batch_size(
        t.model.cfg, "whisper", device_bytes=capacity.device_memory_bytes(t.device),
        weight_bytes=capacity.module_bytes(t.model), model_shards=2,
        **capacity._lane_kwargs(t, t.model, t.max_len))
    out["auto"] = dict(batch=t.batch_size, local_slots=engine.local_slots,
                       per_rank=per_rank, first_slot=engine.first_slot)
    return out


SCENARIOS = (continuous, cancel, device_error, speculative, micro, yoho_session, serve_command, errors)


def main() -> None:
    case = Path(sys.argv[1])
    inp = pickle.loads((case / "inputs.pkl").read_bytes())
    out = {}
    for fn in SCENARIOS:
        print(f"rank {RANK}: {fn.__name__}", flush=True)
        t0 = time.perf_counter()
        try:
            out[fn.__name__] = fn(inp)
        except Exception:  # noqa: BLE001 - the test reports it
            out[fn.__name__] = {"error": traceback.format_exc()}
        out[fn.__name__ + "_s"] = time.perf_counter() - t0
        # A scenario that failed on one rank alone must not leave the
        # others in its collectives: every rank starts the next together.
        pm.barrier("scenario")
    (case / f"out{RANK}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
