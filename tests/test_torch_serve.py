"""The port's serving layer against the JAX package's, on 127.0.0.1.

The trained ``whisper_tiny`` fixture in float32 behind two port servers
(``serve(..., continuous=False)``, the micro-batcher, and
``continuous=True``, the slot engine) and one JAX server, each started once
for the module on an ephemeral port. The same request (three tone clips
in a row as a WAV body: several stitched windows) goes to each:

* every ``response_format`` of ``/v1/audio/transcriptions``, ``POST
  /transcribe`` and the SSE stream give the JAX server's body: text,
  tokens, times and subtitles exactly, the quality signals
  (``avg_logprob``, ``no_speech_prob``) within 1e-4 (the bound of
  ``tests/test_continuous.py``);
* one ``GET /stream`` WebSocket session gives the finalized segments of
  the JAX ``StreamingTranscriber`` for the same push schedule;
* ``/healthz``, ``/v1/models``, ``/statz`` and ``/metrics`` answer and
  count the requests, and ``drain`` returns.

The batchers on their own: ``MicroBatcher`` pools concurrent submits,
sheds load past ``max_pending`` with ``ServerOverloaded`` and drops a
cancelled queued request with ``RequestCancelled``; the
``ContinuousBatcher`` takes concurrent submits and sheds load the same way.
"""

import io
import json
import socket
import struct
import threading
import time
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoho_tpu.cli.serve import drain as jax_drain
from yoho_tpu.cli.serve import serve as jax_serve
from yoho_tpu.core.config import WhisperConfig as JaxConfig
from yoho_tpu.infer.pipeline import Transcriber as JaxTranscriber
from yoho_tpu.infer.streaming import StreamingTranscriber as JaxStreaming
from yoho_tpu.nn.whisper import Whisper as JaxWhisper
from yoho_tpu.text.whisper_tokens import WhisperTokenTable as JaxTable
from yoho_tpu.train.checkpoint import load_params
from yoho_tpu_torch.cli.serve import drain, serve, warmup
from yoho_tpu_torch.core.config import WhisperConfig
from yoho_tpu_torch.infer.batching import MicroBatcher, RequestCancelled, ServerOverloaded
from yoho_tpu_torch.infer.continuous import ContinuousBatcher
from yoho_tpu_torch.infer.pipeline import Transcriber
from yoho_tpu_torch.infer.streaming import StreamingTranscriber
from yoho_tpu_torch.nn.params import load_jax_params
from yoho_tpu_torch.nn.whisper import Whisper
from yoho_tpu_torch.text.srt import compose_srt, compose_vtt, segments_to_subtitles
from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
from yoho_tpu_torch.utils import websocket as ws

FIXTURE = Path(__file__).parent / "fixtures" / "whisper_tiny"
QUALITY = ("avg_logprob", "no_speech_prob")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU: one intra-op thread keeps the eager
    decode loops from oversubscribing it (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _WordBackend:
    def __init__(self, word_ids):
        self.word_ids = {k: int(v) for k, v in word_ids.items()}
        self.id_words = {v: k for k, v in self.word_ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.word_ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.id_words[int(i)] for i in ids if int(i) in self.id_words)


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def env():
    """The fixture's transcribers in both packages, the request audio, and
    the three servers (JAX micro-batching; port micro-batching and
    continuous), drained at the end."""
    cfg = json.loads((FIXTURE / "config.json").read_text())
    golden = json.loads((FIXTURE / "golden.json").read_text())
    words = json.loads((FIXTURE / "word_vocab.json").read_text())
    jcfg = JaxConfig(**cfg)
    jm = JaxWhisper(jcfg)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, jcfg.n_frames, jcfg.n_mels), jnp.float32),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    params = jax.device_get(load_params(FIXTURE / "params.msgpack", template))
    kw = dict(batch_size=2, quantized_cross_kv="int8", quantized_cache=True)
    jt = JaxTranscriber(jm, {"params": params}, family="whisper",
                        token_table=JaxTable(multilingual=True, text_backend=_WordBackend(words)),
                        **kw)
    model = load_jax_params(Whisper(WhisperConfig(**cfg), device="cpu"), params)

    def port_transcriber():
        return Transcriber(model, token_table=WhisperTokenTable(
            multilingual=True, text_backend=_WordBackend(words)), device="cpu", **kw)

    n = jcfg.n_samples
    clips = []
    for hz in golden["tones"]:
        clip = (np.random.default_rng(9).standard_normal(n) * 0.002).astype(np.float32)
        clip[800:4800] += (0.4 * np.sin(2 * np.pi * hz * np.arange(4000) / 16000)
                           ).astype(np.float32)
        clips.append(clip)
    pcm = np.clip(np.round(np.concatenate(clips) * 32767), -32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    servers = {"jax": jax_serve(jt, port=0),
               "micro": serve(port_transcriber(), port=0),
               "continuous": serve(port_transcriber(), port=0, continuous=True,
                                   chunk_tokens=4)}
    warmup(servers["continuous"])
    urls = {k: _start(s) for k, s in servers.items()}
    yield dict(jt=jt, t=port_transcriber(), urls=urls, servers=servers, wav=buf.getvalue(),
               audio=pcm.astype(np.float32) / 32768.0)
    # Every server is drained, its batcher's worker thread joined: a worker
    # left running would outlive the module in the test process.
    jax_drain(servers["jax"], timeout_s=10)
    for name in ("micro", "continuous"):
        t0 = time.monotonic()
        drain(servers[name], timeout_s=10)
        assert time.monotonic() - t0 < 30


def _multipart(fields):
    boundary = "yohoboundary123"
    parts = []
    for name, (filename, data) in fields.items():
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename else "")
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n".encode()
                     + data + b"\r\n")
    return (f"multipart/form-data; boundary={boundary}",
            b"".join(parts) + f"--{boundary}--\r\n".encode())


def _request(url, fmt, wav):
    """(content type, body) of one request in a response format: an
    OpenAI response_format, 'sse' (stream=true) or 'transcribe' (the
    native endpoint)."""
    if fmt == "transcribe":
        req = urllib.request.Request(url + "/transcribe", data=wav,
                                     headers={"Content-Type": "audio/wav"})
    else:
        fields = {"file": ("a.wav", wav)}
        if fmt == "sse":
            fields["stream"] = (None, b"true")
        else:
            fields["response_format"] = (None, fmt.encode())
        ctype, body = _multipart(fields)
        req = urllib.request.Request(url + "/v1/audio/transcriptions", data=body,
                                     headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.headers["Content-Type"], r.read()


def _split_quality(obj):
    """A JSON body with its quality signals taken out: (rest, [signals])."""
    found = []

    def walk(x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in QUALITY:
                    found.append(0.0 if v is None else v)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(obj), found


@pytest.mark.parametrize("fmt", ["json", "text", "verbose_json", "srt", "vtt", "sse",
                                 "transcribe"])
@pytest.mark.parametrize("engine", ["micro", "continuous"])
def test_response_equals_the_jax_server(env, engine, fmt):
    ctype, got = _request(env["urls"][engine], fmt, env["wav"])
    want_ctype, want = _request(env["urls"]["jax"], fmt, env["wav"])
    assert ctype == want_ctype
    if ctype.startswith("application/json"):
        (g, g_q), (w, w_q) = _split_quality(json.loads(got)), _split_quality(json.loads(want))
        assert g == w
        np.testing.assert_allclose(g_q, w_q, rtol=0, atol=1e-4)
        if fmt == "verbose_json":
            assert len(g["segments"]) >= 3 and "thank you" in g["text"]
    else:
        assert got == want
    if fmt == "srt":
        assert got.decode().startswith("1\n00:00:00")


def _ws_connect(url):
    host, port = url.replace("http://", "").split(":")
    s = socket.create_connection((host, int(port)), timeout=120)
    s.sendall(("GET /stream HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               "Connection: Upgrade\r\nSec-WebSocket-Key: AAAAAAAAAAAAAAAAAAAAAA==\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    assert resp.split(b"\r\n", 1)[0].split()[1] == b"101", resp
    return s


def _ws_send(s, payload, opcode):
    mask = b"\x0a\x0b\x0c\x0d"
    n = len(payload)
    hdr = (bytes([0x80 | opcode, 0x80 | n]) if n < 126 else
           bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", n) if n < 1 << 16 else
           bytes([0x80 | opcode, 0x80 | 127]) + struct.pack(">Q", n))
    m = np.frombuffer(mask * (n // 4 + 1), np.uint8)[:n]
    s.sendall(hdr + mask + (np.frombuffer(payload, np.uint8) ^ m).tobytes())


def test_stream_session_equals_jax_streaming(env):
    """PCM in frames of 0.25 s, then {"op": "end"}: the finalized segments
    equal the JAX StreamingTranscriber's for the same pushes."""
    frames = [env["audio"][i:i + 4000] for i in range(0, len(env["audio"]), 4000)]
    ref = JaxStreaming(env["jt"])
    want = [seg for f in frames for seg in ref.push(f)] + ref.flush()
    s = _ws_connect(env["urls"]["continuous"])
    finals, final_msg = [], None
    try:
        for f in frames:
            _ws_send(s, f.astype("<f4").tobytes(), ws.OP_BINARY)
        _ws_send(s, b'{"op": "end"}', ws.OP_TEXT)
        rfile, wfile = s.makefile("rb"), s.makefile("wb")
        while True:
            msg = ws.read_message(rfile, wfile)
            if msg is None:
                break
            body = json.loads(msg[1])
            assert "error" not in body, body
            if not body.get("partial"):
                finals += body["segments"]
            if body.get("final"):
                final_msg = body
                break
    finally:
        s.close()
    assert final_msg is not None and final_msg["text"] == ref.text() != ""
    assert [(g["start"], g["end"], g["text"], g["tokens"]) for g in finals] == \
        [(w.start, w.end, w.text, list(map(int, w.tokens))) for w in want]


def test_stream_transcriber_built_in_decode_equals_jax(env):
    """The port's StreamingTranscriber on its own (the built-in B=1
    decode), pushed in uneven pieces, with a soft flush in the middle."""
    audio = env["audio"]
    cuts = [0, 3000, 9000, 22000, 30000, len(audio)]
    port, ref = StreamingTranscriber(env["t"]), JaxStreaming(env["jt"])
    got, want = [], []
    for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
        got += port.push(audio[a:b])
        want += ref.push(audio[a:b])
        if i == 2:
            got += port.soft_flush()
            want += ref.soft_flush()
    got += port.flush()
    want += ref.flush()
    assert [(g.start, g.end, g.tokens) for g in got] == \
        [(w.start, w.end, list(map(int, w.tokens))) for w in want]
    assert port.text() == ref.text() and port.partial_segments() == []
    # Speaker tracking is ported: whisper segments without a
    # diarize encoder carry no voiceprint, so the tracker labels none.
    tracked = StreamingTranscriber(env["t"], track_speakers=True)
    tracked._tracker.assign(got)
    assert all(g.speaker is None and g.speaker_name is None for g in got)


def test_health_models_statz_metrics(env):
    url = env["urls"]["continuous"]
    with urllib.request.urlopen(url + "/healthz") as r:
        assert json.load(r) == {"status": "ok"}
    with urllib.request.urlopen(url + "/v1/models") as r:
        assert json.load(r)["data"][0]["id"] == "whisper-1"
    _request(url, "json", env["wav"])
    with urllib.request.urlopen(url + "/statz") as r:
        statz = json.load(r)
    assert statz["requests_served"] >= 1 and statz["inflight"] == 0
    assert statz["active_slots"] == 0 and statz["p50_ms"] is not None
    with urllib.request.urlopen(url + "/metrics") as r:
        body = r.read().decode()
    assert f"yoho_requests_served_total {statz['requests_served']}" in body
    assert "# TYPE yoho_active_slots gauge" in body


def test_srt_and_vtt_copies_compose_like_jax(env):
    from yoho_tpu.text import srt as jsrt

    segs = env["t"].transcribe(env["audio"]).segments
    subs = segments_to_subtitles(segs)
    assert compose_srt(subs) == jsrt.compose_srt(jsrt.segments_to_subtitles(segs))
    assert compose_vtt(subs) == jsrt.compose_vtt(jsrt.segments_to_subtitles(segs))


def test_microbatcher_pools_sheds_and_cancels():
    release = threading.Event()
    calls = []

    class SlowT:
        def transcribe_many(self, audios, sample_rate=None, **kw):
            calls.append(len(audios))
            release.wait(30)
            return [f"r{float(np.asarray(a).sum()):.0f}" for a in audios]

    mb = MicroBatcher(SlowT(), max_batch=4, max_wait_ms=1, max_pending=2)
    try:
        with ThreadPoolExecutor(2) as pool:
            f1 = pool.submit(mb.submit, np.ones(4, np.float32))
            deadline = time.monotonic() + 10
            while not calls and time.monotonic() < deadline:
                time.sleep(0.02)  # the first request is dispatched
            f2 = pool.submit(mb.submit, np.full(4, 2.0, np.float32))
            while mb.inflight < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            with pytest.raises(ServerOverloaded):
                mb.submit(np.zeros(4, np.float32))
            mb.max_pending = 3
            with pytest.raises(RequestCancelled):  # dropped while queued
                mb.submit(np.zeros(4, np.float32), cancelled=lambda: True)
            release.set()
            assert (f1.result(timeout=10), f2.result(timeout=10)) == ("r4", "r8")
        stats = mb.stats()
        assert (stats["requests_rejected"], stats["requests_cancelled"],
                stats["requests_served"], stats["inflight"]) == (1, 1, 2, 0)
    finally:
        release.set()
        mb.close()


def test_continuous_batcher_concurrent_submits_and_overload(env):
    t, audio = env["t"], env["audio"]
    want = t.transcribe_many([audio, audio[:20480]])
    batcher = ContinuousBatcher(t, max_batch=2, chunk_tokens=3)
    try:
        with ThreadPoolExecutor(3) as pool:
            got = list(pool.map(batcher.submit, (audio, audio[:20480], audio)))
        assert [[s.tokens for s in r.segments] for r in got] == \
            [[s.tokens for s in r.segments] for r in want + want[:1]]
        assert batcher.stats()["requests_served"] == 3
    finally:
        batcher.close()
    # Past max_pending a submit fails at once; the long request in flight is
    # then cancelled (its slots are freed at the next chunk boundary).
    batcher = ContinuousBatcher(t, max_batch=2, chunk_tokens=3, max_pending=1)
    gone = threading.Event()
    try:
        with ThreadPoolExecutor(1) as pool:
            long = pool.submit(batcher.submit, np.concatenate([audio] * 8),
                               cancelled=gone.is_set)
            deadline = time.monotonic() + 30
            while batcher.inflight < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(ServerOverloaded):
                batcher.submit(audio)
            gone.set()
            with pytest.raises(RequestCancelled):
                long.result(timeout=60)
        assert batcher.stats()["requests_rejected"] == 1
    finally:
        batcher.close()
