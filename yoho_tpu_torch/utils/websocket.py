"""Minimal server-side WebSocket (RFC 6455) over stdlib file objects.

A copy of the JAX package's ``utils/websocket.py`` (which imports no JAX).
It backs the ``/stream`` real-time transcription endpoint of
``yoho_tpu_torch/cli/serve.py``: the serving layer is stdlib-only, so the
framing lives here. Scope: the server side of the protocol only
(handshake, frame read and write with client masking, fragmented
messages, ping/pong, close).
"""

from __future__ import annotations

import base64
import hashlib
import struct
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# DoS guard: reject absurd declared frame lengths before allocating
# (RFC 6455 also caps control-frame payloads at 125 bytes).
MAX_FRAME_BYTES = 64 * 1024 * 1024
# The same bound applies to a REASSEMBLED message: without it a client
# could stream endless small non-FIN continuation frames and grow the
# buffer unboundedly even though every frame passes the per-frame cap.
MAX_MESSAGE_BYTES = MAX_FRAME_BYTES

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def is_upgrade_request(headers) -> bool:
    upgrade = (headers.get("Upgrade") or "").lower()
    connection = (headers.get("Connection") or "").lower()
    return upgrade == "websocket" and "upgrade" in connection


def perform_handshake(handler) -> bool:
    """Upgrade a BaseHTTPRequestHandler connection. True on success."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key or not is_upgrade_request(handler.headers):
        return False
    handler.send_response_only(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    return True


def _read_exact(rfile, n: int) -> bytes:
    parts = []
    got = 0
    while got < n:
        chunk = rfile.read(n - got)
        if not chunk:
            raise ConnectionError("websocket peer closed mid-frame")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _read_frame(rfile) -> Tuple[bool, int, bytes]:
    b0, b1 = _read_exact(rfile, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    length = b1 & 0x7F
    if length == 126:
        (length,) = struct.unpack(">H", _read_exact(rfile, 2))
    elif length == 127:
        (length,) = struct.unpack(">Q", _read_exact(rfile, 8))
    if opcode >= OP_CLOSE and length > 125:
        raise ValueError(f"control frame payload {length} > 125 (RFC 6455)")
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {length} bytes exceeds the "
                         f"{MAX_FRAME_BYTES}-byte limit")
    mask = _read_exact(rfile, 4) if masked else None
    payload = _read_exact(rfile, length)
    if mask:
        # numpy XOR: the per-byte Python loop ran at a few MB/s and
        # throttled real-time audio upload.
        import numpy as np

        m = np.frombuffer(mask * (length // 4 + 1), np.uint8)[:length]
        payload = (np.frombuffer(payload, np.uint8) ^ m).tobytes()
    return fin, opcode, payload


def read_message(rfile, wfile) -> Optional[Tuple[int, bytes]]:
    """Next complete message as (opcode, payload); None once closed.

    Reassembles fragmented messages and answers pings transparently.
    """
    # Accumulate fragments in a list and join once at FIN: `bytes +=`
    # re-copies the whole message per continuation frame, which a client
    # sending 1-byte fragments turns into quadratic CPU (the size cap
    # below bounds memory, not copies).
    parts: list = []
    total = 0
    message_op = None
    while True:
        fin, opcode, payload = _read_frame(rfile)
        if opcode == OP_CLOSE:
            try:
                send_close(wfile)
            except OSError:
                pass
            return None
        if opcode == OP_PING:
            _write_frame(wfile, OP_PONG, payload)
            continue
        if opcode == OP_PONG:
            continue
        if opcode in (OP_TEXT, OP_BINARY):
            message_op = opcode
            parts = [payload]
            total = len(payload)
        elif opcode == OP_CONT and message_op is not None:
            parts.append(payload)
            total += len(payload)
        else:
            raise ValueError(f"unexpected websocket opcode {opcode:#x}")
        if total > MAX_MESSAGE_BYTES:
            raise ValueError(
                f"websocket message exceeds {MAX_MESSAGE_BYTES}-byte limit")
        if fin and message_op is not None:
            return message_op, b"".join(parts)


def _write_frame(wfile, opcode: int, payload: bytes) -> None:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < (1 << 16):
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    wfile.write(header + payload)
    wfile.flush()


def send_text(wfile, text: str) -> None:
    _write_frame(wfile, OP_TEXT, text.encode())


def send_binary(wfile, data: bytes) -> None:
    _write_frame(wfile, OP_BINARY, data)


def send_close(wfile, code: int = 1000) -> None:
    _write_frame(wfile, OP_CLOSE, struct.pack(">H", code))
