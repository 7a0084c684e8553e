"""The msgpack files of ``flax.serialization``, read and written with the
standard library.

The JAX package stores parameters, checkpoints and LoRA adapters with
``flax.serialization.msgpack_serialize`` / ``msgpack_restore``; the machine
with the card has neither ``msgpack`` nor ``flax`` nor ``ml_dtypes``. This
codec covers the subset those files use:

* maps (string keys), strings, binary, ints, floats, bools, None and
  lists (a tuple packs as a list);
* flax's ndarray extension (type 1): a packed ``(shape, dtype name, raw
  C-order bytes)``; its numpy-scalar extension (type 3), the same for a
  0-d array;
* flax's chunked form of a leaf larger than 2**30 bytes: a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": array, ...}}``.

Arrays come back as numpy arrays, except ``bfloat16`` leaves, which numpy
cannot hold without ``ml_dtypes``: they come back as ``torch.bfloat16``
tensors (the raw bytes read through a uint16 view), and a bf16 tensor
writes as a ``bfloat16`` leaf. The encoder picks msgpack's smallest form
for every int, string, binary, list and map, as ``msgpack.packb`` does,
floats as float64, and orders map keys as flax's copy of the tree does:
the bytes equal flax's for the same tree. :func:`dump` writes them to a
file array by array, without building the whole file in memory.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's limit per leaf
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ encode
def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], codes) -> None:
    """A length header: the fix form (base, limit) when it fits, else the
    first of ``codes`` ((code, struct format, limit)) that holds n."""
    base, limit = fix
    if n < limit:
        out.append(base | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} too large for msgpack")


def _pack_bin(out: bytearray, data: bytes) -> None:
    _pack_len(out, len(data), (0, 0), ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                                      (0xC6, ">I", 1 << 32)))
    out += data


def _ext_header(out: bytearray, code: int, n: int) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out.append(code)


class _Out(bytearray):
    """The encoder's output: small items collect in the buffer, an array's
    raw bytes go straight to ``write`` (a file's write releases the GIL, so
    a checkpoint written on a thread does not stall the training loop)."""

    def __init__(self, write):
        super().__init__()
        self.write = write

    def large(self, data) -> None:
        self.flush()
        self.write(data)

    def flush(self) -> None:
        if self:
            self.write(bytes(self))
            del self[:]


def _raw(arr):
    """(shape, dtype name, a flat uint8 view of the C-order bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        a = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        name = "bfloat16" if t.dtype == torch.bfloat16 else a.dtype.name
        shape = tuple(t.shape)
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes do not serialize")
        a, name, shape = np.ascontiguousarray(arr), arr.dtype.name, arr.shape
    return shape, name, a.reshape(-1).view(np.uint8)


def _pack_array(out: _Out, arr, code: int) -> None:
    """flax's ndarray extension: a packed (shape, dtype name, bytes)."""
    shape, name, raw = _raw(arr)
    head = bytearray([0x93])
    _pack(head, list(shape))
    _pack(head, name)
    _pack_len(head, raw.nbytes, (0, 0), ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                                         (0xC6, ">I", 1 << 32)))
    _ext_header(out, code, len(head) + raw.nbytes)
    out += head
    out.large(memoryview(raw))


def _pack(out, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_array(out, x, EXT_NDARRAY)
    elif isinstance(x, np.generic):
        _pack_array(out, np.asarray(x), EXT_NPSCALAR)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 32), ((0xD9, ">B", 1 << 8),
                                               (0xDA, ">H", 1 << 16),
                                               (0xDB, ">I", 1 << 32)))
        out += data
    elif isinstance(x, (bytes, bytearray)):
        _pack_bin(out, bytes(x))
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), (0x90, 16), ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
        for item in x:
            _pack(out, item)
    elif isinstance(x, dict):
        _pack_len(out, len(x), (0x80, 16), ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
        for key, val in x.items():
            _pack(out, key)
            _pack(out, val)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk_leaves(tree):
    """flax's copy of the tree (``tree_map`` orders each map's keys), then
    its ``_chunk_array_leaves_in_place`` (the chunked form's maps keep
    their insertion order)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        flat = tree.reshape(-1)
        step = max(1, MAX_CHUNK_SIZE // (tree.element_size() if isinstance(tree, torch.Tensor)
                                         else tree.dtype.itemsize))
        chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
        return {CHUNKED: True,
                "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def dump(tree, f) -> None:
    """Write ``dumps(tree)`` to the binary file ``f``, array by array."""
    out = _Out(f.write)
    _pack(out, _chunk_leaves(tree))
    out.flush()


def dumps(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    scalars and arrays (numpy or torch)."""
    parts = []
    out = _Out(parts.append)
    _pack(out, _chunk_leaves(tree))
    out.flush()
    return b"".join(parts)


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _dtype_from_name(name: str):
    if name == "bfloat16":
        return torch.bfloat16
    return np.dtype(name)


def _array_from_payload(data: bytes):
    shape, name, raw = _read(_Reader(data))
    name = name.decode() if isinstance(name, (bytes, bytearray)) else name
    dtype = _dtype_from_name(name)
    if dtype is torch.bfloat16:
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        arr = _array_from_payload(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _read(r: _Reader):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return bytes(r.take(n)).decode("utf-8")
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"unsupported msgpack byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> Dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks: List = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def loads(data: bytes):
    """``flax.serialization.msgpack_restore``: the tree, arrays as read-only
    numpy views of ``data`` (bf16 leaves as torch tensors)."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return _unchunk_leaves(tree)
