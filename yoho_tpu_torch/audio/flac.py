"""FLAC codec: pure-Python encoder + decoder (RFC 9639, from scratch).

A copy of the JAX package's ``audio/flac.py`` (the port imports nothing of
``yoho_tpu``); the tests hold the two to equal output.

Why this exists: the reference stores training corpora compressed and
decodes them with the ffmpeg binary (``train/utils/dataloaders.py:53``,
``yoho/src/preprocessing/audio.py:11-18``); its own benchmark shows raw
arrays load 40-500x faster than codec decode
(``experiments/decoding_benchmark.py:50-70``). FLAC is this framework's
native lossless cache format: ~50-60% of WAV size, exact integer PCM
round-trip, no external binaries. The hot decode path is C++
(``yoho_tpu_torch/native/flac.cpp``); this module is the encoder, the readable
spec, and the pure-Python fallback decoder (both decoders are
cross-checked sample-exact in tests, and the encoder is validated against
an independent third-party decoder).

Encoder features: CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes chosen
by coded size, per-partition Rice parameters (both methods + escapes),
wasted-bits detection, stereo decorrelation (independent / left-side /
right-side / mid-side chosen per frame), CRC-8/16, MD5 signature.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

_BLOCKSIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                    512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                    16384: 14, 32768: 15}
_SAMPLE_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                      22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                      96000: 11}
_SAMPLE_SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_FIXED_COEFS = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]


def _make_crc_table(poly: int, width: int) -> List[int]:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = []
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table.append(crc)
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value = int(value)  # numpy ints would overflow the shift
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self.out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a one

    def align(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def getvalue(self) -> bytes:
        assert self._nbits == 0
        return bytes(self.out)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bits

    def byte_pos(self) -> int:
        return self.pos >> 3

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bits(self, n: int) -> int:
        v = 0
        data, pos = self.data, self.pos
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def sbits(self, n: int) -> int:
        v = self.bits(n)
        if n and v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def unary(self) -> int:
        q = 0
        data, pos = self.data, self.pos
        while not (data[pos >> 3] >> (7 - (pos & 7))) & 1:
            pos += 1
            q += 1
        self.pos = pos + 1
        return q


def _write_coded_number(w: BitWriter, v: int) -> None:
    """UTF-8-style variable-length frame/sample number (up to 36 bits).

    Capacity with n total bytes: (7 - n) lead bits + 6*(n - 1)
    continuation bits."""
    if v < 0x80:
        w.write(v, 8)
        return
    nbytes = 2
    while nbytes < 7 and v >= (1 << ((7 - nbytes) + 6 * (nbytes - 1))):
        nbytes += 1
    lead_prefix = (0xFF << (8 - nbytes)) & 0xFF
    w.write(lead_prefix | (v >> (6 * (nbytes - 1))), 8)
    for i in range(nbytes - 2, -1, -1):
        w.write(0x80 | ((v >> (6 * i)) & 0x3F), 8)


def _read_coded_number(r: BitReader) -> int:
    b0 = r.bits(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x80
    while b0 & mask:
        n += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(n - 1):
        v = (v << 6) | (r.bits(8) & 0x3F)
    return v


# --------------------------------------------------------------------------
# Rice residual coding
# --------------------------------------------------------------------------

def _zigzag(res: np.ndarray) -> np.ndarray:
    r = res.astype(np.int64)
    return ((r << 1) ^ (r >> 63)).astype(np.uint64)


def _best_rice_param(u: np.ndarray) -> Tuple[int, int]:
    """(k, bits) minimizing the rice cost for zigzag values ``u``."""
    if len(u) == 0:
        return 0, 0
    best_k, best_bits = 0, None
    for k in range(31):
        bits = int(np.sum(u >> np.uint64(k))) + len(u) * (k + 1)
        if best_bits is None or bits < best_bits:
            best_k, best_bits = k, bits
        elif bits > best_bits * 2:
            break  # cost is convex in k; far past the minimum
    return best_k, best_bits


def _plan_residual(res: np.ndarray, blocksize: int, pred_order: int,
                   max_porder: int = 6):
    """Choose (method, partition_order, [(kind, param, bits)…], total_bits).

    kind is 'rice' or 'escape'(param = raw bit count)."""
    u = _zigzag(res)
    best = None
    for porder in range(0, max_porder + 1):
        nparts = 1 << porder
        if blocksize % nparts:
            continue
        if (blocksize >> porder) <= pred_order:
            break
        parts = []
        total = 0
        idx = 0
        for p in range(nparts):
            count = (blocksize >> porder) - (pred_order if p == 0 else 0)
            pu = u[idx : idx + count]
            idx += count
            k, bits = _best_rice_param(pu)
            # signed bits needed == bit length of the zigzag maximum
            raw = int(pu.max()).bit_length() if len(pu) and pu.max() > 0 else 0
            raw_bits = 5 + count * raw if raw <= 31 else None
            if raw_bits is not None and raw_bits < bits:
                parts.append(("escape", raw, raw_bits))
                total += raw_bits
            else:
                parts.append(("rice", k, bits))
                total += bits
        method = 0 if all(p[1] <= 14 for p in parts if p[0] == "rice") else 1
        plen = 4 if method == 0 else 5
        total += 2 + 4 + nparts * plen
        if best is None or total < best[3]:
            best = (method, porder, parts, total)
    return best


def _write_residual(w: BitWriter, res: np.ndarray, blocksize: int,
                    pred_order: int, plan) -> None:
    method, porder, parts, _ = plan
    plen = 4 if method == 0 else 5
    escape = 15 if method == 0 else 31
    w.write(method, 2)
    w.write(porder, 4)
    u = _zigzag(res)
    idx = 0
    for p, (kind, param, _) in enumerate(parts):
        count = (blocksize >> porder) - (pred_order if p == 0 else 0)
        pu = u[idx : idx + count]
        r = res[idx : idx + count]
        idx += count
        if kind == "escape":
            w.write(escape, plen)
            w.write(param, 5)
            if param:
                for v in r:
                    w.write_signed(int(v), param)
        else:
            w.write(param, plen)
            for uv in pu:
                uv = int(uv)
                w.write_unary(uv >> param)
                if param:
                    w.write(uv & ((1 << param) - 1), param)


def _read_residual(r: BitReader, blocksize: int, pred_order: int) -> np.ndarray:
    method = r.bits(2)
    if method > 1:
        raise ValueError("bad residual method")
    plen, escape = (4, 15) if method == 0 else (5, 31)
    porder = r.bits(4)
    nparts = 1 << porder
    out = np.zeros(blocksize - pred_order, np.int64)
    idx = 0
    for p in range(nparts):
        count = (blocksize >> porder) - (pred_order if p == 0 else 0)
        param = r.bits(plen)
        if param == escape:
            raw = r.bits(5)
            if raw:
                for i in range(count):
                    out[idx + i] = r.sbits(raw)
        else:
            for i in range(count):
                q = r.unary()
                u = (q << param) | (r.bits(param) if param else 0)
                out[idx + i] = (u >> 1) ^ -(u & 1)
        idx += count
    return out


# --------------------------------------------------------------------------
# Subframe encoding
# --------------------------------------------------------------------------

def _quantize_lpc(autoc: np.ndarray, order: int, precision: int = 14):
    """Levinson-Durbin -> quantized integer LPC (coefs, shift), or None."""
    err = autoc[0]
    if err <= 0:
        return None
    a = np.zeros(order + 1)
    a[0] = 1.0
    for i in range(1, order + 1):
        acc = autoc[i] + np.dot(a[1:i], autoc[1:i][::-1])
        k = -acc / err
        a[1 : i + 1] = np.concatenate([a[1:i] + k * a[1:i][::-1], [k]])
        err *= 1 - k * k
        if err <= 0:
            return None
    lpc = -a[1:]  # prediction x[n] ~= sum lpc[j] * x[n-1-j]
    cmax = np.max(np.abs(lpc))
    if cmax <= 0:
        return None
    shift = precision - 1 - int(np.floor(np.log2(cmax))) - 1
    shift = max(0, min(15, shift))
    coefs = np.round(lpc * (1 << shift)).astype(np.int64)
    lim = 1 << (precision - 1)
    coefs = np.clip(coefs, -lim, lim - 1)
    if not np.any(coefs):
        return None
    return coefs, shift


def _lpc_residual(x: np.ndarray, coefs: np.ndarray, shift: int) -> np.ndarray:
    order = len(coefs)
    n = len(x)
    pred = np.zeros(n - order, np.int64)
    for j in range(order):
        pred += coefs[j] * x[order - 1 - j : n - 1 - j]
    return x[order:] - (pred >> shift)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x
    for _ in range(order):
        r = np.diff(r)
    return r


def _plan_subframe(x: np.ndarray, bps: int, use_lpc: bool = True):
    """Choose the cheapest subframe representation. Returns a dict plan."""
    n = len(x)
    # wasted bits: shared trailing zero bits (not for all-zero signals)
    wasted = 0
    orv = int(np.bitwise_or.reduce(x)) if n else 0
    if orv != 0:
        wasted = (orv & -orv).bit_length() - 1
        wasted = min(wasted, bps - 1)
    header = 1 + 6 + 1 + (wasted + 1 if wasted else 0)
    ebps = bps - wasted
    xe = x >> wasted if wasted else x

    if n and np.all(xe == xe[0]):
        return {"type": "constant", "value": int(xe[0]), "wasted": wasted,
                "ebps": ebps, "bits": header + ebps}

    best = {"type": "verbatim", "wasted": wasted, "ebps": ebps,
            "bits": header + n * ebps}

    for order in range(0, 5):
        if n <= order:
            break
        res = _fixed_residual(xe, order)
        plan = _plan_residual(res, n, order)
        if plan is None:
            continue
        bits = header + order * ebps + plan[3]
        if bits < best["bits"]:
            best = {"type": "fixed", "order": order, "res": res,
                    "plan": plan, "wasted": wasted, "ebps": ebps,
                    "bits": bits}

    if use_lpc and n > 64:
        order = min(8, n - 1)
        xf = xe.astype(np.float64)
        xf = xf * np.hanning(n)
        autoc = np.array([np.dot(xf[: n - i], xf[i:]) for i in range(order + 1)])
        q = _quantize_lpc(autoc, order)
        if q is not None:
            coefs, shift = q
            res = _lpc_residual(xe, coefs, shift)
            plan = _plan_residual(res, n, order)
            if plan is not None:
                bits = header + order * ebps + 4 + 5 + order * 14 + plan[3]
                if bits < best["bits"]:
                    best = {"type": "lpc", "order": order, "coefs": coefs,
                            "shift": shift, "res": res, "plan": plan,
                            "wasted": wasted, "ebps": ebps, "bits": bits}
    return best


def _write_subframe(w: BitWriter, x: np.ndarray, plan) -> None:
    w.write(0, 1)  # pad
    t = plan["type"]
    if t == "constant":
        w.write(0, 6)
    elif t == "verbatim":
        w.write(1, 6)
    elif t == "fixed":
        w.write(0b001000 | plan["order"], 6)
    else:
        w.write(0b100000 | (plan["order"] - 1), 6)
    wasted = plan["wasted"]
    if wasted:
        w.write(1, 1)
        w.write_unary(wasted - 1)
    else:
        w.write(0, 1)
    ebps = plan["ebps"]
    xe = x >> wasted if wasted else x
    if t == "constant":
        w.write_signed(plan["value"], ebps)
        return
    if t == "verbatim":
        for v in xe:
            w.write_signed(int(v), ebps)
        return
    order = plan["order"]
    for v in xe[:order]:
        w.write_signed(int(v), ebps)
    if t == "lpc":
        w.write(14 - 1, 4)  # precision-1
        w.write_signed(plan["shift"], 5)
        for c in plan["coefs"]:
            w.write_signed(int(c), 14)
    _write_residual(w, plan["res"], len(x), order, plan["plan"])


def _read_subframe(r: BitReader, blocksize: int, bps: int) -> np.ndarray:
    if r.bits(1) != 0:
        raise ValueError("bad subframe pad bit")
    t = r.bits(6)
    wasted = 0
    if r.bits(1):
        wasted = r.unary() + 1
    ebps = bps - wasted
    if t == 0:
        out = np.full(blocksize, r.sbits(ebps), np.int64)
    elif t == 1:
        out = np.array([r.sbits(ebps) for _ in range(blocksize)], np.int64)
    elif (t & 0x38) == 0x08 and (t & 7) <= 4:
        order = t & 7
        out = np.zeros(blocksize, np.int64)
        for i in range(order):
            out[i] = r.sbits(ebps)
        out[order:] = _read_residual(r, blocksize, order)
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            out[i] += sum(coefs[j] * out[i - 1 - j] for j in range(order))
    elif t & 0x20:
        order = (t & 0x1F) + 1
        out = np.zeros(blocksize, np.int64)
        for i in range(order):
            out[i] = r.sbits(ebps)
        prec = r.bits(4) + 1
        shift = r.sbits(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [r.sbits(prec) for _ in range(order)]
        out[order:] = _read_residual(r, blocksize, order)
        for i in range(order, blocksize):
            pred = sum(coefs[j] * out[i - 1 - j] for j in range(order))
            out[i] += pred >> shift
    else:
        raise ValueError(f"reserved subframe type {t}")
    if wasted:
        out <<= wasted
    return out


# --------------------------------------------------------------------------
# Stream encode / decode
# --------------------------------------------------------------------------

def _md5_signature(samples: np.ndarray, bps: int) -> bytes:
    if bps % 8:
        return b"\x00" * 16
    nbytes = bps // 8
    le = samples.astype("<i4").tobytes()
    if nbytes == 4:
        data = le
    else:
        arr = np.frombuffer(le, np.uint8).reshape(-1, 4)
        data = arr[:, :nbytes].tobytes()
    return hashlib.md5(data).digest()


def encode_flac(samples: np.ndarray, sample_rate: int, bps: int = 16,
                block_size: int = 4096, use_lpc: bool = True,
                use_native: bool = True) -> bytes:
    """Encode integer PCM -> FLAC stream bytes.

    ``samples``: (n,) mono or (n, channels) int array within the signed
    ``bps``-bit range. Exact lossless round-trip with both decoders."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, nch = x.shape
    if not (1 <= nch <= 8):
        raise ValueError(f"unsupported channel count {nch}")
    if not (4 <= bps <= 32):
        raise ValueError(f"unsupported bits per sample {bps}")
    # 16-bit STREAMINFO/frame field and 20-bit sample-rate field: out of
    # range would wrap into a stream both decoders reject as corrupt.
    if not (1 <= block_size <= 65535):
        raise ValueError(f"block_size must be in [1, 65535], got {block_size}")
    if not (1 <= sample_rate < (1 << 20)):
        raise ValueError(f"sample_rate must be in [1, 2^20), got {sample_rate}")
    lim = 1 << (bps - 1)
    x = x.astype(np.int64)
    if n and (x.min() < -lim or x.max() >= lim):
        raise ValueError(f"samples exceed signed {bps}-bit range")

    if use_native and use_lpc and bps <= 32:
        # C++ fast path (>100x realtime; same planning, round-trip exact,
        # MD5 left unset). This pure-Python encoder below is the readable
        # spec and the fallback without a toolchain.
        from yoho_tpu_torch.native import flac_encode_native

        blob = flac_encode_native(x.astype(np.int32), sample_rate, bps=bps,
                                  block_size=block_size)
        if blob is not None:
            return blob

    out = bytearray(b"fLaC")
    # STREAMINFO (last-metadata flag set; 34 bytes)
    si = BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(nch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.getvalue() + _md5_signature(x, bps)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    bs_code_nominal = _BLOCKSIZE_CODES.get(block_size, 7)
    sr_code = _SAMPLE_RATE_CODES.get(sample_rate, 0)
    if sr_code == 0 and sample_rate != 0:
        sr_code = 13 if sample_rate < 65536 else 0
    ss_code = _SAMPLE_SIZE_CODES.get(bps, 0)

    frame_no = 0
    for start in range(0, max(n, 1), block_size):
        blk = x[start : start + block_size]
        bs = len(blk)
        if bs == 0:
            break
        w = BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 1)
        w.write(0, 1)  # fixed blocksize stream
        bs_code = _BLOCKSIZE_CODES.get(bs, 7) if bs != block_size else bs_code_nominal
        w.write(bs_code, 4)
        w.write(sr_code, 4)

        # choose stereo decorrelation by cheap first-difference cost
        # (side channel carries bps+1 bits, so side modes need bps < 32)
        chans: List[np.ndarray]
        if nch == 2 and bps >= 32:
            ch_code, chans, extra = 1, [blk[:, 0], blk[:, 1]], [0, 0]
        elif nch == 2:
            left, right = blk[:, 0], blk[:, 1]
            mid = (left + right) >> 1
            side = left - right

            def cost(a):
                return int(np.abs(np.diff(a)).sum()) + int(abs(a[0]))

            modes = [
                (1, [left, right], [0, 0]),
                (8, [left, side], [0, 1]),
                (9, [side, right], [1, 0]),
                (10, [mid, side], [0, 1]),
            ]
            ch_code, chans, extra = min(
                modes, key=lambda m: sum(cost(c) for c in m[1]))
        else:
            ch_code = nch - 1
            chans = [blk[:, c] for c in range(nch)]
            extra = [0] * nch
        w.write(ch_code, 4)
        w.write(ss_code, 3)
        w.write(0, 1)
        _write_coded_number(w, frame_no)
        if bs_code == 6:
            w.write(bs - 1, 8)
        elif bs_code == 7:
            w.write(bs - 1, 16)
        if sr_code == 12:
            w.write(sample_rate // 1000, 8)
        elif sr_code == 13:
            w.write(sample_rate, 16)
        elif sr_code == 14:
            w.write(sample_rate // 10, 16)
        w.align()
        header = w.getvalue()
        frame = bytearray(header)
        frame.append(_crc8(header))

        w2 = BitWriter()
        for c, xc in enumerate(chans):
            plan = _plan_subframe(xc, bps + extra[c], use_lpc=use_lpc)
            _write_subframe(w2, xc, plan)
        w2.align()
        frame += w2.getvalue()
        frame += _crc16(bytes(frame)).to_bytes(2, "big")
        out += frame
        frame_no += 1
    return bytes(out)


def decode_flac(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream -> ((n, channels) int32, sample_rate, bps).

    Pure-Python mirror of ``yoho_tpu_torch/native/flac.cpp`` (cross-checked).
    Raises ``ValueError`` on ANY malformed input — including truncation,
    which the bit reader reports as running off the end (IndexError) —
    so callers need exactly one exception type for corrupt files."""
    try:
        return _decode_flac(data)
    except (IndexError, OverflowError) as e:
        raise ValueError(f"truncated or corrupt FLAC stream: {e}") from e


def _decode_flac(data: bytes) -> Tuple[np.ndarray, int, int]:
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    r = BitReader(data)
    r.pos = 32
    sr = nch = bps = None
    while True:
        last = r.bits(1)
        btype = r.bits(7)
        length = r.bits(24)
        if btype == 0:
            r.bits(16); r.bits(16); r.bits(24); r.bits(24)
            sr = r.bits(20)
            nch = r.bits(3) + 1
            bps = r.bits(5) + 1
            r.bits(36)
            r.pos += (16 + (length - 34)) * 8
        else:
            r.pos += length * 8
        if last:
            break
    if sr is None:
        raise ValueError("missing STREAMINFO")

    chunks = []
    while True:
        r.align()
        if r.byte_pos() >= len(data) - 1:
            break
        frame_start = r.byte_pos()
        if r.bits(14) != 0x3FFE:
            raise ValueError("lost frame sync")
        r.bits(2)
        bs_code = r.bits(4)
        sr_code = r.bits(4)
        ch_code = r.bits(4)
        ss_code = r.bits(3)
        r.bits(1)
        _read_coded_number(r)
        if bs_code == 6:
            bs = r.bits(8) + 1
        elif bs_code == 7:
            bs = r.bits(16) + 1
        else:
            bs = [0, 192, 576, 1152, 2304, 4608, 0, 0, 256, 512, 1024,
                  2048, 4096, 8192, 16384, 32768][bs_code]
        if sr_code == 12:
            r.bits(8)
        elif sr_code in (13, 14):
            r.bits(16)
        crc8_pos = r.byte_pos()
        want8 = r.bits(8)
        if _crc8(data[frame_start:crc8_pos]) != want8:
            raise ValueError("frame header CRC mismatch")
        fbps = bps if ss_code == 0 else [0, 8, 12, 0, 16, 20, 24, 32][ss_code]

        fch = ch_code + 1 if ch_code < 8 else 2
        bufs = []
        for c in range(fch):
            sub_bps = fbps
            if (ch_code == 8 and c == 1) or (ch_code == 9 and c == 0) or (
                    ch_code == 10 and c == 1):
                sub_bps += 1
            bufs.append(_read_subframe(r, bs, sub_bps))
        r.align()
        crc16_pos = r.byte_pos()
        want16 = r.bits(16)
        if _crc16(data[frame_start:crc16_pos]) != want16:
            raise ValueError("frame CRC mismatch")

        if ch_code == 8:
            bufs[1] = bufs[0] - bufs[1]
        elif ch_code == 9:
            bufs[0] = bufs[1] + bufs[0]
        elif ch_code == 10:
            mid, side = bufs
            mid = (mid << 1) | (side & 1)
            bufs = [(mid + side) >> 1, (mid - side) >> 1]
        chunks.append(np.stack(bufs, axis=1))
    if chunks:
        pcm = np.concatenate(chunks, axis=0).astype(np.int32)
    else:
        pcm = np.zeros((0, nch), np.int32)
    return pcm, sr, bps
