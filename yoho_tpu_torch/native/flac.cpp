// FLAC decoder (from scratch, per the public format spec — RFC 9639).
//
// Closes the reference's dependency on the ffmpeg binary for compressed
// corpora (reference decodes everything by subprocess:
// yoho/src/preprocessing/audio.py:11-18; its corpora are compressed:
// train/utils/dataloaders.py:53, experiments/decoding_benchmark.py:50-70).
// FLAC is the framework's native lossless cache format: ~50-60% of WAV
// size with exact int PCM round-trip (encoder: yoho_tpu_torch/audio/flac.py,
// which doubles as the readable spec + pure-Python fallback decoder).
//
// Supports: 1-8 channels, 4-32 bps, all blocksize/sample-rate codes,
// constant/verbatim/fixed(0-4)/LPC subframes, both Rice methods incl.
// escapes, wasted bits, left/right/mid-side decorrelation, CRC-8/16
// verification.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint64_t load_be64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return __builtin_bswap64(v);
}

// MSB-first bit reader over an in-memory buffer. Hot paths (`bits`,
// `unary`) read through an unaligned 64-bit big-endian window — one
// load + shifts per call instead of a loop per BIT (10x on real
// streams); the last <8 bytes fall back to bit-at-a-time.
struct BitReader {
    const uint8_t* data;
    size_t size;     // bytes
    size_t pos;      // bit position
    bool error = false;

    BitReader(const uint8_t* d, size_t n) : data(d), size(n), pos(0) {}

    size_t byte_pos() const { return pos >> 3; }
    bool aligned() const { return (pos & 7) == 0; }
    void align() { pos = (pos + 7) & ~size_t(7); }

    void skip_bytes(uint64_t n) {  // bounds-checked direct advance
        uint64_t target = pos + n * 8;
        if (target > (uint64_t)size * 8) { error = true; pos = size * 8; return; }
        pos = (size_t)target;
    }

    uint32_t bits_slow(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) {
            size_t byte = pos >> 3;
            if (byte >= size) { error = true; return 0; }
            v = (v << 1) | ((data[byte] >> (7 - (pos & 7))) & 1);
            pos++;
        }
        return v;
    }

    uint32_t bits(int n) {  // n in [0, 32], MSB first
        if (n == 0) return 0;
        size_t byte = pos >> 3;
        if (byte + 8 <= size) {  // off <= 7, n <= 32 -> off + n <= 39 < 64
            int off = (int)(pos & 7);
            uint64_t w = load_be64(data + byte) << off;
            pos += (size_t)n;
            return (uint32_t)(w >> (64 - n));
        }
        return bits_slow(n);
    }

    uint64_t bits64(int n) {
        uint64_t v = 0;
        if (n > 32) { v = bits(n - 32); n = 32; }
        return (v << n) | bits(n);
    }

    int32_t sbits(int n) {  // signed, two's complement
        uint32_t v = bits(n);
        if (n == 0 || n == 32) return (int32_t)v;
        if (v & (1u << (n - 1))) v |= ~((1u << n) - 1);
        return (int32_t)v;
    }

    int64_t sbits64(int n) {  // signed, up to 63 bits (33 for 32-bps side)
        uint64_t v = bits64(n);
        if (n != 0 && n < 64 && (v & (1ull << (n - 1))))
            v |= ~((1ull << n) - 1);
        return (int64_t)v;
    }

    uint32_t unary() {  // count 0-bits until a 1-bit
        uint32_t q = 0;
        for (;;) {
            size_t byte = pos >> 3;
            if (byte >= size) { error = true; return 0; }
            if (byte + 8 <= size) {
                int off = (int)(pos & 7);
                uint64_t w = load_be64(data + byte) << off;
                int valid = 64 - off;
                if (w == 0) { q += (uint32_t)valid; pos += (size_t)valid; continue; }
                int lz = __builtin_clzll(w);
                if (lz >= valid) { q += (uint32_t)valid; pos += (size_t)valid; continue; }
                q += (uint32_t)lz;
                pos += (size_t)lz + 1;
                return q;
            }
            if ((data[byte] >> (7 - (pos & 7))) & 1) { pos++; return q; }
            pos++; q++;
        }
    }
};

struct CrcTables {
    uint8_t t8[256];
    uint16_t t16[256];
    CrcTables() {
        for (int i = 0; i < 256; i++) {
            uint8_t c8 = (uint8_t)i;
            for (int b = 0; b < 8; b++)
                c8 = (c8 & 0x80) ? (uint8_t)((c8 << 1) ^ 0x07) : (uint8_t)(c8 << 1);
            t8[i] = c8;
            uint16_t c16 = (uint16_t)(i << 8);
            for (int b = 0; b < 8; b++)
                c16 = (c16 & 0x8000) ? (uint16_t)((c16 << 1) ^ 0x8005)
                                     : (uint16_t)(c16 << 1);
            t16[i] = c16;
        }
    }
};
const CrcTables CRC;

uint8_t crc8(const uint8_t* d, size_t n) {  // poly 0x07, init 0
    uint8_t crc = 0;
    for (size_t i = 0; i < n; i++) crc = CRC.t8[crc ^ d[i]];
    return crc;
}

uint16_t crc16(const uint8_t* d, size_t n) {  // poly 0x8005, init 0
    uint16_t crc = 0;
    for (size_t i = 0; i < n; i++)
        crc = (uint16_t)((crc << 8) ^ CRC.t16[(crc >> 8) ^ d[i]]);
    return crc;
}

// UTF-8-style coded number (frame/sample index), up to 36 bits / 7 bytes.
bool read_coded_number(BitReader& br, uint64_t* out) {
    uint32_t b0 = br.bits(8);
    if (br.error) return false;
    int extra;
    uint64_t v;
    if ((b0 & 0x80) == 0x00) { *out = b0; return true; }
    else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
    else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
    else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
    else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
    else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
    else if (b0 == 0xFE) { extra = 6; v = 0; }
    else return false;
    for (int i = 0; i < extra; i++) {
        uint32_t b = br.bits(8);
        if (br.error || (b & 0xC0) != 0x80) return false;
        v = (v << 6) | (b & 0x3F);
    }
    *out = v;
    return true;
}

const int FIXED_ORDER_COEFS[5][4] = {
    {},                 // order 0
    {1},                // order 1
    {2, -1},            // order 2
    {3, -3, 1},         // order 3
    {4, -6, 4, -1},     // order 4
};

// Decode one residual section into out[pred_order..blocksize).
bool decode_residual(BitReader& br, int blocksize, int pred_order,
                     int64_t* out) {
    uint32_t method = br.bits(2);
    if (method > 1) return false;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 15 : 31;
    uint32_t porder = br.bits(4);
    uint32_t nparts = 1u << porder;
    if (blocksize % nparts) return false;
    int idx = pred_order;
    for (uint32_t p = 0; p < nparts; p++) {
        int count = blocksize >> porder;
        if (p == 0) count -= pred_order;
        if (count < 0) return false;
        uint32_t param = br.bits(plen);
        if (param == escape) {
            uint32_t raw = br.bits(5);
            for (int i = 0; i < count; i++) {
                out[idx++] = raw == 0 ? 0 : br.sbits(raw);
            }
        } else {
            for (int i = 0; i < count; i++) {
                // 64-bit assembly: high-bps streams can zigzag past 2^32
                // (q << param would silently wrap in uint32).
                uint64_t q = br.unary();
                uint64_t u = (q << param) | br.bits(param);
                out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
            }
        }
        if (br.error) return false;
    }
    return true;
}

// Decode one subframe into buf[0..blocksize). bps already includes the
// channel-assignment +1 for side channels.
bool decode_subframe(BitReader& br, int blocksize, int bps, int64_t* buf) {
    if (br.bits(1) != 0) return false;  // mandatory zero pad bit
    uint32_t type = br.bits(6);
    int wasted = 0;
    if (br.bits(1)) wasted = (int)br.unary() + 1;
    if (br.error) return false;
    int ebps = bps - wasted;
    if (ebps <= 0 || ebps > 33) return false;  // 33: 32-bps side channel

    if (type == 0) {  // CONSTANT
        int64_t v = br.sbits64(ebps);
        for (int i = 0; i < blocksize; i++) buf[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < blocksize; i++) buf[i] = br.sbits64(ebps);
    } else if ((type & 0x38) == 0x08 && (type & 7) <= 4) {  // FIXED
        int order = type & 7;
        for (int i = 0; i < order; i++) buf[i] = br.sbits64(ebps);
        if (!decode_residual(br, blocksize, order, buf)) return false;
        for (int i = order; i < blocksize; i++) {
            int64_t pred = 0;
            for (int j = 0; j < order; j++)
                pred += (int64_t)FIXED_ORDER_COEFS[order][j] * buf[i - 1 - j];
            buf[i] += pred;
        }
    } else if (type & 0x20) {  // LPC
        int order = (int)(type & 0x1F) + 1;
        for (int i = 0; i < order; i++) buf[i] = br.sbits64(ebps);
        uint32_t prec = br.bits(4);
        if (prec == 15) return false;  // invalid
        prec += 1;
        int shift = br.sbits(5);
        if (shift < 0) return false;
        int32_t coef[32];
        for (int i = 0; i < order; i++) coef[i] = br.sbits(prec);
        if (!decode_residual(br, blocksize, order, buf)) return false;
        for (int i = order; i < blocksize; i++) {
            int64_t pred = 0;
            for (int j = 0; j < order; j++)
                pred += (int64_t)coef[j] * buf[i - 1 - j];
            buf[i] += pred >> shift;
        }
    } else {
        return false;  // reserved type
    }
    if (br.error) return false;
    if (wasted)
        for (int i = 0; i < blocksize; i++) buf[i] <<= wasted;
    return true;
}

const int BLOCKSIZES[16] = {-1, 192, 576, 1152, 2304, 4608, -6, -7,
                            256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int SAMPLE_RATES[12] = {0, 88200, 176400, 192000, 8000, 16000, 22050,
                              24000, 32000, 44100, 48000, 96000};
const int SAMPLE_SIZES[8] = {0, 8, 12, -1, 16, 20, 24, 32};

}  // namespace

extern "C" {

void yoho_free(void* p);  // defined in wav.cpp

// Decode a FLAC stream held in memory.
//   out:  malloc'd interleaved int32 samples (n_samples * channels)
//   returns n_samples (per channel), or -1 on any parse/CRC error.
int64_t yoho_flac_decode(const uint8_t* data, int64_t size,
                         int32_t** out, int32_t* out_sr,
                         int32_t* out_channels, int32_t* out_bps) {
    if (size < 8 || memcmp(data, "fLaC", 4) != 0) return -1;
    BitReader br(data, (size_t)size);
    br.pos = 32;

    // --- metadata blocks; need STREAMINFO (type 0, first, mandatory)
    int stream_sr = 0, stream_ch = 0, stream_bps = 0;
    bool have_streaminfo = false;
    for (;;) {
        uint32_t last = br.bits(1);
        uint32_t type = br.bits(7);
        uint32_t len = br.bits(24);
        if (br.error) return -1;
        if (type == 0) {
            if (len < 34) return -1;
            br.bits(16); br.bits(16);      // min/max blocksize
            br.bits(24); br.bits(24);      // min/max framesize
            stream_sr = (int)br.bits(20);
            stream_ch = (int)br.bits(3) + 1;
            stream_bps = (int)br.bits(5) + 1;
            br.bits64(36);                 // total samples (trust frames)
            for (int i = 0; i < 16; i++) br.bits(8);  // MD5
            if (len > 34) br.skip_bytes(len - 34);
            have_streaminfo = true;
        } else {
            // Direct position skip: byte-at-a-time bits(8) cost millions
            // of iterations on files with embedded artwork (a 10 MB
            // PICTURE block is standard for music-derived corpora).
            br.skip_bytes(len);
        }
        if (br.error) return -1;
        if (last) break;
    }
    if (!have_streaminfo || stream_sr == 0) return -1;
    if (stream_ch < 1 || stream_ch > 8) return -1;

    std::vector<int32_t> pcm;
    std::vector<int64_t> ch_buf[8];

    // --- frames
    for (;;) {
        br.align();
        if (br.byte_pos() >= br.size) break;  // clean EOF
        size_t frame_start = br.byte_pos();
        uint32_t sync = br.bits(14);
        if (br.error) break;  // trailing garbage < 2 bytes
        if (sync != 0x3FFE) return -1;
        br.bits(1);                        // reserved
        br.bits(1);                        // blocking strategy
        uint32_t bs_code = br.bits(4);
        uint32_t sr_code = br.bits(4);
        uint32_t ch_code = br.bits(4);
        uint32_t ss_code = br.bits(3);
        if (br.bits(1) != 0) return -1;    // reserved
        uint64_t coded_no;
        if (!read_coded_number(br, &coded_no)) return -1;

        int blocksize;
        if (bs_code == 0) return -1;
        else if (bs_code == 6) blocksize = (int)br.bits(8) + 1;
        else if (bs_code == 7) blocksize = (int)br.bits(16) + 1;
        else blocksize = BLOCKSIZES[bs_code];

        int sr = stream_sr;
        if (sr_code == 12) sr = (int)br.bits(8) * 1000;
        else if (sr_code == 13) sr = (int)br.bits(16);
        else if (sr_code == 14) sr = (int)br.bits(16) * 10;
        else if (sr_code == 15) return -1;
        else if (sr_code != 0) sr = SAMPLE_RATES[sr_code];

        int bps = stream_bps;
        if (ss_code != 0) {
            if (SAMPLE_SIZES[ss_code] < 0) return -1;
            bps = SAMPLE_SIZES[ss_code];
        }

        // header CRC-8 (sync byte .. last header byte)
        size_t crc8_pos = br.byte_pos();
        uint32_t want8 = br.bits(8);
        if (br.error) return -1;
        if (crc8(data + frame_start, crc8_pos - frame_start) != want8) return -1;

        int nch = ch_code < 8 ? (int)ch_code + 1 : 2;
        if (ch_code > 10) return -1;
        if (nch != stream_ch) return -1;   // spec allows per-frame, we don't
        if (blocksize <= 0 || blocksize > 65536) return -1;

        for (int c = 0; c < nch; c++) {
            int sub_bps = bps;
            // side channel carries one extra bit:
            // 8=left/side: ch1; 9=right(side first)=ch0; 10=mid/side: ch1
            if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
                (ch_code == 10 && c == 1))
                sub_bps += 1;
            ch_buf[c].assign((size_t)blocksize, 0);
            if (!decode_subframe(br, blocksize, sub_bps, ch_buf[c].data()))
                return -1;
        }

        br.align();
        size_t crc16_pos = br.byte_pos();
        uint32_t want16 = br.bits(16);
        if (br.error) return -1;
        if (crc16(data + frame_start, crc16_pos - frame_start) != (uint16_t)want16)
            return -1;

        // undo inter-channel decorrelation
        if (ch_code == 8) {          // left/side -> right = left - side
            for (int i = 0; i < blocksize; i++)
                ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
        } else if (ch_code == 9) {   // side/right -> left = right + side
            for (int i = 0; i < blocksize; i++)
                ch_buf[0][i] = ch_buf[1][i] + ch_buf[0][i];
        } else if (ch_code == 10) {  // mid/side
            for (int i = 0; i < blocksize; i++) {
                int64_t mid = ch_buf[0][i], side = ch_buf[1][i];
                mid = (mid << 1) | (side & 1);
                ch_buf[0][i] = (mid + side) >> 1;
                ch_buf[1][i] = (mid - side) >> 1;
            }
        }

        size_t base = pcm.size();
        pcm.resize(base + (size_t)blocksize * nch);
        for (int i = 0; i < blocksize; i++)
            for (int c = 0; c < nch; c++)
                pcm[base + (size_t)i * nch + c] = (int32_t)ch_buf[c][i];
        (void)sr; (void)coded_no;
    }

    int64_t n_samples = (int64_t)(pcm.size() / stream_ch);
    int32_t* buf = (int32_t*)malloc(pcm.size() * sizeof(int32_t) + 1);
    if (!buf) return -1;
    memcpy(buf, pcm.data(), pcm.size() * sizeof(int32_t));
    *out = buf;
    *out_sr = stream_sr;
    *out_channels = stream_ch;
    *out_bps = stream_bps;
    return n_samples;
}

}  // extern "C"

// ==========================================================================
// FLAC ENCODER (C++ port of yoho_tpu_torch/audio/flac.py::encode_flac — that
// module remains the readable spec; this is the >100x-realtime path the
// lossless-corpus-cache feature needs). Same subframe/stereo/Rice
// planning; bitstreams may differ from the Python encoder in tie-breaks,
// round-trip exactness is what tests pin. MD5 is written as zeros
// ("unset" per RFC 9639 §8.2 — the Python encoder fills it in).
// ==========================================================================

namespace {

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int nbits = 0;

    void write(uint64_t value, int n) {
        if (n == 0) return;
        acc = (acc << n) | (value & ((n >= 64) ? ~0ull : ((1ull << n) - 1)));
        nbits += n;
        while (nbits >= 8) {
            nbits -= 8;
            out.push_back((uint8_t)(acc >> nbits));
        }
        acc &= (1ull << nbits) - 1;
    }
    void write_signed(int64_t v, int n) { write((uint64_t)v, n); }
    void write_unary(uint32_t q) {
        while (q >= 32) { write(0, 32); q -= 32; }
        write(1, (int)q + 1);
    }
    void align() { if (nbits) write(0, 8 - nbits); }
};

void write_coded_number(BitWriter& w, uint64_t v) {
    if (v < 0x80) { w.write(v, 8); return; }
    int nbytes = 2;
    while (nbytes < 7 && v >= (1ull << ((7 - nbytes) + 6 * (nbytes - 1))))
        nbytes++;
    uint32_t lead_prefix = (0xFFu << (8 - nbytes)) & 0xFF;
    w.write(lead_prefix | (uint32_t)(v >> (6 * (nbytes - 1))), 8);
    for (int i = nbytes - 2; i >= 0; i--)
        w.write(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

inline uint64_t zigzag64(int64_t r) { return ((uint64_t)r << 1) ^ (uint64_t)(r >> 63); }

int bit_length_u64(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

// (k, bits) minimizing rice cost for zigzag values u[0..n)
void best_rice_param(const uint64_t* u, int n, int* out_k, int64_t* out_bits) {
    if (n == 0) { *out_k = 0; *out_bits = 0; return; }
    int best_k = 0;
    int64_t best_bits = -1;
    for (int k = 0; k < 31; k++) {
        int64_t bits = 0;
        for (int i = 0; i < n; i++) bits += (int64_t)(u[i] >> k);
        bits += (int64_t)n * (k + 1);
        if (best_bits < 0 || bits < best_bits) { best_k = k; best_bits = bits; }
        else if (bits > best_bits * 2) break;  // convex in k; far past min
    }
    *out_k = best_k;
    *out_bits = best_bits;
}

struct PartPlan { bool escape; int param; int64_t bits; };
struct ResidualPlan {
    int method = 0, porder = 0;
    std::vector<PartPlan> parts;
    int64_t total = -1;  // -1: invalid
};

ResidualPlan plan_residual(const int64_t* res, int blocksize, int pred_order,
                           std::vector<uint64_t>& u_scratch,
                           int max_porder = 6) {
    int n_res = blocksize - pred_order;
    u_scratch.resize((size_t)n_res);
    for (int i = 0; i < n_res; i++) u_scratch[i] = zigzag64(res[i]);
    ResidualPlan best;
    for (int porder = 0; porder <= max_porder; porder++) {
        int nparts = 1 << porder;
        if (blocksize % nparts) continue;
        if ((blocksize >> porder) <= pred_order) break;
        ResidualPlan cur;
        cur.porder = porder;
        int64_t total = 0;
        int idx = 0;
        bool rice_fits4 = true;
        for (int p = 0; p < nparts; p++) {
            int count = (blocksize >> porder) - (p == 0 ? pred_order : 0);
            const uint64_t* pu = u_scratch.data() + idx;
            idx += count;
            int k;
            int64_t bits;
            best_rice_param(pu, count, &k, &bits);
            uint64_t pmax = 0;
            for (int i = 0; i < count; i++) if (pu[i] > pmax) pmax = pu[i];
            int raw = bit_length_u64(pmax);
            int64_t raw_bits = (raw <= 31) ? 5 + (int64_t)count * raw : -1;
            if (raw_bits >= 0 && raw_bits < bits) {
                cur.parts.push_back({true, raw, raw_bits});
                total += raw_bits;
            } else {
                cur.parts.push_back({false, k, bits});
                if (k > 14) rice_fits4 = false;
                total += bits;
            }
        }
        cur.method = rice_fits4 ? 0 : 1;
        int plen = cur.method == 0 ? 4 : 5;
        total += 2 + 4 + (int64_t)nparts * plen;
        cur.total = total;
        if (best.total < 0 || total < best.total) best = cur;
    }
    return best;
}

void write_residual(BitWriter& w, const int64_t* res, int blocksize,
                    int pred_order, const ResidualPlan& plan) {
    int plen = plan.method == 0 ? 4 : 5;
    uint32_t escape = plan.method == 0 ? 15 : 31;
    w.write(plan.method, 2);
    w.write(plan.porder, 4);
    int idx = 0;
    for (size_t p = 0; p < plan.parts.size(); p++) {
        int count = (blocksize >> plan.porder) - (p == 0 ? pred_order : 0);
        const int64_t* r = res + idx;
        idx += count;
        const PartPlan& pp = plan.parts[p];
        if (pp.escape) {
            w.write(escape, plen);
            w.write(pp.param, 5);
            if (pp.param)
                for (int i = 0; i < count; i++) w.write_signed(r[i], pp.param);
        } else {
            w.write(pp.param, plen);
            for (int i = 0; i < count; i++) {
                uint64_t uv = zigzag64(r[i]);
                w.write_unary((uint32_t)(uv >> pp.param));
                if (pp.param) w.write(uv & ((1ull << pp.param) - 1), pp.param);
            }
        }
    }
}

struct SubframePlan {
    enum Kind { CONSTANT, VERBATIM, FIXED, LPC } kind = VERBATIM;
    int order = 0;
    int wasted = 0, ebps = 0;
    int64_t value = 0;            // constant
    int32_t coefs[32];            // lpc
    int shift = 0;                // lpc
    std::vector<int64_t> res;     // fixed/lpc residual
    ResidualPlan rplan;
    int64_t bits = 0;
};

// Quantized Levinson-Durbin LPC (precision 14). Returns order or 0.
int quantize_lpc(const double* autoc, int order, int32_t* coefs, int* shift) {
    double err = autoc[0];
    if (err <= 0) return 0;
    double a[33] = {0};
    a[0] = 1.0;
    for (int i = 1; i <= order; i++) {
        double acc = autoc[i];
        for (int j = 1; j < i; j++) acc += a[j] * autoc[i - j];
        double k = -acc / err;
        double tmp[33];
        for (int j = 1; j < i; j++) tmp[j] = a[j] + k * a[i - j];
        for (int j = 1; j < i; j++) a[j] = tmp[j];
        a[i] = k;
        err *= 1 - k * k;
        if (err <= 0) return 0;
    }
    double cmax = 0;
    for (int j = 1; j <= order; j++) {
        double c = a[j] < 0 ? -a[j] : a[j];
        if (c > cmax) cmax = c;
    }
    if (cmax <= 0) return 0;
    const int precision = 14;
    int sh = precision - 1 - (int)std::floor(std::log2(cmax)) - 1;
    sh = sh < 0 ? 0 : (sh > 15 ? 15 : sh);
    bool any = false;
    for (int j = 1; j <= order; j++) {
        double c = -a[j] * (double)(1 << sh);
        int64_t q = (int64_t)std::llround(c);
        int64_t lim = 1 << (precision - 1);
        if (q < -lim) q = -lim;
        if (q > lim - 1) q = lim - 1;
        coefs[j - 1] = (int32_t)q;
        if (q) any = true;
    }
    if (!any) return 0;
    *shift = sh;
    return order;
}

SubframePlan plan_subframe(const int64_t* x, int n, int bps,
                           std::vector<uint64_t>& u_scratch) {
    SubframePlan best;
    int wasted = 0;
    uint64_t orv = 0;
    for (int i = 0; i < n; i++) orv |= (uint64_t)x[i];
    if (orv != 0) {
        wasted = __builtin_ctzll(orv);
        if (wasted > bps - 1) wasted = bps - 1;
    }
    int header = 1 + 6 + 1 + (wasted ? wasted + 1 : 0);
    int ebps = bps - wasted;
    std::vector<int64_t> xe((size_t)n);
    for (int i = 0; i < n; i++) xe[(size_t)i] = x[i] >> wasted;

    bool all_same = n > 0;
    for (int i = 1; i < n; i++) if (xe[(size_t)i] != xe[0]) { all_same = false; break; }
    if (all_same) {
        best.kind = SubframePlan::CONSTANT;
        best.value = xe[0];
        best.wasted = wasted; best.ebps = ebps;
        best.bits = header + ebps;
        return best;
    }

    best.kind = SubframePlan::VERBATIM;
    best.wasted = wasted; best.ebps = ebps;
    best.bits = header + (int64_t)n * ebps;

    // FIXED orders 0-4 (successive differences)
    std::vector<int64_t> cur = xe;
    for (int order = 0; order <= 4 && n > order; order++) {
        if (order > 0) {
            for (int i = (int)cur.size() - 1; i >= 1; i--) cur[(size_t)i] -= cur[(size_t)i - 1];
            cur.erase(cur.begin());
        }
        ResidualPlan rp = plan_residual(cur.data(), n, order, u_scratch);
        if (rp.total < 0) continue;
        int64_t bits = header + (int64_t)order * ebps + rp.total;
        if (bits < best.bits) {
            best.kind = SubframePlan::FIXED;
            best.order = order;
            best.res = cur;
            best.rplan = std::move(rp);
            best.wasted = wasted; best.ebps = ebps;
            best.bits = bits;
        }
    }

    // LPC order 8, Hann-windowed autocorrelation (mirrors the Python spec)
    if (n > 64) {
        int order = 8 < n - 1 ? 8 : n - 1;
        std::vector<double> xf((size_t)n);
        const double pi = 3.14159265358979323846;
        for (int i = 0; i < n; i++)
            xf[(size_t)i] = (double)xe[(size_t)i] *
                            (0.5 - 0.5 * std::cos(2.0 * pi * i / (n - 1)));
        double autoc[33];
        for (int lag = 0; lag <= order; lag++) {
            double s = 0;
            for (int i = 0; i < n - lag; i++) s += xf[(size_t)i] * xf[(size_t)(i + lag)];
            autoc[lag] = s;
        }
        int32_t coefs[32];
        int shift = 0;
        if (quantize_lpc(autoc, order, coefs, &shift)) {
            std::vector<int64_t> res((size_t)(n - order));
            for (int i = order; i < n; i++) {
                int64_t pred = 0;
                for (int j = 0; j < order; j++) pred += (int64_t)coefs[j] * xe[(size_t)(i - 1 - j)];
                res[(size_t)(i - order)] = xe[(size_t)i] - (pred >> shift);
            }
            ResidualPlan rp = plan_residual(res.data(), n, order, u_scratch);
            if (rp.total >= 0) {
                int64_t bits = header + (int64_t)order * ebps + 4 + 5 +
                               (int64_t)order * 14 + rp.total;
                if (bits < best.bits) {
                    best.kind = SubframePlan::LPC;
                    best.order = order;
                    memcpy(best.coefs, coefs, sizeof(coefs));
                    best.shift = shift;
                    best.res = std::move(res);
                    best.rplan = std::move(rp);
                    best.wasted = wasted; best.ebps = ebps;
                    best.bits = bits;
                }
            }
        }
    }
    return best;
}

void write_subframe(BitWriter& w, const int64_t* x, int n,
                    const SubframePlan& plan) {
    w.write(0, 1);  // pad
    switch (plan.kind) {
        case SubframePlan::CONSTANT: w.write(0, 6); break;
        case SubframePlan::VERBATIM: w.write(1, 6); break;
        case SubframePlan::FIXED: w.write(0x08 | plan.order, 6); break;
        case SubframePlan::LPC: w.write(0x20 | (plan.order - 1), 6); break;
    }
    if (plan.wasted) { w.write(1, 1); w.write_unary((uint32_t)plan.wasted - 1); }
    else w.write(0, 1);
    int ebps = plan.ebps;
    std::vector<int64_t> xe((size_t)n);
    for (int i = 0; i < n; i++) xe[(size_t)i] = x[i] >> plan.wasted;
    if (plan.kind == SubframePlan::CONSTANT) { w.write_signed(plan.value, ebps); return; }
    if (plan.kind == SubframePlan::VERBATIM) {
        for (int i = 0; i < n; i++) w.write_signed(xe[(size_t)i], ebps);
        return;
    }
    for (int i = 0; i < plan.order; i++) w.write_signed(xe[(size_t)i], ebps);
    if (plan.kind == SubframePlan::LPC) {
        w.write(14 - 1, 4);
        w.write_signed(plan.shift, 5);
        for (int i = 0; i < plan.order; i++) w.write_signed(plan.coefs[i], 14);
    }
    write_residual(w, plan.res.data(), n, plan.order, plan.rplan);
}

int blocksize_code(int bs) {
    switch (bs) {
        case 192: return 1; case 576: return 2; case 1152: return 3;
        case 2304: return 4; case 4608: return 5; case 256: return 8;
        case 512: return 9; case 1024: return 10; case 2048: return 11;
        case 4096: return 12; case 8192: return 13; case 16384: return 14;
        case 32768: return 15; default: return 7;
    }
}

int sample_rate_code(int sr) {
    switch (sr) {
        case 88200: return 1; case 176400: return 2; case 192000: return 3;
        case 8000: return 4; case 16000: return 5; case 22050: return 6;
        case 24000: return 7; case 32000: return 8; case 44100: return 9;
        case 48000: return 10; case 96000: return 11;
        default: return (sr != 0 && sr < 65536) ? 13 : 0;
    }
}

int sample_size_code(int bps) {
    switch (bps) {
        case 8: return 1; case 12: return 2; case 16: return 4;
        case 20: return 5; case 24: return 6; case 32: return 7;
        default: return 0;
    }
}

}  // namespace

extern "C" {

// Encode interleaved int32 PCM -> malloc'd FLAC stream.
//   pcm: n * nch interleaved samples within signed `bps` range
//   returns byte length (>0), or -1 on invalid parameters.
// Caller frees *out with yoho_free.
int64_t yoho_flac_encode(const int32_t* pcm, int64_t n, int32_t nch,
                         int32_t sr, int32_t bps, int32_t block_size,
                         uint8_t** out) {
    *out = nullptr;
    if (nch < 1 || nch > 8 || bps < 4 || bps > 32 || n < 0) return -1;
    if (block_size <= 0) block_size = 4096;
    // Field-width limits: block size is a 16-bit STREAMINFO/frame field,
    // sample rate a 20-bit field — out-of-range values would silently
    // wrap into a stream our own decoder rejects as corrupt.
    if (block_size > 65535) return -1;
    if (sr <= 0 || sr >= (1 << 20)) return -1;

    BitWriter stream;
    stream.out.reserve((size_t)(n * nch * 2 + 1024));
    stream.out.insert(stream.out.end(), {'f', 'L', 'a', 'C'});

    // STREAMINFO (last-metadata flag set), MD5 zeros (= unset).
    BitWriter si;
    si.write(block_size, 16);
    si.write(block_size, 16);
    si.write(0, 24); si.write(0, 24);
    si.write(sr, 20);
    si.write(nch - 1, 3);
    si.write(bps - 1, 5);
    si.write((uint64_t)n, 36);
    si.align();
    stream.out.push_back(0x80);
    size_t body_len = si.out.size() + 16;
    stream.out.push_back((uint8_t)(body_len >> 16));
    stream.out.push_back((uint8_t)(body_len >> 8));
    stream.out.push_back((uint8_t)body_len);
    stream.out.insert(stream.out.end(), si.out.begin(), si.out.end());
    for (int i = 0; i < 16; i++) stream.out.push_back(0);

    int bs_code_nominal = blocksize_code(block_size);
    int sr_code = sample_rate_code(sr);
    int ss_code = sample_size_code(bps);

    std::vector<uint64_t> u_scratch;
    std::vector<int64_t> chan[8];

    uint64_t frame_no = 0;
    for (int64_t start = 0; start < (n ? n : 1); start += block_size) {
        int bs = (int)((n - start) < block_size ? (n - start) : block_size);
        if (bs <= 0) break;

        BitWriter w;
        w.write(0x3FFE, 14);
        w.write(0, 1);
        w.write(0, 1);  // fixed-blocksize stream
        // Final short block: its own table code, or 7 (explicit 16-bit).
        int bs_code = (bs != block_size) ? blocksize_code(bs) : bs_code_nominal;
        w.write(bs_code, 4);
        w.write(sr_code, 4);

        // stereo decorrelation by cheap first-difference cost
        int ch_code;
        int extra[8] = {0};
        int nch_sub = nch;
        if (nch == 2 && bps < 32) {
            const int32_t* p = pcm + start * 2;
            int64_t cost_l = 0, cost_r = 0, cost_m = 0, cost_s = 0;
            int64_t pl = 0, pr = 0, pm = 0, ps = 0;
            for (int i = 0; i < bs; i++) {
                int64_t l = p[2 * i], r = p[2 * i + 1];
                int64_t m = (l + r) >> 1, s = l - r;
                if (i == 0) { cost_l += l < 0 ? -l : l; cost_r += r < 0 ? -r : r;
                              cost_m += m < 0 ? -m : m; cost_s += s < 0 ? -s : s; }
                else {
                    int64_t dl = l - pl, dr = r - pr, dm = m - pm, ds = s - ps;
                    cost_l += dl < 0 ? -dl : dl; cost_r += dr < 0 ? -dr : dr;
                    cost_m += dm < 0 ? -dm : dm; cost_s += ds < 0 ? -ds : ds;
                }
                pl = l; pr = r; pm = m; ps = s;
            }
            int64_t c_indep = cost_l + cost_r;
            int64_t c_ls = cost_l + cost_s;
            int64_t c_sr = cost_s + cost_r;
            int64_t c_ms = cost_m + cost_s;
            int64_t cbest = c_indep;
            ch_code = 1;
            if (c_ls < cbest) { cbest = c_ls; ch_code = 8; }
            if (c_sr < cbest) { cbest = c_sr; ch_code = 9; }
            if (c_ms < cbest) { cbest = c_ms; ch_code = 10; }
            chan[0].resize((size_t)bs);
            chan[1].resize((size_t)bs);
            for (int i = 0; i < bs; i++) {
                int64_t l = p[2 * i], r = p[2 * i + 1];
                switch (ch_code) {
                    case 1: chan[0][(size_t)i] = l; chan[1][(size_t)i] = r; break;
                    case 8: chan[0][(size_t)i] = l; chan[1][(size_t)i] = l - r; break;
                    case 9: chan[0][(size_t)i] = l - r; chan[1][(size_t)i] = r; break;
                    default: chan[0][(size_t)i] = (l + r) >> 1; chan[1][(size_t)i] = l - r; break;
                }
            }
            if (ch_code == 8) extra[1] = 1;
            else if (ch_code == 9) extra[0] = 1;
            else if (ch_code == 10) extra[1] = 1;
            nch_sub = 2;
        } else {
            ch_code = nch - 1;
            for (int c = 0; c < nch; c++) {
                chan[c].resize((size_t)bs);
                for (int i = 0; i < bs; i++)
                    chan[c][(size_t)i] = pcm[(start + i) * nch + c];
            }
        }
        w.write(ch_code, 4);
        w.write(ss_code, 3);
        w.write(0, 1);
        write_coded_number(w, frame_no);
        if (bs_code == 6) w.write(bs - 1, 8);
        else if (bs_code == 7) w.write(bs - 1, 16);
        if (sr_code == 12) w.write(sr / 1000, 8);
        else if (sr_code == 13) w.write(sr, 16);
        else if (sr_code == 14) w.write(sr / 10, 16);
        w.align();

        std::vector<uint8_t> frame = w.out;
        frame.push_back(crc8(frame.data(), frame.size()));

        BitWriter w2;
        for (int c = 0; c < nch_sub; c++) {
            SubframePlan plan = plan_subframe(chan[c].data(), bs,
                                              bps + extra[c], u_scratch);
            write_subframe(w2, chan[c].data(), bs, plan);
        }
        w2.align();
        frame.insert(frame.end(), w2.out.begin(), w2.out.end());
        uint16_t c16 = crc16(frame.data(), frame.size());
        frame.push_back((uint8_t)(c16 >> 8));
        frame.push_back((uint8_t)c16);
        stream.out.insert(stream.out.end(), frame.begin(), frame.end());
        frame_no++;
        if (n == 0) break;
    }

    uint8_t* buf = (uint8_t*)malloc(stream.out.size() ? stream.out.size() : 1);
    if (!buf) return -1;
    memcpy(buf, stream.out.data(), stream.out.size());
    *out = buf;
    return (int64_t)stream.out.size();
}

}  // extern "C"
