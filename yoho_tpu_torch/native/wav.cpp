// WAV/PCM decoder: RIFF parse, int16/int32/uint8/float32 -> mono float32.
//
// Native replacement for the reference's ffmpeg-subprocess decode of the
// common training format (yoho/src/preprocessing/audio.py:11-18); avoids a
// process spawn + pipe copy per file on the dataloader hot path
// (SURVEY.md §3.4).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Reader {
    FILE* f;
    bool ok = true;
    uint32_t u32() {
        uint8_t b[4];
        if (fread(b, 1, 4, f) != 4) { ok = false; return 0; }
        return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
               ((uint32_t)b[3] << 24);
    }
    uint16_t u16() {
        uint8_t b[2];
        if (fread(b, 1, 2, f) != 2) { ok = false; return 0; }
        return (uint16_t)b[0] | ((uint16_t)b[1] << 8);
    }
};

}  // namespace

extern "C" {

// Returns number of mono samples written to *out (caller frees with
// yoho_free), or -1 on any parse error. *sr_out receives the sample rate.
int64_t yoho_wav_decode(const char* path, float** out, int32_t* sr_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    Reader r{f};

    char tag[5] = {0};
    if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) { fclose(f); return -1; }
    r.u32();  // riff size
    if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) { fclose(f); return -1; }

    uint16_t fmt = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    std::vector<uint8_t> data;
    bool have_fmt = false, have_data = false;

    while (r.ok && !(have_fmt && have_data)) {
        if (fread(tag, 1, 4, f) != 4) break;
        uint32_t size = r.u32();
        if (!r.ok) break;
        if (memcmp(tag, "fmt ", 4) == 0) {
            long chunk_start = ftell(f);
            fmt = r.u16();
            channels = r.u16();
            rate = r.u32();
            r.u32();  // byte rate
            r.u16();  // block align
            bits = r.u16();
            if (fmt == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
                r.u16();                        // cbSize
                r.u16();                        // valid bits
                r.u32();                        // channel mask
                fmt = r.u16();                  // subformat GUID leads with the tag
            }
            fseek(f, chunk_start + (long)size + (size & 1), SEEK_SET);
            have_fmt = true;
        } else if (memcmp(tag, "data", 4) == 0) {
            // The chunk size is UNTRUSTED: clamp to the bytes actually
            // remaining in the file before resize — a corrupt header
            // claiming ~4 GB would otherwise zero-fill gigabytes or
            // throw bad_alloc across the ctypes boundary (std::terminate
            // kills the whole Python process; no fallback ever runs).
            long here = ftell(f);
            if (here < 0) { fclose(f); return -1; }
            if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
            long fend = ftell(f);
            if (fend < 0 || fseek(f, here, SEEK_SET) != 0) { fclose(f); return -1; }
            uint64_t remaining = (uint64_t)(fend - here);
            if ((uint64_t)size > remaining) { fclose(f); return -1; }
            try {
                data.resize(size);
            } catch (const std::bad_alloc&) { fclose(f); return -1; }
            if (size && fread(data.data(), 1, size, f) != size) { fclose(f); return -1; }
            if (size & 1) fseek(f, 1, SEEK_CUR);
            have_data = true;
        } else {
            fseek(f, (long)size + (size & 1), SEEK_CUR);
        }
    }
    fclose(f);
    if (!have_fmt || !have_data || channels == 0) return -1;
    if (fmt != 1 && fmt != 3) return -1;  // PCM or IEEE float only

    const uint32_t bytes_per = bits / 8;
    if (bytes_per == 0) return -1;
    const int64_t total = (int64_t)(data.size() / bytes_per);
    const int64_t frames = total / channels;
    float* mono = (float*)malloc(sizeof(float) * (size_t)frames);
    if (!mono) return -1;

    const uint8_t* p = data.data();
    const float inv_ch = 1.0f / (float)channels;

    // Fast path: mono 16-bit PCM (the dominant training format) — tight
    // vectorizable loop, no per-sample channel mixing.
    if (fmt == 1 && bits == 16 && channels == 1) {
        const int16_t* s16 = (const int16_t*)p;
        constexpr float kInv = 1.0f / 32768.0f;
        for (int64_t i = 0; i < frames; ++i) mono[i] = (float)s16[i] * kInv;
        *out = mono;
        *sr_out = (int32_t)rate;
        return frames;
    }

    for (int64_t i = 0; i < frames; ++i) {
        float acc = 0.0f;
        for (uint16_t c = 0; c < channels; ++c) {
            const uint8_t* s = p + (size_t)(i * channels + c) * bytes_per;
            float v = 0.0f;
            if (fmt == 3 && bits == 32) {
                float fv;
                memcpy(&fv, s, 4);
                v = fv;
            } else if (bits == 16) {
                int16_t iv = (int16_t)((uint16_t)s[0] | ((uint16_t)s[1] << 8));
                v = (float)iv / 32768.0f;
            } else if (bits == 32) {
                int32_t iv;
                memcpy(&iv, s, 4);
                v = (float)iv / 2147483648.0f;
            } else if (bits == 8) {
                v = ((float)s[0] - 128.0f) / 128.0f;
            } else if (bits == 24) {
                int32_t iv = (int32_t)((uint32_t)s[0] << 8 | (uint32_t)s[1] << 16 |
                                       (uint32_t)s[2] << 24) >> 8;
                v = (float)iv / 8388608.0f;
            } else {
                free(mono);
                return -1;
            }
            acc += v;
        }
        mono[i] = acc * inv_ch;
    }
    *out = mono;
    *sr_out = (int32_t)rate;
    return frames;
}

void yoho_free(void* p) { free(p); }

}  // extern "C"
