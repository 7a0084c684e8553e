// Universal in-process audio decode via the system libav* stack
// (libavformat/libavcodec/libswresample) — the last-resort compressed
// formats (m4a/aac/opus/...) without spawning an ffmpeg BINARY per file
// (reference: yoho/src/preprocessing/audio.py:11-18 shells out instead).
//
// Built as its OWN shared library (libyoho_av_*.so), gated on the headers
// and libraries existing — the main libyoho_native build stays free of
// external link dependencies. See native/__init__.py::_build_av_lib.
//
// Contract: decode any container/codec to MONO int16 at target_sr
// (resampled by swresample), matching load_audio's int16 contract.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Decoded {
  std::vector<int16_t> pcm;
};

// Drain all resampled mono-S16 frames swr currently holds for `frame`
// (nullptr flushes). Returns false on conversion error.
bool convert_frame(SwrContext* swr, const AVFrame* frame, int target_sr,
                   std::vector<int16_t>* out) {
  // Upper bound on output samples for this input (plus buffered ones).
  int64_t in_n = frame ? frame->nb_samples : 0;
  int64_t in_sr = frame ? frame->sample_rate : target_sr;
  int64_t cap = av_rescale_rnd(swr_get_delay(swr, in_sr) + in_n, target_sr,
                               in_sr, AV_ROUND_UP) +
                64;
  size_t base = out->size();
  out->resize(base + (size_t)cap);
  uint8_t* dst = reinterpret_cast<uint8_t*>(out->data() + base);
  int got = swr_convert(swr, &dst, (int)cap,
                        frame ? (const uint8_t**)frame->extended_data : nullptr,
                        frame ? frame->nb_samples : 0);
  if (got < 0) return false;
  out->resize(base + (size_t)got);
  return true;
}

}  // namespace

extern "C" {

// Decode `path` -> malloc'd mono int16 at `target_sr`.
// (Log noise like "Estimating duration from bitrate" is suppressed —
// callers see failures through return codes, not stderr.)
// Returns sample count (>= 0) or a negative libav/internal error code.
// Caller frees *out with yoho_av_free.
int64_t yoho_av_decode(const char* path, int32_t target_sr, int16_t** out) {
  *out = nullptr;
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* fmt = nullptr;
  int rc = avformat_open_input(&fmt, path, nullptr, nullptr);
  if (rc < 0) return rc;

  int64_t result = -1;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  std::vector<int16_t> pcm;

  do {
    if (avformat_find_stream_info(fmt, nullptr) < 0) break;
    const AVCodec* codec = nullptr;
    int stream = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec,
                                     0);
    if (stream < 0 || !codec) break;
    AVStream* st = fmt->streams[stream];

    dec = avcodec_alloc_context3(codec);
    if (!dec || avcodec_parameters_to_context(dec, st->codecpar) < 0) break;
    if (avcodec_open2(dec, codec, nullptr) < 0) break;
    if (dec->ch_layout.nb_channels <= 0) break;

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_S16, target_sr,
                            &dec->ch_layout, dec->sample_fmt,
                            dec->sample_rate, 0, nullptr) < 0)
      break;
    if (swr_init(swr) < 0) break;

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) break;

    bool ok = true;
    bool eof = false;
    while (ok && !eof) {
      rc = av_read_frame(fmt, pkt);
      if (rc == AVERROR_EOF) {
        eof = true;
      } else if (rc < 0) {
        ok = false;
        break;
      } else if (pkt->stream_index != stream) {
        av_packet_unref(pkt);
        continue;
      }
      rc = avcodec_send_packet(dec, eof ? nullptr : pkt);
      av_packet_unref(pkt);
      if (rc < 0 && rc != AVERROR_EOF) {
        ok = false;
        break;
      }
      while (true) {
        rc = avcodec_receive_frame(dec, frame);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) break;
        if (rc < 0) {
          ok = false;
          break;
        }
        if (!convert_frame(swr, frame, target_sr, &pcm)) ok = false;
        av_frame_unref(frame);
        if (!ok) break;
      }
    }
    if (!ok) break;
    if (!convert_frame(swr, nullptr, target_sr, &pcm)) break;  // flush swr

    int16_t* buf = (int16_t*)malloc(pcm.size() * sizeof(int16_t));
    if (!buf) break;
    memcpy(buf, pcm.data(), pcm.size() * sizeof(int16_t));
    *out = buf;
    result = (int64_t)pcm.size();
  } while (false);

  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (dec) avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  return result;
}

void yoho_av_free(void* p) { free(p); }

// Encode mono int16 PCM -> AAC in an mp4/m4a container (the reference's
// save_audio target, audio.py:21-29 — but in-process, no ffmpeg binary).
// Returns 0 on success, a negative libav/internal code on failure.
int32_t yoho_av_encode_m4a(const char* path, const int16_t* pcm, int64_t n,
                           int32_t sample_rate, int32_t bit_rate) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* fmt = nullptr;
  int rc = avformat_alloc_output_context2(&fmt, nullptr, nullptr, path);
  if (rc < 0 || !fmt) return rc < 0 ? rc : -1;

  int32_t result = -1;
  AVCodecContext* enc = nullptr;
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  bool io_open = false;

  do {
    const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
    if (!codec) break;
    AVStream* st = avformat_new_stream(fmt, nullptr);
    if (!st) break;
    enc = avcodec_alloc_context3(codec);
    if (!enc) break;
    av_channel_layout_default(&enc->ch_layout, 1);
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;  // the native AAC encoder's format
    enc->sample_rate = sample_rate;
    enc->bit_rate = bit_rate;
    enc->time_base = {1, sample_rate};
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, AV_SAMPLE_FMT_FLTP,
                            sample_rate, &mono, AV_SAMPLE_FMT_S16,
                            sample_rate, 0, nullptr) < 0)
      break;
    if (swr_init(swr) < 0) break;

    if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
      if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) break;
      io_open = true;
    }
    if (avformat_write_header(fmt, nullptr) < 0) break;

    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    if (!frame || !pkt) break;
    const int fs = enc->frame_size > 0 ? enc->frame_size : 1024;

    bool ok = true;
    int64_t pts = 0;
    auto drain = [&](bool flush) {
      int src = avcodec_send_frame(enc, flush ? nullptr : frame);
      if (src < 0 && src != AVERROR_EOF) return false;
      while (true) {
        int rr = avcodec_receive_packet(enc, pkt);
        if (rr == AVERROR(EAGAIN) || rr == AVERROR_EOF) return true;
        if (rr < 0) return false;
        av_packet_rescale_ts(pkt, enc->time_base, fmt->streams[0]->time_base);
        pkt->stream_index = 0;
        if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
      }
    };

    for (int64_t off = 0; off < n && ok; off += fs) {
      int chunk = (int)((n - off) < fs ? (n - off) : fs);
      // A SHORT final frame (nb_samples = chunk, accepted by AAC with
      // AV_CODEC_CAP_SMALL_LAST_FRAME): padding it to fs would append
      // up to fs-1 spurious silence samples to every encoded file,
      // breaking save_audio -> load_audio length round-trips and
      // disagreeing with the ffmpeg-binary fallback path.
      frame->nb_samples = chunk;
      frame->format = AV_SAMPLE_FMT_FLTP;
      av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
      frame->sample_rate = sample_rate;
      if (av_frame_get_buffer(frame, 0) < 0 ||
          av_frame_make_writable(frame) < 0) {
        ok = false;
        break;
      }
      const uint8_t* in = reinterpret_cast<const uint8_t*>(pcm + off);
      if (swr_convert(swr, frame->data, chunk, &in, chunk) < 0) {
        ok = false;
        break;
      }
      frame->pts = pts;
      pts += chunk;
      if (!drain(false)) ok = false;
      av_frame_unref(frame);
    }
    if (!ok) break;
    if (!drain(true)) break;  // flush encoder
    if (av_write_trailer(fmt) < 0) break;
    result = 0;
  } while (false);

  if (pkt) av_packet_free(&pkt);
  if (frame) av_frame_free(&frame);
  if (swr) swr_free(&swr);
  if (enc) avcodec_free_context(&enc);
  if (io_open) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return result;
}

}  // extern "C"
