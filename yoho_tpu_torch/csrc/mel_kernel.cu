// Fused log-mel frontend: framing -> windowed real DFT -> power -> mel ->
// log10, one kernel, no frame matrix in device memory.
//
// Replaces the TPU kernel yoho_tpu/ops/mel_kernel.py::fused_log_mel
// (body _mel_kernel). Each block owns TF consecutive frames of one audio
// row: it copies the audio span those frames cover into shared memory
// (frame f is x[f*hop : f*hop + n_fft] of the span, so the overlapping
// (B, frames, n_fft) frame matrix is never written out), accumulates the
// windowed DFT in full FP32 with FMAs (the reference runs its matmuls at
// Precision.HIGHEST; TF32 would cost digits through the power -> log
// chain), forms re^2 + im^2 in shared memory, projects it onto the mel
// filterbank and writes log10(max(mel, floor)).
//
// The window (and the scipy convention's 1/sum(win) scale) is folded into
// the DFT bases on the host in float64, as the TPU kernel's _constants
// does. Audio past the end of a row reads as zero: that is the scipy
// convention's end padding; the whisper convention's reflect padding is
// done by the wrapper.
//
// Bound on the H100: the DFT is 2 * n_fft * n_freq FMAs per frame
// (whisper: 400 * 201, 16 x 3000 frames = 15.4 GFLOP in FP32), which at
// 67 TFLOP/s FP32 takes ~0.23 ms, while the bytes (audio in, log-mel out)
// are ~35 MB, ~0.01 ms: the kernel is bound by FP32 operations. Each
// thread keeps the real and imaginary sums of TF frames for two
// frequencies in registers, so its basis loads (from L2, shared by all
// blocks) are reused across TF frames, and each audio sample, read four
// at a time as a shared-memory broadcast, feeds four FMAs: the loop is
// bound by its FMAs, not by shared-memory loads.
#include "common.cuh"

namespace {

constexpr int TF = 16;       // frames per block
constexpr int THREADS = 128;  // thread i owns frequencies i and i + THREADS

__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ audio, int n_audio, int num_frames,
           const float* __restrict__ cos_w, const float* __restrict__ sin_w,
           const float* __restrict__ filt, float* __restrict__ out, int n_fft,
           int hop, int n_freq, int n_mels, float log_floor) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const int span = (TF - 1) * hop + n_fft;
  float* x = smem;              // span audio samples
  float* pw = smem + span;      // TF x n_freq power spectrum

  const float* row = audio + (size_t)b * n_audio;
  const long base = (long)f0 * hop;
  for (int i = threadIdx.x; i < span; i += THREADS) {
    const long g = base + i;
    x[i] = g < n_audio ? row[g] : 0.f;
  }
  __syncthreads();

  for (int k0 = threadIdx.x; k0 < n_freq; k0 += 2 * THREADS) {
    const int k1 = k0 + THREADS;
    const bool two = k1 < n_freq;  // the second frequency's bases read as 0 past n_freq
    float re0[TF], im0[TF], re1[TF], im1[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) re0[f] = im0[f] = re1[f] = im1[f] = 0.f;
    int n = 0;
    if ((hop & 3) == 0) {
      // Four samples per shared-memory load: x[f*hop + n .. n+3] is 16-byte
      // aligned when hop and n are multiples of 4; each sample feeds four
      // FMAs (two frequencies, real and imaginary).
      for (; n + 4 <= n_fft; n += 4) {
        float c0[4], s0[4], c1[4], s1[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          c0[u] = cos_w[(n + u) * n_freq + k0];
          s0[u] = sin_w[(n + u) * n_freq + k0];
          c1[u] = two ? cos_w[(n + u) * n_freq + k1] : 0.f;
          s1[u] = two ? sin_w[(n + u) * n_freq + k1] : 0.f;
        }
#pragma unroll
        for (int f = 0; f < TF; ++f) {
          const float4 xv = *reinterpret_cast<const float4*>(x + f * hop + n);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            re0[f] = fmaf(xs[u], c0[u], re0[f]);
            im0[f] = fmaf(xs[u], s0[u], im0[f]);
            re1[f] = fmaf(xs[u], c1[u], re1[f]);
            im1[f] = fmaf(xs[u], s1[u], im1[f]);
          }
        }
      }
    }
    for (; n < n_fft; ++n) {
      const float c0 = cos_w[n * n_freq + k0], s0 = sin_w[n * n_freq + k0];
      const float c1 = two ? cos_w[n * n_freq + k1] : 0.f;
      const float s1 = two ? sin_w[n * n_freq + k1] : 0.f;
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float xv = x[f * hop + n];
        re0[f] = fmaf(xv, c0, re0[f]);
        im0[f] = fmaf(xv, s0, im0[f]);
        re1[f] = fmaf(xv, c1, re1[f]);
        im1[f] = fmaf(xv, s1, im1[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      pw[f * n_freq + k0] = re0[f] * re0[f] + im0[f] * im0[f];
      if (two) pw[f * n_freq + k1] = re1[f] * re1[f] + im1[f] * im1[f];
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < TF * n_mels; o += THREADS) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    if (f0 + f >= num_frames) continue;
    float acc = 0.f;
    for (int k = 0; k < n_freq; ++k) acc = fmaf(pw[f * n_freq + k], filt[k * n_mels + m], acc);
    out[((size_t)b * num_frames + f0 + f) * n_mels + m] = log10f(fmaxf(acc, log_floor));
  }
}

}  // namespace

YOHO_ERROR_STRING_FN

// audio (B, n_audio) f32 -> out (B, num_frames, n_mels) f32.
extern "C" int mel_log_spectrogram(const float* audio, int batch, int n_audio,
                                   int num_frames, const float* cos_w,
                                   const float* sin_w, const float* filt, float* out,
                                   int n_fft, int hop, int n_freq, int n_mels,
                                   float log_floor, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(TF - 1) * hop + n_fft + (size_t)TF * n_freq);
  cudaError_t err = allow_smem(mel_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((num_frames + TF - 1) / TF, batch);
  mel_kernel<<<grid, THREADS, smem, stream>>>(audio, n_audio, num_frames, cos_w, sin_w,
                                              filt, out, n_fft, hop, n_freq, n_mels,
                                              log_floor);
  return cudaGetLastError();
}
