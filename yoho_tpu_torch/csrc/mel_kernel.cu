// Fused log-mel frontend: framing -> windowed real DFT -> power -> mel ->
// log10, one kernel, no frame matrix in device memory.
//
// Replaces the TPU kernel yoho_tpu/ops/mel_kernel.py::fused_log_mel
// (body _mel_kernel). Each block owns TF = 64 consecutive frames of one
// audio row: it copies the audio span those frames cover into shared
// memory once (frame f is x[f*hop : f*hop + n_fft] of the span, so the
// overlapping (B, frames, n_fft) frame matrix is never written out), runs
// the DFT of all its frames as a GEMM on the tensor cores, forms
// re^2 + im^2 in shared memory, projects it onto the mel bands and writes
// log10(max(mel, floor)).
//
// The DFT is (TF x n_fft) frames times (n_fft x 2 n_freq) bases, in
// mma.sync m16n8k8 TF32 with the error-compensated 3xTF32 split: each
// operand x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
// hi*lo + lo*hi + hi*hi summed in f32. That keeps the f32 accuracy the
// reference's Precision.HIGHEST buys (a single TF32 pass keeps about three
// digits, which the power -> log chain cannot afford). The window (and
// the scipy convention's 1/sum(win) scale) is folded into the bases on the
// host in float64, as the TPU kernel's _constants does; the host lays the
// f32 bases out in mma fragment order (per 8 samples x 8 frequencies: the
// cosine and sine operands of one lane in one 16-byte load) and the kernel
// splits them as they arrive; the audio frames are split as they are read
// from shared memory. A warp owns all TF frames and two groups of 8
// frequencies (cosine and sine tiles side by side, so each thread holds
// re and im of the same bins), and every thread of the 13 warps does work:
// no idle half-threads at n_freq = 201. The audio span is stored with a
// 4-float gap after every hop of samples, so the 8 frames a fragment load
// reads sit in 8 different bank groups.
//
// The mel projection reads only each band's nonzero bins: the host passes
// every band's first bin and its weights (a triangular filter covers a few
// contiguous bins), added in ascending bin order, which gives the same f32
// sum as the dense loop over all bins (the skipped terms are exact zeros).
//
// Audio past the end of a row reads as zero: that is the scipy
// convention's end padding; the whisper convention's reflect padding is
// done by the wrapper.
//
// Bound on the H100, whisper (16 x 3000 frames, n_fft 400, 201 bins):
// the three TF32 products are 46.3 G tensor-core operations, 0.094 ms at
// 495 TFLOP/s; the bytes (audio in, log-mel out) about 46 MB, 0.014 ms:
// bound by operations. The same DFT in FP32 FMAs alone is 15.4 GFLOP,
// 0.23 ms at 67 TFLOP/s.
#include "common.cuh"

namespace {

constexpr int TF = 64;          // frames per block: 4 m16 tiles
constexpr int GPW = 2;          // groups of 8 frequencies per warp
constexpr int MAX_WARPS = 13;   // n_fft 400: 26 groups of 8 frequencies

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both exact in TF32 (the tensor cores read 19 bits of each).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// D (16x8, f32) += A (16x8 tf32, row) * B (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bases: (n_k8, n_grp, 32, 4) f32 — for 8 samples kb, 8 frequencies gp and
// lane 4 g + t4: {cos[8 kb + t4][8 gp + g], cos[8 kb + t4 + 4][...], sin[...],
// sin[...]} (windowed, zero past n_fft and n_freq). bands: n_mels first
// bins, then n_mels + 1 offsets into wts, the bands' weights in bin order.
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
mel_kernel(const float* __restrict__ audio, int n_audio, int num_frames,
           const float4* __restrict__ bases, const int* __restrict__ bands,
           const float* __restrict__ wts, float* __restrict__ out, int n_fft, int hop,
           int n_freq, int n_mels, float log_floor) {
  extern __shared__ __align__(16) float smem[];
  const int n_k8 = (n_fft + 7) / 8;
  const int n_grp = (n_freq + 7) / 8;
  const int pad = (36 - hop % 32) % 32;  // row stride hop + pad = 4 (mod 32) words
  const int stride = hop + pad;
  const int span = (TF - 1) * hop + 8 * n_k8;  // samples the block's frames read
  const int n_seg = (span + hop - 1) / hop;
  float* x = smem;                              // n_seg rows of hop samples (+ pad)
  float* pw = smem + n_seg * stride;            // TF x (8 n_grp) power spectrum
  const int pw_w = 8 * n_grp;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int g = lane / 4, t4 = lane % 4;

  const float* row = audio + (size_t)b * n_audio;
  const long base = (long)f0 * hop;
  for (int seg = warp; seg < n_seg; seg += n_warps)
    for (int t = lane; t < hop; t += 32) {
      const int i = seg * hop + t;
      const long gi = base + i;
      x[seg * stride + t] = (i < span && gi < n_audio) ? row[gi] : 0.f;
    }
  __syncthreads();

  for (int gp0 = warp * GPW; gp0 < n_grp; gp0 += n_warps * GPW) {
    float acc[TF / 16][2 * GPW][4];
#pragma unroll
    for (int mt = 0; mt < TF / 16; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * GPW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
    // Sample n of frame f sits at x[f * stride + (n / hop) * stride + n % hop];
    // (q, r) track n / hop and n % hop of the fragment's samples t4 and t4 + 4.
    int q0 = t4 / hop, r0 = t4 % hop, q1 = (t4 + 4) / hop, r1 = (t4 + 4) % hop;
    auto load_b = [&](int kb, float4 (&bv)[GPW]) {
#pragma unroll
      for (int p = 0; p < GPW; ++p) {
        const int gp = gp0 + p;
        bv[p] = (gp < n_grp && kb < n_k8) ? __ldg(bases + ((size_t)kb * n_grp + gp) * 32 + lane)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    float4 bnext[GPW];
    load_b(0, bnext);
    for (int kb = 0; kb < n_k8; ++kb) {
      uint32_t bh[GPW][4], bl[GPW][4];
#pragma unroll
      for (int p = 0; p < GPW; ++p) {
        split(bnext[p].x, bh[p][0], bl[p][0]);
        split(bnext[p].y, bh[p][1], bl[p][1]);
        split(bnext[p].z, bh[p][2], bl[p][2]);
        split(bnext[p].w, bh[p][3], bl[p][3]);
      }
      load_b(kb + 1, bnext);  // in flight while this step's products run
      const int o0 = q0 * stride + r0, o1 = q1 * stride + r1;
#pragma unroll
      for (int mt = 0; mt < TF / 16; ++mt) {
        const float* xf = x + (16 * mt + g) * stride;
        uint32_t ah[4], al[4];
        split(xf[o0], ah[0], al[0]);
        split(xf[8 * stride + o0], ah[1], al[1]);
        split(xf[o1], ah[2], al[2]);
        split(xf[8 * stride + o1], ah[3], al[3]);
#pragma unroll
        for (int p = 0; p < GPW; ++p)
#pragma unroll
          for (int cs = 0; cs < 2; ++cs) {  // cosine, sine
            float(&d)[4] = acc[mt][2 * p + cs];
            mma_tf32(d, al, bh[p][2 * cs], bh[p][2 * cs + 1]);
            mma_tf32(d, ah, bl[p][2 * cs], bl[p][2 * cs + 1]);
            mma_tf32(d, ah, bh[p][2 * cs], bh[p][2 * cs + 1]);
          }
      }
      r0 += 8;
      r1 += 8;
      while (r0 >= hop) r0 -= hop, ++q0;
      while (r1 >= hop) r1 -= hop, ++q1;
    }
    // Power, in the reference's rounding: re*re + im*im.
#pragma unroll
    for (int p = 0; p < GPW; ++p) {
      const int gp = gp0 + p;
      if (gp >= n_grp) continue;
#pragma unroll
      for (int mt = 0; mt < TF / 16; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float re = acc[mt][2 * p][i], im = acc[mt][2 * p + 1][i];
          pw[(16 * mt + g + 8 * (i / 2)) * pw_w + 8 * gp + 2 * t4 + (i & 1)] =
              __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
    }
  }
  __syncthreads();

  const int* first = bands;
  const int* offset = bands + n_mels;
  for (int o = threadIdx.x; o < TF * n_mels; o += blockDim.x) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    if (f0 + f >= num_frames) continue;
    const float* p = pw + f * pw_w + first[m];
    const float* w = wts + offset[m];
    const int len = offset[m + 1] - offset[m];
    float acc = 0.f;
    for (int j = 0; j < len; ++j) acc = fmaf(p[j], w[j], acc);
    out[((size_t)b * num_frames + f0 + f) * n_mels + m] = log10f(fmaxf(acc, log_floor));
  }
}

}  // namespace

YOHO_ERROR_STRING_FN

// audio (B, n_audio) f32 -> out (B, num_frames, n_mels) f32; bases, bands
// and wts as above (ops/mel_kernel.py makes them).
extern "C" int mel_log_spectrogram(const float* audio, int batch, int n_audio,
                                   int num_frames, const float* bases, const int* bands,
                                   const float* wts, float* out, int n_fft, int hop,
                                   int n_freq, int n_mels, float log_floor,
                                   cudaStream_t stream) {
  if (hop < 8 || n_fft < 8 || n_freq != n_fft / 2 + 1 || n_mels < 1 || num_frames < 1)
    return cudaErrorInvalidValue;
  const int n_k8 = (n_fft + 7) / 8, n_grp = (n_freq + 7) / 8;
  const int span = (TF - 1) * hop + 8 * n_k8;
  const int n_seg = (span + hop - 1) / hop;
  const int stride = hop + (36 - hop % 32) % 32;
  const size_t smem = sizeof(float) * ((size_t)n_seg * stride + (size_t)TF * 8 * n_grp);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mel_kernel, smem);
  if (err != cudaSuccess) return err;
  const int warps = min(MAX_WARPS, (n_grp + GPW - 1) / GPW);
  dim3 grid((num_frames + TF - 1) / TF, batch);
  mel_kernel<<<grid, 32 * warps, smem, stream>>>(
      audio, n_audio, num_frames, reinterpret_cast<const float4*>(bases), bands, wts, out,
      n_fft, hop, n_freq, n_mels, log_floor);
  return cudaGetLastError();
}
