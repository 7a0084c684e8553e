// Flash-decode attention of a few queries against a time-minor KV cache.
//
// Replaces the TPU kernel yoho_tpu/ops/decode_attention.py::
// _decode_attention_call (body _decode_attn_kernel). On the TPU the T axis
// is a sequential grid dimension with the softmax state carried in
// scratch from one step to the next; CUDA blocks run in no order, so here
// T is split across blocks and a second pass combines them (below).
//
//   q        (B, Hq, S, D)        f32 or bf16, already scaled
//   k, v     (B, Hkv, D/pack, T)  int8 (pack 1), nibble-packed int4
//                                 (pack 2: D[0:D/2] in the low nibbles,
//                                 D[D/2:] in the high ones) with bf16
//                                 per-position scales (B, Hkv, 1, T), or
//                                 the type of q without scales
//   out      (B, S, Hq, D)        the type of q
//
// The TPU kernel's sequential T grid becomes a split over T: block
// (b*Hq + h, j) takes the TC positions [j*TC, (j+1)*TC) and writes its
// partial softmax state (chunk max m, normalizer l, unnormalized P.V) to
// a workspace; a second pass merges the splits of each (b, h) with the
// usual rescaling by exp(m_j - max m). Within a block the K and V chunks
// are staged in shared memory (rows of the time-minor layout are runs of
// consecutive positions, so the copy coalesces); then (A) thread t forms
// the S scores of position j*TC + t in f32, dequantizing in registers,
// times k_scale; masked keys (t >= kv_len, or t > pos + s when causal)
// take finfo(float32).min. (B) one warp per query row takes the chunk max
// and turns the scores into weights p * v_scale, rounded to the type of q
// as the reference rounds them before its value product. (C) one warp per
// value row d sums w[s, t] * v[d, t] over the chunk. The (B, H, S, T)
// scores never reach device memory, and keys at or past
// min(T, kv_len, pos + S) are never read.
//
// Bound on the H100: the cache bytes. Whisper-small's cross read at B=16
// moves 2 x 16 x 12 x 64 x 1500 B = 36.9 MB of int8 codes (+ 1.2 MB of
// scales) per launch, ~11 us at 3.35 TB/s; its operations (4*S*T*D per
// head) are far below the tensor-core line. So the design is about bytes
// in flight: the split gives 1152 blocks for that read (192 without it),
// and each block first stages its K and V chunk in shared memory with
// 4-byte loads sent back to back, then computes from shared memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TC = THREADS;  // positions per block
constexpr int WARPS = THREADS / 32;
constexpr int COMBINE_THREADS = 128;

enum { KV_INT8 = 0, KV_INT4 = 1, KV_FLOAT = 2 };

template <typename QT, int KIND> struct KvType { using T = QT; };
template <typename QT> struct KvType<QT, KV_INT8> { using T = int8_t; };
template <typename QT> struct KvType<QT, KV_INT4> { using T = uint8_t; };

// Copies positions [t0, t0 + TC) of the ROWS rows of one (b, h) slab of
// the time-minor K and V, (.., ROWS, T), into shared memory (row stride
// TC); positions at or past t_end read as zero. Every thread starts all
// its loads of K and V before its first store, so they are in flight
// together; rows whose byte length is a multiple of 4 move as 4-byte words.
template <int ROWS, typename E>
__device__ __forceinline__ void stage(E* k_dst, E* v_dst, const E* __restrict__ k_src,
                                      const E* __restrict__ v_src, int T, int t0,
                                      int t_end) {
  const int n_pos = min(TC, t_end - t0);
  constexpr int WORDS = TC * sizeof(E) / 4;  // words per chunk row
  constexpr int ITER = ROWS * WORDS / THREADS;
  static_assert(ROWS * WORDS % THREADS == 0, "chunk must split evenly");
  if ((T * sizeof(E)) % 4 == 0 && (n_pos * sizeof(E)) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(k_src) % 4 == 0 && reinterpret_cast<uintptr_t>(v_src) % 4 == 0) {
    const int valid = n_pos * sizeof(E) / 4;
    uint32_t kb[ITER], vb[ITER];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / WORDS, w = i - r * WORDS;
      const size_t off = (size_t)r * T + t0;
      kb[it] = w < valid ? __ldg(reinterpret_cast<const uint32_t*>(k_src + off) + w) : 0u;
      vb[it] = w < valid ? __ldg(reinterpret_cast<const uint32_t*>(v_src + off) + w) : 0u;
    }
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i / WORDS, w = i - r * WORDS;
      reinterpret_cast<uint32_t*>(k_dst + r * TC)[w] = kb[it];
      reinterpret_cast<uint32_t*>(v_dst + r * TC)[w] = vb[it];
    }
  } else {
    constexpr int BATCH = 8;
    constexpr int EITER = ROWS * TC / THREADS;
    static_assert(EITER % BATCH == 0, "chunk must split evenly");
    for (int it0 = 0; it0 < EITER; it0 += BATCH) {
      E kb[BATCH], vb[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = threadIdx.x + (it0 + u) * THREADS, r = i / TC, p = i - r * TC;
        const bool in = p < n_pos;
        kb[u] = in ? k_src[(size_t)r * T + t0 + p] : E{};
        vb[u] = in ? v_src[(size_t)r * T + t0 + p] : E{};
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        k_dst[threadIdx.x + (it0 + u) * THREADS] = kb[u];
        v_dst[threadIdx.x + (it0 + u) * THREADS] = vb[u];
      }
    }
  }
}

// Partial state of split j for (bh, s): part[((bh * n_split + j) * S + s) * (D + 2)
// + {0..D-1: P.V, D: m, D+1: l}].
template <typename QT, int KIND, int SMAX, int D>
__global__ void __launch_bounds__(THREADS)
decode_attn_split(const QT* __restrict__ q, const void* __restrict__ k,
                  const void* __restrict__ v, const __nv_bfloat16* __restrict__ k_scale,
                  const __nv_bfloat16* __restrict__ v_scale, float* __restrict__ part,
                  int Hq, int Hkv, int S, int T, int t_end, int causal, int pos) {
  using E = typename KvType<QT, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? D / 2 : D;
  extern __shared__ __align__(16) unsigned char smem[];
  E* k_s = reinterpret_cast<E*>(smem);                 // DK x TC
  E* v_s = k_s + DK * TC;                              // DK x TC
  float* q_s = reinterpret_cast<float*>(v_s + DK * TC);  // S x D
  float* w_s = q_s + S * D;                            // S x TC

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t kv_base = (size_t)(b * Hkv + hk) * DK * T;
  const size_t sc_base = (size_t)(b * Hkv + hk) * T;
  const bool scaled = k_scale != nullptr;
  const int t0 = split * TC;

  stage<DK>(k_s, v_s, static_cast<const E*>(k) + kv_base, static_cast<const E*>(v) + kv_base,
            T, t0, t_end);
  for (int i = tid; i < S * D; i += THREADS) q_s[i] = to_f32<QT>(q[(size_t)bh * S * D + i]);
  __syncthreads();

  // (A) scores of position t0 + tid, K dequantized from shared memory.
  const int t = t0 + tid;
  float sc[SMAX];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) sc[s] = 0.f;
  if (t < t_end) {
#pragma unroll 8
    for (int dd = 0; dd < DK; ++dd) {
      const E e = k_s[dd * TC + tid];
      if constexpr (KIND == KV_INT4) {
        const float lo = (float)((e & 0xF) - 8), hi = (float)((e >> 4) - 8);
#pragma unroll
        for (int s = 0; s < SMAX; ++s)
          if (s < S) sc[s] = fmaf(q_s[s * D + dd + DK], hi, fmaf(q_s[s * D + dd], lo, sc[s]));
      } else {
        const float kd = to_f32<E>(e);
#pragma unroll
        for (int s = 0; s < SMAX; ++s)
          if (s < S) sc[s] = fmaf(q_s[s * D + dd], kd, sc[s]);
      }
    }
    if (scaled) {
      const float ks = __bfloat162float(k_scale[sc_base + t]);
#pragma unroll
      for (int s = 0; s < SMAX; ++s) sc[s] *= ks;
    }
  }
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    if (s < S) {
      const bool valid = t < t_end && (!causal || t <= pos + s);
      w_s[s * TC + tid] = valid ? sc[s] : YOHO_NEG_INF;
    }
  }
  __syncthreads();

  // (B) chunk softmax state, one warp per query row.
  for (int s = warp; s < S; s += WARPS) {
    float mx = YOHO_NEG_INF;
#pragma unroll
    for (int j = lane; j < TC; j += 32) mx = fmaxf(mx, w_s[s * TC + j]);
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = lane; j < TC; j += 32) {
      const float sv = w_s[s * TC + j];
      // A masked key has score finfo.min and weight 0.
      const float p = sv == YOHO_NEG_INF ? 0.f : expf(sv - mx);
      sum += p;
      const float vs = scaled && t0 + j < t_end ? __bfloat162float(v_scale[sc_base + t0 + j]) : 1.f;
      w_s[s * TC + j] = round_as<QT>(p * vs);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      float* ps = part + (((size_t)bh * n_split + split) * S + s) * (D + 2);
      ps[D] = mx;
      ps[D + 1] = sum;
    }
  }
  __syncthreads();

  // (C) P.V over the chunk, one warp per value row (positions past t_end
  // hold zero weight and zero values).
  for (int row = warp; row < DK; row += WARPS) {
#pragma unroll
    for (int s = 0; s < SMAX; ++s) {
      if (s < S) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int j = lane; j < TC; j += 32) {
          const float w = w_s[s * TC + j];
          const E e = v_s[row * TC + j];
          if constexpr (KIND == KV_INT4) {
            lo = fmaf(w, (float)((e & 0xF) - 8), lo);
            hi = fmaf(w, (float)((e >> 4) - 8), hi);
          } else {
            lo = fmaf(w, to_f32<E>(e), lo);
          }
        }
        lo = warp_sum(lo);
        float* ps = part + (((size_t)bh * n_split + split) * S + s) * (D + 2);
        if (lane == 0) ps[row] = lo;
        if constexpr (KIND == KV_INT4) {
          hi = warp_sum(hi);
          if (lane == 0) ps[row + DK] = hi;
        }
      }
    }
  }
}

// Merges the splits of each (b, h): out = sum_j e_j acc_j / sum_j e_j l_j
// with e_j = exp(m_j - max_j m_j).
template <typename QT>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_attn_combine(const float* __restrict__ part, QT* __restrict__ out, int Hq, int S,
                    int D, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const size_t stride = (size_t)S * (D + 2);
  for (int i = threadIdx.x; i < S * D; i += COMBINE_THREADS) {
    const int s = i / D, d = i - s * D;
    const float* p = part + ((size_t)bh * n_split * S + s) * (D + 2);
    float m = YOHO_NEG_INF;
    for (int j = 0; j < n_split; ++j) m = fmaxf(m, p[j * stride + D]);
    float l = 0.f, o = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float e = expf(p[j * stride + D] - m);
      l = fmaf(e, p[j * stride + D + 1], l);
      o = fmaf(e, p[j * stride + d], o);
    }
    out[(((size_t)b * S + s) * Hq + h) * D + d] = from_f32<QT>(o / fmaxf(l, 1e-30f));
  }
}

template <typename QT, int KIND, int SMAX, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, void* out, float* part, int B, int Hq, int Hkv, int S,
                   int T, int t_end, int causal, int pos, cudaStream_t stream) {
  const int n_split = (t_end + TC - 1) / TC;
  using E = typename KvType<QT, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? D / 2 : D;
  const size_t smem = 2 * sizeof(E) * DK * TC + sizeof(float) * ((size_t)S * D + (size_t)S * TC);
  auto kern = decode_attn_split<QT, KIND, SMAX, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B * Hq, n_split), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), k, v, static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), part, Hq, Hkv, S, T, t_end, causal, pos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<QT><<<B * Hq, COMBINE_THREADS, 0, stream>>>(
      part, static_cast<QT*>(out), Hq, S, D, n_split);
  return cudaGetLastError();
}

template <typename QT, int KIND, int SMAX>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, void* out, float* part, int B, int Hq, int Hkv,
                       int S, int T, int t_end, int causal, int pos, cudaStream_t st) {
  if (D != 64) return cudaErrorInvalidValue;  // every whisper size has head dim 64
  return launch<QT, KIND, SMAX, 64>(q, k, v, ks, vs, out, part, B, Hq, Hkv, S, T, t_end, causal, pos, st);
}

template <typename QT, int KIND>
cudaError_t dispatch_s(int D, const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, void* out, float* part, int B, int Hq, int Hkv,
                       int S, int T, int t_end, int causal, int pos, cudaStream_t st) {
  if (S <= 1) return dispatch_d<QT, KIND, 1>(D, q, k, v, ks, vs, out, part, B, Hq, Hkv, S, T, t_end, causal, pos, st);
  if (S <= 4) return dispatch_d<QT, KIND, 4>(D, q, k, v, ks, vs, out, part, B, Hq, Hkv, S, T, t_end, causal, pos, st);
  if (S <= 32) return dispatch_d<QT, KIND, 32>(D, q, k, v, ks, vs, out, part, B, Hq, Hkv, S, T, t_end, causal, pos, st);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t dispatch_kind(int kind, int D, const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, void* out, float* part, int B,
                          int Hq, int Hkv, int S, int T, int t_end, int causal, int pos,
                          cudaStream_t st) {
  switch (kind) {
    case KV_INT8: return dispatch_s<QT, KV_INT8>(D, q, k, v, ks, vs, out, part, B, Hq, Hkv, S, T, t_end, causal, pos, st);
    case KV_INT4: return dispatch_s<QT, KV_INT4>(D, q, k, v, ks, vs, out, part, B, Hq, Hkv, S, T, t_end, causal, pos, st);
    case KV_FLOAT: return dispatch_s<QT, KV_FLOAT>(D, q, k, v, ks, vs, out, part, B, Hq, Hkv, S, T, t_end, causal, pos, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

YOHO_ERROR_STRING_FN

// q_dtype: 0 = float32, 1 = bfloat16. kind: 0 = int8, 1 = int4 (packed),
// 2 = K/V in the type of q (k_scale and v_scale null). causal: query row s
// sees keys <= pos + s. part: f32 workspace of at least
// B * Hq * ceil(T / 256) * S * (D + 2) floats. D is 64.
extern "C" int decode_attention(int q_dtype, int kind, const void* q, const void* k,
                                const void* v, const void* k_scale, const void* v_scale,
                                void* out, float* part, int B, int Hq, int Hkv, int S, int D,
                                int T, int kv_len, int causal, int pos, cudaStream_t stream) {
  int t_end = min(T, kv_len);
  if (causal) t_end = min(t_end, pos + S);
  if (t_end <= 0) return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return dispatch_kind<float>(kind, D, q, k, v, k_scale, v_scale, out, part, B, Hq, Hkv, S,
                                T, t_end, causal, pos, stream);
  if (q_dtype == 1)
    return dispatch_kind<__nv_bfloat16>(kind, D, q, k, v, k_scale, v_scale, out, part, B, Hq,
                                        Hkv, S, T, t_end, causal, pos, stream);
  return cudaErrorInvalidValue;
}
