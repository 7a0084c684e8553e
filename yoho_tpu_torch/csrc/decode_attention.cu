// Flash-decode attention of a few queries against a time-minor KV cache.
//
// Replaces the TPU kernel yoho_tpu/ops/decode_attention.py::
// _decode_attention_call (body _decode_attn_kernel). On the TPU the T axis
// is a sequential grid dimension with the softmax state carried in
// scratch from one step to the next; CUDA blocks run in no order, so here
// the T axis of one (b, h) is shared by the blocks of a thread-block
// cluster, which merge their softmax states through distributed shared
// memory: one launch per call, no workspace in device memory.
//
//   q        (B, Hq, S, D)        f32 or bf16, already scaled
//   k, v     (B, Hkv, D/pack, T)  int8 (pack 1), nibble-packed int4
//                                 (pack 2: D[0:D/2] in the low nibbles,
//                                 D[D/2:] in the high ones) with bf16
//                                 per-position scales (B, Hkv, 1, T), or
//                                 the type of q without scales
//   out      (B, S, Hq, D)        the type of q
//
// Bound on the H100: the cache bytes. Whisper-small's cross read at B=16
// moves 2 x 16 x 12 x 64 x 1500 B = 36.9 MB of int8 codes (+ 1.2 MB of
// scales) per launch, ~11 us at 3.35 TB/s; its operations (4*S*T*D per
// head) are far below the tensor-core line. So the design is about bytes
// in flight and about nothing else standing in their way:
//
// - Positions [0, t_end), t_end = min(T, kv_len, pos + S when causal), are
//   cut into chunks of 64. With per-row positions (continuous batching:
//   pos_rows, a device array of B ints the host never reads) the grid is
//   sized for min(T, kv_len), and each (b, h) ends its row at
//   min(T, kv_len, pos_rows[b] + S): a block whose chunks all lie past the
//   row's end loads nothing and publishes the empty state (m = finfo.min,
//   l = 0), which the combine weighs by exp(finfo.min - m) = 0 (never
//   exp(-inf - -inf)). The CL blocks of a cluster (CL a power of two up
//   to 8, grown until the grid has about two blocks per SM) take the
//   chunks of one (b, h) in turn, each through a ring of three shared-memory
//   stages. Where rows are a multiple of 16 bytes (the cross K/V, padded to
//   a multiple of 128 positions for this; the caches), one thread fills a
//   stage with four TMA tile loads (K and V, 64 positions by D/pack rows,
//   and the two scale rows) that report to the stage's mbarrier, so the
//   next chunks' loads are in flight while a chunk computes and no
//   register stages them. A bulk copy per row, tried first, was bound by
//   the copy engine's cost per request, not by the bytes. The first loads
//   go out before q is read. Rows of a multiple of 4 or 8 bytes (the
//   unpadded bf16 cross K/V of 1500 positions; f32 K/V, wider than a TMA
//   swizzle) take 4- or 8-byte cp.async
//   words through the same ring; any other T is copied element by element.
// - The tiles use the 64- or 128-byte TMA swizzle. Each of the 4 warps owns
//   16 positions of a chunk and keeps its own softmax state (m, l, acc) per
//   query row: lane l holds key and value dims l and l + 32 (one int4 byte
//   holds both), reads them as 16-byte words (conflict-free under the
//   swizzle), forms partial scores for its 16 positions, and a 16-shuffle
//   butterfly leaves each position's full score in a lane pair. Masked keys
//   (t >= t_end, or t > pos + s when causal) get weight 0, as
//   finfo(float32).min gets from the reference's softmax. Weights
//   p * v_scale are rounded to the type of q before the value product, as
//   the reference rounds them.
// - The warps' states merge in shared memory; then, after a cluster
//   barrier, each block reads the CL block states from its peers' shared
//   memory for its share of the S x D outputs and writes them. A last
//   cluster barrier keeps every block alive while its peers read it.
#include <cooperative_groups.h>

#include <type_traits>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;                // every whisper size
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PW = 16;               // positions per warp per chunk
constexpr int TC = WARPS * PW;       // positions per chunk
constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int BLOCKS_PER_SM = 2;     // the grid the cluster size aims at
constexpr int PART = D + 2;          // a softmax state: acc[D], m, l

enum { KV_INT8 = 0, KV_INT4 = 1, KV_FLOAT = 2 };

template <typename QT, int KIND> struct KvType { using T = QT; };
template <typename QT> struct KvType<QT, KV_INT8> { using T = int8_t; };
template <typename QT> struct KvType<QT, KV_INT4> { using T = uint8_t; };

// One shared-memory stage (1024-byte aligned): the K tile and the V tile,
// DK rows of TC positions (ROWB bytes) each, then TC bf16 k scales and TC
// v scales.
template <typename E, int DK> struct Stage {
  static constexpr int ROWB = TC * (int)sizeof(E);
  static constexpr int KV = DK * ROWB;
  static constexpr int SCALES = 2 * KV;
  static constexpr int BYTES = (2 * KV + 2 * TC * 2 + 1023) / 1024 * 1024;
};

// Byte offset of byte `b` of tile row `r`: the TMA swizzle of the row
// width (64 B: 16-byte chunk ^= (r / 2) % 4; 128 B: chunk ^= r % 8). f32
// rows (256 B, never loaded by TMA) take the 128-byte pattern in software.
template <int ROWB>
__device__ __forceinline__ int swz(int r, int b) {
  return r * ROWB + (ROWB == 64 ? b ^ (((r >> 1) & 3) << 4) : b ^ ((r & 7) << 4));
}

// Four bytes to floats without the (quarter-rate) integer conversion: a
// byte b placed under the exponent of 2^23 reads as 2^23 + b; `bias` is
// 2^23 plus the code's offset (128 for a signed byte flipped to unsigned,
// 8 for an int4 nibble).
__device__ __forceinline__ void bytes4(uint32_t u, float bias, float* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - bias;
}

// The 16 positions [16 w, 16 w + 16) of tile row r, as floats.
template <typename E>
__device__ __forceinline__ void row16(const unsigned char* tile, int r, int w, float (&x)[16]) {
  constexpr int ROWB = TC * (int)sizeof(E);
  constexpr int PER = 16 / (int)sizeof(E);  // elements per 16-byte word
#pragma unroll
  for (int j = 0; j < (int)sizeof(E); ++j) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        tile + swz<ROWB>(r, w * 16 * (int)sizeof(E) + 16 * j));
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if constexpr (sizeof(E) == 1) {
        if (i % 4 == 0) bytes4(word[i / 4] ^ 0x80808080u, 8388736.f, &x[PER * j + i]);
      } else if constexpr (sizeof(E) == 2) {
        const uint32_t bits = (i % 2 == 0 ? word[i / 2] << 16 : word[i / 2] & 0xFFFF0000u);
        x[PER * j + i] = __uint_as_float(bits);  // bf16 -> f32 is exact
      } else {
        x[PER * j + i] = __uint_as_float(word[i]);
      }
    }
  }
}

// int4: the low nibbles are dim r, the high nibbles dim r + D/2.
__device__ __forceinline__ void row16_int4(const unsigned char* tile, int r, int w,
                                           float (&lo)[16], float (&hi)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(tile + swz<TC>(r, w * 16));
  const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bytes4(word[i] & 0x0F0F0F0Fu, 8388616.f, &lo[4 * i]);
    bytes4((word[i] >> 4) & 0x0F0F0F0Fu, 8388616.f, &hi[4 * i]);
  }
}

// N-byte asynchronous copy global -> shared; `bytes` 0 writes zeros.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of butterfly16: keeps HALF of the values, adds the partner's.
template <int HALF>
__device__ __forceinline__ void fold(float (&v)[16], int lane) {
  const bool up = lane & (2 * HALF);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? v[j] : v[j + HALF];
    const float keep = up ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// Sums 16 values over the 32 lanes: each step keeps half of the values and
// adds the partner's other half. Lane l ends with the sum of value l >> 1.
__device__ __forceinline__ float butterfly16(float (&v)[16], int lane) {
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Max and sum over the 16 lane pairs (both lanes of a pair hold one value).
__device__ __forceinline__ float pair_max(float x) {
  for (int o = 2; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float pair_sum(float x) {
  for (int o = 2; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, int KIND, int SMAX>
__global__ void __launch_bounds__(THREADS)
decode_attn(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_ks, const __grid_constant__ CUtensorMap tm_vs,
            const QT* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
            const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
            QT* __restrict__ out, int Hq, int Hkv, int S, int T, int t_end_all, int causal,
            int pos_all, const int* __restrict__ pos_rows, int mode) {
  using E = typename KvType<QT, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? D / 2 : D;
  using L = Stage<E, DK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * L::BYTES);
  float* q_s = reinterpret_cast<float*>(bars + STAGES);  // S x D
  float* wpart = q_s + S * D;                            // WARPS x S x PART
  float* bpart = wpart + WARPS * S * PART;               // S x PART: this block's state

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  // This row's causal position and end: the launch's, or row b's own.
  const int pos = pos_rows != nullptr ? pos_rows[b] : pos_all;
  const int t_end = pos_rows != nullptr ? min(t_end_all, pos + S) : t_end_all;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool scaled = k_scale != nullptr;
  const int n_chunks = (t_end + TC - 1) / TC;
  const int my_n = rank < n_chunks ? (n_chunks - rank + CL - 1) / CL : 0;  // chunks rank + i CL

  // Thread 0 starts the TMA loads of local chunk i into its stage; rows
  // past T arrive as zeros.
  const CUtensorMap *map_k = &tm_k, *map_v = &tm_v, *map_ks = &tm_ks, *map_vs = &tm_vs;
  auto issue = [&](int i) {
    const uint32_t buf = smem_addr(smem + (i % STAGES) * L::BYTES);
    const uint32_t bar = smem_addr(bars + i % STAGES);
    const int t0 = (rank + i * CL) * TC;
    mbar_expect_tx(bar, 2 * L::KV + (scaled ? 4 * TC : 0));
    tma_load(buf, map_k, bar, t0, 0, bhk);
    tma_load(buf + L::KV, map_v, bar, t0, 0, bhk);
    if (scaled) {
      tma_load(buf + L::SCALES, map_ks, bar, t0, bhk);
      tma_load(buf + L::SCALES + 2 * TC, map_vs, bar, t0, bhk);
    }
  };
  // Rows of a multiple of 4 bytes that TMA does not take (mode 1, or 3
  // where rows are a multiple of 8): every thread starts 4- or 8-byte
  // asynchronous copies of local chunk i into the same layout (cp.async,
  // one commit group per chunk); words at or past t_end are zero-filled.
  auto issue_words_of = [&](int i, auto word_bytes) {
    constexpr int WB = decltype(word_bytes)::value;
    constexpr int WPR = TC * (int)sizeof(E) / WB;  // words per chunk row
    unsigned char* buf = smem + (i % STAGES) * L::BYTES;
    const int t0 = (rank + i * CL) * TC;
    for (int e = tid; e < 2 * DK * WPR; e += THREADS) {
      const int r = e / WPR, w = e - r * WPR;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          static_cast<const E*>(r < DK ? k : v) + ((size_t)bhk * DK + r % DK) * T + t0);
      const bool in = t0 + WB * w / (int)sizeof(E) < t_end;
      cp_async<WB>(smem_addr(buf + (r < DK ? 0 : L::KV) + swz<L::ROWB>(r % DK, WB * w)),
                   in ? src + WB * w : src, in ? WB : 0);
    }
    for (int e = tid; scaled && e < TC; e += THREADS) {  // two bf16 scales a word
      const int r = e / (TC / 2), w = e - r * (TC / 2);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          (r == 0 ? k_scale : v_scale) + (size_t)bhk * T + t0);
      const bool in = t0 + 2 * w < t_end;
      cp_async<4>(smem_addr(buf + L::SCALES + r * TC * 2 + 4 * w), in ? src + w : src,
                  in ? 4 : 0);
    }
    cp_async_commit();
  };
  auto issue_words = [&](int i) {
    if (mode == 3) issue_words_of(i, std::integral_constant<int, 8>{});
    else issue_words_of(i, std::integral_constant<int, 4>{});
  };
  // Any other T (mode 0): all threads copy local chunk i element by element
  // through registers, BATCH loads in flight before the first store;
  // positions at or past t_end read as zero.
  auto load_plain = [&](int i) {
    unsigned char* buf = smem + (i % STAGES) * L::BYTES;
    const int t0 = (rank + i * CL) * TC;
    constexpr int BATCH = 8;
    static_assert(2 * DK * TC % (BATCH * THREADS) == 0, "elements split evenly");
    for (int e0 = 0; e0 < 2 * DK * TC; e0 += BATCH * THREADS) {
      E x[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS + tid, r = e / TC, t = t0 + e - r * TC;
        const E* src = static_cast<const E*>(r < DK ? k : v) + ((size_t)bhk * DK + r % DK) * T;
        x[u] = t < t_end ? src[t] : E{};
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS + tid, r = e / TC, p = e - r * TC;
        *reinterpret_cast<E*>(buf + (r < DK ? 0 : L::KV) +
                              swz<L::ROWB>(r % DK, p * (int)sizeof(E))) = x[u];
      }
    }
    if (scaled) {
      __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(buf + L::SCALES);
      for (int e = tid; e < 2 * TC; e += THREADS) {
        const int r = e / TC, t = t0 + e - r * TC;
        sc[e] = t < t_end ? (r == 0 ? k_scale : v_scale)[(size_t)bhk * T + t]
                          : __float2bfloat16(0.f);
      }
    }
  };

  // The first loads go out before q is read, so the two latencies overlap.
  const bool tma = mode == 2;
  if (tma && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(bars + s), 1);
    mbar_fence_init();
    for (int i = 0; i < min(STAGES, my_n); ++i) issue(i);
  }
  const bool words = mode == 1 || mode == 3;
  if (words)  // STAGES - 1 commit groups, empty where there is no chunk
    for (int i = 0; i < STAGES - 1; ++i) i < my_n ? issue_words(i) : cp_async_commit();
  for (int i = tid; i < S * D; i += THREADS) q_s[i] = to_f32<QT>(q[(size_t)bh * S * D + i]);
  __syncthreads();

  float m_w[SMAX], l_w[SMAX], acc[SMAX][2];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) m_w[s] = YOHO_NEG_INF, l_w[s] = 0.f, acc[s][0] = acc[s][1] = 0.f;
  const int pl = lane >> 1;  // the position whose full score this lane holds

  for (int i = 0; i < my_n; ++i) {
    const unsigned char* buf = smem + (i % STAGES) * L::BYTES;
    if (tma) {
      mbar_wait(smem_addr(bars + i % STAGES), (i / STAGES) & 1);
    } else if (words) {
      // Chunk i + STAGES - 1 goes into the stage chunk i - 1 left (every
      // warp passed the barrier at the end of the last pass).
      if (i + STAGES - 1 < my_n) issue_words(i + STAGES - 1);
      else cp_async_commit();  // an empty group keeps the count
      cp_async_wait<STAGES - 1>();
      __syncthreads();
    } else {
      __syncthreads();  // every warp is done with the stage's previous chunk
      load_plain(i);
      __syncthreads();
    }
    const int tw = (rank + i * CL) * TC + warp * PW;  // this warp's first position
    if (tw < t_end) {
      float k0[16], k1[16], v0[16], v1[16];  // dims lane and lane + 32
      if constexpr (KIND == KV_INT4) {
        row16_int4(buf, lane, warp, k0, k1);
        row16_int4(buf + L::KV, lane, warp, v0, v1);
      } else {
        row16<E>(buf, lane, warp, k0);
        row16<E>(buf, lane + 32, warp, k1);
        row16<E>(buf + L::KV, lane, warp, v0);
        row16<E>(buf + L::KV, lane + 32, warp, v1);
      }
      const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(buf + L::SCALES) + warp * PW;
      const float k_sc = scaled ? __bfloat162float(ks[pl]) : 1.f;
      const float v_sc = scaled ? __bfloat162float(ks[TC + pl]) : 1.f;
      const int t = tw + pl;
#pragma unroll
      for (int s = 0; s < SMAX; ++s) {
        if (s >= S) break;
        const float qa = q_s[s * D + lane], qb = q_s[s * D + lane + 32];
        float part[16];
#pragma unroll
        for (int p = 0; p < 16; ++p) part[p] = fmaf(qb, k1[p], qa * k0[p]);
        const float x = butterfly16(part, lane) * k_sc;
        const bool valid = t < t_end && (!causal || t <= pos + s);
        const float m_new = fmaxf(m_w[s], pair_max(valid ? x : YOHO_NEG_INF));
        const float alpha = __expf(m_w[s] - m_new);
        const float p = valid ? __expf(x - m_new) : 0.f;
        l_w[s] = l_w[s] * alpha + pair_sum(p);
        m_w[s] = m_new;
        const float w = round_as<QT>(p * v_sc);
        float a0 = acc[s][0] * alpha, a1 = acc[s][1] * alpha;
#pragma unroll
        for (int pp = 0; pp < 16; ++pp) {
          const float wp = __shfl_sync(0xffffffffu, w, 2 * pp);
          if (tw + pp < t_end) {  // positions past t_end may hold stale bytes
            a0 = fmaf(wp, v0[pp], a0);
            a1 = fmaf(wp, v1[pp], a1);
          }
        }
        acc[s][0] = a0;
        acc[s][1] = a1;
      }
    }
    if (words) __syncthreads();  // every warp is done with this stage
    if (tma && i + STAGES < my_n) {
      __syncthreads();  // every warp is done with this stage
      if (tid == 0) {
        fence_proxy_async();
        issue(i + STAGES);
      }
    }
  }

  // The warps' states -> this block's state.
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    if (s >= S) break;
    float* wp = wpart + (warp * S + s) * PART;
    wp[lane] = acc[s][0];
    wp[lane + 32] = acc[s][1];
    if (lane == 0) wp[D] = m_w[s], wp[D + 1] = l_w[s];
  }
  __syncthreads();
  for (int e = tid; e < S * D; e += THREADS) {
    const int s = e / D, d = e - s * D;
    float mx = YOHO_NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wpart[(w * S + s) * PART + D]);
    float a = 0.f, l = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* wp = wpart + (w * S + s) * PART;
      const float c = expf(wp[D] - mx);
      a = fmaf(c, wp[d], a);
      l = fmaf(c, wp[D + 1], l);
    }
    bpart[s * PART + d] = a;
    if (d == 0) bpart[s * PART + D] = mx, bpart[s * PART + D + 1] = l;
  }
  cluster.sync();  // every block's state is written

  // The cluster's states -> the output; block `rank` writes its share.
  for (int e = rank * THREADS + tid; e < S * D; e += CL * THREADS) {
    const int s = e / D, d = e - s * D;
    float mx = YOHO_NEG_INF;
    for (int r = 0; r < CL; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(bpart, r)[s * PART + D]);
    float a = 0.f, l = 0.f;
    for (int r = 0; r < CL; ++r) {
      const float* rp = cluster.map_shared_rank(bpart, r) + s * PART;
      const float c = expf(rp[D] - mx);
      a = fmaf(c, rp[d], a);
      l = fmaf(c, rp[D + 1], l);
    }
    out[(((size_t)b * S + s) * Hq + h) * D + d] = from_f32<QT>(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no block leaves while a peer still reads its state
}

template <typename QT, int KIND, int SMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   void* out, int B, int Hq, int Hkv, int S, int T, int t_end, int causal,
                   int pos, const int* pos_rows, cudaStream_t stream) {
  using E = typename KvType<QT, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? D / 2 : D;
  using L = Stage<E, DK>;
  const int n_chunks = (t_end + TC - 1) / TC;
  int cl = 1;
  const int target = BLOCKS_PER_SM * sm_count();
  while (cl < MAX_CLUSTER && 2 * cl <= n_chunks && B * Hq * cl < target) cl *= 2;

  // TMA maps: K and V as (T, DK, B * Hkv) tiles of (TC, DK, 1) in the
  // row width's swizzle, the scales as (T, B * Hkv) rows of TC.
  CUtensorMap mk, mv, mks, mvs;
  memset(&mks, 0, sizeof(mks));
  memset(&mvs, 0, sizeof(mvs));
  int tma = L::ROWB <= 128;  // the widest row a TMA swizzle covers
  if (tma) {
    const CUtensorMapDataType type =
        sizeof(E) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle swizzle =
        L::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    const uint64_t dims[3] = {(uint64_t)T, (uint64_t)DK, (uint64_t)B * Hkv};
    const uint64_t strides[2] = {(uint64_t)T * sizeof(E), (uint64_t)DK * T * sizeof(E)};
    const uint32_t box[3] = {TC, DK, 1};
    tma = tensor_map(&mk, type, 3, k, dims, strides, box, swizzle) &&
          tensor_map(&mv, type, 3, v, dims, strides, box, swizzle);
    if (tma && ks != nullptr) {
      const uint64_t sdims[2] = {(uint64_t)T, (uint64_t)B * Hkv};
      const uint64_t sstrides[1] = {(uint64_t)T * 2};
      const uint32_t sbox[2] = {TC, 1};
      tma = tensor_map(&mks, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ks, sdims, sstrides, sbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE) &&
            tensor_map(&mvs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vs, sdims, sstrides, sbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
    }
  }
  if (!tma) memset(&mk, 0, sizeof(mk)), memset(&mv, 0, sizeof(mv));
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  auto rows_of = [&](int n) {  // rows (and scale rows) of a multiple of n bytes
    return (T * sizeof(E)) % n == 0 && aligned(k, n) && aligned(v, n) &&
           (ks == nullptr || (aligned(ks, 4) && aligned(vs, 4)));
  };
  // 2: TMA; 3, 1: 8- or 4-byte cp.async words; 0: element copies.
  const int mode = tma ? 2 : rows_of(8) ? 3 : rows_of(4) ? 1 : 0;

  const size_t smem = 1024 + (size_t)STAGES * L::BYTES + 8 * STAGES +
                      sizeof(float) * ((size_t)S * D + (size_t)(WARPS + 1) * S * PART);
  auto kern = decode_attn<QT, KIND, SMAX>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, B * Hq);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // A block on its own is a cluster of one without the attribute, which
  // launches faster.
  cfg.numAttrs = cl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, mk, mv, mks, mvs, static_cast<const QT*>(q), k, v,
                           static_cast<const __nv_bfloat16*>(ks),
                           static_cast<const __nv_bfloat16*>(vs), static_cast<QT*>(out), Hq, Hkv,
                           S, T, t_end, causal, pos, pos_rows, mode);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename QT, int KIND>
cudaError_t dispatch_s(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, void* out, int B, int Hq, int Hkv, int S, int T,
                       int t_end, int causal, int pos, const int* pr, cudaStream_t st) {
  if (S <= 1) return launch<QT, KIND, 1>(q, k, v, ks, vs, out, B, Hq, Hkv, S, T, t_end, causal, pos, pr, st);
  if (S <= 4) return launch<QT, KIND, 4>(q, k, v, ks, vs, out, B, Hq, Hkv, S, T, t_end, causal, pos, pr, st);
  if (S <= 32) return launch<QT, KIND, 32>(q, k, v, ks, vs, out, B, Hq, Hkv, S, T, t_end, causal, pos, pr, st);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t dispatch_kind(int kind, const void* q, const void* k, const void* v, const void* ks,
                          const void* vs, void* out, int B, int Hq, int Hkv, int S, int T,
                          int t_end, int causal, int pos, const int* pr, cudaStream_t st) {
  switch (kind) {
    case KV_INT8: return dispatch_s<QT, KV_INT8>(q, k, v, ks, vs, out, B, Hq, Hkv, S, T, t_end, causal, pos, pr, st);
    case KV_INT4: return dispatch_s<QT, KV_INT4>(q, k, v, ks, vs, out, B, Hq, Hkv, S, T, t_end, causal, pos, pr, st);
    case KV_FLOAT: return dispatch_s<QT, KV_FLOAT>(q, k, v, ks, vs, out, B, Hq, Hkv, S, T, t_end, causal, pos, pr, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

YOHO_ERROR_STRING_FN

// q_dtype: 0 = float32, 1 = bfloat16. kind: 0 = int8, 1 = int4 (packed),
// 2 = K/V in the type of q (k_scale and v_scale null). causal: query row s
// of batch row b sees keys <= pos + s, or <= pos_rows[b] + s when pos_rows
// (B ints on the device, each >= 0) is not null. D is 64. One launch; no
// workspace.
extern "C" int decode_attention(int q_dtype, int kind, const void* q, const void* k,
                                const void* v, const void* k_scale, const void* v_scale,
                                void* out, int B, int Hq, int Hkv, int S, int Dh, int T,
                                int kv_len, int causal, int pos, const int* pos_rows,
                                cudaStream_t stream) {
  int t_end = min(T, kv_len);
  if (causal && pos_rows == nullptr) t_end = min(t_end, pos + S);
  if (t_end <= 0 || Dh != D || Hkv <= 0 || Hq % Hkv != 0 || (pos_rows != nullptr && !causal))
    return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return dispatch_kind<float>(kind, q, k, v, k_scale, v_scale, out, B, Hq, Hkv, S, T, t_end,
                                causal, pos, pos_rows, stream);
  if (q_dtype == 1)
    return dispatch_kind<__nv_bfloat16>(kind, q, k, v, k_scale, v_scale, out, B, Hq, Hkv, S,
                                        T, t_end, causal, pos, pos_rows, stream);
  return cudaErrorInvalidValue;
}
