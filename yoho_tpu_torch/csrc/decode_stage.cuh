// The K/V stage ring shared by the two routes of decode attention:
// decode_attention.cu (one query a lane pair on FMAs: S = 1, and f32 q)
// and decode_attention_mq.cu (several bf16 queries on tensor cores).
//
// Both stream the positions [0, t_end) of one (b, KV head) in chunks of TC
// positions; the CL blocks of a thread-block cluster take the chunks in
// turn (block `rank` takes chunks rank, rank + CL, ...), each through a ring
// of NST shared-memory stages. A stage holds the chunk's K tile and V tile,
// DK rows of TC positions each, then TC bf16 k scales and TC v scales. Four
// ways in, by what the rows allow (the launch's `mode`):
//
//   2  rows a multiple of 16 bytes (the padded cross K/V, the caches): one
//      thread fills a stage with four TMA tile loads (K, V, the two scale
//      rows) that report to the stage's mbarrier; rows past DKh and
//      positions past T arrive as zeros;
//   3, 1  rows a multiple of 8 or 4 bytes (the unpadded bf16 cross K/V of
//      1500 positions, f32 K/V wider than a TMA swizzle): every thread
//      starts 8- or 4-byte cp.async words into the same layout, one commit
//      group a chunk; words at or past t_end are zero-filled;
//   0  any other T: all threads copy element by element through registers.
//
// The tiles use the 64- or 128-byte TMA swizzle of their row width (f32
// rows, 256 bytes, take the 128-byte pattern in software).
//
// Head dims past the widest width (the split route, SPLIT): a (b, KV head)
// has nk = ceil(DKh / DK) parts of DK K/V rows, and the block of slice sl
// computes the output dims of V's part sl. Each chunk then streams as nk
// units through the ring: parts 0 .. nk - 2 bring K's rows of that part
// alone (the block sums their partial scores), and the last brings K's last
// part with V's part sl and the scales, the unit a chunk is without the
// split. Rows past DKh arrive as zeros, as any padded row does.
#pragma once

#include <algorithm>
#include <type_traits>

#include "tma.cuh"

namespace decode {

enum { KV_INT8 = 0, KV_INT4 = 1, KV_FLOAT = 2 };

template <typename QT, int KIND> struct KvType { using T = QT; };
template <typename QT> struct KvType<QT, KV_INT8> { using T = int8_t; };
template <typename QT> struct KvType<QT, KV_INT4> { using T = uint8_t; };

// The shared memory the stages of a ring may take, with what else the
// kernel keeps there (f32 K/V at width 256, 129 KB a stage, run one
// stage; int8 at width 256 beside the tensor-core route's tiles, two).
constexpr int RING_BYTES = 200 * 1024;

// One shared-memory stage (1024-byte aligned): the K tile and the V tile,
// DK rows of TC positions (ROWB bytes) each, then TC bf16 k scales and TC
// v scales.
template <typename E, int DK, int TC> struct Stage {
  static constexpr int ROWB = TC * (int)sizeof(E);
  static constexpr int KV = DK * ROWB;
  static constexpr int SCALES = 2 * KV;
  static constexpr int BYTES = (2 * KV + 2 * TC * 2 + 1023) / 1024 * 1024;
};

// The stages of a ring: the most, up to `stages`, that fit in RING_BYTES
// beside `other_bytes` of the kernel's own, and at least one.
__host__ __device__ constexpr int ring_stages(int stage_bytes, int stages, int other_bytes = 0) {
  return stages <= 1 || stages * stage_bytes + other_bytes <= RING_BYTES
             ? stages
             : ring_stages(stage_bytes, stages - 1, other_bytes);
}

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

// The ring of one block: element type E, DK tile rows, TC positions a
// chunk, THREADS threads, NST stages at `smem`, their mbarriers at `bars`.
// t_end is the block's end: positions at or past it are never read. With
// SPLIT, local unit i is part i % nk of chunk i / nk (K's rows part x DK
// on, V's from v_row in the last part) and my_n counts units; without it
// a unit is a chunk and nk and v_row are not read.
template <typename E, int DK, int TC, int THREADS, int NST, bool SPLIT = false>
struct Ring {
  using L = Stage<E, DK, TC>;
  unsigned char* smem;
  uint64_t* bars;
  const CUtensorMap *map_k, *map_v, *map_ks, *map_vs;
  const void* k;
  const void* v;
  const __nv_bfloat16* k_scale;
  const __nv_bfloat16* v_scale;
  int bhk, DKh, T, t_end, rank, CL, mode, my_n, tid;
  int nk, v_row;

  __device__ bool scaled() const { return k_scale != nullptr; }
  __device__ bool tma() const { return mode == 2; }
  __device__ bool words() const { return mode == 1 || mode == 3; }
  __device__ unsigned char* stage(int i) const { return smem + (i % NST) * L::BYTES; }
  __device__ int first(int i) const {  // local unit i's first position
    if constexpr (SPLIT) return (rank + i / nk * CL) * TC;
    else return (rank + i * CL) * TC;
  }
  __device__ int part(int i) const { return i % nk; }  // SPLIT: unit i's K part
  // SPLIT: unit i brings V's rows and the scales (the chunk's last part).
  __device__ bool last(int i) const { return !SPLIT || i % nk == nk - 1; }

  // Thread 0 starts the TMA loads of local chunk i into its stage.
  __device__ void issue(int i) const {
    if constexpr (SPLIT) return issue_split(i);
    const uint32_t buf = smem_addr(stage(i));
    const uint32_t bar = smem_addr(bars + i % NST);
    const int t0 = first(i);
    mbar_expect_tx(bar, 2 * L::KV + (scaled() ? 4 * TC : 0));
    tma_load(buf, map_k, bar, t0, 0, bhk);
    tma_load(buf + L::KV, map_v, bar, t0, 0, bhk);
    if (scaled()) {
      tma_load(buf + L::SCALES, map_ks, bar, t0, bhk);
      tma_load(buf + L::SCALES + 2 * TC, map_vs, bar, t0, bhk);
    }
  }
  // Every thread starts WB-byte asynchronous copies of local chunk i.
  template <int WB>
  __device__ void issue_words_of(int i) const {
    if constexpr (SPLIT) return issue_words_split<WB>(i);
    constexpr int WPR = TC * (int)sizeof(E) / WB;  // words per chunk row
    unsigned char* buf = stage(i);
    const int t0 = first(i);
    for (int e = tid; e < 2 * DK * WPR; e += THREADS) {
      const int r = e / WPR, w = e - r * WPR, rr = r % DK;
      const bool row_in = rr < DKh;  // rows past DKh are padding: zeros
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          static_cast<const E*>(r < DK ? k : v) + ((size_t)bhk * DKh + (row_in ? rr : 0)) * T +
          t0);
      const bool in = row_in && t0 + WB * w / (int)sizeof(E) < t_end;
      cp_async<WB>(smem_addr(buf + (r < DK ? 0 : L::KV) + swz<L::ROWB>(r % DK, WB * w)),
                   in ? src + WB * w : src, in ? WB : 0);
    }
    for (int e = tid; scaled() && e < TC; e += THREADS) {  // two bf16 scales a word
      const int r = e / (TC / 2), w = e - r * (TC / 2);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          (r == 0 ? k_scale : v_scale) + (size_t)bhk * T + t0);
      const bool in = t0 + 2 * w < t_end;
      cp_async<4>(smem_addr(buf + L::SCALES + r * TC * 2 + 4 * w), in ? src + w : src,
                  in ? 4 : 0);
    }
    cp_async_commit();
  }
  __device__ void issue_words(int i) const {
    if (mode == 3) issue_words_of<8>(i);
    else issue_words_of<4>(i);
  }
  // All threads copy local chunk i element by element, BATCH loads in
  // flight before the first store; positions at or past t_end read as 0.
  __device__ void load_plain(int i) const {
    if constexpr (SPLIT) return load_plain_split(i);
    unsigned char* buf = stage(i);
    const int t0 = first(i);
    constexpr int BATCH = 8;
    static_assert(2 * DK * TC % (BATCH * THREADS) == 0, "elements split evenly");
    for (int e0 = 0; e0 < 2 * DK * TC; e0 += BATCH * THREADS) {
      E x[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS + tid, r = e / TC, t = t0 + e - r * TC, rr = r % DK;
        const E* src = static_cast<const E*>(r < DK ? k : v) +
                       ((size_t)bhk * DKh + (rr < DKh ? rr : 0)) * T;
        x[u] = t < t_end && rr < DKh ? src[t] : E{};
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS + tid, r = e / TC, p = e - r * TC;
        *reinterpret_cast<E*>(buf + (r < DK ? 0 : L::KV) +
                              swz<L::ROWB>(r % DK, p * (int)sizeof(E))) = x[u];
      }
    }
    if (scaled()) {
      __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(buf + L::SCALES);
      for (int e = tid; e < 2 * TC; e += THREADS) {
        const int r = e / TC, t = t0 + e - r * TC;
        sc[e] = t < t_end ? (r == 0 ? k_scale : v_scale)[(size_t)bhk * T + t]
                          : __float2bfloat16(0.f);
      }
    }
  }

  // The split route's loads of unit i: K's rows of its part, and in the
  // chunk's last part also V's rows from v_row and the scales; rows past
  // DKh arrive as zeros.
  __device__ void issue_split(int i) const {
    const uint32_t buf = smem_addr(stage(i));
    const uint32_t bar = smem_addr(bars + i % NST);
    const int t0 = first(i);
    const bool with_v = last(i);
    mbar_expect_tx(bar, (with_v ? 2 : 1) * L::KV + (with_v && scaled() ? 4 * TC : 0));
    tma_load(buf, map_k, bar, t0, part(i) * DK, bhk);
    if (!with_v) return;
    tma_load(buf + L::KV, map_v, bar, t0, v_row, bhk);
    if (scaled()) {
      tma_load(buf + L::SCALES, map_ks, bar, t0, bhk);
      tma_load(buf + L::SCALES + 2 * TC, map_vs, bar, t0, bhk);
    }
  }
  template <int WB>
  __device__ void issue_words_split(int i) const {
    constexpr int WPR = TC * (int)sizeof(E) / WB;
    unsigned char* buf = stage(i);
    const int t0 = first(i);
    const bool with_v = last(i);
    for (int e = tid; e < (with_v ? 2 : 1) * DK * WPR; e += THREADS) {
      const int r = e / WPR, w = e - r * WPR, rr = r % DK;
      const int gr = (r < DK ? part(i) * DK : v_row) + rr;  // the row in global memory
      const bool row_in = gr < DKh;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          static_cast<const E*>(r < DK ? k : v) + ((size_t)bhk * DKh + (row_in ? gr : 0)) * T +
          t0);
      const bool in = row_in && t0 + WB * w / (int)sizeof(E) < t_end;
      cp_async<WB>(smem_addr(buf + (r < DK ? 0 : L::KV) + swz<L::ROWB>(rr, WB * w)),
                   in ? src + WB * w : src, in ? WB : 0);
    }
    for (int e = tid; with_v && scaled() && e < TC; e += THREADS) {
      const int r = e / (TC / 2), w = e - r * (TC / 2);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          (r == 0 ? k_scale : v_scale) + (size_t)bhk * T + t0);
      const bool in = t0 + 2 * w < t_end;
      cp_async<4>(smem_addr(buf + L::SCALES + r * TC * 2 + 4 * w), in ? src + w : src,
                  in ? 4 : 0);
    }
    cp_async_commit();
  }
  __device__ void load_plain_split(int i) const {
    unsigned char* buf = stage(i);
    const int t0 = first(i);
    const bool with_v = last(i);
    constexpr int BATCH = 8;
    static_assert(DK * TC % (BATCH * THREADS) == 0, "elements split evenly");
    for (int e0 = 0; e0 < (with_v ? 2 : 1) * DK * TC; e0 += BATCH * THREADS) {
      E x[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS + tid, r = e / TC, t = t0 + e - r * TC;
        const int gr = (r < DK ? part(i) * DK : v_row) + r % DK;
        const E* src = static_cast<const E*>(r < DK ? k : v) +
                       ((size_t)bhk * DKh + (gr < DKh ? gr : 0)) * T;
        x[u] = t < t_end && gr < DKh ? src[t] : E{};
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS + tid, r = e / TC, p = e - r * TC;
        *reinterpret_cast<E*>(buf + (r < DK ? 0 : L::KV) +
                              swz<L::ROWB>(r % DK, p * (int)sizeof(E))) = x[u];
      }
    }
    if (with_v && scaled()) {
      __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(buf + L::SCALES);
      for (int e = tid; e < 2 * TC; e += THREADS) {
        const int r = e / TC, t = t0 + e - r * TC;
        sc[e] = t < t_end ? (r == 0 ? k_scale : v_scale)[(size_t)bhk * T + t]
                          : __float2bfloat16(0.f);
      }
    }
  }

  // The first loads: TMA's barriers and its first NST chunks (thread 0),
  // or NST - 1 word groups (empty where there is no chunk). A block
  // barrier must follow before the first acquire.
  __device__ void start() const {
    if (tma() && tid == 0) {
      for (int s = 0; s < NST; ++s) mbar_init(smem_addr(bars + s), 1);
      mbar_fence_init();
      for (int i = 0; i < min(NST, my_n); ++i) issue(i);
    }
    if (words())
      for (int i = 0; i < NST - 1; ++i) i < my_n ? issue_words(i) : cp_async_commit();
  }
  // Local chunk i lies in its stage when this returns, for every thread.
  __device__ void acquire(int i) const {
    if (tma()) {
      mbar_wait(smem_addr(bars + i % NST), (i / NST) & 1);
    } else if (words()) {
      // Chunk i + NST - 1 goes into the stage chunk i - 1 left (every
      // thread passed release(i - 1)).
      if (i + NST - 1 < my_n) issue_words(i + NST - 1);
      else cp_async_commit();  // an empty group keeps the count
      cp_async_wait<NST - 1>();
      __syncthreads();
    } else {
      __syncthreads();  // every thread is done with the stage's previous chunk
      load_plain(i);
      __syncthreads();
    }
  }
  // Every thread is done with chunk i's stage once this returns; TMA
  // refills it with chunk i + NST. `synced`: the caller has just passed a
  // block barrier after its last read of the stage.
  __device__ void release(int i, bool synced = false) const {
    if (words() && !synced) __syncthreads();
    if (tma() && i + NST < my_n) {
      if (!synced) __syncthreads();
      if (tid == 0) {
        fence_proxy_async();
        issue(i + NST);
      }
    }
  }
};

// The arguments of one launch of either route (t_end: the keys every row
// ends by, min(T, kv_len) and, for a scalar causal pos, pos + S).
struct Args {
  const void *q, *k, *v, *ks, *vs;
  void* out;
  int B, Hq, Hkv, S, Dh, T, t_end, causal, pos;
  const int* pos_rows;
  cudaStream_t stream;
};

// The tensor maps and load mode of one launch: K and V as (T, DKh, B Hkv)
// tiles of (TC, DK, 1) in the row width's swizzle (rows past DKh
// zero-filled), the scales as (T, B Hkv) rows of TC. Mode 2 where TMA
// takes the rows, else 3 / 1 (8- / 4-byte words) or 0 (elements).
struct KvMaps {
  CUtensorMap k, v, ks, vs;
  int mode;
};

template <typename E, int DK, int TC>
KvMaps kv_maps(const void* k, const void* v, const void* ks, const void* vs, int B, int Hkv,
               int DKh, int T) {
  constexpr int ROWB = TC * (int)sizeof(E);
  KvMaps m;
  memset(&m, 0, sizeof(m));
  int tma = ROWB <= 128;  // the widest row a TMA swizzle covers
  if (tma) {
    const CUtensorMapDataType type =
        sizeof(E) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle swizzle =
        ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    const uint64_t dims[3] = {(uint64_t)T, (uint64_t)DKh, (uint64_t)B * Hkv};
    const uint64_t strides[2] = {(uint64_t)T * sizeof(E), (uint64_t)DKh * T * sizeof(E)};
    const uint32_t box[3] = {TC, DK, 1};
    tma = tensor_map(&m.k, type, 3, k, dims, strides, box, swizzle) &&
          tensor_map(&m.v, type, 3, v, dims, strides, box, swizzle);
    if (tma && ks != nullptr) {
      const uint64_t sdims[2] = {(uint64_t)T, (uint64_t)B * Hkv};
      const uint64_t sstrides[1] = {(uint64_t)T * 2};
      const uint32_t sbox[2] = {TC, 1};
      tma = tensor_map(&m.ks, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ks, sdims, sstrides, sbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE) &&
            tensor_map(&m.vs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vs, sdims, sstrides, sbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
    }
  }
  if (!tma) memset(&m, 0, sizeof(m));
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  auto rows_of = [&](int n) {  // rows (and scale rows) of a multiple of n bytes
    return (T * sizeof(E)) % n == 0 && aligned(k, n) && aligned(v, n) &&
           (ks == nullptr || (aligned(ks, 4) && aligned(vs, 4)));
  };
  m.mode = tma ? 2 : rows_of(8) ? 3 : rows_of(4) ? 1 : 0;
  return m;
}

// The cluster size: a power of two up to `max_cl`, grown while each block
// keeps two chunks and the grid of `blocks` clusters stays below `target`
// blocks.
inline int cluster_size(int n_chunks, int blocks, int target, int max_cl) {
  int cl = 1;
  while (cl < max_cl && 2 * cl <= n_chunks && blocks * cl < target) cl *= 2;
  return cl;
}

// Launches `kern` on `grid` blocks of `threads` in clusters of `cl` along
// x; a block on its own is a cluster of one without the attribute, which
// launches faster.
template <typename K, typename... Args>
cudaError_t launch_clusters(K kern, dim3 grid, int threads, size_t smem, int cl,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace decode
