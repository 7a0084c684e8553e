// Decode attention of several bf16 queries against a time-minor KV cache,
// on tensor cores: a prompt's prefill (S up to the 448-token context), beams
// folded into the query axis (5 beams; the beam prefill of 5 x 224), a
// speculative verify step (gamma + 1 queries). Single-query reads and f32 q
// run the FMA route of decode_attention.cu, whose arguments, stage ring
// (decode_stage.cuh) and cluster split this route shares.
//
// Replaces the TPU kernel yoho_tpu/ops/decode_attention.py::
// _decode_attention_call (body _decode_attn_kernel), which computes all S
// queries of a head as one MXU product for the scores and one for the
// values, at any S in one call. So does this kernel: one launch at any S,
// every query row of a KV head on mma.sync.m16n8k16 (bf16 operands, f32
// accumulators), the K/V of each (b, KV head) read once for all its query
// heads.
//
//   q        (B, Hq, S, D)        bf16, already scaled
//   k, v     (B, Hkv, D/pack, T)  int8 (pack 1), nibble-packed int4 (pack
//                                 2), with bf16 scales (B, Hkv, 1, T), or
//                                 bf16 without scales
//   out      (B, S, Hq, D)        bf16
//
// Bound on the H100: the cache bytes at a few queries (the folded 5-beam
// cross read of whisper-small at B = 16 moves the 36.9 MB of int8 codes the
// one-query read moves, ~11 us at 3.35 TB/s); the operations at a prompt's
// length (4 S T D per query head: 16.5 GFLOP for S = 224 over 1500
// positions at B = 16, ~17 us at the bf16 tensor-core rate), with the
// softmax's S T exponentials beside them. The FMA route spent 16 FMAs, a
// 16-shuffle butterfly and a 16-shuffle broadcast per query per 16
// positions, and ran 32 queries a launch, each launch reading the K/V
// again; here 16 query rows by 16 positions are 2 W / 16 score and W / 8
// value products on the tensor cores.
//
// - The rows of a KV head are its S x G queries (G = Hq / Hkv query heads):
//   row r is query r / G of head kvh G + r % G. A block takes 16 WM rows
//   (WM = 1, 2 or 4 tiles of 16, from S G) of one (b, KV head); its 4 warps
//   each take one 16-row tile and 64 / (4 / WM) positions of every chunk,
//   so at a few rows (5 beams: one tile) the 4 warps split each chunk. A
//   warp takes its positions of a chunk in one step (16 at W = 256; an
//   instantiation of one 16-position group, fewer registers, for one tile
//   a block), so at many rows the score products of 4 groups of 16
//   positions run side by side and one online-softmax update covers 64
//   positions. The CL blocks of
//   a cluster split the chunks of T as the FMA route does, and each block
//   ends its chunks at the last position its rows read (a causal prefill's
//   first rows read few).
// - The chunks stream through the FMA route's ring of stages (TMA tile
//   loads where rows are a multiple of 16 bytes, cp.async words or element
//   copies otherwise). bf16 K/V are read by ldmatrix from the stage itself
//   (rows of 64 positions, 128-byte swizzle). int8 and int4 codes are first
//   converted into bf16 tiles of that layout (exact: |code| <= 128; int4's
//   high nibbles become rows W/2 onward), each warp a quarter of the
//   positions, with the chunk's scales (the k scales times log2(e)), into
//   one of two buffers: after one block barrier a chunk the stage goes back
//   to TMA and the warps read the tiles while the next chunk converts into
//   the other buffer (at one row tile a block each warp reads only the
//   positions it converted, so one buffer does, and four blocks fit an SM).
// - q is loaded once into A fragments (zeros in padded dims and rows).
//   Scores: ldmatrix.trans gives K's B fragments (dims pairs at a position)
//   from the position-minor tile; each score is multiplied by its
//   position's k scale (in log2 units, for the exponential unit's 2^x); a
//   masked key (t >= the row's end: t_end, and when causal t > pos + s, or
//   pos[b] + s) gets weight 0, as finfo(float32).min gets from the
//   reference's softmax; steps whose keys every row reads skip the masks.
//   The online softmax runs per row (a quad of lanes holds a row), and the
//   accumulators are rescaled only when some row's maximum moved. The
//   weights p * v_scale are rounded to bf16, the reference's rounding
//   point, and become the value product's A fragment straight from the
//   score registers; ldmatrix gives V's B fragments (position pairs at a
//   dim) without a transpose. bf16 V past the row's end is zeroed in
//   registers: a cache past its write position may hold anything.
// - After the chunks the warps' states (acc, m, l per row) take the ring's
//   memory over and merge into the block's state of each row (the warps
//   that split a tile's positions); after a cluster barrier each block
//   combines, for its share of the rows' outputs, the CL blocks' states
//   (read from its peers' shared memory, all CL maxima first) and writes
//   them.
//
// Head dims: any Dh from 1 to 256 (int4: even) at the smallest width W =
// 16, 32, 64, 128 or 256 that holds it, padded as the FMA route pads (q's
// padded dims zero, padded output dims not stored; int4's split at Dh/2 sits
// at W/2). At W = 256 a warp holds 64 q and 128 accumulator registers.
//
// Head dims above 256 (int4: even ones) run the split route (SPLIT) at W =
// 256, as the FMA route does: nk = ceil(DKh / DK) parts of K/V rows, one
// cluster per (row tiles, slice) on the grid's y axis, every chunk nk ring
// units (decode_stage.cuh). For K's first nk - 1 parts a warp loads q's
// fragments of that part (from global memory, L1) and adds the part's
// score products into the chunk's partial scores (kept per 16-position
// step, in local memory); the last part brings V's rows of the block's
// slice and the scales, and the chunk's softmax and value products run as
// without the split. int8 and int4 parts convert their K codes alone.
#include <cooperative_groups.h>

#include "decode_stage.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TC = 64;               // positions per chunk
constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int BLOCKS_PER_SM = 2;     // the grid the cluster size aims at
constexpr float LOG2E = 1.4426950408889634f;
static_assert(WARPS * 16 == TC, "each warp converts 16 positions of a chunk");

// d += a b: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory: lane j gives
// the address of row j % 8 of matrix j / 8. Lane i receives, of each
// matrix, row i / 4, columns 2 (i % 4) and 2 (i % 4) + 1; transposed
// (.trans), rows 2 (i % 4) and 2 (i % 4) + 1 of column i / 4.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two floats as a bf16 pair (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x (the exponential unit; 2^-inf and 2^-FLT_MAX are 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Positions [16 c, 16 c + 16) of row r of a bf16 tile (rows of TC
// positions, 128-byte swizzle).
__device__ __forceinline__ void store16(unsigned char* tile, int r, int c, const float (&x)[16]) {
  *reinterpret_cast<uint4*>(tile + swz<2 * TC>(r, 32 * c)) =
      make_uint4(bf16x2(x[0], x[1]), bf16x2(x[2], x[3]), bf16x2(x[4], x[5]), bf16x2(x[6], x[7]));
  *reinterpret_cast<uint4*>(tile + swz<2 * TC>(r, 32 * c + 16)) =
      make_uint4(bf16x2(x[8], x[9]), bf16x2(x[10], x[11]), bf16x2(x[12], x[13]),
                 bf16x2(x[14], x[15]));
}

// Shared memory past the ring of a chunk's converted codes: the K and V
// tiles in bf16 (W rows of TC positions, the layout of bf16 K/V in a
// stage), then TC k scales times log2(e) and TC v scales, in f32.
template <int W> struct Tiles {
  static constexpr int TILE = W * 2 * TC;
  static constexpr int SCALES = 2 * TILE;
  static constexpr int BYTES = SCALES + 2 * TC * 4;
};

// Warp `c` converts positions [16 c, 16 c + 16) of a chunk: its K and V
// codes (DK rows of TC bytes, 64-byte swizzle; int4: byte row r's low
// nibbles become row r, its high nibbles row r + W/2) and its scales.
// K_ONLY (a split route's K part): K's codes alone.
template <int KIND, int W, bool K_ONLY = false>
__device__ __forceinline__ void convert16(const unsigned char* stage, unsigned char* tiles, int c,
                                          int lane) {
  constexpr int DK = KIND == KV_INT4 ? W / 2 : W;
  using T = Tiles<W>;
  for (int e = lane; e < (K_ONLY ? 1 : 2) * DK; e += 32) {
    const int m = e / DK, r = e - m * DK;  // K or V, code row
    const uint4 u = *reinterpret_cast<const uint4*>(stage + m * DK * TC + swz<TC>(r, 16 * c));
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
    unsigned char* dst = tiles + m * T::TILE;
    float lo[16];
    if constexpr (KIND == KV_INT8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) bytes4(word[i] ^ 0x80808080u, 8388736.f, &lo[4 * i]);
    } else {
      float hi[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bytes4(word[i] & 0x0F0F0F0Fu, 8388616.f, &lo[4 * i]);
        bytes4((word[i] >> 4) & 0x0F0F0F0Fu, 8388616.f, &hi[4 * i]);
      }
      store16(dst, r + W / 2, c, hi);
    }
    store16(dst, r, c, lo);
  }
  if constexpr (K_ONLY) return;
  const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(stage + 2 * DK * TC);
  float* dst = reinterpret_cast<float*>(tiles + T::SCALES);
  const int t = 16 * c + (lane & 15), v = lane >> 4;  // lanes 0-15: k scales, 16-31: v scales
  dst[v * TC + t] = __bfloat162float(sc[v * TC + t]) * (v ? 1.f : LOG2E);
}

// The shared memory of the stages and the converted tiles: two buffers of
// tiles where the warps of a block read every position of a chunk (the
// next chunk converts into the other while they read); one where each
// warp reads only the quarter it converted (one row tile a block).
template <int KIND, int W>
__host__ __device__ int ring_smem(int wm) {
  using E = typename KvType<__nv_bfloat16, KIND>::T;
  using L = Stage<E, KIND == KV_INT4 ? W / 2 : W, TC>;
  constexpr int TB = KIND != KV_FLOAT ? Tiles<W>::BYTES : 0;
  return ring_stages(L::BYTES, STAGES, 2 * TB) * L::BYTES + (wm > 1 ? 2 : 1) * TB;
}

template <int KIND, int W, int NG, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
decode_attn_mq(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_ks, const __grid_constant__ CUtensorMap tm_vs,
               const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
               const void* __restrict__ v, const __nv_bfloat16* __restrict__ k_scale,
               const __nv_bfloat16* __restrict__ v_scale, __nv_bfloat16* __restrict__ out, int Hq,
               int Hkv, int S, int Dh, int T, int t_end_all, int causal, int pos_all,
               const int* __restrict__ pos_rows, int mode, int WM) {
  using E = typename KvType<__nv_bfloat16, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? W / 2 : W;
  const int DKh = KIND == KV_INT4 ? Dh / 2 : Dh;  // K/V rows of a (b, h) in global memory
  using L = Stage<E, DK, TC>;
  constexpr bool CONVERT = KIND != KV_FLOAT;
  constexpr int NST = ring_stages(L::BYTES, STAGES, CONVERT ? 2 * Tiles<W>::BYTES : 0);
  constexpr int PART = W + 2;           // a row's softmax state: acc[W], m, l
  constexpr int STATES = (int)sizeof(float) * (WARPS + 2) * 16 * PART;
  const int ring_bytes = ring_smem<KIND, W>(WM);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  // After the last chunk the warps' and the block's states take the ring's
  // memory over; the barriers lie past both.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + max(ring_bytes, STATES));
  unsigned char* tiles = smem + NST * L::BYTES;
  float* wpart = reinterpret_cast<float*>(smem);  // WARPS x 16 rows x PART

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int bhk = blockIdx.z;
  const int b = bhk / Hkv;
  const int kvh = bhk - b * Hkv;
  const int G = Hq / Hkv;
  const int R = S * G;                  // query rows of this KV head
  const int WT = WARPS / WM;            // warps that share a row tile
  const int nk = SPLIT ? (DKh + DK - 1) / DK : 1;  // K parts (and slices)
  const int sl = SPLIT ? (int)blockIdx.y % nk : 0;  // this cluster's slice
  const int r_blk = (SPLIT ? (int)blockIdx.y / nk : (int)blockIdx.y) * 16 * WM;
  const int pos = pos_rows != nullptr ? pos_rows[b] : pos_all;
  const int t_end = pos_rows != nullptr ? min(t_end_all, pos + S) : t_end_all;
  // The end of row r's keys: t_end, and past pos + s (s = r / G) when causal.
  auto row_end = [&](int r) { return causal ? min(t_end, pos + r / G + 1) : t_end; };
  const int t_blk = row_end(min(r_blk + 16 * WM, R) - 1);  // this block's last row's end
  const int n_chunks = (t_blk + TC - 1) / TC;
  // Ring units: chunks rank + i CL, nk units each.
  const int my_n = (rank < n_chunks ? (n_chunks - rank + CL - 1) / CL : 0) * nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;  // a fragment's row (and row + 8) and column pair
  const int row0 = r_blk + (warp % WM) * 16;  // this warp's 16 rows
  const int ppw = TC / WT;              // positions of each chunk this warp takes
  const int p0 = (warp / WM) * ppw;
  const int step = min(ppw, 16 * NG);
  const bool has_rows = row0 < R;
  const int t_warp = has_rows ? row_end(min(row0 + 16, R) - 1) : 0;  // its rows' last end
  const int t_first = has_rows ? row_end(row0) : 0;                  // and first end
  const int t_row[2] = {row_end(min(row0 + g, R - 1)), row_end(min(row0 + g + 8, R - 1))};
  // Dim dw of W's layout -> the true dim it holds, or -1 for a padded one.
  auto true_dim = [&](int dw) {
    if constexpr (KIND == KV_INT4) {
      const int half = Dh / 2, l = dw < W / 2 ? dw : dw - W / 2;
      return l < half ? (dw < W / 2 ? l : l + half) : -1;
    } else {
      return dw < Dh ? dw : -1;
    }
  };
  // The same for dim dw of part p (the split route).
  auto part_dim = [&](int p, int dw) {
    if constexpr (KIND == KV_INT4) {
      const int half = Dh / 2, l = (dw < W / 2 ? dw : dw - W / 2) + p * (W / 2);
      return l < half ? (dw < W / 2 ? l : l + half) : -1;
    } else {
      return dw + p * W < Dh ? dw + p * W : -1;
    }
  };

  const Ring<E, DK, TC, THREADS, NST, SPLIT> ring{
      smem, bars, &tm_k, &tm_v, &tm_ks, &tm_vs, k, v, k_scale, v_scale,
      bhk, DKh, T, t_blk, rank, CL, mode, my_n, tid, nk, sl * DK};
  // The first loads go out before q is read, so the two latencies overlap.
  ring.start();
  // q of this warp's rows as A fragments: register i of k-step kk holds row
  // g + 8 (i & 1), dims 16 kk + 8 (i >> 1) + 2 c and the next (the split
  // route: of part p, loaded a unit at a time).
  uint32_t qa[W / 16][4];
  auto load_qa = [&](auto dim_of) {
    const unsigned short* qrow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i, s = row / G;
      qrow[i] = row < R ? reinterpret_cast<const unsigned short*>(q) +
                              (((size_t)b * Hq + kvh * G + row - s * G) * S + s) * Dh
                        : nullptr;
    }
    auto q_at = [&](int i, int dw) -> uint32_t {
      const int d = dim_of(dw);
      return qrow[i] != nullptr && d >= 0 ? qrow[i][d] : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dw = 16 * kk + 8 * (i >> 1) + 2 * c;
        qa[kk][i] = q_at(i & 1, dw) | (q_at(i & 1, dw + 1) << 16);
      }
  };
  if constexpr (!SPLIT) load_qa(true_dim);
  __syncthreads();  // the ring's barriers are initialized

  // Scores and running maxima are kept in log2 units (k scale x log2(e)).
  float o[W / 8][4], m_r[2] = {YOHO_NEG_INF, YOHO_NEG_INF}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < W / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // ldmatrix rows: K transposed (matrices 0-3: dims +0, +8, +0, +8 at
  // positions +0, +0, +8, +8), V as stored (dims +0, +0, +8, +8 at
  // positions +0, +8, +0, +8); rows 8 apart share the swizzle `sw`.
  const int lr = lane & 7, lm = lane >> 3, sw = lr << 4;
  const int k_row = ((lm & 1) << 3) + lr, k_pos = (lm >> 1) << 3;
  const int v_row = ((lm >> 1) << 3) + lr, v_pos = (lm & 1) << 3;
  const bool scaled = k_scale != nullptr;
  // The split route's partial scores of a chunk, per step of this warp (a
  // split instantiation takes one 16-position group a step, NG = 1).
  float sacc[SPLIT ? TC / 16 : 1][2][4];

  for (int i = 0; i < my_n; ++i) {
    ring.acquire(i);
    const unsigned char* st = ring.stage(i);
    unsigned char* tl = tiles + (WM > 1 ? i & 1 : 0) * Tiles<W>::BYTES;
    // The split route: the chunk's softmax and value products run in its
    // last part; every part first loads q's fragments of its dims.
    const bool last = ring.last(i);
    if constexpr (SPLIT) load_qa([&](int dw) { return part_dim(ring.part(i), dw); });
    if constexpr (CONVERT) {
      // Each warp converts a quarter of the chunk's positions (the scales
      // come along); after a block barrier the stage is free and TMA
      // refills it while the warps read the tiles.
      if constexpr (SPLIT) {
        if (!last) convert16<KIND, W, true>(st, tl, warp, lane);
        else convert16<KIND, W>(st, tl, warp, lane);
      } else {
        convert16<KIND, W>(st, tl, warp, lane);
      }
      __syncthreads();
      ring.release(i, true);
    }
    const uint32_t k_base = smem_addr(CONVERT ? tl : st), v_base = k_base + Tiles<W>::TILE;
    const float* ks = reinterpret_cast<const float*>(tl + Tiles<W>::SCALES);
    const int t_chunk = ring.first(i);
    for (int tp = p0; has_rows && tp < p0 + ppw; tp += step) {
      const int t0 = t_chunk + tp;
      if (t0 >= t_warp) break;  // every row of the warp ends before this step
      // The groups holding a key some row reads; whether a row ends inside.
      const int ng = (min(step, t_warp - t0) + 15) / 16;
      const bool masked = t0 + 16 * ng > t_first;
      float s[NG][2][4];
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if constexpr (SPLIT) {  // the chunk's earlier parts' sums, or 0
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[gi][j][e] = ring.part(i) > 0 ? sacc[(tp - p0) / step][j][e] : 0.f;
          } else {
            s[gi][j][0] = s[gi][j][1] = s[gi][j][2] = s[gi][j][3] = 0.f;
          }
        }
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          if (gi >= ng) break;
          uint32_t kb[4];
          ldsm4_t(kb, k_base + (16 * kk + k_row) * 2 * TC + ((2 * (tp + 16 * gi + k_pos)) ^ sw));
          mma_bf16(s[gi][0], qa[kk], kb[0], kb[1]);
          mma_bf16(s[gi][1], qa[kk], kb[2], kb[3]);
        }
      if constexpr (SPLIT) {
        if (!last) {  // a K part: the partial scores wait for the next part
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[(tp - p0) / step][j][e] = s[0][j][e];
          continue;
        }
      }
      // s[gi][j][e]: row g + 8 (e >> 1), position t0 + 16 gi + 8 j + 2 c +
      // (e & 1); in log2 units, masked keys at finfo.min.
      float mx[2] = {YOHO_NEG_INF, YOHO_NEG_INF};
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        if (gi >= ng) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pl = tp + 16 * gi + 8 * j + 2 * c;  // the pair's first position in the chunk
          const float2 kf = scaled ? *reinterpret_cast<const float2*>(ks + pl)
                                   : make_float2(LOG2E, LOG2E);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[gi][j][e] * ((e & 1) ? kf.y : kf.x);
            if (masked && t_chunk + pl + (e & 1) >= t_row[e >> 1]) x = YOHO_NEG_INF;
            s[gi][j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        alpha[h] = ex2(m_r[h] - m_new);
        m_r[h] = m_new;
        l_r[h] *= alpha[h];
      }
      // Once the maxima settle the accumulators keep their scale.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          o[n][0] *= alpha[0], o[n][1] *= alpha[0];
          o[n][2] *= alpha[1], o[n][3] *= alpha[1];
        }
      }
      // The weights p * v_scale, rounded to bf16: the value product's A
      // fragments (a step's 16 positions each).
      uint32_t pa[NG][4];
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        if (gi >= ng) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pl = tp + 16 * gi + 8 * j + 2 * c;
          const float2 vf = scaled ? *reinterpret_cast<const float2*>(ks + TC + pl)
                                   : make_float2(1.f, 1.f);
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool valid = !masked || t_chunk + pl + (e & 1) < t_row[e >> 1];
            const float p = valid ? ex2(s[gi][j][e] - m_r[e >> 1]) : 0.f;
            l_r[e >> 1] += p;
            w[e] = p * ((e & 1) ? vf.y : vf.x);
          }
          pa[gi][2 * j] = bf16x2(w[0], w[1]);
          pa[gi][2 * j + 1] = bf16x2(w[2], w[3]);
        }
      }
      // bf16 V at positions past t_end is zeroed: vb[0] and vb[2] hold
      // positions 2 c and the next of a group, vb[1] and vb[3] those + 8.
      const bool tail = KIND == KV_FLOAT && t0 + 16 * ng > t_end;
#pragma unroll
      for (int nn = 0; nn < W / 16; ++nn)
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          if (gi >= ng) break;
          uint32_t vb[4];
          ldsm4(vb, v_base + (16 * nn + v_row) * 2 * TC + ((2 * (tp + 16 * gi + v_pos)) ^ sw));
          if (tail) {
            const int ta = t0 + 16 * gi + 2 * c, tb = ta + 8;
            const uint32_t keep_a =
                (ta < t_end ? 0xFFFFu : 0u) | (ta + 1 < t_end ? 0xFFFF0000u : 0u);
            const uint32_t keep_b =
                (tb < t_end ? 0xFFFFu : 0u) | (tb + 1 < t_end ? 0xFFFF0000u : 0u);
            vb[0] &= keep_a, vb[2] &= keep_a, vb[1] &= keep_b, vb[3] &= keep_b;
          }
          mma_bf16(o[2 * nn], pa[gi], vb[0], vb[1]);
          mma_bf16(o[2 * nn + 1], pa[gi], vb[2], vb[3]);
        }
    }
    if constexpr (!CONVERT) ring.release(i);  // bf16 K/V: the warps read the stage itself
  }

  // This warp's states (rows g and g + 8 of its tile; a quad holds a row),
  // in the ring's memory once every warp is done with it.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  __syncthreads();
  float* wp = wpart + warp * 16 * PART;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    *reinterpret_cast<float2*>(wp + g * PART + 8 * n + 2 * c) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(wp + (g + 8) * PART + 8 * n + 2 * c) =
        make_float2(o[n][2], o[n][3]);
  }
  if (c == 0) {
    wp[g * PART + W] = m_r[0], wp[g * PART + W + 1] = l_r[0];
    wp[(g + 8) * PART + W] = m_r[1], wp[(g + 8) * PART + W + 1] = l_r[1];
  }
  // The block's state of each of its rows: the WT warps that share a tile
  // merged (when one warp holds a tile, its state is the block's: warp wm
  // holds rows 16 wm onward).
  const int rows = min(16 * WM, R - r_blk);
  float* bpart = wpart;
  if (WT > 1) {
    bpart = wpart + WARPS * 16 * PART;
    __syncthreads();
    for (int e = tid; e < rows * PART; e += THREADS) {
      const int rl = e / PART, col = e - rl * PART;
      float mw[WARPS], mx = YOHO_NEG_INF;
#pragma unroll
      for (int p = 0; p < WARPS; ++p)
        if (p < WT) mw[p] = wpart[(p * WM * 16 + rl) * PART + W], mx = fmaxf(mx, mw[p]);
      float a = 0.f;
#pragma unroll
      for (int p = 0; p < WARPS; ++p)
        if (p < WT && col != W)
          a = fmaf(ex2(mw[p] - mx), wpart[(p * WM * 16 + rl) * PART + col], a);
      bpart[rl * PART + col] = col == W ? mx : a;
    }
  }
  cluster.sync();  // every block's state is written

  // The cluster's states -> the output; block `rank` writes its share.
  for (int e = rank * THREADS + tid; e < rows * W; e += CL * THREADS) {
    const int rl = e / W, dw = e - rl * W, dt = SPLIT ? part_dim(sl, dw) : true_dim(dw);
    if (dt < 0) continue;  // a padded dim: not stored
    float mr[MAX_CLUSTER], mx = YOHO_NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < CL) mr[r] = cluster.map_shared_rank(bpart, r)[rl * PART + W], mx = fmaxf(mx, mr[r]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < CL) {
        const float* rp = cluster.map_shared_rank(bpart, r) + rl * PART;
        const float cf = ex2(mr[r] - mx);
        a = fmaf(cf, rp[dw], a);
        l = fmaf(cf, rp[W + 1], l);
      }
    const int row = r_blk + rl, s = row / G, h = kvh * G + row - s * G;
    out[(((size_t)b * S + s) * Hq + h) * Dh + dt] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no block leaves while a peer still reads its state
}

template <int KIND, int W, int NG, bool SPLIT>
cudaError_t launch(const Args& a, int wm, int n_rt) {
  using E = typename KvType<__nv_bfloat16, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? W / 2 : W;
  constexpr int STATES = (int)sizeof(float) * (WARPS + 2) * 16 * (W + 2);
  const int DKh = KIND == KV_INT4 ? a.Dh / 2 : a.Dh;
  const int nk = SPLIT ? (DKh + DK - 1) / DK : 1;  // slices: row tiles x nk on the grid's y
  if ((long)n_rt * nk > 65535) return cudaErrorInvalidValue;
  const int n_chunks = (a.t_end + TC - 1) / TC;
  const int cl = cluster_size(n_chunks, a.B * a.Hkv * n_rt * nk, BLOCKS_PER_SM * sm_count(),
                              MAX_CLUSTER);
  const KvMaps m = kv_maps<E, DK, TC>(a.k, a.v, a.ks, a.vs, a.B, a.Hkv, DKh, a.T);
  const size_t smem = 1024 + (size_t)std::max(ring_smem<KIND, W>(wm), STATES) + 8 * STAGES;
  return launch_clusters(decode_attn_mq<KIND, W, NG, SPLIT>, dim3(cl, n_rt * nk, a.B * a.Hkv),
                         THREADS, smem,
                         cl, a.stream, m.k, m.v, m.ks, m.vs,
                         static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
                         static_cast<const __nv_bfloat16*>(a.ks),
                         static_cast<const __nv_bfloat16*>(a.vs),
                         static_cast<__nv_bfloat16*>(a.out), a.Hq, a.Hkv, a.S, a.Dh, a.T,
                         a.t_end, a.causal, a.pos, a.pos_rows, m.mode, wm);
}

// Row tiles of 16: one, two, or four a block (the four warps split each
// chunk's positions among the warps of a tile). A warp's step takes its
// share of a chunk, 64 positions at four tiles a block; one 16-position
// group where the warps split the positions four ways (fewer registers,
// more blocks resident: the few-query reads) and at W = 256 (whose
// accumulators fill the registers), split or not.
template <int KIND, int W, bool SPLIT>
cudaError_t dispatch_rows(const Args& a) {
  const int tiles = (a.S * (a.Hq / a.Hkv) + 15) / 16;
  const int wm = tiles >= 3 ? WARPS : tiles;
  const int n_rt = (tiles + wm - 1) / wm;
  if (a.B * a.Hkv > 65535 || n_rt > 65535) return cudaErrorInvalidValue;
  if constexpr (W < 256)
    if (wm > 1) return launch<KIND, W, TC / 16, SPLIT>(a, wm, n_rt);
  return launch<KIND, W, 1, SPLIT>(a, wm, n_rt);
}

template <int W, bool SPLIT = false>
cudaError_t dispatch_kind(int kind, const Args& a) {
  switch (kind) {
    case KV_INT8: return dispatch_rows<KV_INT8, W, SPLIT>(a);
    case KV_INT4: return dispatch_rows<KV_INT4, W, SPLIT>(a);
    case KV_FLOAT: return dispatch_rows<KV_FLOAT, W, SPLIT>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

YOHO_ERROR_STRING_FN

// The arguments of decode_attention (decode_attention.cu), for bf16 q
// (q_dtype 1) at any S >= 1: kind 0 = int8, 1 = int4 (packed), 2 = bf16
// K/V (k_scale and v_scale null); causal: query row s of batch row b sees
// keys <= pos + s, or <= pos_rows[b] + s when pos_rows (B ints on the
// device, each >= 0) is not null. Dh is any head dim >= 1 (int4: even),
// run at the smallest of the widths 16, 32, 64, 128, 256 that holds it, or
// above 256 split into slices of 256. One launch; no workspace.
extern "C" int decode_attention_mq(int q_dtype, int kind, const void* q, const void* k,
                                   const void* v, const void* k_scale, const void* v_scale,
                                   void* out, int B, int Hq, int Hkv, int S, int Dh, int T,
                                   int kv_len, int causal, int pos, const int* pos_rows,
                                   cudaStream_t stream) {
  int t_end = min(T, kv_len);
  if (causal && pos_rows == nullptr) t_end = min(t_end, pos + S);
  if (q_dtype != 1 || S < 1 || t_end <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (pos_rows != nullptr && !causal) || Dh < 1 || (kind == KV_INT4 && Dh % 2))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, out, B, Hq, Hkv, S, Dh, T, t_end, causal, pos,
               pos_rows, stream};
  if (Dh <= 16) return dispatch_kind<16>(kind, a);
  if (Dh <= 32) return dispatch_kind<32>(kind, a);
  if (Dh <= 64) return dispatch_kind<64>(kind, a);
  if (Dh <= 128) return dispatch_kind<128>(kind, a);
  if (Dh <= 256) return dispatch_kind<256>(kind, a);
  return dispatch_kind<256, true>(kind, a);
}
