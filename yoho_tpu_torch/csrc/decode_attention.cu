// Flash-decode attention of a few queries against a time-minor KV cache:
// the FMA route, one query a lane pair. It runs every single-query read (a
// decode step) and f32 q at any S; several bf16 queries (a prompt's
// prefill, folded beams, a speculative verify) run the tensor-core route of
// decode_attention_mq.cu, which shares this file's stage ring
// (decode_stage.cuh) and arguments.
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
// Widths W = 16, 32, 64, 128 and 256 for every K/V kind: 64 is every
// whisper size and the full-width YOHO model. Lane l < STR holds the NPL
// key and value dims l + STR j: two dims (STR = W/2) up to W = 64, so at
// W = 16 and 32 only lanes 0-7 or 0-15 hold dims and the others add zeros
// to the score butterfly, and W/32 (STR = 32) above; an int4 byte row
// l + 32 j holds dims l + 32 j and l + 32 j + W/2, entries j and j + NPL/2
// of that map. These are simple instantiations, not fast ones (at W = 256
// a lane's 16 positions of K and V are 256 registers, which spill). The
// tiles stay DK rows of 64 positions, so the TMA boxes and swizzles are
// those of D = 64 with fewer or more rows (W = 256 bf16: a 64 x 256 box,
// 65 KB a stage). When the chunks are done the warps' and the block's
// softmax states take the stage memory over, which keeps f32 K/V at W = 128
// with 32 queries (three 66.5 KB stages, 83 KB of states) inside the 227 KB
// a block may have; f32 K/V at W = 256 (129 KB a stage) run one stage and
// at most 4 queries a launch.
//
// Any head dim Dh from 1 to 256 (int4: even; the JAX model attends at any
// dims // heads) runs on the smallest width W >= Dh, a runtime argument of
// the same instantiations. Nothing here needs Dh to be a multiple of 8:
// q and out move element by element, and K/V rows are T positions long
// whatever Dh is, so the TMA boxes, the word copies and their strides (T
// elements a row, DKh T a head) are those of any Dh. Global rows follow Dh (q and out rows of Dh,
// DKh = Dh / pack K/V rows a (b, h)); shared memory, the lane map and the
// softmax states keep W. The TMA maps describe DKh rows under a box of
// W / pack rows, so the rows past DKh arrive zero-filled; the word and
// element copies write zeros there. q is laid out in W's dims with zeros in
// the padded ones, so a padded dim adds nothing to a score, and padded
// output dims are never stored. int4 keeps its stored split at Dh / 2: byte
// row r holds dims r and r + Dh / 2, so q's dim r + Dh / 2 sits at W's
// r + W / 2 (a zero byte decodes to -8, which a zero q lane cancels). At
// Dh == W every map is the identity and the outputs are the width's own.
//
// Head dims above 256 (int4: even ones; the split route, SPLIT) run at
// width 256 in slices: nk = ceil(DKh / DK) parts of DK = 256 K/V rows (128
// int4 byte rows, each holding dims r and r + Dh / 2: a slice is cut in
// byte rows, so it never straddles the split at Dh / 2), one cluster per
// (b, h, slice) on the grid's z axis. Every chunk streams as nk ring units
// (decode_stage.cuh): K's first nk - 1 parts alone, whose partial scores a
// lane pair keeps per query (the butterfly is linear, so the parts' sums
// add), then K's last part with V's rows of the block's slice and the
// scales, where the chunk's softmax and value product run as without the
// split. q of each part is read from global memory (L1), so shared memory
// does not grow with Dh. Each slice's cluster reads all of K and its own
// part of V: K is read nk times (nk - 1 extra reads of K against the
// bound).
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
//   stages (decode_stage.cuh). Where rows are a multiple of 16 bytes (the cross K/V, padded to
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

#include "decode_stage.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PW = 16;               // positions per warp per chunk
constexpr int TC = WARPS * PW;       // positions per chunk
constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int BLOCKS_PER_SM = 2;     // the grid the cluster size aims at

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

// int4: the low nibbles of byte row r are dim r, the high nibbles dim
// r + D/2.
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

template <typename QT, int KIND, int SMAX, int D, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
decode_attn(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_ks, const __grid_constant__ CUtensorMap tm_vs,
            const QT* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
            const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
            QT* __restrict__ out, int Hq, int Hkv, int S, int Dh, int T, int t_end_all,
            int causal, int pos_all, const int* __restrict__ pos_rows, int mode) {
  using E = typename KvType<QT, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? D / 2 : D;
  const int DKh = KIND == KV_INT4 ? Dh / 2 : Dh;  // K/V rows of a (b, h) in global memory
  constexpr int NPL = D > 64 ? D / 32 : 2;  // dims per lane
  constexpr int STR = D / NPL;    // lane l < STR holds dims l + STR j, j < NPL
  constexpr int PART = D + 2;     // a softmax state: acc[D], m, l
  using L = Stage<E, DK, TC>;
  constexpr int NST = ring_stages(L::BYTES, STAGES);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  // After the last chunk the states take the stages' memory over; the
  // barriers and q (not with SPLIT: read a part at a time) lie past both.
  const int region = max(NST * L::BYTES, (int)sizeof(float) * (WARPS + 1) * S * PART);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (region + 7) / 8 * 8);
  float* q_s = reinterpret_cast<float*>(bars + NST);     // S x D
  float* wpart = reinterpret_cast<float*>(smem);         // WARPS x S x PART
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
  const bool holds = lane < STR;  // always at D >= 64
  const bool scaled = k_scale != nullptr;
  const int nk = SPLIT ? (DKh + DK - 1) / DK : 1;  // K parts (and slices)
  const int sl = SPLIT ? (int)blockIdx.z : 0;       // this cluster's slice
  const int n_chunks = (t_end + TC - 1) / TC;
  // Ring units: chunks rank + i CL, nk units each.
  const int my_n = (rank < n_chunks ? (n_chunks - rank + CL - 1) / CL : 0) * nk;
  // Dim dw of W's layout -> the true dim it holds, or -1 for a padded one.
  auto true_dim = [&](int dw) {
    if constexpr (KIND == KV_INT4) {
      const int half = Dh / 2, l = dw < D / 2 ? dw : dw - D / 2;
      return l < half ? (dw < D / 2 ? l : l + half) : -1;
    } else {
      return dw < Dh ? dw : -1;
    }
  };
  // The same for dim dw of part p (the split route).
  auto part_dim = [&](int p, int dw) {
    if constexpr (KIND == KV_INT4) {
      const int half = Dh / 2, l = (dw < D / 2 ? dw : dw - D / 2) + p * (D / 2);
      return l < half ? (dw < D / 2 ? l : l + half) : -1;
    } else {
      return dw + p * D < Dh ? dw + p * D : -1;
    }
  };
  // Query s's dim dw of part p, from global memory (the split route).
  auto q_at = [&](int s, int p, int dw) {
    const int d = part_dim(p, dw);
    return d >= 0 ? to_f32<QT>(q[((size_t)bh * S + s) * Dh + d]) : 0.f;
  };

  const Ring<E, DK, TC, THREADS, NST, SPLIT> ring{
      smem, bars, &tm_k, &tm_v, &tm_ks, &tm_vs, k, v, k_scale, v_scale,
      bhk, DKh, T, t_end, rank, CL, mode, my_n, tid, nk, sl * DK};
  // The first loads go out before q is read, so the two latencies overlap.
  ring.start();
  if constexpr (!SPLIT) {
    for (int i = tid; i < S * D; i += THREADS) {
      const int s = i / D, d = true_dim(i - s * D);
      q_s[i] = d >= 0 ? to_f32<QT>(q[((size_t)bh * S + s) * Dh + d]) : 0.f;
    }
  }
  __syncthreads();

  float m_w[SMAX], l_w[SMAX], acc[SMAX][NPL];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    m_w[s] = YOHO_NEG_INF, l_w[s] = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) acc[s][j] = 0.f;
  }
  const int pl = lane >> 1;  // the position whose full score this lane holds
  // The split route's K parts: K's rows at this warp's 16 positions, dims
  // lane + STR j (int4 as below), and q's dims qd against them, summed
  // over the lanes (unscaled), as the chunk's last part computes them.
  auto k_rows = [&](const unsigned char* tile, float (&x)[NPL][16]) {
    if (!holds) {
#pragma unroll
      for (int j = 0; j < NPL; ++j)
#pragma unroll
        for (int p = 0; p < 16; ++p) x[j][p] = 0.f;
    } else if constexpr (KIND == KV_INT4) {
#pragma unroll
      for (int j = 0; j < NPL / 2; ++j)
        row16_int4(tile, lane + STR * j, warp, x[j], x[j + NPL / 2]);
    } else {
#pragma unroll
      for (int j = 0; j < NPL; ++j) row16<E>(tile, lane + STR * j, warp, x[j]);
    }
  };
  auto score = [&](const float (&qd)[NPL], const float (&kr)[NPL][16]) {
    float part[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      part[p] = qd[0] * kr[0][p];
#pragma unroll
      for (int j = 1; j < NPL; ++j) part[p] = fmaf(qd[j], kr[j][p], part[p]);
    }
    return butterfly16(part, lane);
  };
  // The split route's partial scores of position pl over the chunk's K
  // parts so far, per query.
  float xs[SMAX];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) xs[s] = 0.f;

  for (int i = 0; i < my_n; ++i) {
    const unsigned char* buf = ring.stage(i);
    ring.acquire(i);
    const int tw = ring.first(i) + warp * PW;  // this warp's first position
    if constexpr (SPLIT) {
      if (!ring.last(i)) {  // a K part alone: partial scores
        if (tw < t_end) {
          float kr[NPL][16], qd[NPL];
          k_rows(buf, kr);
#pragma unroll
          for (int s = 0; s < SMAX; ++s) {
            if (s >= S) break;
#pragma unroll
            for (int j = 0; j < NPL; ++j)
              qd[j] = holds ? q_at(s, ring.part(i), lane + STR * j) : 0.f;
            xs[s] += score(qd, kr);
          }
        }
        ring.release(i);
        continue;
      }
    }
    if (tw < t_end) {
      float kr[NPL][16], vr[NPL][16];  // dims lane + STR j
      if (!holds) {
#pragma unroll
        for (int j = 0; j < NPL; ++j)
#pragma unroll
          for (int p = 0; p < 16; ++p) kr[j][p] = vr[j][p] = 0.f;
      } else if constexpr (KIND == KV_INT4) {
        // Byte row lane + STR j holds dims lane + STR j (low nibbles) and
        // lane + STR j + D/2 (high nibbles): j and j + NPL/2 of the map.
#pragma unroll
        for (int j = 0; j < NPL / 2; ++j) {
          row16_int4(buf, lane + STR * j, warp, kr[j], kr[j + NPL / 2]);
          row16_int4(buf + L::KV, lane + STR * j, warp, vr[j], vr[j + NPL / 2]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          row16<E>(buf, lane + STR * j, warp, kr[j]);
          row16<E>(buf + L::KV, lane + STR * j, warp, vr[j]);
        }
      }
      const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(buf + L::SCALES) + warp * PW;
      const float k_sc = scaled ? __bfloat162float(ks[pl]) : 1.f;
      const float v_sc = scaled ? __bfloat162float(ks[TC + pl]) : 1.f;
      const int t = tw + pl;
#pragma unroll
      for (int s = 0; s < SMAX; ++s) {
        if (s >= S) break;
        float qd[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          if constexpr (SPLIT) qd[j] = holds ? q_at(s, nk - 1, lane + STR * j) : 0.f;
          else qd[j] = holds ? q_s[s * D + lane + STR * j] : 0.f;
        }
        float part[16];
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          part[p] = qd[0] * kr[0][p];
#pragma unroll
          for (int j = 1; j < NPL; ++j) part[p] = fmaf(qd[j], kr[j][p], part[p]);
        }
        float x;  // the split route adds the chunk's earlier parts
        if constexpr (SPLIT) x = (butterfly16(part, lane) + xs[s]) * k_sc, xs[s] = 0.f;
        else x = butterfly16(part, lane) * k_sc;
        const bool valid = t < t_end && (!causal || t <= pos + s);
        const float m_new = fmaxf(m_w[s], pair_max(valid ? x : YOHO_NEG_INF));
        const float alpha = __expf(m_w[s] - m_new);
        const float p = valid ? __expf(x - m_new) : 0.f;
        l_w[s] = l_w[s] * alpha + pair_sum(p);
        m_w[s] = m_new;
        const float w = round_as<QT>(p * v_sc);
        float a[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) a[j] = acc[s][j] * alpha;
#pragma unroll
        for (int pp = 0; pp < 16; ++pp) {
          const float wp = __shfl_sync(0xffffffffu, w, 2 * pp);
          if (tw + pp < t_end) {  // positions past t_end may hold stale bytes
#pragma unroll
            for (int j = 0; j < NPL; ++j) a[j] = fmaf(wp, vr[j][pp], a[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NPL; ++j) acc[s][j] = a[j];
      }
    }
    ring.release(i);
  }

  // The warps' states -> this block's state, in the stages' memory once
  // every warp is done with its last chunk (every load has landed).
  __syncthreads();
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    if (s >= S) break;
    float* wp = wpart + (warp * S + s) * PART;
    if (holds) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) wp[lane + STR * j] = acc[s][j];
    }
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
    const int s = e / D, d = e - s * D, dt = SPLIT ? part_dim(sl, d) : true_dim(d);
    if (dt < 0) continue;  // a padded dim: not stored
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
    out[(((size_t)b * S + s) * Hq + h) * Dh + dt] = from_f32<QT>(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no block leaves while a peer still reads its state
}

template <typename QT, int KIND, int SMAX, int D, bool SPLIT>
cudaError_t launch(const Args& a) {
  using E = typename KvType<QT, KIND>::T;
  constexpr int DK = KIND == KV_INT4 ? D / 2 : D;
  using L = Stage<E, DK, TC>;
  constexpr int NST = ring_stages(L::BYTES, STAGES);
  const int DKh = KIND == KV_INT4 ? a.Dh / 2 : a.Dh;
  const int nk = SPLIT ? (DKh + DK - 1) / DK : 1;  // slices: the grid's z
  const int n_chunks = (a.t_end + TC - 1) / TC;
  const int cl = cluster_size(n_chunks, a.B * a.Hq * nk, BLOCKS_PER_SM * sm_count(),
                              MAX_CLUSTER);
  const KvMaps m = kv_maps<E, DK, TC>(a.k, a.v, a.ks, a.vs, a.B, a.Hkv, DKh, a.T);
  constexpr int PART = D + 2;
  const size_t states = sizeof(float) * (size_t)(WARPS + 1) * a.S * PART;
  const size_t smem = 1024 + (std::max((size_t)NST * L::BYTES, states) + 7) / 8 * 8 + 8 * NST +
                      (SPLIT ? 0 : sizeof(float) * (size_t)a.S * D);
  if (nk > 65535) return cudaErrorInvalidValue;
  return launch_clusters(decode_attn<QT, KIND, SMAX, D, SPLIT>, dim3(cl, a.B * a.Hq, nk), THREADS,
                         smem, cl, a.stream, m.k, m.v, m.ks, m.vs, static_cast<const QT*>(a.q), a.k,
                         a.v, static_cast<const __nv_bfloat16*>(a.ks),
                         static_cast<const __nv_bfloat16*>(a.vs), static_cast<QT*>(a.out), a.Hq,
                         a.Hkv, a.S, a.Dh, a.T, a.t_end, a.causal, a.pos, a.pos_rows, m.mode);
}

// S queries -> the instantiation that holds them: one query for bf16 q
// (several bf16 queries run decode_attention_mq.cu); 1, 4 or 32 for f32 q,
// 1 or 4 at width 256 (and split), whose 32-query states the registers
// cannot hold.
template <typename QT, int KIND, int D, bool SPLIT>
cudaError_t dispatch_s(const Args& a) {
  if (a.S <= 1) return launch<QT, KIND, 1, D, SPLIT>(a);
  if constexpr (std::is_same<QT, float>::value) {
    if (a.S <= 4) return launch<QT, KIND, 4, D, SPLIT>(a);
    if constexpr (D <= 128)
      if (a.S <= 32) return launch<QT, KIND, 32, D, SPLIT>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename QT, int D, bool SPLIT = false>
cudaError_t dispatch_kind(int kind, const Args& a) {
  switch (kind) {
    case KV_INT8: return dispatch_s<QT, KV_INT8, D, SPLIT>(a);
    case KV_INT4: return dispatch_s<QT, KV_INT4, D, SPLIT>(a);
    case KV_FLOAT: return dispatch_s<QT, KV_FLOAT, D, SPLIT>(a);
    default: return cudaErrorInvalidValue;
  }
}

// Head dim Dh -> the smallest width W >= Dh: 16, 32, 64, 128 or 256, for
// every kind; any Dh above 256 runs split at width 256. Any Dh >= 1; int4
// an even one (its bytes hold dims r and r + Dh/2).
template <typename QT>
cudaError_t dispatch_d(int kind, const Args& a) {
  if (a.Dh < 1 || (kind == KV_INT4 && a.Dh % 2)) return cudaErrorInvalidValue;
  if (a.Dh <= 16) return dispatch_kind<QT, 16>(kind, a);
  if (a.Dh <= 32) return dispatch_kind<QT, 32>(kind, a);
  if (a.Dh <= 64) return dispatch_kind<QT, 64>(kind, a);
  if (a.Dh <= 128) return dispatch_kind<QT, 128>(kind, a);
  if (a.Dh <= 256) return dispatch_kind<QT, 256>(kind, a);
  return dispatch_kind<QT, 256, true>(kind, a);
}

}  // namespace

YOHO_ERROR_STRING_FN

// q_dtype: 0 = float32, 1 = bfloat16 (one query: several bf16 queries
// run decode_attention_mq, with the same arguments). kind: 0 = int8, 1 =
// int4 (packed), 2 = K/V in the type of q (k_scale and v_scale null).
// causal: query row s of batch row b sees keys <= pos + s, or <=
// pos_rows[b] + s when pos_rows (B ints on the device, each >= 0) is not
// null. Dh is any head dim >= 1 (int4: even), above 256 split into
// slices of 256 (a grid axis). One launch; no workspace.
extern "C" int decode_attention(int q_dtype, int kind, const void* q, const void* k,
                                const void* v, const void* k_scale, const void* v_scale,
                                void* out, int B, int Hq, int Hkv, int S, int Dh, int T,
                                int kv_len, int causal, int pos, const int* pos_rows,
                                cudaStream_t stream) {
  int t_end = min(T, kv_len);
  if (causal && pos_rows == nullptr) t_end = min(t_end, pos + S);
  if (t_end <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (pos_rows != nullptr && !causal))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, out, B, Hq, Hkv, S, Dh, T, t_end, causal, pos,
               pos_rows, stream};
  if (q_dtype == 0) return dispatch_d<float>(kind, a);
  if (q_dtype == 1) return dispatch_d<__nv_bfloat16>(kind, a);
  return cudaErrorInvalidValue;
}
