// Flash attention forward: tiled online-softmax attention that never
// writes the (Tq x Tk) score matrix to device memory.
//
// Replaces the TPU kernel yoho_tpu/ops/flash_attention.py::
// _flash_forward_impl (body _flash_kernel). Scores are dot(q, k) in f32
// times `scale`; keys at or past kv_len (padded keys; kv_len = Tk by
// default) take the reference's masking value finfo(float32).min, as do
// keys above the diagonal in causal mode. Tiles wholly past kv_len or past
// the diagonal are skipped. P is rounded to the input type before the PV
// product, as the reference does (p.astype(v.dtype)).
//
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), out (B, Tq, H, D) — the
// projections' own layout, so no transpose is made.
//
// Bound on the H100: 4 * Tq * Tk * D operations per (batch, head); at
// whisper-small (B=16, H=12, T=1500, D=64) 110.6 GFLOP per call, 0.11 ms
// at the 989 TFLOP/s bf16 tensor-core rate, while q, k, v and out are
// 4 x 36.9 MB, 0.044 ms at 3.35 TB/s: bound by operations. At D = 64 the
// softmax's exponentials are a second limit of the same size (16 x 12 x
// 1500^2 = 432 M ex2 at 16 per clock per SM, about 0.1 ms).
//
// bf16 (the main path): warp-specialized for Hopper, persistent (one
// block per SM walks the (query block, batch x head) items). A block has
// three consumer warpgroups of 64 query rows each and a producer
// warpgroup, which gives up its registers (setmaxnreg) while one of its
// threads issues TMA loads: each item's Q into one of two buffers (the
// next item's Q lands while this one computes), then 128-key tiles of K
// and V into a ring of three stages guarded by mbarriers (full: the bytes
// landed; empty: every consumer is done with the stage). The tensor maps
// describe the (B, T, H, D) layout as a 4-D tensor (D, H, T, B) with the
// 128-byte swizzle (one 64-wide bf16 row is 128 B), so the ragged
// T = 1500 comes in zero-filled; keys >= kv_len are still masked, since a
// zero key scores 0, not -inf. A consumer computes S = Q K^T with wgmma
// (m64n128k16, both operands in shared memory), the online softmax in
// registers, and O += P V with wgmma (m64n64k16) whose A operand, P in
// bf16, stays in registers (the accumulator layout of S is the
// register-operand layout of A) and whose B operand, V, is read MN-major
// from the same swizzled tile: no transpose pass. The S product of tile
// kb + 1 is issued with the PV product of tile kb, so each warpgroup's
// softmax runs while its own products are on the tensor cores, and three
// warpgroups keep the exponential unit and the tensor cores busy in turn.
// (Two warpgroups in a ping-pong on named barriers measured no faster; see
// PERF.md.)
//
// float32 keeps full FP32 arithmetic on FMAs from shared memory (TF32
// would lose digits); it is not on the main path.
//
// Head dims 16, 32 and 128 (YOHO sessions: the trained fixture is dims 64
// on 4 heads; dims 384 on 12 heads or 512 on 4 give 32 and 128) run the FMA
// kernel for both types: bf16 inputs are widened on load, P is rounded to
// bf16 before the PV product as the reference rounds it, and the output
// is rounded once. The wgmma path's tiles are built on one 64-wide bf16 row
// per 128-byte swizzle; these instantiations are simple and right, not
// fast. Their shared memory, BQ (D+1) + BK (D+1) + BK D + BQ (BK+1) floats,
// is 41.7 KB at D = 32 and 115.5 KB at D = 128 (over the 48 KB default,
// granted by allow_smem as for every launch).
//
// Any other head dim Dh that is a multiple of 8 up to 128 (the JAX model
// attends at any dims // heads: 8 in its dry run, 48 or 96 for dims 384 on
// 8 or 4 heads) runs on the smallest instantiated width W >= Dh, a runtime
// argument of the same instantiations. Global memory is addressed with Dh
// (rows of H Dh elements); shared memory keeps W. Loads of dims >= Dh give
// 0, so a padded dim adds q.k = 0 and the scores are exact, and padded
// output dims are never stored. On the wgmma route (bf16, Dh 40-56) the
// tensor maps' innermost global dim is Dh under a box of 64: TMA zero-fills
// columns Dh..63 (Dh a multiple of 8 keeps the 16-byte stride rule). At
// Dh == W the arithmetic and the outputs are those of the width alone.
#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int TPR = THREADS / BQ;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Tq, int Tk,
                 int kv_len, int Dh, float scale, int causal) {
  static_assert(D % TPR == 0, "head dim must be a multiple of 4");
  static_assert(THREADS % D == 0 && BK % (THREADS / D) == 0, "a pass loads whole tile rows");
  constexpr int DP = D + 1;       // padded rows: no bank conflicts
  constexpr int RPP = THREADS / D;  // K/V tile rows one pass of the block loads
  constexpr int KPT = BK / TPR;   // keys per thread
  constexpr int DPT = D / TPR;    // output dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x DP
  float* k_s = q_s + BQ * DP;     // BK x DP
  float* v_s = k_s + BK * DP;     // BK x D
  float* p_s = v_s + BK * D;      // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;        // query row of this thread
  const int c = tid - r * TPR;    // its part of the row
  const size_t row_stride = (size_t)H * Dh;  // global rows: the true head dim
  // This thread's column of the K/V tiles, the same in every pass, and its
  // first row; each pass moves RPP rows on. The column's offset is formed
  // once, so a pass costs one multiply by the runtime row stride.
  const int dc = tid % D, j0 = tid / D;
  const bool col_in = dc < Dh;
  const size_t col0 = (size_t)b * Tk * row_stride + h * Dh + dc;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int j = i / D, d = i - j * D;
    const int qp = q0 + j;
    q_s[j * DP + d] =
        qp < Tq && d < Dh ? to_f32<T>(q[((size_t)b * Tq + qp) * row_stride + h * Dh + d]) : 0.f;
  }

  float m = YOHO_NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int qpos = q0 + r;
  int n_kb = (kv_len + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int j = j0; j < BK; j += RPP) {
      const int kp = k0 + j;
      const bool in = col_in && kp < kv_len;
      const size_t off = col0 + (size_t)kp * row_stride;
      k_s[j * DP + dc] = in ? to_f32<T>(k[off]) : 0.f;
      v_s[j * D + dc] = in ? to_f32<T>(v[off]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[r * DP + d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] = fmaf(qv, k_s[(c + TPR * i) * DP + d], s[i]);
    }
    float mx = YOHO_NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kp = k0 + c + TPR * i;
      const bool valid = kp < kv_len && (!causal || kp <= qpos);
      s[i] = valid ? s[i] * scale : YOHO_NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      sum += p;
      p_s[r * (BK + 1) + c + TPR * i] = round_as<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // the row's P is written and read by its own 4 lanes

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = p_s[r * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, v_s[j * D + c + TPR * i], acc[i]);
    }
    __syncwarp();
  }

  if (qpos < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + ((size_t)b * Tq + qpos) * row_stride + h * Dh;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (c + TPR * i < Dh) o[c + TPR * i] = from_f32<T>(acc[i] * inv);
  }
}

// ------------------------------------------------------- bf16: wgmma + TMA
namespace wg {

constexpr int D = 64;                  // head dim: one 128-byte swizzled row
constexpr int NWG = 3;                 // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NWG;
constexpr int BK = 128;                // keys per tile
constexpr int STAGES = 3;
constexpr int THREADS = 128 * (NWG + 1);  // consumers: warpgroups 0 .. NWG-1; producer: NWG
// Registers per thread after setmaxnreg: the producer keeps 24, the
// consumers share the rest of the SM's 64 K (a multiple of 8, at most 240).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = (65536 / 128 - PRODUCER_REGS) / NWG / 8 * 8 > 240
                                  ? 240
                                  : (65536 / 128 - PRODUCER_REGS) / NWG / 8 * 8;
constexpr int Q_BYTES = BQ * D * 2;
constexpr int TILE_BYTES = BK * D * 2; // 16 KB for each of K and V
// Q, then K stages, then V stages; every tile 1024-byte aligned (the
// 128-byte swizzle repeats every 8 rows of 128 B).
constexpr int K_OFF = 2 * Q_BYTES;       // two Q buffers: the next item's Q loads early
constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 8 * (4 + 2 * STAGES) + 1024;  // + alignment slack

// 2^x on the special-function unit (flush-to-zero: a masked score's
// weight comes out exactly 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16) * B^T (128 x 16), both from shared memory,
// K-major; accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64) from shared
// memory, MN-major (transposed B).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Online softmax of one 64 x 128 score tile in registers (the accumulator
// layout above), keys from k0: masks keys >= kv_len and, when causal, keys
// past each row (rows row0, row0 + 8; the warpgroup's first row wg_row0),
// updates the running max m and sum l, leaves exp2((s - m) * scale2) in s
// and the factor that rescales O in alpha. Max and mask act on the raw
// scores (scale2 > 0 keeps the order); one FFMA scales and shifts each score.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale2, int k0, int kv_len,
                                             int causal, int row0, int wg_row0, int t4) {
  const bool edge = k0 + BK > kv_len || (causal && k0 + BK - 1 > wg_row0);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    if (edge) {
      const int kp = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (kp >= kv_len || (causal && kp > row0 + 8 * r)) s[i] = YOHO_NEG_INF;
    }
    mx[r] = fmaxf(mx[r], s[i]);
  }
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * scale2);
    m[r] = mx[r];
    shift[r] = -mx[r] * scale2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], scale2, shift[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
}

// P (bf16, as the reference's p.astype(v.dtype)) as the register A operand
// of the PV product: keys 16 kk .. 16 kk + 15 are S columns of chunks
// 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int j0 = 4 * (2 * kk), j1 = 4 * (2 * kk + 1);
    pa[kk][0] = pack_bf16(s[j0], s[j0 + 1]);
    pa[kk][1] = pack_bf16(s[j0 + 2], s[j0 + 3]);
    pa[kk][2] = pack_bf16(s[j1], s[j1 + 1]);
    pa[kk][3] = pack_bf16(s[j1 + 2], s[j1 + 3]);
  }
}

// Accumulator layout of a wgmma m64nN f32 tile, per thread (warp w of the
// warpgroup, lane = 4 g + t4): element i sits in row 16 w + g + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 t4 + i % 2.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                int B, int H, int Tq, int kv_len, int Dh, float scale, int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full0 = base + BAR_OFF;          // 2 barriers: a Q buffer landed
  const uint32_t q_empty0 = q_full0 + 16;           // 2 barriers: consumers done with it
  const uint32_t full0 = q_empty0 + 16;             // STAGES barriers
  const uint32_t empty0 = full0 + 8 * STAGES;       // STAGES barriers

  // Work items (query block, batch x head), consecutive items of one head
  // on neighbouring blocks; block i takes items i, i + gridDim.x, ...
  const int n_qb = (Tq + BQ - 1) / BQ;
  const int n_items = n_qb * B * H;
  auto item_tiles = [&](int q0) {
    const int n = (kv_len + BK - 1) / BK;
    return causal ? min(n, (q0 + BQ + BK - 1) / BK) : n;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, NWG * 128);  // every consumer thread arrives
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == NWG) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * NWG) {
      int tile = 0;  // K/V tiles loaded so far: the ring position
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const int bh = item / n_qb, q0 = (item - bh * n_qb) * BQ;
        const int b = bh / H, h = bh - b * H;
        const int qb = n & 1;  // Q double buffer: the load of item n waits for item n - 2
        mbar_wait(q_empty0 + 8 * qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full0 + 8 * qb, Q_BYTES);
        tma_load(base + qb * Q_BYTES, &tm_q, q_full0 + 8 * qb, 0, h, q0, b);
        for (int kb = 0, n_kb = item_tiles(q0); kb < n_kb; ++kb, ++tile) {
          const int st = tile % STAGES;
          mbar_wait(empty0 + 8 * st, ((tile / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st;
          mbar_expect_tx(full, 2 * TILE_BYTES);
          tma_load(base + K_OFF + st * TILE_BYTES, &tm_k, full, 0, h, kb * BK, b);
          tma_load(base + V_OFF + st * TILE_BYTES, &tm_v, full, 0, h, kb * BK, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    constexpr float LOG2E = 1.4426950408889634f;
    const float scale2 = scale * LOG2E;  // softmax in the log2 domain
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;

    int tile = 0;
    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int bh = item / n_qb, q0 = (item - bh * n_qb) * BQ;
      const int b = bh / H, h = bh - b * H;
      const int n_kb = item_tiles(q0);
      const int row0 = q0 + wgi * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const int qb = n & 1;
      // Q rows of this warpgroup; K-major, 8-row groups 1024 B apart.
      const uint64_t dq = desc_sw128(base + qb * Q_BYTES + wgi * 64 * D * 2, 1, 64);
      // S = Q K^T: K is K-major like Q; 16 dims are 32 B further along a row.
      auto issue_qk = [&](float (&s)[64], int st) {
        const uint64_t dk = desc_sw128(base + K_OFF + st * TILE_BYTES, 1, 64);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_m64n128k16(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
        wgmma_commit();
      };
      // O += P V: V is MN-major, 64 dims (one 128-byte swizzle atom) by 128
      // keys in 8-key groups 1024 B apart; both of its offsets are 1024 B, so
      // the field the hardware reads for the key direction holds it either
      // way; 16 keys are 2048 B further.
      auto issue_pv = [&](float (&o)[32], const uint32_t (&pa)[BK / 16][4], int st) {
        const uint64_t dv = desc_sw128(base + V_OFF + st * TILE_BYTES, 64, 64);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_m64n64k16_tb(o, pa[kk], dv + 128 * kk);
        wgmma_commit();
      };

      float o[32], s[64];
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      float m[2] = {YOHO_NEG_INF, YOHO_NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
      mbar_wait(q_full0 + 8 * qb, (n >> 1) & 1);

      // Tile 0's S, then per tile kb: the S product of tile kb + 1 and the
      // PV product of tile kb go out together, the softmax of tile kb + 1
      // runs while PV(kb) is on the tensor cores, and O is rescaled once
      // PV(kb) is done. The last PV is peeled off, so every pass of the loop
      // commits the same two groups.
      mbar_wait(full0 + 8 * (tile % STAGES), (tile / STAGES) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, tile % STAGES);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_kb == 1) mbar_arrive(q_empty0 + 8 * qb);  // Q is no longer read
      softmax_tile(s, m, l, alpha, scale2, 0, kv_len, causal, row0, q0 + wgi * 64, t4);
      pack_p(s, pa);
      for (int kb = 0; kb + 1 < n_kb; ++kb, ++tile) {
        mbar_wait(full0 + 8 * ((tile + 1) % STAGES), ((tile + 1) / STAGES) & 1);
        fence_regs(s);
        fence_regs(o);
        wgmma_fence();
        issue_qk(s, (tile + 1) % STAGES);
        issue_pv(o, pa, tile % STAGES);
        wgmma_wait<1>();  // S of tile kb + 1 is in; PV(kb) may still run
        fence_regs(s);
        if (kb + 2 == n_kb) mbar_arrive(q_empty0 + 8 * qb);
        softmax_tile(s, m, l, alpha, scale2, (kb + 1) * BK, kv_len, causal, row0,
                     q0 + wgi * 64, t4);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty0 + 8 * (tile % STAGES));  // this thread is done with the stage
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p(s, pa);
      }
      fence_regs(o);
      wgmma_fence();
      issue_pv(o, pa, tile % STAGES);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty0 + 8 * (tile % STAGES));
      ++tile;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Tq) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow = out + ((size_t)b * Tq + row) * H * Dh + h * Dh;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (8 * j < Dh)  // padded dims (Dh a multiple of 8) are not stored
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
                __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// A (B, T, H, Dh) bf16 tensor (Dh <= 64, a multiple of 8) as the 4-D map
// (Dh, H, T, B), boxes of 64 dims of one head's `rows` consecutive
// positions, 128-byte swizzle, zero fill past T and past Dh.
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int Dh, int rows) {
  const uint64_t dims[4] = {(uint64_t)Dh, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)Dh * 2, (uint64_t)H * Dh * 2,
                               (uint64_t)T * H * Dh * 2};
  const uint32_t box[4] = {(uint32_t)D, 1, (uint32_t)rows, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int Tq, int Tk, int kv_len, int Dh, float scale, int causal,
                         cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, Tq, H, Dh, BQ) || !make_map(&mk, k, B, Tk, H, Dh, BK) ||
      !make_map(&mv, v, B, Tk, H, Dh, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_wgmma, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // Persistent: one block per SM walks the work items.
  const int n_items = (Tq + BQ - 1) / BQ * B * H;
  flash_fwd_wgmma<<<min(n_items, sm_count()), THREADS, SMEM_BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), B, H, Tq, kv_len, Dh, scale, causal);
  return cudaGetLastError();
}

}  // namespace wg

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Tq, int Tk, int kv_len, int Dh, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                                       (size_t)BK * D + (size_t)BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(out), H,
                                        Tq, Tk, kv_len, Dh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

YOHO_ERROR_STRING_FN

// dtype: 0 = float32 (FP32 FMAs), 1 = bfloat16 (wgmma + TMA at widths
// 40-64; q, k and v 16-byte aligned). q (B, Tq, H, D); k, v (B, Tk, H, D);
// keys >= kv_len (1 <= kv_len <= Tk) are masked. D is a multiple of 8 from 8
// to 128, run at the width W = 16, 32, 64 or 128 that holds it: 64 is every
// whisper size and the full-width YOHO model (wgmma for bf16), 16, 32 and 128
// run FMAs for both types.
extern "C" int flash_attention_forward(int dtype, const void* q, const void* k,
                                       const void* v, void* out, int B, int H, int Tq,
                                       int Tk, int kv_len, int D, float scale, int causal,
                                       cudaStream_t stream) {
  if (kv_len < 1 || kv_len > Tk || (dtype != 0 && dtype != 1) || D < 8 || D > 128 || D % 8)
    return cudaErrorInvalidValue;
  if (D > 32 && D <= 64) {
    if (dtype == 0)
      return launch<float, 64>(q, k, v, out, B, H, Tq, Tk, kv_len, D, scale, causal, stream);
    return wg::launch_wgmma(q, k, v, out, B, H, Tq, Tk, kv_len, D, scale, causal, stream);
  }
  auto fma_route = [&](auto w) -> cudaError_t {
    constexpr int W = decltype(w)::value;
    if (dtype == 0)
      return launch<float, W>(q, k, v, out, B, H, Tq, Tk, kv_len, D, scale, causal, stream);
    return launch<__nv_bfloat16, W>(q, k, v, out, B, H, Tq, Tk, kv_len, D, scale, causal,
                                    stream);
  };
  if (D <= 16) return fma_route(std::integral_constant<int, 16>{});
  if (D <= 32) return fma_route(std::integral_constant<int, 32>{});
  return fma_route(std::integral_constant<int, 128>{});
}
