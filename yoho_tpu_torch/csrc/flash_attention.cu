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
// Layout: q (B, Tq, H, D), k and v (B, Tk, Hkv, D), out (B, Tq, H, D) — the
// projections' own layout, so no transpose is made. Grouped-query
// attention reads each KV head once: query head h reads KV head
// h / (H / Hkv), which is what repeating every KV head H / Hkv times on the
// head axis (the JAX model's jnp.repeat) gives, without the copy.
//
// Bound on the H100: 4 * Tq * Tk * D operations per (batch, head); at
// whisper-small (B=16, H=12, T=1500, D=64) 110.6 GFLOP per call, 0.11 ms
// at the 989 TFLOP/s bf16 tensor-core rate, while q, k, v and out are
// 4 x 36.9 MB, 0.044 ms at 3.35 TB/s: bound by operations. At D = 64 the
// softmax's exponentials are a second limit of the same size (16 x 12 x
// 1500^2 = 432 M ex2 at 16 per clock per SM, about 0.1 ms); at D = 16 and
// 32 they are the first (the products shrink with D, the exponentials do
// not).
//
// bf16 at every head dim that is a multiple of 8 up to 128 (the main
// path): warp-specialized for Hopper, persistent (one block per SM walks
// the (query block, batch x head) items), at the width W = 16, 32, 64 or
// 128 that holds the head dim. A block has consumer warpgroups of 64 query
// rows each and a producer warpgroup, which gives up its registers
// (setmaxnreg) while one of its threads issues TMA loads: each item's Q
// into one of two buffers (the next item's Q lands while this one
// computes; one at width 128), then 128-key tiles of K and V into a ring of stages guarded
// by mbarriers (full: the bytes landed; empty: every consumer is done with
// the stage). The tensor maps describe the (B, T, H, D) layout as a 4-D
// tensor (D, H, T, B) whose rows are swizzled at their own width: a
// 16-wide bf16 row is 32 bytes (32-byte swizzle), 32-wide 64 bytes
// (64-byte swizzle), 64-wide 128 bytes (128-byte swizzle), and a 128-wide
// row is two 128-byte atoms, so each Q, K and V tile loads as two boxes of
// 64 dims into two regions. The ragged T = 1500 comes in zero-filled; keys
// >= kv_len are still masked, since a zero key scores 0, not -inf. A
// consumer computes S = Q K^T with wgmma (m64n128k16, W / 16 steps, both
// operands in shared memory; at W = 128 steps 0-3 read the first region and
// 4-7 the second), the online softmax in registers, and O += P V with
// wgmma (m64nWk16, two m64n64k16 at W = 128, one per region) whose A
// operand, P in bf16, stays in registers (the accumulator layout of S is
// the register-operand layout of A) and whose B operand, V, is read
// MN-major from the same swizzled tile: no transpose pass. The S product
// of tile kb + 1 is issued with the PV product of tile kb, so each
// warpgroup's softmax runs while its own products are on the tensor cores.
// Widths 16-64 run three stages and three consumer warpgroups, so the
// exponential unit and the tensor cores stay busy in turn, or two where a
// short sequence fills the card's last round of items better in blocks of
// 128 rows than of 192 (wg::pick_nwg; the outputs are the same). Width 128 holds
// 64 output and 64 score registers a thread, which three warpgroups' 160
// registers cannot, and its Q and K/V tiles are twice as large: it runs
// two consumer warpgroups at 240 registers, one Q buffer and three K/V
// stages (Q 32 KB, K/V 3 x 64 KB: 224 KB; two Q buffers and two stages
// measured 15% slower at (16, 512, 4, 128), PERF.md). (Two warpgroups in a
// ping-pong on named barriers measured no faster at width 64; see PERF.md.)
//
// float32 keeps full FP32 arithmetic on FMAs from shared memory (TF32
// would lose digits); it is not on the main path. The same FMA kernel
// takes the bf16 head dims that TMA cannot: those that are not a multiple
// of 8 (a row of D bf16 is then not a multiple of 16 bytes) and those from
// 129 to 256 (past the wgmma widths): bf16 inputs are widened on load, P
// is rounded to bf16 before the PV product as the reference rounds it, and
// the output is rounded once. It runs one 64-query block of 256 threads per
// (batch, head); these instantiations are simple and right, not fast. Its
// shared memory, BQ (D+1) + BK (D+1) + BK D + BQ (BK+1) floats, is 41.7 KB
// at D = 32, 115.5 KB at D = 128 and 213.8 KB at D = 256 (over the 48 KB
// default, granted by allow_smem as for every launch).
//
// A head dim Dh below its width W (the JAX model attends at any dims //
// heads: 8 in its dry run, 12 for dims 48 on 4 heads, 48 or 96 for dims 384
// on 8 or 4 heads) is a runtime argument of the same instantiations. Global
// memory is addressed with Dh (rows of H Dh elements); shared memory keeps
// W. Loads of dims >= Dh give 0, so a padded dim adds q.k = 0 and the
// scores are exact, and padded output dims are never stored. On the wgmma
// route the tensor maps' innermost global dim is Dh under a box of W (or
// 64): TMA zero-fills the columns past Dh (Dh a multiple of 8 keeps the
// 16-byte stride rule). At Dh == W the arithmetic and the outputs are
// those of the width alone.
//
// Head dims above 256 (the JAX package attends at any dims // heads) run
// the split route: the output dims are cut into slices, one of width 256
// per 256 dims and the rest at the smallest FMA width that holds it (264 =
// 256 + 8: widths 256 and 16), and a grid axis takes the slices, one block
// per (query block, batch x head, slice). Every block computes the scores
// over all of Dh, staging q and K through shared memory 64 dims at a time
// (the same sequential sum over d as the FMA kernel), runs that kernel's
// online softmax, and accumulates P V for its own slice of V only; it
// writes its slice once. Shared memory follows the chunk and the slice
// (113 KB at width 256), not Dh, so no head dim is too wide. The scores are
// recomputed once per slice: ceil(Dh / 256) times the QK products of one
// pass, and q and K are read that many times.
#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int TPR = THREADS / BQ;

// One K tile of the FMA kernels for query row r (its TPR lanes, this one
// at c): the raw scores s of keys k0 + c + TPR i are scaled and masked
// (keys >= kv_len, and past qpos when causal), the running max m and sum l
// move on, P (rounded to T, as the reference's p.astype(v.dtype)) goes
// through p_s, and acc = acc * alpha + P V over v_s (BK rows of W floats).
template <typename T, int W>
__device__ __forceinline__ void softmax_pv(float (&s)[BK / TPR], float (&acc)[W / TPR], float& m,
                                           float& l, float* p_s, const float* v_s, int r,
                                           int c, int k0, int qpos, int kv_len, int causal,
                                           float scale) {
  constexpr int KPT = BK / TPR;
  constexpr int DPT = W / TPR;
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
    for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, v_s[j * W + c + TPR * i], acc[i]);
  }
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int groups, int Tq,
                 int Tk, int kv_len, int Dh, float scale, int causal) {
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
  const size_t kv_stride = (size_t)(H / groups) * Dh;  // K/V rows: Hkv heads
  // This thread's column of the K/V tiles, the same in every pass, and its
  // first row; each pass moves RPP rows on. The column's offset is formed
  // once, so a pass costs one multiply by the runtime row stride.
  const int dc = tid % D, j0 = tid / D;
  const bool col_in = dc < Dh;
  const size_t col0 = (size_t)b * Tk * kv_stride + (h / groups) * Dh + dc;

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
      const size_t off = col0 + (size_t)kp * kv_stride;
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
    softmax_pv<T, D>(s, acc, m, l, p_s, v_s, r, c, k0, qpos, kv_len, causal, scale);
  }

  if (qpos < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + ((size_t)b * Tq + qpos) * row_stride + h * Dh;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (c + TPR * i < Dh) o[c + TPR * i] = from_f32<T>(acc[i] * inv);
  }
}

// ------------------------------------------------- D > 256: output slices
constexpr int SPLIT_DC = 64;  // the q and K dims one pass stages for the scores

// One slice of W output dims from dim s0 = d0 + blockIdx.z W: the FMA
// kernel's arithmetic, with the scores summed over every dim of Dh in
// chunks of SPLIT_DC through shared memory.
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
flash_fwd_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int H, int groups, int Tq, int Tk, int kv_len, int Dh,
                float scale, int causal, int d0) {
  constexpr int DC = SPLIT_DC;
  constexpr int CP = DC + 1;        // padded chunk rows: no bank conflicts
  constexpr int RPC = THREADS / DC;  // chunk rows one pass of the block loads
  constexpr int RPP = THREADS / W;  // V slice rows one pass loads
  constexpr int KPT = BK / TPR;
  constexpr int DPT = W / TPR;
  static_assert(THREADS % W == 0 && BK % RPP == 0 && BQ % RPC == 0 && BK % RPC == 0,
                "a pass loads whole tile rows");
  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x CP
  float* k_s = q_s + BQ * CP;     // BK x CP
  float* v_s = k_s + BK * CP;     // BK x W
  float* p_s = v_s + BK * W;      // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int s0 = d0 + blockIdx.z * W;  // this block's first output dim
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int c = tid - r * TPR;
  const size_t row_stride = (size_t)H * Dh;
  const size_t kv_stride = (size_t)(H / groups) * Dh;
  const T* q_bh = q + (size_t)b * Tq * row_stride + h * Dh;
  const size_t kv0 = (size_t)b * Tk * kv_stride + (h / groups) * Dh;
  const int cc = tid % DC, cj0 = tid / DC;  // this thread's chunk column and first row
  const int vc = tid % W, vj0 = tid / W;    // and its V slice column
  const bool v_in = s0 + vc < Dh;

  float m = YOHO_NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int qpos = q0 + r;
  int n_kb = (kv_len + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
    for (int dc0 = 0; dc0 < Dh; dc0 += DC) {
      __syncthreads();  // the previous chunk (and tile) fully consumed
      const int d = dc0 + cc;
      const bool d_in = d < Dh;
      for (int j = cj0; j < BQ; j += RPC) {
        const int qp = q0 + j;
        q_s[j * CP + cc] = qp < Tq && d_in ? to_f32<T>(q_bh[(size_t)qp * row_stride + d]) : 0.f;
      }
      for (int j = cj0; j < BK; j += RPC) {
        const int kp = k0 + j;
        k_s[j * CP + cc] = kp < kv_len && d_in ? to_f32<T>(k[kv0 + (size_t)kp * kv_stride + d])
                                               : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float qv = q_s[r * CP + dd];
#pragma unroll
        for (int i = 0; i < KPT; ++i) s[i] = fmaf(qv, k_s[(c + TPR * i) * CP + dd], s[i]);
      }
    }
    // V's slice (every thread has passed a barrier since the last P V read).
    for (int j = vj0; j < BK; j += RPP) {
      const int kp = k0 + j;
      v_s[j * W + vc] =
          v_in && kp < kv_len ? to_f32<T>(v[kv0 + (size_t)kp * kv_stride + s0 + vc]) : 0.f;
    }
    __syncthreads();

    softmax_pv<T, W>(s, acc, m, l, p_s, v_s, r, c, k0, qpos, kv_len, causal, scale);
  }

  if (qpos < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + ((size_t)b * Tq + qpos) * row_stride + h * Dh + s0;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (s0 + c + TPR * i < Dh) o[c + TPR * i] = from_f32<T>(acc[i] * inv);
  }
}

// ------------------------------------------------------- bf16: wgmma + TMA
namespace wg {

// Consumer warpgroups, 64 query rows each: at widths 16-64 a launch takes
// NWG or NWG_ALT, whichever pick_nwg expects to be faster for its shape;
// width 128 takes NWG_128 (64 output + 64 score registers a thread).
constexpr int NWG = 3;
constexpr int NWG_ALT = 2;
constexpr int NWG_128 = 2;
constexpr int BK = 128;    // keys per tile
constexpr int STAGES = 3;  // the K/V ring
constexpr int QBUF = 2;    // Q buffers: the next item's Q loads while this one computes
// Registers per thread after setmaxnreg: the producer keeps 24, the
// consumers share the rest of the SM's 64 K (a multiple of 8, at most 240).
constexpr int PRODUCER_REGS = 24;

// The geometry of width W (16, 32, 64 or 128) with NW consumer warpgroups.
template <int W, int NW>
struct Geo {
  static constexpr int ST = STAGES;
  // Width 128 has one Q buffer: its shared memory holds a third K/V stage instead.
  static constexpr int QB = W == 128 ? 1 : QBUF;
  static constexpr int BQ = 64 * NW;
  static constexpr int THREADS = 128 * (NW + 1);  // consumers: warpgroups 0 .. NW-1; producer: NW
  static constexpr int CONSUMER_REGS = (65536 / 128 - PRODUCER_REGS) / NW / 8 * 8 > 240
                                           ? 240
                                           : (65536 / 128 - PRODUCER_REGS) / NW / 8 * 8;
  static constexpr int ATOMS = W == 128 ? 2 : 1;  // swizzle atoms (TMA boxes) a row
  static constexpr int BW = W / ATOMS;            // dims a box: 16, 32 or 64
  static constexpr int RB = 2 * BW;               // bytes of a box row = the swizzle: 32, 64, 128
  static constexpr int Q_BYTES = BQ * W * 2;
  static constexpr int TILE_BYTES = BK * W * 2;   // each of K and V
  // Q buffers, then K stages, then V stages; every region 1024-byte
  // aligned (a swizzle pattern repeats every 8 rows, at most 1024 B).
  static constexpr int K_OFF = QB * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + ST * TILE_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 8 * (4 + 2 * ST) + 1024;  // + alignment slack
  static_assert(W == 16 || W == 32 || W == 64 || W == 128, "wgmma widths");
  static_assert(QB == 1 || QB == 2, "one or two Q buffers");
  static_assert(SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");
};

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

// D (64 x N, f32) += A (64 x 16 bf16, registers) * B (16 x N) from shared
// memory, MN-major (transposed B); N = 64, 32 or 16.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
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

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<16>(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
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
// and column 8 (i / 4) + 2 t4 + i % 2. The output of width W is ATOMS such
// tiles of BW columns, the second (W = 128) from column 64.
template <int W, int NW>
__global__ void __launch_bounds__(Geo<W, NW>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                int B, int H, int groups, int Tq, int kv_len, int Dh, float scale, int causal) {
  using G = Geo<W, NW>;
  constexpr int BQ = G::BQ, ST = G::ST, QB = G::QB, ATOMS = G::ATOMS, BW = G::BW, RB = G::RB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_full0 = base + G::BAR_OFF;       // 2 barriers: a Q buffer landed
  const uint32_t q_empty0 = q_full0 + 16;           // 2 barriers: consumers done with it
  const uint32_t full0 = q_empty0 + 16;             // ST barriers
  const uint32_t empty0 = full0 + 8 * ST;           // ST barriers

  // Work items (query block, batch x head), consecutive items of one head
  // (and the heads of one KV head) on neighbouring blocks; block i takes
  // items i, i + gridDim.x, ...
  const int n_qb = (Tq + BQ - 1) / BQ;
  const int n_items = n_qb * B * H;
  auto item_tiles = [&](int q0) {
    const int n = (kv_len + BK - 1) / BK;
    return causal ? min(n, (q0 + BQ + BK - 1) / BK) : n;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, NW * 128);  // every consumer thread arrives
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NW * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == NW) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * NW) {
      int tile = 0;  // K/V tiles loaded so far: the ring position
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const int bh = item / n_qb, q0 = (item - bh * n_qb) * BQ;
        const int b = bh / H, h = bh - b * H, hk = h / groups;
        const int qb = n % QB;  // the load of item n waits for item n - QB
        mbar_wait(q_empty0 + 8 * qb, ((n / QB) & 1) ^ 1);
        mbar_expect_tx(q_full0 + 8 * qb, G::Q_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          tma_load(base + qb * G::Q_BYTES + a * BQ * RB, &tm_q, q_full0 + 8 * qb, a * BW, h, q0,
                   b);
        for (int kb = 0, n_kb = item_tiles(q0); kb < n_kb; ++kb, ++tile) {
          const int st = tile % ST;
          mbar_wait(empty0 + 8 * st, ((tile / ST) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st;
          mbar_expect_tx(full, 2 * G::TILE_BYTES);
#pragma unroll
          for (int a = 0; a < ATOMS; ++a)
            tma_load(base + G::K_OFF + st * G::TILE_BYTES + a * BK * RB, &tm_k, full, a * BW, hk,
                     kb * BK, b);
#pragma unroll
          for (int a = 0; a < ATOMS; ++a)
            tma_load(base + G::V_OFF + st * G::TILE_BYTES + a * BK * RB, &tm_v, full, a * BW, hk,
                     kb * BK, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::CONSUMER_REGS));
    constexpr float LOG2E = 1.4426950408889634f;
    const float scale2 = scale * LOG2E;  // softmax in the log2 domain
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // K-major tiles (Q, K): rows of RB bytes, 8-row groups 8 RB apart; 16
    // dims are 32 B further along a row, the next box's dims a region on.
    constexpr uint32_t SBO = 8 * RB / 16;

    int tile = 0;
    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int bh = item / n_qb, q0 = (item - bh * n_qb) * BQ;
      const int b = bh / H, h = bh - b * H;
      const int n_kb = item_tiles(q0);
      const int row0 = q0 + wgi * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const int qb = n % QB;
      // Q rows of this warpgroup.
      const uint32_t q_rows = base + qb * G::Q_BYTES + wgi * 64 * RB;
      // S = Q K^T: K is K-major like Q.
      auto issue_qk = [&](float (&s)[64], int st) {
        const uint32_t k_tile = base + G::K_OFF + st * G::TILE_BYTES;
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          const int a = kk / (BW / 16), j = kk % (BW / 16);
          wgmma_ss_m64n128k16(s, desc_sw<RB>(q_rows + a * BQ * RB, 1, SBO) + 2 * j,
                              desc_sw<RB>(k_tile + a * BK * RB, 1, SBO) + 2 * j, kk > 0);
        }
        wgmma_commit();
      };
      // O += P V: V is MN-major, BW dims (one swizzle atom) by 128 keys in
      // 8-key groups 8 RB apart; both of its offsets are 8 RB, so the field
      // the hardware reads for the key direction holds it either way; 16
      // keys are 16 RB further. At W = 128 each region is its own product.
      auto issue_pv = [&](float (&o)[ATOMS][BW / 2], const uint32_t (&pa)[BK / 16][4], int st) {
        const uint32_t v_tile = base + G::V_OFF + st * G::TILE_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int a = 0; a < ATOMS; ++a)
            wgmma_rs_tb<BW>(o[a], pa[kk],
                            desc_sw<RB>(v_tile + a * BK * RB, SBO, SBO) + RB * kk);
        wgmma_commit();
      };
      auto fence_o = [&](float (&o)[ATOMS][BW / 2]) {
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
      };

      float o[ATOMS][BW / 2], s[64];
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
#pragma unroll
        for (int i = 0; i < BW / 2; ++i) o[a][i] = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      float m[2] = {YOHO_NEG_INF, YOHO_NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
      mbar_wait(q_full0 + 8 * qb, (n / QB) & 1);

      // Tile 0's S, then per tile kb: the S product of tile kb + 1 and the
      // PV product of tile kb go out together, the softmax of tile kb + 1
      // runs while PV(kb) is on the tensor cores, and O is rescaled once
      // PV(kb) is done. The last PV is peeled off, so every pass of the loop
      // commits the same two groups.
      mbar_wait(full0 + 8 * (tile % ST), (tile / ST) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, tile % ST);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_kb == 1) mbar_arrive(q_empty0 + 8 * qb);  // Q is no longer read
      softmax_tile(s, m, l, alpha, scale2, 0, kv_len, causal, row0, q0 + wgi * 64, t4);
      pack_p(s, pa);
      for (int kb = 0; kb + 1 < n_kb; ++kb, ++tile) {
        mbar_wait(full0 + 8 * ((tile + 1) % ST), ((tile + 1) / ST) & 1);
        fence_regs(s);
        fence_o(o);
        wgmma_fence();
        issue_qk(s, (tile + 1) % ST);
        issue_pv(o, pa, tile % ST);
        wgmma_wait<1>();  // S of tile kb + 1 is in; PV(kb) may still run
        fence_regs(s);
        if (kb + 2 == n_kb) mbar_arrive(q_empty0 + 8 * qb);
        softmax_tile(s, m, l, alpha, scale2, (kb + 1) * BK, kv_len, causal, row0,
                     q0 + wgi * 64, t4);
        wgmma_wait<0>();
        fence_o(o);
        mbar_arrive(empty0 + 8 * (tile % ST));  // this thread is done with the stage
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
#pragma unroll
          for (int i = 0; i < BW / 2; ++i) o[a][i] *= alpha[(i >> 1) & 1];
        pack_p(s, pa);
      }
      fence_o(o);
      wgmma_fence();
      issue_pv(o, pa, tile % ST);
      wgmma_wait<0>();
      fence_o(o);
      mbar_arrive(empty0 + 8 * (tile % ST));
      ++tile;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Tq) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow = out + ((size_t)b * Tq + row) * H * Dh + h * Dh;
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
#pragma unroll
          for (int j = 0; j < BW / 8; ++j) {
            const int col = a * BW + 8 * j;
            if (col < Dh)  // padded dims (Dh a multiple of 8) are not stored
              *reinterpret_cast<__nv_bfloat162*>(orow + col + 2 * t4) = __floats2bfloat162_rn(
                  o[a][4 * j + 2 * r] * inv, o[a][4 * j + 2 * r + 1] * inv);
          }
      }
    }
  }
}

// A (B, T, heads, Dh) bf16 tensor (Dh <= W, a multiple of 8) as the 4-D map
// (Dh, heads, T, B), boxes of BW dims of one head's `rows` consecutive
// positions in the swizzle of BW's rows, zero fill past T and past Dh.
template <int W, int NW>
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int heads, int Dh, int rows) {
  using G = Geo<W, NW>;
  const uint64_t dims[4] = {(uint64_t)Dh, (uint64_t)heads, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)Dh * 2, (uint64_t)heads * Dh * 2,
                               (uint64_t)T * heads * Dh * 2};
  const uint32_t box[4] = {(uint32_t)G::BW, 1, (uint32_t)rows, 1};
  const CUtensorMapSwizzle swizzle = G::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box, swizzle);
}

template <int W, int NW>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int Hkv, int Tq, int Tk, int kv_len, int Dh, float scale, int causal,
                         cudaStream_t stream) {
  using G = Geo<W, NW>;
  CUtensorMap mq, mk, mv;
  if (!make_map<W, NW>(&mq, q, B, Tq, H, Dh, G::BQ) ||
      !make_map<W, NW>(&mk, k, B, Tk, Hkv, Dh, BK) ||
      !make_map<W, NW>(&mv, v, B, Tk, Hkv, Dh, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_wgmma<W, NW>, G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // Persistent: one block per SM walks the work items.
  const int n_items = (Tq + G::BQ - 1) / G::BQ * B * H;
  flash_fwd_wgmma<W, NW><<<min(n_items, sm_count()), G::THREADS, G::SMEM_BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), B, H, H / Hkv, Tq, kv_len, Dh, scale,
      causal);
  return cudaGetLastError();
}

// The consumer warpgroups of a launch at widths 16-64: NWG or NWG_ALT,
// whichever gives the smaller rounds x rows a round / throughput, where a
// round is one item on every SM and three warpgroups do r times the work
// of two in the same time. Every row's arithmetic is the same at either
// count, so the output is too. A short sequence often fills its last round
// better in blocks of 128 rows: the YOHO encoder (16, 512, 6 heads) is 288
// items of 192 rows (3 rounds, the last a fifth full) or 384 of 128 (3
// full). r is fitted a width to the readings at the sequences of 512
// where the choice flips (PERF.md): 7/6 at width 16 ((16, 512, 24, 16):
// 9 rounds of three 3.7% faster than 12 of two), 11/10 at 32 and 64
// ((16, 512, 8, 48): 4 rounds of two 4.6% faster than 3 of three).
// Whisper's encoders take three at any r above 1 (as many rows a round x
// rounds at either count); there r reads 1.2.
template <int W>
int pick_nwg(int B, int H, int Tq) {
  constexpr int num = W == 16 ? 7 : 11, den = W == 16 ? 6 : 10;
  auto cost = [&](int nw) {
    const long items = (long)((Tq + 64 * nw - 1) / (64 * nw)) * B * H;
    const long rounds = (items + sm_count() - 1) / sm_count();
    return rounds * nw * (nw >= 3 ? den : num);
  };
  return cost(NWG_ALT) < cost(NWG) ? NWG_ALT : NWG;
}

template <int W>
cudaError_t launch_width(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int Hkv, int Tq, int Tk, int kv_len, int Dh, float scale, int causal,
                         cudaStream_t stream) {
  if constexpr (W == 128) {
    return launch_wgmma<W, NWG_128>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, Dh, scale, causal,
                                    stream);
  } else {
    if (pick_nwg<W>(B, H, Tq) == NWG_ALT)
      return launch_wgmma<W, NWG_ALT>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, Dh, scale,
                                      causal, stream);
    return launch_wgmma<W, NWG>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, Dh, scale, causal,
                                stream);
  }
}

}  // namespace wg

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Hkv, int Tq, int Tk, int kv_len, int Dh, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                                       (size_t)BK * D + (size_t)BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(out), H,
                                        H / Hkv, Tq, Tk, kv_len, Dh, scale, causal);
  return cudaGetLastError();
}

// n_slices slices of width W from output dim d0, one grid row each.
template <typename T, int W>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int Hkv, int Tq, int Tk, int kv_len, int Dh, float scale, int causal,
                         int d0, int n_slices, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (SPLIT_DC + 1) + (size_t)BK * W +
                                       (size_t)BQ * (BK + 1));
  auto kern = flash_fwd_split<T, W>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H, n_slices);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(out), H,
                                        H / Hkv, Tq, Tk, kv_len, Dh, scale, causal, d0);
  return cudaGetLastError();
}

// D > 256: a launch of width 256 over the D / 256 full slices, then one of
// the smallest FMA width that holds the rest, if any.
template <typename T>
cudaError_t launch_slices(const void* q, const void* k, const void* v, void* out, int B, int H,
                          int Hkv, int Tq, int Tk, int kv_len, int D, float scale, int causal,
                          cudaStream_t stream) {
  const int full = D / 256, rest = D - 256 * full;
  if (full > 65535) return cudaErrorInvalidValue;
  cudaError_t err = launch_split<T, 256>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, D, scale,
                                         causal, 0, full, stream);
  if (err != cudaSuccess || rest == 0) return err;
  auto rest_slice = [&](auto width) -> cudaError_t {
    return launch_split<T, decltype(width)::value>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, D,
                                                   scale, causal, 256 * full, 1, stream);
  };
  if (rest <= 16) return rest_slice(std::integral_constant<int, 16>{});
  if (rest <= 32) return rest_slice(std::integral_constant<int, 32>{});
  if (rest <= 64) return rest_slice(std::integral_constant<int, 64>{});
  if (rest <= 128) return rest_slice(std::integral_constant<int, 128>{});
  return rest_slice(std::integral_constant<int, 256>{});
}

}  // namespace

YOHO_ERROR_STRING_FN

// dtype: 0 = float32 (FP32 FMAs), 1 = bfloat16. q (B, Tq, H, D); k, v (B,
// Tk, Hkv, D) with Hkv dividing H (query head h reads KV head h / (H / Hkv));
// keys >= kv_len (1 <= kv_len <= Tk) are masked; any D >= 1. bf16 at a
// multiple of 8 up to 128 runs wgmma + TMA (q, k and v 16-byte aligned) at
// the width W = 16, 32, 64 or 128 that holds D; f32,
// and bf16 at any other D up to 256, run FMAs at the width 16, 32, 64, 128
// or 256 that holds it; D > 256 runs the split route (output slices of
// width 256 and the rest's width, one launch per width).
extern "C" int flash_attention_forward(int dtype, const void* q, const void* k,
                                       const void* v, void* out, int B, int H, int Hkv,
                                       int Tq, int Tk, int kv_len, int D, float scale,
                                       int causal, cudaStream_t stream) {
  if (kv_len < 1 || kv_len > Tk || (dtype != 0 && dtype != 1) || D < 1 || Hkv < 1 || H % Hkv)
    return cudaErrorInvalidValue;
  if (D > 256) {
    if (dtype == 0)
      return launch_slices<float>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, D, scale, causal,
                                  stream);
    return launch_slices<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, D, scale,
                                        causal, stream);
  }
  if (dtype == 1 && D % 8 == 0 && D <= 128) {
    const int w = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
    auto wgmma_route = [&](auto width) -> cudaError_t {
      return wg::launch_width<decltype(width)::value>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len,
                                                      D, scale, causal, stream);
    };
    if (w == 16) return wgmma_route(std::integral_constant<int, 16>{});
    if (w == 32) return wgmma_route(std::integral_constant<int, 32>{});
    if (w == 64) return wgmma_route(std::integral_constant<int, 64>{});
    return wgmma_route(std::integral_constant<int, 128>{});
  }
  auto fma_route = [&](auto width) -> cudaError_t {
    constexpr int W = decltype(width)::value;
    if (dtype == 0)
      return launch<float, W>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, D, scale, causal,
                              stream);
    return launch<__nv_bfloat16, W>(q, k, v, out, B, H, Hkv, Tq, Tk, kv_len, D, scale, causal,
                                    stream);
  };
  if (D <= 16) return fma_route(std::integral_constant<int, 16>{});
  if (D <= 32) return fma_route(std::integral_constant<int, 32>{});
  if (D <= 64) return fma_route(std::integral_constant<int, 64>{});
  if (D <= 128) return fma_route(std::integral_constant<int, 128>{});
  return fma_route(std::integral_constant<int, 256>{});
}
