// W8A8 dense: per-row dynamic int8 quantization of x, an int8 x int8 ->
// int32 product on the tensor cores, and the rescale / bias / tanh-GELU
// epilogue, with the output written once in its final type.
//
// Replaces the TPU kernel yoho_tpu/ops/w8a8_dense.py::w8a8_dense (body
// _w8a8_kernel). Two kernels, launched back to back by one entry point:
//
// 1. quantize_rows: warps hold rows of x (M, K) bf16/f32 in registers
//    (read once), 32 values a thread: up to 4096 values, as few warps per
//    row as hold it, 8 warps a block; longer rows, a block of 8 warps per
//    row. They take the row's absmax, xs = max(absmax / 127, 1e-12),
//    and write xq = clip(rint(x / xs), -127, 127) as int8 and xs as f32. A true
//    IEEE division and round-half-to-even, as the reference computes it,
//    so the codes are bit-exact with the plain version. The per-row scale
//    needs the whole K row before the first product, and every column
//    block of the product reads the same rows: a separate pass quantizes
//    each row once (it moves M*K*3 bytes) instead of once per column block.
// 2. w8a8_gemm: persistent and warp-specialized for Hopper. One block per
//    SM walks the 128 x 128 output tiles in row-major order (the tiles of
//    one 128-row band of xq are neighbours, so a band is read from memory
//    once and from L2 after; the int8 weights, at most 6.6 MB at whisper
//    widths, stay in L2). A producer warp issues TMA loads of xq and w_q
//    tiles (128 rows x 128 bytes of K each, K-major, 128-byte swizzle;
//    nn.Linear's (N, K) layout is the K-major B operand s8 wgmma takes)
//    into a ring of STAGES mbarrier-guarded stages. NWG = 2 consumer
//    warpgroups (setmaxnreg: they hold the registers the producer gives
//    up) run wgmma m64n128k32 .s32.s8.s8, two per 32 bytes of K, with
//    int32 accumulators in registers, exact as the reference's integer
//    product. PINGPONG = 1: each warpgroup owns whole tiles, taking the
//    block's tiles in turn, and their product loops take turns on order
//    barriers, so one runs its epilogue while the other's products use
//    the tensor cores. PINGPONG = 0 (cooperative): the warpgroups share
//    one tile of NWG x 128 rows, epilogue after the products.
//    The epilogue computes ((float)acc * xs) * w_scale + bias, then the
//    optional tanh-GELU, in the reference's order with rounded operations
//    only (no FMA contraction) and the accurate tanhf, so the output is
//    bit-identical to the plain version. Those are long dependent chains
//    per output, and with a whole tile's 128 accumulators per thread live
//    the compiler (168 registers for the kernel's 384 threads) ran them
//    one at a time; so each 64-row half tile is parked in shared memory as
//    int32 first, and the math runs from there, four columns per 16-byte
//    read, with registers to spare for independent chains. The outputs
//    land in the output's TMA boxes (128-byte swizzle: f32 in place of the
//    int32, bf16 beside it) and TMA stores write them, clipping the ragged
//    M and N edges. A K tail shorter than a stage reads TMA's zero fill,
//    which adds nothing to an integer sum.
//
// Layout: x (M, K) row-major; w_q (N, K) int8, K contiguous; w_scale (N)
// f32; bias (N) f32 or null; out (M, N). M is any size, K a multiple of 32
// up to 8192 and N a multiple of 8 (every whisper width): every row is then
// a multiple of 16 bytes, so TMA takes every shape of the contract.
//
// Bound on the H100: 2*M*K*N int8 operations over 1,979 TOP/s against the
// bytes of x, w_q and out over 3.35 TB/s; at the large-v3-turbo encoder MLP
// (M = 16 x 1500, K = 1280, N = 5120) 314.6 G operations (0.159 ms) against
// 313.8 MB (0.094 ms): bound by operations. The epilogue is a second limit
// of the same size: about 30 rounded instructions per output (tanhf half
// of them), 123 M outputs, about 0.12-0.15 ms of the SMs' issue slots; the
// ping-pong schedule overlaps it with the products. At K = 1280 a tile's
// GELU epilogue still outlasts the next tile's products, so that shape runs
// at the epilogue's pace.
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int MAX_K = 8192;  // 8 warps x 32 values a thread
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)

// Eight consecutive values of a row as f32 (16-byte aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// G warps take one row of x (each thread up to CH chunks of 8 values), and
// a block takes ROWS rows.
template <typename T, int G, int CH, int ROWS>
__global__ void __launch_bounds__(32 * G * ROWS)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int M,
              int K) {
  __shared__ float red[G * ROWS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp / G;
  const int t = (warp % G) * 32 + lane, nt = 32 * G;  // this thread among its row's
  const int nc = row < M ? K / 8 : 0;  // chunks of 8 values; chunk t + nt * i is this thread's
  const T* xr = x + (size_t)row * K;
  float v[CH][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + nt * i;
    if (c < nc) {
      load8(xr + 8 * c, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  amax = warp_max(amax);
  if (G > 1) {  // the same for the whole block
    if (lane == 0) red[warp] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < G; ++w) amax = fmaxf(amax, red[warp / G * G + w]);
  }
  const float s = fmaxf(amax / 127.0f, 1e-12f);
  if (t == 0 && row < M) xs[row] = s;
  int8_t* qr = xq + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + nt * i;
    if (c < nc) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = min(127, max(-127, __float2int_rn(__fdiv_rn(v[i][j], s))));
        w[j / 4] |= (uint32_t)(q & 0xff) << (8 * (j % 4));
      }
      *reinterpret_cast<uint2*>(qr + 8 * c) = make_uint2(w[0], w[1]);
    }
  }
}

// ------------------------------------------------------------------- GEMM
constexpr int PINGPONG = 1;   // 1: a warpgroup per tile, in turns; 0: both on one tile
constexpr int STAGES = 4;     // ring depth (2 fit beside the cooperative tile)
constexpr int NWG = 2;        // consumer warpgroups
constexpr int BM = 128;       // rows of a warpgroup's tile
constexpr int MH = BM / 64;   // its m64 products per k-slice (accumulator halves)
constexpr int BN = 128;       // columns: the wgmma n
constexpr int BK = 128;       // bytes of K per stage: one 128-byte swizzled row
constexpr int A_ROWS = PINGPONG ? BM : NWG * BM;  // xq rows per stage (and per tile)
constexpr int A_BYTES = A_ROWS * BK;
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr int BOX = 64 * 128;                 // one 64-row x 128-byte box of output
constexpr int ACC_BYTES = 64 * BN * 4;        // a 64 x BN half tile of int32 (or f32)
constexpr int OUT16_BYTES = 64 * BN * 2;      // the same half tile in bf16
constexpr int EPI_BYTES = ACC_BYTES + OUT16_BYTES;  // per consumer warpgroup
constexpr int EPI_OFF = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = EPI_OFF + NWG * EPI_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 8 * (2 * STAGES + NWG) + 1024;  // + alignment slack
constexpr int THREADS = 128 * (NWG + 1);  // consumers: warpgroups 0 .. NWG-1; producer: NWG
constexpr int PRODUCER_REGS = 40;
// setmaxnreg moves registers within the block's launch allocation: what the
// producer warpgroup gives up, split among the consumers (a multiple of 8).
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int CONSUMER_REGS = (LAUNCH_REGS * (NWG + 1) - PRODUCER_REGS) / NWG / 8 * 8 > 240
                                  ? 240 : (LAUNCH_REGS * (NWG + 1) - PRODUCER_REGS) / NWG / 8 * 8;
constexpr int EPI_ROWS = 2;   // rows of a half tile whose epilogues run side by side
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(PRODUCER_REGS + CONSUMER_REGS * NWG <= LAUNCH_REGS * (NWG + 1),
              "setmaxnreg stays within the block's registers");

// D (64 x 128, s32) (+)= A (64 x 32 s8) * B^T (128 x 32 s8), both from
// shared memory, K-major; accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The epilogue of NV accumulators, in the reference's order:
// ((float)acc * xs) * w_scale + bias, then 0.5*y*(1 + tanh(c*(y + 0.044715*y*y*y))),
// written one step at a time across all NV, so that their independent
// chains sit side by side.
template <bool GELU, int NV>
__device__ __forceinline__ void epilogue(float (&y)[NV], const int (&acc)[NV],
                                         const float (&sx)[NV], const float (&sw)[NV],
                                         const float (&b)[NV], bool has_bias) {
#pragma unroll
  for (int i = 0; i < NV; ++i) y[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sx[i]), sw[i]);
  if (has_bias)
#pragma unroll
    for (int i = 0; i < NV; ++i) y[i] = __fadd_rn(y[i], b[i]);
  if (GELU) {
    float t[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y[i]), y[i]), y[i]);
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = tanhf(__fmul_rn(GELU_C, __fadd_rn(y[i], t[i])));
#pragma unroll
    for (int i = 0; i < NV; ++i) y[i] = __fmul_rn(__fmul_rn(0.5f, y[i]), __fadd_rn(1.0f, t[i]));
  }
}

// Four consecutive outputs of one row, written where the output tile's TMA
// boxes hold them: f32 in place of their accumulators, bf16 at `bf16_at`.
template <typename OutT>
__device__ __forceinline__ void store4(unsigned char* acc_at, unsigned char* bf16_at, float4 y) {
  if constexpr (sizeof(OutT) == 4) {
    *reinterpret_cast<float4*>(acc_at) = y;
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y), hi = __floats2bfloat162_rn(y.z, y.w);
    *reinterpret_cast<uint2*>(bf16_at) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
}

// Byte offset of byte `byte` of row `row` (< 64) across a run of 64-row x
// 128-byte boxes in the 128-byte swizzle: 16-byte chunk k of a row of a box
// sits at chunk k ^ (row % 8), which the TMA store undoes.
__device__ __forceinline__ int sw128(int row, int byte) {
  return (byte >> 7) * BOX + row * 128 + ((((byte & 127) >> 4) ^ (row & 7)) << 4) + (byte & 15);
}

// Synchronizes the 128 threads of one warpgroup on named barrier `id`.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Accumulator layout of a wgmma m64nN tile, per thread (warp w of the
// warpgroup, lane = 4 g + t4): element i sits in row 16 w + g + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 t4 + i % 2.
template <typename OutT, bool GELU>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_gemm(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ xs,
          const float* __restrict__ w_scale, const float* __restrict__ bias, int M, int N,
          int K) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t full0 = base + BAR_OFF;          // STAGES barriers: a stage landed
  const uint32_t empty0 = full0 + 8 * STAGES;     // STAGES barriers: its consumers are done
  const uint32_t order0 = empty0 + 8 * STAGES;    // NWG barriers: warpgroup i may start its products

  const int n_tn = (N + BN - 1) / BN;
  const int n_items = (M + A_ROWS - 1) / A_ROWS * n_tn;  // tiles, row-major
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, (PINGPONG ? 1 : NWG) * 128);  // every consumer thread arrives
    }
    for (int i = 0; i < NWG; ++i) mbar_init(order0 + 8 * i, 128);
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == NWG) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * NWG) {
      int s = 0;  // stages loaded so far: the ring position
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int m0 = item / n_tn * A_ROWS, n0 = item % n_tn * BN;
        for (int kb = 0; kb < n_k; ++kb, ++s) {
          const int st = s % STAGES;
          mbar_wait(empty0 + 8 * st, ((s / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st, dst = base + st * STAGE_BYTES;
          mbar_expect_tx(full, STAGE_BYTES);
          tma_load(dst, &tm_x, full, kb * BK, m0);
          tma_load(dst + A_BYTES, &tm_w, full, kb * BK, n0);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool has_bias = bias != nullptr;
    const uint32_t a_off = PINGPONG ? 0 : wgi * BM * BK;  // this warpgroup's rows of a stage
    unsigned char* acc_s = smem + EPI_OFF + wgi * EPI_BYTES;  // a half tile of int32 / f32
    unsigned char* out16_s = acc_s + ACC_BYTES;               // the half tile in bf16
    const uint32_t store_a = base + EPI_OFF + wgi * EPI_BYTES + (sizeof(OutT) == 4 ? 0 : ACC_BYTES);
    int acc[MH][64];
    auto fence_acc = [&] {
#pragma unroll
      for (int h = 0; h < MH; ++h) fence_regs(acc[h]);
    };

    // The block's j-th tile is loaded into stages j * n_k ... (j + 1) * n_k - 1.
    // In ping-pong the warpgroups' product loops take turns (order barriers:
    // each starts its loop once the warpgroup before it has passed the last
    // stage wait of the block's tile before). Besides keeping the tensor cores to one
    // warpgroup at a time, this keeps every stage wait unambiguous: a
    // warpgroup only waits on a stage whose ring slot has completed the
    // phase before, so the parity it waits for cannot be an older phase's.
    for (int j = PINGPONG ? wgi : 0, t = 0;; j += PINGPONG ? NWG : 1, ++t) {
      const int item = blockIdx.x + j * gridDim.x;
      if (item >= n_items) break;
      if (PINGPONG && (wgi > 0 || t > 0))
        mbar_wait(order0 + 8 * wgi, (wgi > 0 ? t : t - 1) & 1);
      const int m0 = item / n_tn * A_ROWS + (PINGPONG ? 0 : wgi * BM), n0 = item % n_tn * BN;
      const int s0 = j * n_k;
      // The epilogue's scales and bias, loaded before the products so that
      // their latency hides behind them. In the epilogue's second pass warp w
      // takes rows 4 it + w of each half tile and lane l its columns 4 l ...
      // 4 l + 3: one row of 512 bytes of int32 per warp.
      const int col4 = n0 + 4 * lane;  // a multiple of 4; col4 < N implies col4 + 3 < N
      float4 sw = make_float4(0.f, 0.f, 0.f, 0.f), b = sw;
      if (col4 < N) {
        sw = *reinterpret_cast<const float4*>(w_scale + col4);
        if (has_bias) b = *reinterpret_cast<const float4*>(bias + col4);
      }
      float sx[MH][16];
#pragma unroll
      for (int h = 0; h < MH; ++h)
#pragma unroll
        for (int it = 0; it < 16; ++it) {
          const int row = m0 + 64 * h + 4 * it + warp;
          sx[h][it] = row < M ? xs[row] : 0.f;
        }

      // Stage s: 4 k-slices of 32 bytes (2 descriptor units apart), each
      // two m64 products (the second half of A is 64 rows = 8 KB further).
      auto issue = [&](int s, int kb) {
        const int st = s % STAGES;
        const uint32_t stage = base + st * STAGE_BYTES;
        const uint64_t db = desc_sw128(stage + A_BYTES, 1, 64);
        mbar_wait(full0 + 8 * st, (s / STAGES) & 1);
        fence_acc();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int h = 0; h < MH; ++h)
            wgmma_s8_m64n128k32(acc[h], desc_sw128(stage + a_off + h * 64 * BK, 1, 64) + 2 * kk,
                                db + 2 * kk, kb > 0 || kk > 0);
        wgmma_commit();
      };
      // One stage's products stay in flight while the next stage's go out;
      // a stage is released once its products are done.
      issue(s0, 0);
      for (int kb = 1; kb < n_k; ++kb) {
        issue(s0 + kb, kb);
        wgmma_wait<1>();
        fence_acc();
        mbar_arrive(empty0 + 8 * ((s0 + kb - 1) % STAGES));
      }
      if (PINGPONG) mbar_arrive(order0 + 8 * ((wgi + 1) % NWG));  // the next may start its loop
      wgmma_wait<0>();
      fence_acc();
      mbar_arrive(empty0 + 8 * ((s0 + n_k - 1) % STAGES));

      // Epilogue, one 64-row half tile at a time, through shared memory:
      // the accumulators are parked there as int32 (in the f32 output's
      // TMA boxes: 64 rows x 128 bytes, 128-byte swizzle), then each thread
      // takes 16-byte runs of 4 columns back, computes their outputs with
      // registers to spare for independent chains (the rounded rescale and
      // tanhf are long dependent chains; with the whole tile's accumulators
      // live they ran one at a time), and writes them where the TMA store
      // reads them: f32 in place, bf16 into its own boxes.
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        // f32 is written in place: the last stores must have read the buffer.
        if (sizeof(OutT) == 4 && tid == 0) tma_store_wait_read();
        warpgroup_sync(1 + wgi);
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int off = sw128(16 * warp + g + 8 * r, (8 * c + 2 * t4) * 4);
            *reinterpret_cast<int2*>(acc_s + off) =
                make_int2(acc[h][4 * c + 2 * r], acc[h][4 * c + 2 * r + 1]);
          }
        if (sizeof(OutT) == 2 && tid == 0) tma_store_wait_read();
        warpgroup_sync(1 + wgi);
#pragma unroll
        for (int it = 0; it < 16; it += EPI_ROWS) {
          constexpr int NV = 4 * EPI_ROWS;
          int a[NV];
          float sxv[NV], swv[NV], bv[NV], y[NV];
#pragma unroll
          for (int u = 0; u < EPI_ROWS; ++u) {
            const int4 v =
                *reinterpret_cast<const int4*>(acc_s + sw128(4 * (it + u) + warp, 16 * lane));
            const int av[4] = {v.x, v.y, v.z, v.w};
            const float swu[4] = {sw.x, sw.y, sw.z, sw.w}, bu[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a[4 * u + e] = av[e];
              sxv[4 * u + e] = sx[h][it + u];
              swv[4 * u + e] = swu[e];
              bv[4 * u + e] = bu[e];
            }
          }
          epilogue<GELU>(y, a, sxv, swv, bv, has_bias);
#pragma unroll
          for (int u = 0; u < EPI_ROWS; ++u) {
            const int row = 4 * (it + u) + warp;
            store4<OutT>(acc_s + sw128(row, 16 * lane), out16_s + sw128(row, 8 * lane),
                         make_float4(y[4 * u], y[4 * u + 1], y[4 * u + 2], y[4 * u + 3]));
          }
        }
        fence_proxy_async();  // the writes above, before the TMA engine reads them
        warpgroup_sync(1 + wgi);
        if (tid == 0) {
          constexpr int COLS = 128 / (int)sizeof(OutT);  // columns of one box
#pragma unroll
          for (int bx = 0; bx < BN / COLS; ++bx)
            tma_store(&tm_out, store_a + bx * BOX, n0 + bx * COLS, m0 + 64 * h);
          tma_store_commit();
        }
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

template <typename OutT>
bool out_map(CUtensorMap* map, void* out, int M, int N);
template <>
bool out_map<__nv_bfloat16>(CUtensorMap* map, void* out, int M, int N) {
  const uint64_t dims[2] = {(uint64_t)N, (uint64_t)M}, strides[1] = {(uint64_t)N * 2};
  const uint32_t box[2] = {64, 64};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}
template <>
bool out_map<float>(CUtensorMap* map, void* out, int M, int N) {
  const uint64_t dims[2] = {(uint64_t)N, (uint64_t)M}, strides[1] = {(uint64_t)N * 4};
  const uint32_t box[2] = {32, 64};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// An (R, K) int8 matrix as a 2-D map of boxes of `rows` rows x BK bytes.
bool int8_map(CUtensorMap* map, const void* ptr, int R, int K, int rows) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)R}, strides[1] = {(uint64_t)K};
  const uint32_t box[2] = {(uint32_t)BK, (uint32_t)rows};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename InT, typename OutT>
cudaError_t launch(const void* x, const void* wq, const void* w_scale, const void* bias,
                   void* xq, void* xs, void* out, int M, int N, int K, int gelu,
                   cudaStream_t stream) {
  const InT* xt = static_cast<const InT*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  // 32 values a thread: as few warps per row as hold it, 8 warps a block;
  // rows longer than 4096 values, 8 warps a row, a block each.
  if (K <= 1024)
    quantize_rows<InT, 1, 4, 8><<<(M + 7) / 8, 256, 0, stream>>>(xt, q, s, M, K);
  else if (K <= 2048)
    quantize_rows<InT, 2, 4, 4><<<(M + 3) / 4, 256, 0, stream>>>(xt, q, s, M, K);
  else if (K <= 3072)
    quantize_rows<InT, 3, 4, 2><<<(M + 1) / 2, 192, 0, stream>>>(xt, q, s, M, K);
  else if (K <= 4096)
    quantize_rows<InT, 4, 4, 2><<<(M + 1) / 2, 256, 0, stream>>>(xt, q, s, M, K);
  else
    quantize_rows<InT, 8, 4, 1><<<M, 256, 0, stream>>>(xt, q, s, M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mw, mo;
  if (!int8_map(&mx, xq, M, K, A_ROWS) || !int8_map(&mw, wq, N, K, BN) ||
      !out_map<OutT>(&mo, out, M, N))
    return cudaErrorInvalidValue;
  auto kern = gelu ? w8a8_gemm<OutT, true> : w8a8_gemm<OutT, false>;
  err = allow_smem(kern, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int n_items = (M + A_ROWS - 1) / A_ROWS * ((N + BN - 1) / BN);
  kern<<<min(n_items, sm_count()), THREADS, SMEM_BYTES, stream>>>(
      mx, mw, mo, static_cast<const float*>(xs), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), M, N, K);
  return cudaGetLastError();
}

}  // namespace

YOHO_ERROR_STRING_FN

// x_dtype, out_dtype: 0 = float32, 1 = bfloat16. x (M, K); w_q (N, K) int8;
// w_scale (N) f32; bias (N) f32 or null; xq (M, K) int8 and xs (M) f32 are
// scratch that the caller allocates; out (M, N). gelu: 1 = tanh-GELU.
// K % 32 == 0 and K <= 8192, N % 8 == 0, every pointer 16-byte aligned.
extern "C" int w8a8_dense(int x_dtype, int out_dtype, const void* x, const void* w_q,
                          const void* w_scale, const void* bias, void* xq, void* xs,
                          void* out, int M, int N, int K, int gelu, cudaStream_t stream) {
  if (M < 1 || N < 8 || K < 32 || K > MAX_K || N % 8 != 0 || K % 32 != 0)
    return cudaErrorInvalidValue;
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w_q, w_scale, bias, xq, xs, out, M, N, K,
                                                gelu, stream);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w_q, w_scale, bias, xq, xs, out, M, N, K, gelu,
                                        stream);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w_q, w_scale, bias, xq, xs, out, M, N, K, gelu,
                                        stream);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, w_q, w_scale, bias, xq, xs, out, M, N, K, gelu, stream);
  return cudaErrorInvalidValue;
}
