// W8A8 dense: per-row dynamic int8 quantization of x, an int8 x int8 ->
// int32 product on the tensor cores, and the rescale / bias / tanh-GELU
// epilogue, with the output written once in its final type.
//
// Replaces the TPU kernel yoho_tpu/ops/w8a8_dense.py::w8a8_dense (body
// _w8a8_kernel). Two kernels, launched back to back by one entry point:
//
// 1. quantize_rows: one block per row of x (M, K) bf16/f32 holds the row
//    in registers (read once), takes its absmax,
//    xs = max(absmax / 127, 1e-12), and writes
//    xq = clip(rint(x / xs), -127, 127) as int8 and xs as f32. A true
//    IEEE division and round-half-to-even, as the reference computes it,
//    so the codes are bit-exact with the plain version.
// 2. w8a8_gemm: a 128 x 128 output tile per block of 16 warps (each
//    32 x 32; two blocks per SM, 32 warps to hide the latency of the loads
//    and MMAs) runs mma.sync m16n8k32 (s8 x s8 -> s32) over K in 128-byte
//    steps, with a three-stage cp.async ring of the xq and w_q tiles in
//    shared memory; the operand fragments come by ldmatrix, every k-slice
//    of a step requested before the first MMA. The epilogue computes
//    ((float)acc * xs) * w_scale + bias, then the optional tanh-GELU, in
//    the reference's order with rounded operations only (no FMA
//    contraction), and stores bf16 or f32.
//
// Why two passes: the per-row scale needs the whole K row before the first
// product, and every column block of the product reads the same rows; a
// separate pass quantizes each row once (it reads M*K*2 bytes and writes
// M*K, a tenth of the kernel's time at whisper widths) instead of once per
// column block.
//
// Layout: x (M, K) row-major; w_q (N, K) int8, K contiguous (nn.Linear's
// layout, the "col" B operand of the MMA); w_scale (N) f32; bias (N) f32 or
// null; out (M, N). M is any size (the ragged row edge is masked), K a
// multiple of 32 up to 8192 and N a multiple of 8 (every whisper width).
//
// Bound on the H100: 2*M*K*N int8 operations over 1,979 TOP/s against the
// bytes of x, w_q and out over 3.35 TB/s; at the large-v3-turbo encoder MLP
// (M = 16 x 1500, K = 1280, N = 5120) 314.6 G operations (0.159 ms) against
// 313.8 MB (0.094 ms): bound by operations. This design reaches about a
// fifth of that peak (PERF.md): the tile shapes tried on the card (warp
// tiles of 32 x 32 to 64 x 64, 8 to 32 warps per SM, 64- to 256-byte
// k-steps) all stay latency-bound on mma.sync; wgmma and TMA are later work.
#include "common.cuh"

namespace {

constexpr int QTHREADS = 128;            // one quantize block per row
constexpr int QCHUNKS = 8;               // 8-value chunks per thread: K <= 8192
constexpr int MAX_K = QTHREADS * QCHUNKS * 8;
constexpr int BM = 128, BN = 128, BK = 128;  // BK in bytes (int8 values)
constexpr int LDS = BK + 16;             // padded row: conflict-free ldmatrix
constexpr int STAGES = 3;                // 3 x 36 KB: two blocks fit an SM
constexpr int THREADS = 512;             // 16 warps as 4 (M) x 4 (N)
constexpr int MIN_BLOCKS = 2;            // per SM: 32 warps, at most 64 registers
constexpr int WM = 32, WN = 32;          // warp tile
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int STAGE_BYTES = (BM + BN) * LDS;
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

template <typename T>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
              int K) {
  __shared__ float red[QTHREADS / 32];
  const int row = blockIdx.x;
  const int nc = K / 8;  // chunks of 8 values; chunk c + QTHREADS * i is this thread's
  const T* xr = x + (size_t)row * K;
  float v[QCHUNKS][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < QCHUNKS; ++i) {
    const int c = threadIdx.x + QTHREADS * i;
    if (c < nc) {
      load8(xr + 8 * c, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  amax = warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < QTHREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(amax / 127.0f, 1e-12f);
  if (threadIdx.x == 0) xs[row] = s;
  int8_t* qr = xq + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < QCHUNKS; ++i) {
    const int c = threadIdx.x + QTHREADS * i;
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

// Four 8x16-byte tiles of shared memory: lane l gives the address of row
// l % 8 of tile l / 8 and receives 32-bit word l % 4 of row l / 4 of each
// tile, the mma.sync fragment layout of an s8 operand.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const unsigned char* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// D (16x8, s32) += A (16x32 s8, row) * B (32x8 s8, col). |acc| stays below
// K * 127^2 (8.3e7 at K = 5120), far from int32 overflow.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying the K bytes [k0, k0 + BK) of rows [r0, r0 + ROWS) of an
// (R, K) int8 matrix into a padded tile; rows >= R and bytes >= K (K is a
// multiple of 32, so a 16-byte chunk is wholly in or out) are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile_async(unsigned char* dst, const int8_t* src, int r0,
                                                int R, int k0, int K) {
  constexpr int CHUNKS = BK / 16;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i - r * CHUNKS;
    const int k = k0 + 16 * c;
    const bool in = r0 + r < R && k < K;
    cp_async16(dst + r * LDS + 16 * c, src + (in ? (size_t)(r0 + r) * K + k : 0), in ? 16 : 0);
  }
}

// The epilogue of one accumulator, in the reference's order:
// ((float)acc * xs) * w_scale + bias, then 0.5*y*(1 + tanh(c*(y + 0.044715*y*y*y))).
__device__ __forceinline__ float epilogue(int acc, float sx, float sw, float b, bool has_bias,
                                          bool gelu) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (has_bias) y = __fadd_rn(y, b);
  if (gelu) {
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
    const float t = tanhf(__fmul_rn(GELU_C, __fadd_rn(y, cube)));
    y = __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, t));
  }
  return y;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
w8a8_gemm(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
          const float* __restrict__ xs, const float* __restrict__ w_scale,
          const float* __restrict__ bias, OutT* __restrict__ out, int M, int N, int K,
          int gelu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_kt = (K + BK - 1) / BK;
  auto stage = [&](int kt) {
    if (kt < n_kt) {
      unsigned char* a_s = smem + (kt % STAGES) * STAGE_BYTES;
      load_tile_async<BM>(a_s, xq, m0, M, kt * BK, K);
      load_tile_async<BN>(a_s + BM * LDS, wq, n0, N, kt * BK, K);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage(s);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread, and tile kt-1 is consumed
    stage(kt + STAGES - 1);       // refills the slot tile kt-1 used
    const unsigned char* a_s = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* b_s = a_s + BM * LDS;
    // Every 32-byte k-slice's fragments are requested before the first
    // slice's MMAs, so the later slices' loads overlap them.
    uint32_t af[BK / 32][MT][4], bf[BK / 32][NT / 2][4];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // A (16 rows x 32 bytes per m-tile): tiles are rows 0-7 / 8-15 at
      // bytes 0-15, then the same rows at bytes 16-31 (a0..a3).
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[ks][mt],
                    a_s + (wm + 16 * mt + (lane % 16)) * LDS + 32 * ks + 16 * (lane / 16));
      // B (8 columns x 32 bytes per n-tile), two n-tiles per load: tiles
      // are columns 0-7 at bytes 0-15 / 16-31, then columns 8-15.
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4(bf[ks][np], b_s + (wn + 16 * np + (lane % 8) + 8 * (lane / 16)) * LDS +
                                    32 * ks + 16 * ((lane / 8) % 2));
    }
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_s8(acc[mt][2 * np], af[ks][mt], bf[ks][np][0], bf[ks][np][1]);
          mma_s8(acc[mt][2 * np + 1], af[ks][mt], bf[ks][np][2], bf[ks][np][3]);
        }
  }
  cp_async_wait<0>();

  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn + 8 * nt + 2 * t4;  // even; col < N implies col + 1 < N
    if (col >= N) continue;
    const float s0 = w_scale[col], s1 = w_scale[col + 1];
    const float b0 = has_bias ? bias[col] : 0.f, b1 = has_bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * mt + g + 8 * h;
        if (row >= M) continue;
        const float sx = xs[row];
        store2(out + (size_t)row * N + col,
               epilogue(acc[mt][nt][2 * h], sx, s0, b0, has_bias, gelu),
               epilogue(acc[mt][nt][2 * h + 1], sx, s1, b1, has_bias, gelu));
      }
    }
  }
}

template <typename InT, typename OutT>
cudaError_t launch(const void* x, const void* wq, const void* w_scale, const void* bias,
                   void* xq, void* xs, void* out, int M, int N, int K, int gelu,
                   cudaStream_t stream) {
  quantize_rows<InT><<<M, QTHREADS, 0, stream>>>(
      static_cast<const InT*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)STAGES * STAGE_BYTES;
  auto kern = w8a8_gemm<OutT>;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K, gelu);
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
  if (M < 1 || N < 8 || K < 32 || K > MAX_K || N % 8 != 0 || K % 32 != 0 ||
      (M + BM - 1) / BM > 65535)
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
