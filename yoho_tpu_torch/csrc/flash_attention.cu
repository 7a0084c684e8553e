// Flash attention forward: tiled online-softmax attention that never
// writes the (Tq x Tk) score matrix to device memory.
//
// Replaces the TPU kernel yoho_tpu/ops/flash_attention.py::
// _flash_forward_impl (body _flash_kernel). Each block owns BQ queries of
// one (batch, head) and loops over BK-key tiles of K and V staged in
// shared memory, keeping the running max m, normalizer l and accumulator
// in f32. Scores are dot(q, k) in f32 times `scale`; keys at or past
// kv_len (padded keys; kv_len = Tk by default, and the ragged last tile of
// Tk = 1500, no tile multiple, is masked the same way) take the
// reference's masking value finfo(float32).min, as do keys above the
// diagonal in causal mode. Tiles wholly past kv_len or past the diagonal
// are skipped. P is rounded to the input type before the PV product, as the
// reference does (p.astype(v.dtype)).
//
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), out (B, Tq, H, D) — the
// projections' own layout, read with strides, so no transpose is made.
//
// Bound on the H100: 4 * Tq * Tk * D operations per (batch, head); at
// whisper-small (B=16, H=12, T=1500, D=64) 110.6 GFLOP per call, 0.11 ms
// at the 989 TFLOP/s bf16 tensor-core rate, while q, k, v and out are
// 4 x 36.9 MB, 0.044 ms at 3.35 TB/s: bound by operations. bf16 inputs
// therefore run on the tensor cores: each of 4 warps owns 16 query rows,
// computes S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 operands,
// f32 accumulators) and keeps P in registers between the two products
// (the accumulator layout of S is the operand layout of P); the next K/V
// tile streams into a second shared-memory stage (cp.async) while the
// current one computes, and V's operand fragments come transposed out of
// its row-major tile (ldmatrix.trans). float32
// inputs keep full FP32 arithmetic on FMAs from shared memory (TF32
// would lose digits).
// wgmma and TMA are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int TPR = THREADS / BQ;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Tq, int Tk,
                 int kv_len, float scale, int causal) {
  static_assert(D % TPR == 0, "head dim must be a multiple of 4");
  constexpr int DP = D + 1;       // padded rows: no bank conflicts
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
  const size_t row_stride = (size_t)H * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int j = i / D, d = i - j * D;
    const int qp = q0 + j;
    q_s[j * DP + d] = qp < Tq ? to_f32<T>(q[((size_t)b * Tq + qp) * row_stride + h * D + d]) : 0.f;
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
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      const int kp = k0 + j;
      const size_t off = ((size_t)b * Tk + kp) * row_stride + h * D + d;
      k_s[j * DP + d] = kp < kv_len ? to_f32<T>(k[off]) : 0.f;
      v_s[j * D + d] = kp < kv_len ? to_f32<T>(v[off]) : 0.f;
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
    T* o = out + ((size_t)b * Tq + qpos) * row_stride + h * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[c + TPR * i] = from_f32<T>(acc[i] * inv);
  }
}

// ---------------------------------------------------------------- bf16 mma
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;  // 16 query rows per warp

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16 bf16, row) * B (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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

// Four 8x8 bf16 tiles, transposed: lane l gives the address of row l % 8
// of tile l / 8 and receives element pairs as the col-major B operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Starts copying rows [r0, r0 + ROWS) of a (B, T, H, D) bf16 tensor for one
// head into shared memory (row stride LD), 16 bytes per copy; rows >= T
// (the valid length) are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                size_t row_stride, int r0, int T) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = i - r * CHUNKS;
    const bool in = r0 + r < T;
    cp_async16(dst + r * LD + 8 * c, src + (size_t)(in ? r0 + r : 0) * row_stride + 8 * c,
               in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H,
              int Tq, int Tk, int kv_len, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;        // row stride: conflict-free fragment loads
  constexpr int NT = BK / 8;       // score tiles of 8 keys
  constexpr int DT = D / 8;        // output tiles of 8 dims
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LD
  __nv_bfloat16* kv_s = q_s + BQ * LD;  // 2 stages x (K, V), each BK x LD

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + (size_t)b * Tq * row_stride + h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Tk * row_stride + h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Tk * row_stride + h * D;

  int n_kb = (kv_len + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);
  auto stage_tile = [&](int kb_i) {
    __nv_bfloat16* k_s = kv_s + (kb_i & 1) * 2 * BK * LD;
    load_rows_async<BK, D, LD>(k_s, kb, row_stride, kb_i * BK, kv_len);
    load_rows_async<BK, D, LD>(k_s + BK * LD, vb, row_stride, kb_i * BK, kv_len);
    cp_async_commit();
  };
  load_rows_async<BQ, D, LD>(q_s, qb, row_stride, q0, Tq);
  stage_tile(0);  // the Q rows ride in the first group

  uint32_t qa[D / 16][4];
  const int r_lo = warp * 16 + g;
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // Softmax state in the log2 domain: scores are scaled by scale*log2(e).
  float m[2] = {YOHO_NEG_INF, YOHO_NEG_INF}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};
  const float scale2 = scale * LOG2E;

  for (int kb_i = 0; kb_i < n_kb; ++kb_i) {
    if (kb_i + 1 < n_kb) {
      stage_tile(kb_i + 1);  // prefetch the next tile while this one computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb_i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][0] = lds32(q_s + r_lo * LD + 16 * kk + 2 * t4);
        qa[kk][1] = lds32(q_s + (r_lo + 8) * LD + 16 * kk + 2 * t4);
        qa[kk][2] = lds32(q_s + r_lo * LD + 16 * kk + 2 * t4 + 8);
        qa[kk][3] = lds32(q_s + (r_lo + 8) * LD + 16 * kk + 2 * t4 + 8);
      }
    }
    const __nv_bfloat16* k_s = kv_s + (kb_i & 1) * 2 * BK * LD;
    const __nv_bfloat16* v_s = k_s + BK * LD;
    const int k0 = kb_i * BK;

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = k_s + (8 * nt + g) * LD + 16 * kk + 2 * t4;
        mma_bf16(sc[nt], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    float mx[2] = {YOHO_NEG_INF, YOHO_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + 8 * nt + 2 * t4 + (c & 1);
        const int r = c >> 1;
        const bool valid = kp < kv_len && (!causal || kp <= qpos[r]);
        sc[nt][c] = valid ? sc[nt][c] * scale2 : YOHO_NEG_INF;
        mx[r] = fmaxf(mx[r], sc[nt][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[nt][c] = exp2f(sc[nt][c] - m[c >> 1]);
        sum[c >> 1] += sc[nt][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
    }
    // P (bf16, as the reference's p.astype(v.dtype)) times V; the V
    // fragments come transposed out of the row-major tile by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int mat = lane / 8, row = lane % 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + (16 * kk + (mat & 1) * 8 + row) * LD + 8 * (dt + (mat >> 1)));
        mma_bf16(o[dt], pa, bv[0], bv[1]);
        mma_bf16(o[dt + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)b * Tq + qpos[r]) * row_stride + h * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * dt + 2 * t4) = pair;
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int H,
                       int Tq, int Tk, int kv_len, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)BQ + 4 * (size_t)BK) * (D + 8);
  auto kern = flash_fwd_mma<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Tq, Tk,
      kv_len, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Tq, int Tk, int kv_len, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                                       (size_t)BK * D + (size_t)BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(out), H,
                                        Tq, Tk, kv_len, scale, causal);
  return cudaGetLastError();
}

}  // namespace

YOHO_ERROR_STRING_FN

// dtype: 0 = float32 (FP32 FMAs), 1 = bfloat16 (tensor cores).
// q (B, Tq, H, D); k, v (B, Tk, H, D); keys >= kv_len (1 <= kv_len <= Tk)
// are masked. D is 64, the head dim of every whisper size.
extern "C" int flash_attention_forward(int dtype, const void* q, const void* k,
                                       const void* v, void* out, int B, int H, int Tq,
                                       int Tk, int kv_len, int D, float scale, int causal,
                                       cudaStream_t stream) {
  if (D != 64 || kv_len < 1 || kv_len > Tk) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 64>(q, k, v, out, B, H, Tq, Tk, kv_len, scale, causal, stream);
  if (dtype == 1)
    return launch_mma<64>(q, k, v, out, B, H, Tq, Tk, kv_len, scale, causal, stream);
  return cudaErrorInvalidValue;
}
