// Tensor Memory Accelerator (TMA) helpers shared by the kernels: encoding
// tensor maps on the host, and tile loads and stores on the device.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <string.h>

#include <mutex>

#include "common.cuh"

// cuTensorMapEncodeTiled is a CUDA driver API function; the runtime hands out
// its address (cudaGetDriverEntryPoint), so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled tensor map of up to 4 dims (innermost first; strides in bytes of
// dims 1..rank-1), zero fill out of bounds. Maps depend only on these
// arguments, so the last 256 are kept (the decode loop reads the same
// cross K/V and caches at every step). Returns false when the map cannot
// be made (unaligned base or stride, no CUDA driver entry point).
static bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                       const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return false;
  uint64_t key[16] = {reinterpret_cast<uintptr_t>(ptr), (uint64_t)type, (uint64_t)rank,
                      (uint64_t)swizzle};
  for (int i = 0; i < rank; ++i) key[4 + i] = dims[i], key[8 + i] = box[i];
  for (int i = 0; i + 1 < rank; ++i) key[12 + i] = strides[i];
  struct Entry {
    uint64_t key[16];
    CUtensorMap map;
    bool used;
  };
  static Entry cache[256];
  static std::mutex lock;
  uint64_t h = 1469598103934665603ull;
  for (uint64_t k : key) h = (h ^ k) * 1099511628211ull;
  std::lock_guard<std::mutex> guard(lock);
  Entry& e = cache[h & 255];
  if (e.used && memcmp(e.key, key, sizeof(key)) == 0) {
    *map = e.map;
    return true;
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[4], s[3];
  cuuint32_t b[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = dims[i], b[i] = box[i];
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  if (fn(map, type, rank, const_cast<void*>(ptr), d, s, b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(e.key, key, sizeof(key));
  e.map = *map;
  e.used = true;
  return true;
}

// Loads one box of a tensor map into shared memory; the bytes report to
// the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Stores one box of shared memory to a 2-D tensor map (the part of the box
// past the tensor's edge is not written); tma_store_commit closes this
// thread's group of such stores.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk stores have read their shared memory (the
// buffer may be written again), or until they have completed.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
