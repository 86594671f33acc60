// PTX wrappers, index and alignment helpers shared by the tensor-core 3x3
// convolutions (conv3x3_tc.cuh, bf16; conv3x3_tf32.cuh, f32 as 3xTF32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gst {

// n / d by a multiply-high for the small numerators of the index maps
// (exact while n * d < 2^32); m = ceil(2^32 / d).
struct FastDiv {
  uint32_t d, m;
  __host__ __device__ void set(int dv) {
    d = static_cast<uint32_t>(dv);
    m = dv == 1 ? 0u : 0xFFFFFFFFu / d + 1u;
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));
  }
};

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// 16 bytes global -> shared, zero-filled (src-size 0) where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 16-byte matrices; lanes 8j..8j+7 give matrix j's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace gst
