// Static per-tensor int8 quantization of an activation: the pass in front
// of every s8 convolution of int8 generation (generate --quant).
//
// Replaces the quantization of the JAX package's int8 convs,
//   gan_segmentation_tpu/ops/quant.py::quantize_act (:125),
// which XLA fused into the convolution's producer on the TPU (no Pallas
// kernel):
//
//   y = clip(round(x * inv), -127, 127) as s8
//
// with x bf16 or f32 (the product in f32), round half to even
// (__float2int_rn, as jnp.round), and inv read from device memory: a CUDA
// graph captured over this launch reads the scale a requantization writes
// there, where a host scalar would be frozen into the graph.
//
// What bounds it: bytes (2 or 4 read and 1 written an element, one
// multiply): each thread moves 8 elements at a time, 16 bytes of bf16 (or
// 32 of f32) in and 8 bytes out, in a grid-stride loop.  Left for later:
// quantizing in the producer's epilogue instead (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_core.cuh"  // DType
#include "sm90_util.cuh"     // aligned

namespace gst {
namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quant(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return static_cast<int8_t>(max(-127, min(127, q)));
}

// vec: n % 8 == 0 and x, y 16-byte aligned: 8 elements a thread and step
template <typename T>
__global__ void __launch_bounds__(256)
    quantize_s8_kernel(const T* x, const float* inv_p, int8_t* y, size_t n,
                       int vec) {
  const float inv = *inv_p;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    for (size_t g = t0; g < n / 8; g += stride) {
      __align__(16) T v[8];
      const uint4* src = reinterpret_cast<const uint4*>(x + g * 8);
#pragma unroll
      for (int k = 0; k < (int)sizeof(T) / 2; ++k)
        reinterpret_cast<uint4*>(v)[k] = src[k];
      union {
        int8_t b[8];
        uint2 u;
      } out;
#pragma unroll
      for (int k = 0; k < 8; ++k) out.b[k] = quant(to_f32(v[k]), inv);
      reinterpret_cast<uint2*>(y)[g] = out.u;
    }
  } else {
    for (size_t i = t0; i < n; i += stride) y[i] = quant(to_f32(x[i]), inv);
  }
}

template <typename T>
int launch_quantize(const void* x, const float* inv, void* y, size_t n,
                    cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* yt = static_cast<int8_t*>(y);
  const int vec = n % 8 == 0 && aligned(x, 16) && aligned(y, 16);
  int dev = 0, sms = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  const size_t work = vec ? n / 8 : n;
  size_t blocks = (work + 255) / 256;
  if (blocks > (size_t)sms * 16) blocks = (size_t)sms * 16;
  if (blocks < 1) blocks = 1;
  quantize_s8_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(xt, inv, yt, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gst

extern "C" {

// x: n elements of dtype (0 f32, 1 bf16); inv: one f32 on the device; y: n
// s8.  Returns a CUDA error code (0 on success).
int gst_quantize_s8(const void* x, const float* inv, void* y, long long n,
                    int dtype, void* stream) {
  if (n < 0 || inv == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32)
    return gst::launch_quantize<float>(x, inv, y, (size_t)n, st);
  if (dtype == gst::BF16)
    return gst::launch_quantize<__nv_bfloat16>(x, inv, y, (size_t)n, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
