// The per-pixel chain of a synthesis block as two passes (bf16 or f32,
// NHWC), the glue around kernel 1 in models/stylegan.py::StyleBlock:
//
//   pass A  y = lrelu(x + noise * nscale + bias), and per (n, c) the sums
//           of the STORED y (as f32) and of its square;
//   pass B  y = (x - mean) * rsqrt(max(var, 0) + eps) * (ys + 1) + yb,
//           the AdaIN apply after pass A and after kernel 1.
//
// It replaces no Pallas kernel: the JAX package left this chain to XLA,
// which fused it into the convolutions' neighbours on the TPU
// (gan_segmentation_tpu/models/layers.py::AddNoise, Bias, AdaIN).  Written
// as PyTorch ops it took some 70 passes over the activation at 1024^2,
// most of them broadcasts on PyTorch's generic elementwise kernel.
//
// Each value is computed in f32 and rounded once to x's dtype, in the
// order of the plain twins (kernels/adain_fused.py), with the IEEE
// intrinsics (__fadd_rn, __fmul_rn: no contraction into FMAs), so that a
// twin on the CPU gives the same bits.  The statistics are taken from the
// values as stored, so the apply normalizes exactly what was measured.
//
// What bounds them: bytes.  Pass A reads x and the (N, H, W) f32 noise and
// writes y; pass B reads x and writes y.  A thread owns 16 bytes of
// channels (8 bf16 or 4 f32; one channel where C or a pointer does not
// allow it) and walks the pixels of its block's tile, UNROLL pixels' loads
// in flight; the per-channel parameters stay in its registers.  The grid
// is (tiles, N), the tile split made in Python (adain_fused.tile_plan) so
// that every shape from 4^2 x 512 to 1024^2 x 16 fills the card.  Pass A's
// per-(n, tile, c) partial sums are added by a second kernel in a fixed
// order: no atomics, so repeats are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_core.cuh"  // DType
#include "sm90_util.cuh"     // aligned

namespace gst {
namespace {

constexpr int THREADS = 256;  // a block's threads, at least (C / V of them)
constexpr int UNROLL = 4;     // pixels whose loads a thread has in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T: one 16-byte access where V * sizeof(T) == 16
template <typename T, int V>
struct alignas(V * sizeof(T) == 16 ? 16 : alignof(T)) Pack {
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  Pack<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(r.e) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.e[k] = p[k];
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& r) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r.e);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = r.e[k];
  }
}

// The thread's place: channel group cg (channels cg*V ..) and pixel lane
// (of tpx lanes) of a block of G * tpx threads.
struct Place {
  int cg, lane, tpx;
  __device__ Place(int g)
      : cg(threadIdx.x % g), lane(threadIdx.x / g), tpx(blockDim.x / g) {}
};

// Pass A over the pixels [tile * tile_px, ..) of image blockIdx.y; its
// partial sums go to partial[n][tile][2][C].
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : THREADS)
    gst_noise_bias_lrelu_stats_kernel(const T* __restrict__ x,
                                      const float* __restrict__ noise,
                                      const float* __restrict__ nscale,
                                      const float* __restrict__ bias,
                                      T* __restrict__ y,
                                      float* __restrict__ partial, int P,
                                      int C, int tile_px, float leaky) {
  extern __shared__ float red[];  // [2][tpx][C]
  const Place at(C / V);
  const int n = blockIdx.y, tile = blockIdx.x, c0 = at.cg * V;
  float s[V], b[V], s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = nscale[c0 + k];
    b[k] = bias[c0 + k];
    s1[k] = s2[k] = 0.f;
  }
  const size_t base = (size_t)n * P;
  const int p0 = tile * tile_px, p1 = min(P, p0 + tile_px);
  for (int p = p0 + at.lane; p < p1; p += UNROLL * at.tpx) {
    Pack<T, V> v[UNROLL];
    float z[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = p + u * at.tpx;
      if (q < p1) {
        v[u] = load<T, V>(x + (base + q) * C + c0);
        z[u] = __ldg(noise + base + q);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = p + u * at.tpx;
      if (q < p1) {
        Pack<T, V> out;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float t = __fadd_rn(__fadd_rn(to_f32(v[u].e[k]), __fmul_rn(z[u], s[k])),
                              b[k]);
          t = t >= 0.f ? t : __fmul_rn(leaky, t);
          out.e[k] = from_f32<T>(t);
          const float r = to_f32(out.e[k]);
          s1[k] += r;
          s2[k] = fmaf(r, r, s2[k]);
        }
        store<T, V>(y + (base + q) * C + c0, out);
      }
    }
  }
  float* r1 = red + at.lane * C + c0;
  float* r2 = red + (at.tpx + at.lane) * C + c0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    r1[k] = s1[k];
    r2[k] = s2[k];
  }
  __syncthreads();
  float* out = partial + ((size_t)n * gridDim.x + tile) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int l = 0; l < at.tpx; ++l) {  // the lanes in order
      a += red[l * C + c];
      q += red[(at.tpx + l) * C + c];
    }
    out[c] = a;
    out[C + c] = q;
  }
}

// partial[n][tiles][2][C] -> sum[n][C], sumsq[n][C]: block (blockIdx.x,
// n) takes channels [blockIdx.x * cw, ..) in cw lanes; each of THREADS /
// cw stripes adds every stripes-th tile, then the stripes are added in
// order.
__global__ void __launch_bounds__(THREADS)
    gst_in_sums_finish_kernel(const float* __restrict__ partial,
                              float* __restrict__ sum,
                              float* __restrict__ sumsq, int tiles, int C) {
  __shared__ float red[2][THREADS];
  const int n = blockIdx.y, cw = min(C, THREADS), stripes = THREADS / cw;
  const int lane = threadIdx.x % cw, stripe = threadIdx.x / cw;
  const int c = blockIdx.x * cw + lane;
  float a = 0.f, q = 0.f;
  if (stripe < stripes && c < C) {
    const float* src = partial + (size_t)n * tiles * 2 * C + c;
    for (int t = stripe; t < tiles; t += stripes) {
      a += src[(size_t)t * 2 * C];
      q += src[(size_t)t * 2 * C + C];
    }
  }
  red[0][threadIdx.x] = a;
  red[1][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.x < cw && c < C) {
    a = q = 0.f;
    for (int k = 0; k < stripes; ++k) {
      a += red[0][k * cw + lane];
      q += red[1][k * cw + lane];
    }
    sum[(size_t)n * C + c] = a;
    sumsq[(size_t)n * C + c] = q;
  }
}

// Pass B over the pixels [tile * tile_px, ..) of image blockIdx.y.  count >
// 0: mean and var hold the sums of v and v^2 over count pixels.
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : THREADS)
    gst_adain_apply_kernel(const T* __restrict__ x,
                           const float* __restrict__ mean,
                           const float* __restrict__ var,
                           const T* __restrict__ ys, const T* __restrict__ yb,
                           long long ys_stride, long long yb_stride,
                           T* __restrict__ y, int P, int C, int tile_px,
                           float eps, float count) {
  const Place at(C / V);
  const int n = blockIdx.y, tile = blockIdx.x, c0 = at.cg * V;
  float m[V], r[V], g[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = n * C + c0 + k;
    float mu = mean[i], va = var[i];
    if (count > 0.f) {
      mu = __fdiv_rn(mu, count);
      va = __fsub_rn(__fdiv_rn(va, count), __fmul_rn(mu, mu));
    }
    m[k] = mu;
    r[k] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(fmaxf(va, 0.f), eps)));
    g[k] = __fadd_rn(to_f32(ys[n * ys_stride + c0 + k]), 1.f);
    b[k] = to_f32(yb[n * yb_stride + c0 + k]);
  }
  const size_t base = (size_t)n * P;
  const int p0 = tile * tile_px, p1 = min(P, p0 + tile_px);
  for (int p = p0 + at.lane; p < p1; p += UNROLL * at.tpx) {
    Pack<T, V> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = p + u * at.tpx;
      if (q < p1) v[u] = load<T, V>(x + (base + q) * C + c0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = p + u * at.tpx;
      if (q < p1) {
        Pack<T, V> out;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float t = __fmul_rn(
              __fmul_rn(__fsub_rn(to_f32(v[u].e[k]), m[k]), r[k]), g[k]);
          out.e[k] = from_f32<T>(__fadd_rn(t, b[k]));
        }
        store<T, V>(y + (base + q) * C + c0, out);
      }
    }
  }
}

// A block of (C / V) channel groups times max(1, THREADS / (C / V)) pixel
// lanes; 0 threads where C / V passes 1024.
inline int block_threads(int C, int V) {
  const int g = C / V;
  if (g > 1024) return 0;
  return g * (g >= THREADS ? 1 : THREADS / g);
}

// 16 bytes of channels a thread where C, the pointers and the block size
// allow it, else one channel
template <typename T>
int vec_width(int C, const void* a, const void* b) {
  constexpr int V = 16 / sizeof(T);
  return C % V == 0 && C / V <= THREADS && aligned(a, 16) && aligned(b, 16)
             ? V
             : 1;
}

template <typename T>
int launch_stats(const void* x, const float* noise, const float* nscale,
                 const float* bias, void* y, float* partial, float* sum,
                 float* sumsq, int N, int P, int C, int tile_px, int tiles,
                 float leaky, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
  const int V = vec_width<T>(C, x, y);
  const int threads = block_threads(C, V);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, N);
  const size_t smem = 2 * (size_t)(threads / (C / V)) * C * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (V == VW)
    gst_noise_bias_lrelu_stats_kernel<T, VW><<<grid, threads, smem, st>>>(
        xt, noise, nscale, bias, yt, partial, P, C, tile_px, leaky);
  else
    gst_noise_bias_lrelu_stats_kernel<T, 1><<<grid, threads, smem, st>>>(
        xt, noise, nscale, bias, yt, partial, P, C, tile_px, leaky);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int cw = C < THREADS ? C : THREADS;
  gst_in_sums_finish_kernel<<<dim3((C + cw - 1) / cw, N), THREADS, 0, st>>>(
      partial, sum, sumsq, tiles, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const float* mean, const float* var,
                 const void* ys, const void* yb, long long ys_stride,
                 long long yb_stride, void* y, int N, int P, int C,
                 int tile_px, int tiles, float eps, float count,
                 cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
  const int V = vec_width<T>(C, x, y);
  const int threads = block_threads(C, V);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, N);
  const T* xt = static_cast<const T*>(x);
  const T* yst = static_cast<const T*>(ys);
  const T* ybt = static_cast<const T*>(yb);
  T* yt = static_cast<T*>(y);
  if (V == VW)
    gst_adain_apply_kernel<T, VW><<<grid, threads, 0, st>>>(
        xt, mean, var, yst, ybt, ys_stride, yb_stride, yt, P, C, tile_px, eps,
        count);
  else
    gst_adain_apply_kernel<T, 1><<<grid, threads, 0, st>>>(
        xt, mean, var, yst, ybt, ys_stride, yb_stride, yt, P, C, tile_px, eps,
        count);
  return (int)cudaGetLastError();
}

inline bool bad_grid(int N, int P, int C, int tile_px, int tiles) {
  return N < 1 || N > 65535 || P < 1 || C < 1 || tile_px < 1 || tiles < 1 ||
         (long long)tile_px * tiles < P ||
         (long long)(tiles - 1) * tile_px >= P;
}

}  // namespace
}  // namespace gst

extern "C" {

// Pass A.  x, y: (N, P, C) of dtype (0 f32, 1 bf16), P = H * W pixels;
// noise (N, P) f32; nscale, bias (C) f32; partial: (N, tiles, 2, C) f32
// scratch; sum, sumsq: (N, C) f32.  The pixels of image n are cut into
// `tiles` tiles of tile_px (the last one shorter).  Two launches (the pass,
// then the fixed-order sum of its partials).  Returns a CUDA error code.
int gst_noise_bias_lrelu_stats(const void* x, const float* noise,
                               const float* nscale, const float* bias,
                               void* y, float* partial, float* sum,
                               float* sumsq, int n, int p, int c, int tile_px,
                               int tiles, int dtype, float leaky,
                               void* stream) {
  if (gst::bad_grid(n, p, c, tile_px, tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32)
    return gst::launch_stats<float>(x, noise, nscale, bias, y, partial, sum,
                                    sumsq, n, p, c, tile_px, tiles, leaky, st);
  if (dtype == gst::BF16)
    return gst::launch_stats<__nv_bfloat16>(x, noise, nscale, bias, y, partial,
                                            sum, sumsq, n, p, c, tile_px,
                                            tiles, leaky, st);
  return (int)cudaErrorInvalidValue;
}

// Pass B.  x, y: (N, P, C) of dtype; mean, var: (N, C) f32 (with count >
// 0, the sums of v and v^2 over count pixels); ys, yb: row n at
// ys + n * ys_stride, C elements of dtype.  Returns a CUDA error code.
int gst_adain_apply(const void* x, const float* mean, const float* var,
                    const void* ys, const void* yb, long long ys_stride,
                    long long yb_stride, void* y, int n, int p, int c,
                    int tile_px, int tiles, int dtype, float eps, float count,
                    void* stream) {
  if (gst::bad_grid(n, p, c, tile_px, tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32)
    return gst::launch_apply<float>(x, mean, var, ys, yb, ys_stride,
                                    yb_stride, y, n, p, c, tile_px, tiles, eps,
                                    count, st);
  if (dtype == gst::BF16)
    return gst::launch_apply<__nv_bfloat16>(x, mean, var, ys, yb, ys_stride,
                                            yb_stride, y, n, p, c, tile_px,
                                            tiles, eps, count, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
