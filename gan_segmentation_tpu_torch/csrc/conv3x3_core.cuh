// Main loop and epilogue of the direct (FFMA) 3x3 convolution kernel of
// bil_conv.cu's bf16 body, and the dtype codes, activation codes and
// dimension check that all three kernels' entry points share.
//
// Layout: x is NHWC, w is HWIO (3, 3, Cin, Cout), stride 1, zero pad 1.
// x and w are f32 or bf16; every product is accumulated in f32.
//
// One block computes a TH x TW tile of output pixels for CT output channels
// of one image (bil_conv.cu: a th x TW tile of each of several images).  The loop over Cin takes CK channels at a time: the block
// stages the (TH+2) x (TW+2) x CK input halo and the 3 x 3 x CK x CT weight
// slice in shared memory (converted to f32), then every thread accumulates
// PX consecutive output columns x CPT output channels in registers.  Pixels
// and channels beyond the tensor's edge are staged as zeros, so ragged
// tiles (H = 4, Cout = 2) need no special case in the loop; the epilogue
// masks the stores.
//
// The products run on the CUDA cores (FFMA).  This core serves the bf16
// calls of kernel 3 alone (on no path); the bf16 calls of kernels 1 and 2
// run the tensor-core implicit GEMM of conv3x3_tc.cuh, every f32 call the
// 3xTF32 one of conv3x3_tf32.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gst {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int PX = 4;    // consecutive output columns per thread
constexpr int CK = 16;   // input channels staged per chunk
constexpr int CPT = 4;   // output channels per thread (one float4 of weights)
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int XS_STRIDE = CK + 1;  // staged pixel stride (see below)
constexpr int PIX_GROUPS = TH * TW / PX;

enum DType { F32 = 0, BF16 = 1 };

__host__ __device__ inline int num_tiles(int h, int w) {
  return ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <int CT>
struct Tile {
  static_assert(CT % CPT == 0, "CT must be a multiple of CPT");
  static constexpr int COUT_GROUPS = CT / CPT;
  static constexpr int THREADS = COUT_GROUPS * PIX_GROUPS;
};

// Where this thread's outputs sit inside the block's tile.  Threads run
// output-channel group fastest, then pixel group, then sample.
struct ThreadSlot {
  int cg;      // output-channel group: channels cg*CPT .. cg*CPT+CPT-1
  int pg;      // pixel group
  int prow;    // tile row of the group
  int pcol;    // first tile column of the group
  int sample;  // which of the block's samples (0 for one image per block)
};

// th: output rows per block (TH unless the block holds several samples).
template <int CT>
__device__ __forceinline__ ThreadSlot thread_slot(int th = TH) {
  const int groups = th * (TW / PX);
  const int rest = threadIdx.x / Tile<CT>::COUT_GROUPS;
  ThreadSlot s;
  s.cg = threadIdx.x % Tile<CT>::COUT_GROUPS;
  s.pg = rest % groups;
  s.sample = rest / groups;
  s.prow = s.pg / (TW / PX);
  s.pcol = (s.pg % (TW / PX)) * PX;
  return s;
}

// acc[p][j] = sum over taps and Cin of x * w for output pixel
// (oy0 + prow, ox0 + pcol + p) of image n0 + s.sample and output channel
// co0 + cg*CPT + j.  Per chunk of CHUNK input channels the block stages the
// (th+2) x (TW+2) input halo of its nb images n0 .. n0+nb-1 into xs
// ([nb][th+2][TW+2][CHUNK+1]) and the 9 x CHUNK x CT taps into ws ONCE for
// all of them.  threads: the block's thread count.
template <typename T, int CT, int CHUNK = CK>
__device__ __forceinline__ void conv3x3_accumulate(
    const T* __restrict__ x, const T* __restrict__ w, int n0, int nb, int th,
    int threads, int h, int wd, int cin, int cout, int oy0, int ox0, int co0,
    const ThreadSlot& s, float (&acc)[PX][CPT], float* __restrict__ xs,
    float* __restrict__ ws) {
  // one float of padding per staged pixel: the 4 pixel groups a warp reads
  // then start 4 * (CHUNK + 1) floats apart, in different banks
  constexpr int XS = CHUNK + 1;
  const int halo_px = (th + 2) * HALO_W;
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

  const float* xsn = nb == 1 ? xs : xs + s.sample * halo_px * XS;
  for (int c0 = 0; c0 < cin; c0 += CHUNK) {
    // input halo of each image, channel-fastest so that neighbouring
    // threads read neighbouring addresses
    for (int sb = 0; sb < nb; ++sb) {
      const T* xn = x + (size_t)(n0 + sb) * h * wd * cin;
      float* xsb = xs + sb * halo_px * XS;
      for (int i = threadIdx.x; i < halo_px * CHUNK; i += threads) {
        const int ci = i % CHUNK;
        const int p = i / CHUNK;
        const int iy = oy0 - 1 + p / HALO_W;
        const int ix = ox0 - 1 + p % HALO_W;
        const int c = c0 + ci;
        float v = 0.f;
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd && c < cin)
          v = to_f32(xn[((size_t)iy * wd + ix) * cin + c]);
        xsb[p * XS + ci] = v;
      }
    }
    // weight slice ws[(tap*CHUNK + ci)*CT + co], output-channel fastest
    for (int i = threadIdx.x; i < 9 * CHUNK * CT; i += threads) {
      const int co = i % CT;
      const int r = i / CT;
      const int ci = r % CHUNK;
      const int tap = r / CHUNK;
      const int c = c0 + ci;
      const int o = co0 + co;
      float v = 0.f;
      if (c < cin && o < cout) v = to_f32(w[((size_t)tap * cin + c) * cout + o]);
      ws[i] = v;
    }
    __syncthreads();

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* xrow = xsn + ((s.prow + ky) * HALO_W + s.pcol + kx) * XS;
        const float* wt = ws + (ky * 3 + kx) * CHUNK * CT + s.cg * CPT;
#pragma unroll
        for (int ci = 0; ci < CHUNK; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + ci * CT);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float xv = xrow[p * XS + ci];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

enum Act { NONE = 0, RELU = 1, LEAKY = 2 };

// y = act(acc + bias) for this thread's outputs of image n, row oy; bias
// may be null.  Stores beyond the tensor's edge are masked.
template <typename T>
__device__ __forceinline__ void store_bias_act(
    const float (&acc)[PX][CPT], const float* __restrict__ bias,
    T* __restrict__ y, int n, int oy, int ox0, int co0, int h, int wd,
    int cout, int act, float slope) {
  float bs[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int co = co0 + j;
    bs[j] = (bias != nullptr && co < cout) ? bias[co] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = ox0 + p;
    if (oy >= h || ox >= wd) continue;
    const size_t pix = ((size_t)n * h + oy) * wd + ox;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = co0 + j;
      if (co >= cout) continue;
      float v = acc[p][j] + bs[j];
      if (act == RELU)
        v = fmaxf(v, 0.f);
      else if (act == LEAKY)
        v = v >= 0.f ? v : slope * v;
      y[pix * cout + co] = from_f32<T>(v);
    }
  }
}

// Output-channel tile width for a layer: wide tiles reuse each staged input
// pixel across more channels; narrow ones waste fewer threads on Cout = 2.
inline int pick_ct(int cout) { return cout >= 32 ? 32 : (cout > 4 ? 16 : 4); }

inline bool valid_dims(int n, int h, int wd, int cin, int cout) {
  return n > 0 && n <= 65535 && h > 0 && wd > 0 && cin > 0 && cout > 0 &&
         (long long)num_tiles(h, wd) < (1LL << 31);
}

}  // namespace gst
