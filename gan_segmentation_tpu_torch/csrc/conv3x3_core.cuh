// Shared main loop of the two direct 3x3 convolution kernels
// (conv_in_stats.cu and small_conv.cu).
//
// Layout: x is NHWC, w is HWIO (3, 3, Cin, Cout), stride 1, zero pad 1.
// x and w are f32 or bf16; every product is accumulated in f32.
//
// One block computes a TH x TW tile of output pixels for CT output channels
// of one image.  The loop over Cin takes CK channels at a time: the block
// stages the (TH+2) x (TW+2) x CK input halo and the 3 x 3 x CK x CT weight
// slice in shared memory (converted to f32), then every thread accumulates
// PX consecutive output columns x CPT output channels in registers.  Pixels
// and channels beyond the tensor's edge are staged as zeros, so ragged
// tiles (H = 4, Cout = 2) need no special case in the loop; the epilogue
// masks the stores.
//
// The products run on the CUDA cores (FFMA).  Tensor-core MMAs (wgmma),
// TMA staging and a multi-stage smem ring are left for later work.
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
// one float of padding per staged pixel: the 4 pixel groups a warp reads
// then start 4 * 17 floats apart, in different banks
constexpr int XS_STRIDE = CK + 1;
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

// Where this thread's outputs sit inside the block's tile.
struct ThreadSlot {
  int cg;    // output-channel group: channels cg*CPT .. cg*CPT+CPT-1
  int pg;    // pixel group
  int prow;  // tile row of the group
  int pcol;  // first tile column of the group
};

template <int CT>
__device__ __forceinline__ ThreadSlot thread_slot() {
  ThreadSlot s;
  s.cg = threadIdx.x % Tile<CT>::COUT_GROUPS;
  s.pg = threadIdx.x / Tile<CT>::COUT_GROUPS;
  s.prow = s.pg / (TW / PX);
  s.pcol = (s.pg % (TW / PX)) * PX;
  return s;
}

// acc[p][j] = sum over taps and Cin of x * w for output pixel
// (oy0 + prow, ox0 + pcol + p) and output channel co0 + cg*CPT + j.
template <typename T, int CT>
__device__ __forceinline__ void conv3x3_accumulate(
    const T* __restrict__ x, const T* __restrict__ w, int n, int h, int wd,
    int cin, int cout, int oy0, int ox0, int co0, const ThreadSlot& s,
    float (&acc)[PX][CPT], float* __restrict__ xs, float* __restrict__ ws) {
  constexpr int THREADS = Tile<CT>::THREADS;
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

  const T* xn = x + (size_t)n * h * wd * cin;
  for (int c0 = 0; c0 < cin; c0 += CK) {
    // input halo, channel-fastest so that neighbouring threads read
    // neighbouring addresses
    for (int i = threadIdx.x; i < HALO_H * HALO_W * CK; i += THREADS) {
      const int ci = i % CK;
      const int p = i / CK;
      const int iy = oy0 - 1 + p / HALO_W;
      const int ix = ox0 - 1 + p % HALO_W;
      const int c = c0 + ci;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd && c < cin)
        v = to_f32(xn[((size_t)iy * wd + ix) * cin + c]);
      xs[p * XS_STRIDE + ci] = v;
    }
    // weight slice ws[(tap*CK + ci)*CT + co], output-channel fastest
    for (int i = threadIdx.x; i < 9 * CK * CT; i += THREADS) {
      const int co = i % CT;
      const int r = i / CT;
      const int ci = r % CK;
      const int tap = r / CK;
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
        const float* xrow =
            xs + ((s.prow + ky) * HALO_W + s.pcol + kx) * XS_STRIDE;
        const float* wt = ws + (ky * 3 + kx) * CK * CT + s.cg * CPT;
#pragma unroll
        for (int ci = 0; ci < CK; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + ci * CT);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float xv = xrow[p * XS_STRIDE + ci];
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

// The block's tile from blockIdx: x = spatial tile, y = Cout tile, z = image.
struct BlockTile {
  int n, oy0, ox0, co0, tile;
};

template <int CT>
__device__ __forceinline__ BlockTile block_tile(int wd) {
  BlockTile b;
  const int tiles_w = (wd + TW - 1) / TW;
  b.tile = blockIdx.x;
  b.oy0 = (blockIdx.x / tiles_w) * TH;
  b.ox0 = (blockIdx.x % tiles_w) * TW;
  b.co0 = blockIdx.y * CT;
  b.n = blockIdx.z;
  return b;
}

// Output-channel tile width for a layer: wide tiles reuse each staged input
// pixel across more channels; narrow ones waste fewer threads on Cout = 2.
inline int pick_ct(int cout) { return cout >= 32 ? 32 : (cout > 4 ? 16 : 4); }

inline bool valid_dims(int n, int h, int wd, int cin, int cout) {
  return n > 0 && n <= 65535 && h > 0 && wd > 0 && cin > 0 && cout > 0 &&
         (long long)num_tiles(h, wd) < (1LL << 31);
}

}  // namespace gst
