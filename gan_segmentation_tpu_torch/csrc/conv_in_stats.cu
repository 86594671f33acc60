// conv3x3 + noise + bias + leaky-relu, with the per-(N, C) instance-norm
// statistics of the result taken in the epilogue.
//
// Replaces the TPU kernel
//   experiments/pallas_archive/conv_in_stats.py::conv3x3_noise_bias_lrelu_instats
// (body _kernel, pl.pallas_call at its line 118).  It is conv_2 of every
// StyleGAN synthesis block (models/stylegan.py): 4^2 x 512 -> 512 up to
// 1024^2 x 16 -> 16 on ffhq.
//
//   y = lrelu(conv3x3(x, w) + noise * nscale + bias, slope)
//   partial[n, tile, 0, c] = sum over the tile's pixels of y  (f32 epilogue)
//   partial[n, tile, 1, c] = sum over the tile's pixels of y^2
//
// y is stored once, in x's dtype; the statistics come from the f32 values
// before that rounding, as in the Pallas kernel.  The Pallas kernel carried
// the sums across a sequential grid axis; GPU blocks have no order, so each
// block writes its own partial sums (reduced over the block in a fixed order,
// no float atomics) and the wrapper reduces the tile axis in a second pass.
// The whole kernel is deterministic.
//
// bf16 (generate, batch 8) runs the tensor-core implicit GEMM of
// conv3x3_tc.cuh.  What bounds it: at 256^2-1024^2 (16-64 channels, 68-284
// flop per byte) the layers sit below the bf16 ridge of ~295 flop/byte and
// are bound by bytes, so the design reads each input pixel from HBM once
// (N spans Cout up to 64), keeps the halo in bf16 and keeps two stages of
// cp.async loads in flight behind the multiply; the noise rides in the same
// ring.  The 512-channel layers at 4^2-32^2 (~2,300 flop/byte) are bound
// by the multiply rate but small: 8-64 blocks of the FFMA tiling for 132
// SMs, so the plan tiles 64 channels x 256 pixels where that still fills
// the card (32^2-256^2), else x 128 pixels, packs several 4^2 / 8^2 images
// into one tile, and splits K over Cin where the grid is still short,
// reducing the splits in a fixed order.  Measured (device time, NVIDIA
// H100 80GB HBM3, 700.00 W): 1024^2 x 16 takes 0.78 ms against an HBM
// floor of 0.17 ms, and the same conv without noise and statistics
// (kernel 2) 0.56 ms, so the bound at 256^2-1024^2 is the SM's work per
// pixel (staging index math, ldmatrix re-reading the halo once per tap,
// the epilogue and the statistics), not HBM: an L2 prefetch two items
// ahead made these layers slower.  The statistics' partial extent is the
// tensor-core plan's
// tile count (kernels/tc_plan.py), one partial per image even where a tile
// spans several images.  Left for later: fusing the following AdaIN (it
// needs the statistics of the whole image, so it would run as the next
// conv's prologue).
//
// f32 stays on the FFMA core of conv3x3_core.cuh: f32 on tensor cores
// means TF32, which would break the f32 contract.
#include "conv3x3_core.cuh"
#include "conv3x3_tc.cuh"

namespace gst {

template <typename T, int CT>
__global__ void __launch_bounds__(Tile<CT>::THREADS)
    conv3x3_in_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ noise,
                            const float* __restrict__ nscale,
                            const float* __restrict__ bias, T* __restrict__ y,
                            float* __restrict__ partial, int h, int wd,
                            int cin, int cout, float slope) {
  __shared__ __align__(16) float xs[HALO_H * HALO_W * XS_STRIDE];
  __shared__ __align__(16) float ws[9 * CK * CT];
  __shared__ float red[2][PIX_GROUPS][CT];

  const BlockTile b = block_tile<CT>(wd);
  const ThreadSlot s = thread_slot<CT>();
  float acc[PX][CPT];
  conv3x3_accumulate<T, CT>(x, w, b.n, 1, TH, Tile<CT>::THREADS, h, wd, cin,
                            cout, b.oy0, b.ox0, b.co0, s, acc, xs, ws);

  const int oy = b.oy0 + s.prow;
  float s1[CPT], s2[CPT], ns[CPT], bs[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int co = b.co0 + s.cg * CPT + j;
    s1[j] = 0.f;
    s2[j] = 0.f;
    ns[j] = co < cout ? nscale[co] : 0.f;
    bs[j] = co < cout ? bias[co] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = b.ox0 + s.pcol + p;
    if (oy >= h || ox >= wd) continue;
    const size_t pix = ((size_t)b.n * h + oy) * wd + ox;
    const float nz = noise[pix];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = b.co0 + s.cg * CPT + j;
      if (co >= cout) continue;
      float v = acc[p][j] + nz * ns[j] + bs[j];
      v = v >= 0.f ? v : slope * v;
      y[pix * cout + co] = from_f32<T>(v);
      s1[j] += v;
      s2[j] += v * v;
    }
  }

  // block reduction over the pixel groups, in a fixed order
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    red[0][s.pg][s.cg * CPT + j] = s1[j];
    red[1][s.pg][s.cg * CPT + j] = s2[j];
  }
  __syncthreads();
  const int tiles = gridDim.x;
  for (int i = threadIdx.x; i < 2 * CT; i += Tile<CT>::THREADS) {
    const int k = i / CT;
    const int c = i % CT;
    const int co = b.co0 + c;
    if (co >= cout) continue;
    float t = 0.f;
    for (int g = 0; g < PIX_GROUPS; ++g) t += red[k][g][c];
    partial[(((size_t)b.n * tiles + b.tile) * 2 + k) * cout + co] = t;
  }
}

template <typename T, int CT>
static void launch(const void* x, const void* w, const float* noise,
                   const float* nscale, const float* bias, void* y,
                   float* partial, int n, int h, int wd, int cin, int cout,
                   float slope, cudaStream_t stream) {
  const dim3 grid(num_tiles(h, wd), (cout + CT - 1) / CT, n);
  conv3x3_in_stats_kernel<T, CT><<<grid, Tile<CT>::THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), noise, nscale, bias,
      static_cast<T*>(y), partial, h, wd, cin, cout, slope);
}

template <typename T>
static void dispatch_ct(const void* x, const void* w, const float* noise,
                        const float* nscale, const float* bias, void* y,
                        float* partial, int n, int h, int wd, int cin,
                        int cout, float slope, cudaStream_t stream) {
  switch (pick_ct(cout)) {
    case 32:
      launch<T, 32>(x, w, noise, nscale, bias, y, partial, n, h, wd, cin,
                    cout, slope, stream);
      break;
    case 16:
      launch<T, 16>(x, w, noise, nscale, bias, y, partial, n, h, wd, cin,
                    cout, slope, stream);
      break;
    default:
      launch<T, 4>(x, w, noise, nscale, bias, y, partial, n, h, wd, cin, cout,
                   slope, stream);
  }
}

}  // namespace gst

extern "C" {

// Number of spatial tiles of the f32 (FFMA) kernel, i.e. the extent of the
// partial-sum axis the caller allocates for f32: partial is
// (n, gst_conv3x3_num_tiles(h, w), 2, cout).  For bf16 the extent is the
// plan's tile count (kernels/tc_plan.py: Plan.tiles).
int gst_conv3x3_num_tiles(int h, int w) { return gst::num_tiles(h, w); }

// f32 runs the FFMA core (ws and plan unused); bf16 runs the tensor-core
// kernel with plan = int[9] from kernels/tc_plan.py and ws its split-K
// workspace (null without a split).
// Returns cudaGetLastError() after the launch (0 on success).
int gst_conv3x3_in_stats(const void* x, const void* w, const float* noise,
                         const float* nscale, const float* bias, void* y,
                         float* partial, float* ws, int n, int h, int wd,
                         int cin, int cout, int dtype, float slope,
                         const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32) {
    gst::dispatch_ct<float>(x, w, noise, nscale, bias, y, partial, n, h, wd,
                            cin, cout, slope, st);
    return (int)cudaGetLastError();
  }
  if (dtype != gst::BF16) return (int)cudaErrorInvalidValue;
  gst::tc::Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.noise = noise;
  a.nscale = nscale;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = partial;
  a.ws = ws;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.act = gst::tc::LEAKY;
  a.slope = slope;
  return gst::tc::run(a, plan, st);
}

}  // extern "C"
