// Direct 3x3 convolution with a fused bias and relu / leaky-relu epilogue.
//
// Replaces the TPU kernel
//   experiments/pallas_archive/small_conv.py::conv3x3_small
// (body _kernel, pl.pallas_call at its line 84).  In the port it runs every
// 3x3 conv of the eval-mode segmentation decoder (models/decoder.py) with
// batch norm folded into w and b: cvt_i_conv (Cin 512..16 -> 32 or 16),
// main_i conv_0 / conv_1 (64 -> 32, 32 -> 32, up to 64 -> 16 and 16 -> 16
// at 1024^2), leaky 0.2, and the final main_8_conv (32 -> 2, no activation).
//
//   y = act(conv3x3(x, w) + b),  act in {none, relu, leaky(slope)}
//
// accumulated in f32, stored once in x's dtype.  Pallas required
// H % tile_h == 0; here ragged tiles are masked, so H = 4 and Cout = 2 run.
//
// bf16 (generate, batch 8) runs the tensor-core implicit GEMM of
// conv3x3_tc.cuh.  What bounds it: from 256^2 up the decoder's layers carry
// 16-64 channels at 17-192 flop per byte (main_8_conv 32 -> 2 at 17,
// main_7.conv_0 64 -> 16 at 115), below the bf16 ridge of ~295, so they are
// bound by bytes: the design reads each input pixel from HBM once (N spans
// all of Cout, up to 64), keeps the halo in bf16, and keeps two stages of
// cp.async loads in flight behind the multiply.  cvt_0..3 (Cin 512 at
// 4^2-32^2) have few output pixels: there the bound is the block count,
// and the plan splits K over Cin to fill the SMs.  Measured (device time,
// NVIDIA H100 80GB HBM3, 700.00 W): the 1024^2 convs take 0.56-1.18 ms
// against HBM floors of 0.16-0.40 ms; the bound is the SM's work per pixel
// (staging index math, ldmatrix re-reading the halo once per tap, the
// epilogue), not HBM latency: an L2 bulk prefetch two items ahead made them
// 5-10% slower.
//
// f32 (evaluate at batch 1, train's cvt_0..4 forward) stays on the FFMA
// core of conv3x3_core.cuh: one TF32 pass would break the f32 contract
// (card = CPU to six decimals in the train checks), and the 3xTF32 split
// that keeps it (conv3x3_tf32.cuh, kernel 3) is not used here yet.
#include "conv3x3_core.cuh"
#include "conv3x3_tc.cuh"

namespace gst {

template <typename T, int CT>
__global__ void __launch_bounds__(Tile<CT>::THREADS)
    conv3x3_small_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ y,
                         int h, int wd, int cin, int cout, int act,
                         float slope) {
  __shared__ __align__(16) float xs[HALO_H * HALO_W * XS_STRIDE];
  __shared__ __align__(16) float ws[9 * CK * CT];

  const BlockTile b = block_tile<CT>(wd);
  const ThreadSlot s = thread_slot<CT>();
  float acc[PX][CPT];
  conv3x3_accumulate<T, CT>(x, w, b.n, 1, TH, Tile<CT>::THREADS, h, wd, cin,
                            cout, b.oy0, b.ox0, b.co0, s, acc, xs, ws);
  store_bias_act<T>(acc, bias, y, b.n, b.oy0 + s.prow, b.ox0 + s.pcol,
                    b.co0 + s.cg * CPT, h, wd, cout, act, slope);
}

template <typename T, int CT>
static void launch(const void* x, const void* w, const float* bias, void* y,
                   int n, int h, int wd, int cin, int cout, int act,
                   float slope, cudaStream_t stream) {
  const dim3 grid(num_tiles(h, wd), (cout + CT - 1) / CT, n);
  conv3x3_small_kernel<T, CT><<<grid, Tile<CT>::THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), h, wd, cin, cout, act, slope);
}

template <typename T>
static void dispatch_ct(const void* x, const void* w, const float* bias,
                        void* y, int n, int h, int wd, int cin, int cout,
                        int act, float slope, cudaStream_t stream) {
  switch (pick_ct(cout)) {
    case 32:
      launch<T, 32>(x, w, bias, y, n, h, wd, cin, cout, act, slope, stream);
      break;
    case 16:
      launch<T, 16>(x, w, bias, y, n, h, wd, cin, cout, act, slope, stream);
      break;
    default:
      launch<T, 4>(x, w, bias, y, n, h, wd, cin, cout, act, slope, stream);
  }
}

}  // namespace gst

extern "C" {

// bias may be null.  act: 0 none, 1 relu, 2 leaky(slope).  f32 runs the
// FFMA core (ws and plan unused); bf16 runs the tensor-core kernel with
// plan = int[9] from kernels/tc_plan.py and ws its split-K workspace
// (null without a split).
// Returns cudaGetLastError() after the launch (0 on success).
int gst_conv3x3_small(const void* x, const void* w, const float* bias,
                      void* y, float* ws, int n, int h, int wd, int cin,
                      int cout, int dtype, int act, float slope,
                      const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32) {
    gst::dispatch_ct<float>(x, w, bias, y, n, h, wd, cin, cout, act, slope,
                            st);
    return (int)cudaGetLastError();
  }
  if (dtype != gst::BF16) return (int)cudaErrorInvalidValue;
  gst::tc::Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.ws = ws;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.act = act;
  a.slope = slope;
  return gst::tc::run(a, plan, st);
}

}  // extern "C"
