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
// bf16 (generate, batch 8) runs the Hopper body of conv3x3_sm90.cuh
// (gst_conv3x3_small_sm90) wherever kernels/tc_plan.py::plan_sm90 takes
// the shape, which is every generate path shape (main_8_conv, Cout 2, with
// resident taps and stores from registers); the mma.sync body of
// conv3x3_tc.cuh keeps the rest (Cin % 8 != 0, an unaligned view).  The
// mma.sync body's design, as it was measured before.  What bounds it: from 256^2 up the decoder's layers carry
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
// s8 (int8 generation, generate --quant): small_conv_s8.cu, this kernel's
// epilogue after the dequantization on the Hopper body (entry 5) or the
// mma.sync body.
//
// f32 (evaluate at batch 1, train's cvt_0..4 forward, generate with
// dtype fp32 at batch 8) runs the 3xTF32 split, which keeps the f32
// contract (card = CPU to six decimals in the train checks; one TF32 pass
// would break it): on the Hopper body's f32 form (small_conv_f32.cu)
// wherever kernels/tc_plan.py::plan_tf32 takes the call, else on the
// mma.sync implicit GEMM of conv3x3_tf32.cuh (gst_conv3x3_small; Cin >
// 128, an unaligned view, Cin % 4 != 0).  What bounds
// it: three MMAs per product, 3 x FLOP / 495 TFLOP/s (0.415 ms over an
// evaluate sample's 26 convs).  cvt_0..4 at batch 1 (Cin 512 / 256 at
// 4^2-64^2) have 1-32 items of 128 pixels for 132 SMs and 16-32 Cin chunks
// each: the plan splits K there and a finish kernel adds the splits in a
// fixed order.
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"
#include "conv3x3_tc.cuh"
#include "conv3x3_tf32.cuh"

extern "C" {

// bias may be null.  act: 0 none, 1 relu, 2 leaky(slope).  f32 runs the
// 3xTF32 tensor-core kernel with plan = int[11] from
// kernels/tc_plan.py::plan_f32, bf16 the bf16 tensor-core kernel with
// plan = int[9] from kernels/tc_plan.py::plan; ws is the plan's split-K
// workspace (null without a split).
// Returns a CUDA error code (0 on success).
int gst_conv3x3_small(const void* x, const void* w, const float* bias,
                      void* y, float* ws, int n, int h, int wd, int cin,
                      int cout, int dtype, int act, float slope,
                      const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32) {
    gst::tf32::Args a = {};
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const float*>(w);
    a.bias = bias;
    a.y = static_cast<float*>(y);
    a.ws = ws;
    a.n = n;
    a.h = h;
    a.wd = wd;
    a.cin = cin;
    a.cout = cout;
    a.act = act;
    a.slope = slope;
    return gst::tf32::run<2>(a, plan, st);
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
  return gst::tc::run<2>(a, plan, st);
}

// The Hopper body (bf16 only; conv3x3_sm90.cuh): the arguments of
// gst_conv3x3_small with plan = int[11] from kernels/tc_plan.py::plan_sm90.
int gst_conv3x3_small_sm90(const void* x, const void* w, const float* bias,
                           void* y, float* ws, int n, int h, int wd, int cin,
                           int cout, int dtype, int act, float slope,
                           const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2 ||
      dtype != gst::BF16)
    return (int)cudaErrorInvalidValue;
  return gst::sm90::run<2>(
      gst::sm90::args(x, w, nullptr, nullptr, nullptr, bias, y, 0, nullptr,
                      ws, n, h, wd, cin, cout, act, slope),
      plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
