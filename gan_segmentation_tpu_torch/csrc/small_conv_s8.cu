// Kernel 2 (small_conv.cu) in s8, for generate --quant int8 | int8-full:
// every 3x3 site of the int8 decoder (Cout up to 4 x 32 for a block stage's
// conv_0 over the coarse grid, the four output parities as channels) and,
// under int8-full, the generator's up-sampling convs in sub-pixel form (4 x
// Cout, up to 4 x 512),
//
//   y = act(float(acc) * deq[c] [+ bias]),  act in {none, relu, leaky}
//
// each step rounded on its own.  x comes quantized by quantize_s8.cu, w is
// s8 [tap][Cout][Cin].
//
// Replaces, in the int8 form the port's --quant path needs, the TPU kernel
//   experiments/pallas_archive/small_conv.py::conv3x3_small
// (body _kernel, pl.pallas_call at its line 84).
//
// Two bodies, picked on the host by kernels/tc_plan.py::plan_s8, as kernel
// 1's (conv_in_stats_s8.cu): the Hopper body of conv3x3_sm90.cuh (entry 5:
// gst_conv3x3_small_s8_sm90) wherever TMA's rules take the shape (Cin % 16
// == 0, 16-byte bases: every int8 and int8-full shape of ffhq, cars and
// bedrooms), else the mma.sync s8 body of conv3x3_tc.cuh
// (gst_conv3x3_small_s8).  What bounds them: bytes from 256^2 up, as in
// bf16 (s8 halves the input's bytes; the separate quantize pass reads the
// bf16 tensor once more and writes the s8 one), the block count at the
// Cin-512 layers of 4^2-32^2, which split K and add the s32 partials
// exactly.  Their y is the same, bit for bit.
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"
#include "conv3x3_tc.cuh"

extern "C" {

// The mma.sync s8 body: x s8 NHWC, w s8 [tap][Cout][Cin], deq (Cout,) f32,
// bias (Cout,) f32 or null; act: 0 none, 1 relu, 2 leaky(slope); y in
// out_dtype (0 f32, 1 bf16); plan = int[9] from
// kernels/tc_plan.py::plan(s8=True); ws the split-K workspace (s32).
// Returns a CUDA error code (0 on success).
int gst_conv3x3_small_s8(const void* x, const void* w, const float* deq,
                         const float* bias, void* y, float* ws, int n, int h,
                         int wd, int cin, int cout, int out_dtype, int act,
                         float slope, const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2 ||
      (out_dtype != gst::F32 && out_dtype != gst::BF16) || deq == nullptr)
    return (int)cudaErrorInvalidValue;
  gst::tc::Args a = {};
  a.x = x;
  a.w = w;
  a.deq = deq;
  a.bias = bias;
  a.y = y;
  a.y_f32 = out_dtype == gst::F32;
  a.ws = ws;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.act = act;
  a.slope = slope;
  return gst::tc::run<5>(a, plan, static_cast<cudaStream_t>(stream));
}

// The Hopper s8 body: the arguments of gst_conv3x3_small_s8 with plan =
// int[11] from kernels/tc_plan.py::plan_s8 (a PlanSM90).
int gst_conv3x3_small_s8_sm90(const void* x, const void* w,
                              const float* deq, const float* bias, void* y,
                              float* ws, int n, int h, int wd, int cin,
                              int cout, int out_dtype, int act, float slope,
                              const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2 ||
      (out_dtype != gst::F32 && out_dtype != gst::BF16) || deq == nullptr)
    return (int)cudaErrorInvalidValue;
  return gst::sm90::run<5>(
      gst::sm90::args(x, w, deq, nullptr, nullptr, bias, y,
                      out_dtype == gst::F32, nullptr, ws, n, h, wd, cin,
                      cout, act, slope),
      plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
