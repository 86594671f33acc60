// Kernel 1 (conv_in_stats.cu) in s8, for generate --quant int8-full: conv_2
// of every synthesis block with x and w quantized, the epilogue after the
// dequantization,
//
//   v = float(acc) * deq[c] + noise * nscale + bias,  y = leaky(v)
//
// each step rounded on its own, and the statistics of v as in bf16.  x
// comes quantized by quantize_s8.cu, w is s8 [tap][Cout][Cin] (K
// contiguous: both bodies need it, ldmatrix and wgmma transposing only
// 16-bit elements).
//
// Replaces, in the int8 form the port's --quant path needs, the TPU kernel
//   experiments/pallas_archive/conv_in_stats.py::conv3x3_noise_bias_lrelu_instats
// (body _kernel, pl.pallas_call at its line 118).
//
// Two bodies, picked on the host by kernels/tc_plan.py::plan_s8: the
// Hopper body of conv3x3_sm90.cuh (entry 4 of it: TMA boxes of s8 into an
// mbarrier ring, wgmma m64nBNk32 s32, the epilogue and statistics from the
// accumulators; gst_conv3x3_in_stats_s8_sm90) wherever TMA's rules take
// the shape (Cin % 16 == 0, W % 4 == 0, 16-byte bases: every int8-full
// shape of ffhq, cars and bedrooms), else the mma.sync s8 body of
// conv3x3_tc.cuh (gst_conv3x3_in_stats_s8).  What bounds them: bytes from
// 64^2 up (s8 halves x's bytes; int8 peaks at twice bf16's rate), the
// multiply rate below.  Their y is the same, bit for bit (the sums are
// exact and the epilogue rounds step by step); the statistics differ only
// by summation order.  In their own file so that nvcc builds them beside
// the bf16 kernels, not after them.
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"
#include "conv3x3_tc.cuh"

extern "C" {

// The mma.sync s8 body: x s8 NHWC, w s8 [tap][Cout][Cin], deq (Cout,) f32;
// y in out_dtype (0 f32, 1 bf16); plan = int[9] from
// kernels/tc_plan.py::plan(noise=True, s8=True); ws the split-K workspace
// (s32); partial is (n, tiles, 2, cout) with the plan's tile count.
// Returns a CUDA error code (0 on success).
int gst_conv3x3_in_stats_s8(const void* x, const void* w, const float* deq,
                            const float* noise, const float* nscale,
                            const float* bias, void* y, float* partial,
                            float* ws, int n, int h, int wd, int cin,
                            int cout, int out_dtype, float slope,
                            const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) ||
      (out_dtype != gst::F32 && out_dtype != gst::BF16) || deq == nullptr)
    return (int)cudaErrorInvalidValue;
  gst::tc::Args a = {};
  a.x = x;
  a.w = w;
  a.deq = deq;
  a.bias = bias;
  a.noise = noise;
  a.nscale = nscale;
  a.y = y;
  a.y_f32 = out_dtype == gst::F32;
  a.partial = partial;
  a.ws = ws;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.act = gst::tc::LEAKY;
  a.slope = slope;
  return gst::tc::run<4>(a, plan, static_cast<cudaStream_t>(stream));
}

// The Hopper s8 body: the arguments of gst_conv3x3_in_stats_s8 with plan =
// int[11] from kernels/tc_plan.py::plan_s8 (a PlanSM90).
int gst_conv3x3_in_stats_s8_sm90(const void* x, const void* w,
                                 const float* deq, const float* noise,
                                 const float* nscale, const float* bias,
                                 void* y, float* partial, float* ws, int n,
                                 int h, int wd, int cin, int cout,
                                 int out_dtype, float slope, const int* plan,
                                 void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) ||
      (out_dtype != gst::F32 && out_dtype != gst::BF16) || deq == nullptr)
    return (int)cudaErrorInvalidValue;
  return gst::sm90::run<4>(
      gst::sm90::args(x, w, deq, noise, nscale, bias, y,
                      out_dtype == gst::F32, partial, ws, n, h, wd, cin,
                      cout, gst::tc::LEAKY, slope),
      plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
