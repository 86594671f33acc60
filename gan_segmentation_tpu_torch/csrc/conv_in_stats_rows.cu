// Kernel 1 (conv_in_stats.cu) over one row band of its images: generate
// --spatial, where each card holds a band of every activation's rows
// (core/spatial.py).
//
// Replaces, in the band form the port's spatial path needs, the TPU kernel
//   experiments/pallas_archive/conv_in_stats.py::conv3x3_noise_bias_lrelu_instats
// (body _kernel, pl.pallas_call at its line 118).  The JAX package's
// spatial mode let XLA pad the sharded H and exchange the halos; here the
// caller exchanges them and the kernel takes
//
//   x      (N, H + 2, W, Cin): the band's H rows with the row above and
//          the row below it (a neighbour's edge row, or zeros at the
//          image's top and bottom);
//   noise  (N, H, W): the band's rows of the image's noise;
//   y      (N, H, W, Cout) = lrelu(conv3x3 + noise * nscale + bias), the
//          conv with no pad in H and a zero pad of one in W;
//   partial (N, tiles, 2, Cout): the band's per-tile sums of y and y^2 (f32,
//          before y's rounding); the caller adds them over the tiles, then
//          over the bands in a fixed order, for the whole image's mean and
//          variance.
//
// The bodies are kernel 1's (in bf16 conv3x3_sm90.cuh where
// tc_plan.plan_sm90 takes the band's shape, else conv3x3_tc.cuh;
// conv3x3_tf32.cuh in f32, with the launch plans of kernels/tc_plan.py for
// the band's H), each instantiated as entry 6 so that a profile tells the
// band form apart.  The one change is the halo's input row (ROWS in the
// mma.sync headers; the Hopper body's box starts at the band's first input
// row).
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"
#include "conv3x3_tc.cuh"
#include "conv3x3_tf32.cuh"

extern "C" {

// h is the band's output rows; x holds h + 2.  Otherwise the arguments of
// gst_conv3x3_in_stats (conv_in_stats.cu): f32 with plan = int[11] from
// tc_plan.plan_f32(stats=True), bf16 with plan = int[9] from
// tc_plan.plan(noise=True), both for the output shape.
int gst_conv3x3_in_stats_rows(const void* x, const void* w,
                              const float* noise, const float* nscale,
                              const float* bias, void* y, float* partial,
                              float* ws, int n, int h, int wd, int cin,
                              int cout, int dtype, float slope,
                              const int* plan, void* stream) {
  if (h < 1 || !gst::valid_dims(n, h + 2, wd, cin, cout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32) {
    gst::tf32::Args a = {};
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const float*>(w);
    a.bias = bias;
    a.noise = noise;
    a.nscale = nscale;
    a.y = static_cast<float*>(y);
    a.partial = partial;
    a.ws = ws;
    a.n = n;
    a.h = h;
    a.wd = wd;
    a.cin = cin;
    a.cout = cout;
    a.act = gst::LEAKY;
    a.slope = slope;
    return gst::tf32::run<6>(a, plan, st);
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
  return gst::tc::run<6>(a, plan, st);
}

// The Hopper body over a band: plan = int[11] from
// tc_plan.plan_sm90(noise=True) for the output shape.
int gst_conv3x3_in_stats_rows_sm90(const void* x, const void* w,
                                   const float* noise, const float* nscale,
                                   const float* bias, void* y,
                                   float* partial, float* ws, int n, int h,
                                   int wd, int cin, int cout, int dtype,
                                   float slope, const int* plan,
                                   void* stream) {
  if (h < 1 || !gst::valid_dims(n, h + 2, wd, cin, cout) ||
      dtype != gst::BF16)
    return (int)cudaErrorInvalidValue;
  return gst::sm90::run<6>(
      gst::sm90::args(x, w, nullptr, noise, nscale, bias, y, 0, partial,
                      ws, n, h, wd, cin, cout, gst::tc::LEAKY, slope),
      plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
