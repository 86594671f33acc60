// Kernel 2 (small_conv.cu) in f32 on the Hopper body: the decoder's eval
// convs at batch 1 (evaluate, predict) and its f32 calls at any batch, y =
// act(conv3x3(x, w) [+ b]) in f32 as 3xTF32.
//
// Replaces, in f32, the TPU kernel
//   experiments/pallas_archive/small_conv.py::conv3x3_small
// (body _kernel, pl.pallas_call at its line 84).
//
// The f32 form of conv3x3_sm90.cuh (entry 8), as kernel 3's
// (bil_conv_sm90.cu): TMA boxes of f32 halos into the mbarrier ring, the
// taps split by the blocks into resident K-major tf32 hi and lo, wgmma k8
// (A_hi [B_hi | B_lo], then A_lo B_hi), 8-channel blocks at the small
// layers, y from registers.  kernels/tc_plan.py::plan_tf32 picks it wherever
// TMA's rules take the shape and Cin <= 128 (every eval conv from main_0 on
// and cvt_5..8); cvt_0..4 (Cin 512 / 256, chains split 4-16 ways) and the
// shapes TMA refuses keep the mma.sync 3xTF32 body of conv3x3_tf32.cuh
// (gst_conv3x3_small).  What bounds it: 3 x FLOP / 495 TFLOP/s, the bytes
// at the 1024^2 16-channel layers.
//
// Its own source, so that nvcc builds its kernels beside the others'.
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"

extern "C" {

// The arguments of gst_conv3x3_small (dtype must be 0: f32) with plan =
// int[11] from kernels/tc_plan.py::plan_tf32 (a PlanSM90).
int gst_conv3x3_small_f32_sm90(const void* x, const void* w,
                               const float* bias, void* y, float* ws, int n,
                               int h, int wd, int cin, int cout, int dtype,
                               int act, float slope, const int* plan,
                               void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2 ||
      dtype != gst::F32)
    return (int)cudaErrorInvalidValue;
  return gst::sm90::run<8>(
      gst::sm90::args(x, w, nullptr, nullptr, nullptr, bias, y, 0, nullptr,
                      ws, n, h, wd, cin, cout, act, slope),
      plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
