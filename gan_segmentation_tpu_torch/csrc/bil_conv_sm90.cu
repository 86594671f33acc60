// Kernel 3 (bil_conv.cu) in f32 on the Hopper body: the train step's 38
// calls but one, the decoder's train-mode forward convs inside the
// contract and their input gradients (kernels/conv3x3_grad.py), y =
// act(conv3x3(x, w) [+ b]) in f32 as 3xTF32.
//
// Replaces the TPU kernel
//   experiments/pallas_archive/bil_conv.py::conv3x3_bil
// (body _kernel, pl.pallas_call at its line 115), as bil_conv.cu does, and
// keeps its contract (B * Cin, B * Cout <= 128).
//
// The f32 form of conv3x3_sm90.cuh (entry 3): x by TMA boxes of f32 into
// the mbarrier ring, the taps split by the blocks into resident K-major
// tf32 hi and lo, wgmma k8 (A_hi [B_hi | B_lo], then A_lo B_hi), y from
// registers; 8-channel blocks where wider ones would leave SMs idle (the
// 8^2-64^2 layers), split-K only where a plan asks for it (the workspace,
// the fixed-order finish kernel; the rule does not: it lost to the narrow
// blocks on the card).  kernels/tc_plan.py::plan_tf32 picks it
// wherever TMA's rules take the shape (Cin % 4 == 0, 16-byte bases): every
// call of a train step but main_8_conv's input gradient (Cin 2), which
// keeps the mma.sync 3xTF32 body of conv3x3_tf32.cuh (gst_conv3x3_bil).
// What bounds it on the H100: 3 x FLOP / 495 TFLOP/s over the step's
// calls, the bytes at the 1024^2 16-channel layers.
//
// Its own source, so that nvcc builds its kernels beside the others'.
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"

namespace {
constexpr int MAX_LANES = 128;  // B * Cin and B * Cout bound
}  // namespace

extern "C" {

// x, w (HWIO) and y f32 (dtype must be 0); bias may be null; act: 0 none,
// 1 relu, 2 leaky(slope); plan = int[11] from kernels/tc_plan.py::plan_tf32
// (a PlanSM90); ws the split-K workspace (splits x N*H*W x Cout f32), null
// without a split.  Returns a CUDA error code (0 on success).
int gst_conv3x3_bil_sm90(const void* x, const void* w, const float* bias,
                         void* y, float* ws, int n, int h, int wd, int cin,
                         int cout, int dtype, int act, float slope,
                         const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2 ||
      dtype != gst::F32 || n * cin > MAX_LANES || n * cout > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  return gst::sm90::run<3>(
      gst::sm90::args(x, w, nullptr, nullptr, nullptr, bias, y, 0, nullptr,
                      ws, n, h, wd, cin, cout, act, slope),
      plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
