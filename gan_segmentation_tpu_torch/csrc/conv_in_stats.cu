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
// bf16 (generate, batch 8) runs the Hopper body of conv3x3_sm90.cuh (TMA
// halo boxes into an mbarrier ring, wgmma, the epilogue and the statistics
// from the accumulators; gst_conv3x3_in_stats_sm90) wherever
// kernels/tc_plan.py::plan_sm90 takes the shape, which is every generate
// path shape; the mma.sync body of conv3x3_tc.cuh below keeps the rest
// (Cin % 8 != 0, W % 4 != 0, an unaligned view).  The mma.sync body's
// design, as it was measured before the Hopper body.  What bounds it: at 256^2-1024^2 (16-64 channels, 68-284
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
// s8 (generate --quant int8-full): conv_in_stats_s8.cu, this kernel's
// epilogue after the dequantization on the Hopper body (entry 4) or the
// mma.sync body.
//
// f32 (the generator with dtype fp32: the sample collection and the
// annotation side, batch 8) runs the 3xTF32 tensor-core implicit GEMM of
// conv3x3_tf32.cuh, which keeps the f32 contract.  What bounds it: three
// MMAs per product, 3 x FLOP / 495 TFLOP/s (1.58 ms over a batch's 9
// calls; the 512 -> 512 layers run 8 Cout blocks of 64 with taps per
// stage).  The plan splits K where the items are fewer than the SMs (4^2,
// 8^2) and wherever one accumulator chain would pass 8 Cin chunks (Cin 512
// and 256: the tensor cores round the accumulator toward zero).  The
// noise is read in the epilogue; the statistics come from the accumulators
// (xor-shuffles over a warp's rows, then the slots of an image added in
// order), one partial per (image, tile) as in bf16.
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"
#include "conv3x3_tc.cuh"
#include "conv3x3_tf32.cuh"

extern "C" {

// f32 runs the 3xTF32 tensor-core kernel with plan = int[11] from
// kernels/tc_plan.py::plan_f32, bf16 the bf16 tensor-core kernel with
// plan = int[9] from kernels/tc_plan.py::plan; ws is the plan's split-K
// workspace (null without a split).  partial is (n, tiles, 2, cout) with
// the plan's tile count.
// Returns a CUDA error code (0 on success).
int gst_conv3x3_in_stats(const void* x, const void* w, const float* noise,
                         const float* nscale, const float* bias, void* y,
                         float* partial, float* ws, int n, int h, int wd,
                         int cin, int cout, int dtype, float slope,
                         const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
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
    return gst::tf32::run<1>(a, plan, st);
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
  return gst::tc::run<1>(a, plan, st);
}

// The Hopper body (bf16 only; conv3x3_sm90.cuh): the arguments of
// gst_conv3x3_in_stats with plan = int[11] from
// kernels/tc_plan.py::plan_sm90(noise=True).
int gst_conv3x3_in_stats_sm90(const void* x, const void* w,
                              const float* noise, const float* nscale,
                              const float* bias, void* y, float* partial,
                              float* ws, int n, int h, int wd, int cin,
                              int cout, int dtype, float slope,
                              const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || dtype != gst::BF16)
    return (int)cudaErrorInvalidValue;
  return gst::sm90::run<1>(
      gst::sm90::args(x, w, nullptr, noise, nscale, bias, y, 0, partial,
                      ws, n, h, wd, cin, cout, gst::tc::LEAKY, slope),
      plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
