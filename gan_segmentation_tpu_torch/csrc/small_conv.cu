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
// What bounds it on the H100: the decoder's 1024^2 and 512^2 layers carry
// 16-64 channels, ~72-290 flop per byte moved in bf16, at or below the
// tensor cores' ridge of ~295 flop/byte, so on tensor cores they would be
// bound by memory.  This simple design multiplies on the CUDA cores (FFMA,
// ridge ~20 flop/byte) and is bound by the FFMA rate.  Left for later:
// wgmma, TMA staging, reading the nearest-2x upsample and the concat
// directly from their inputs, and the batch-in-channels tile mode of
// experiments/pallas_archive/bil_conv.py.
#include "conv3x3_core.cuh"

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

// bias may be null.  act: 0 none, 1 relu, 2 leaky(slope).
// Returns cudaGetLastError() after the launch (0 on success).
int gst_conv3x3_small(const void* x, const void* w, const float* bias,
                      void* y, int n, int h, int wd, int cin, int cout,
                      int dtype, int act, float slope, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32)
    gst::dispatch_ct<float>(x, w, bias, y, n, h, wd, cin, cout, act, slope,
                            st);
  else if (dtype == gst::BF16)
    gst::dispatch_ct<__nv_bfloat16>(x, w, bias, y, n, h, wd, cin, cout, act,
                                    slope, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
