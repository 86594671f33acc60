// 3x3 convolution of a small batch, with a fused bias and relu /
// leaky-relu epilogue.
//
// Replaces the TPU kernel
//   experiments/pallas_archive/bil_conv.py::conv3x3_bil
// (body _kernel, pl.pallas_call at its line 115) and keeps its contract:
// 3x3, stride 1, zero pad 1, x (B, H, W, Cin) NHWC f32 or bf16, w HWIO,
// optional f32 bias, f32 accumulation, output in x's dtype, and
// B * Cin <= 128, B * Cout <= 128.  Pallas also required H % tile_h == 0;
// here ragged tiles are masked.
//
// On the TPU the kernel packs the batch into the 128 lanes: it relayouts x
// to (H, W, B*C) in HBM and multiplies each tap against a block-diagonal
// (B*Cin, B*Cout) matrix, because the MXU multiplies a dense 128 x 128
// anyway.  Neither carries over: the block-diagonal zeros are B times the
// work, and the relayout is two more passes over x and y through memory.
// What this kernel keeps is the idea that one block serves several
// samples where they are small.
//
// In the port it runs the decoder's train-mode forward of every 3x3 conv
// that fits the contract at batch 1 (cvt_5..cvt_8, every main_i conv_0 and
// conv_1, main_8_conv) and the input gradient of the 17 convs that need one
// (kernels/conv3x3_grad.py): 38 calls per train step, all f32, C 2-128 at
// 8^2-1024^2, 102.7 GFLOP and 1.91 GB per step.
//
// f32: the 3xTF32 split, which keeps the f32 contract (conv3x3_tf32.cuh
// says why one TF32 pass does not), on the body kernels/tc_plan.py::
// plan_f32_body picks: the Hopper body's f32 form (bil_conv_sm90.cu, entry
// gst_conv3x3_bil_sm90) wherever TMA's rules take the call, else this
// file's entry, the mma.sync implicit GEMM of conv3x3_tf32.cuh without a
// split (main_8_conv's input gradient, Cin 2).  What bounds them on the
// H100: the three MMAs per product, 3 x FLOP / 495 TFLOP/s = 0.725 ms per
// train step, above the 0.570 ms that the bytes take at 3.35 TB/s and
// below the 1.581 ms that the same FLOP take at the FFMA peak, which
// bounded the FFMA body before them.
//
// bf16 is on no path (generate's convs run kernel 2, train is f32) and
// stays on the FFMA core of conv3x3_core.cuh: one block owns a th x TW
// tile of output pixels of EVERY sample, stages their halos and the taps
// once for the batch, and th halves as B grows so that the block stays
// within 512 threads.
#include "conv3x3_core.cuh"
#include "conv3x3_tf32.cuh"

namespace gst {
namespace bil {

constexpr int MAX_LANES = 128;    // B * Cin and B * Cout bound
constexpr int MAX_THREADS = 512;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the H100's per-block limit

// Rows per block: the largest power of two <= TH that keeps
// B x (TH x TW / PX) x (CT / CPT) threads within MAX_THREADS.
template <int CT>
inline int pick_th(int n) {
  int th = TH;
  while (th > 1 && n * th * (TW / PX) * Tile<CT>::COUT_GROUPS > MAX_THREADS)
    th /= 2;
  return th;
}

// taps [9][CK][CT], then the halo of every sample [B][th+2][TW+2][CK+1]
template <int CT, int CK>
inline size_t smem_bytes(int n, int th) {
  return sizeof(float) *
         (9 * CK * CT + (size_t)n * (th + 2) * HALO_W * (CK + 1));
}

// The block's row tile of all n samples: conv3x3_accumulate stages the
// halo of every sample and the taps once for the batch.
template <typename T, int CT, int CK>
__global__ void __launch_bounds__(MAX_THREADS)
    conv3x3_bil_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y,
                       int n, int h, int wd, int cin, int cout, int th,
                       int act, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* xs = smem + 9 * CK * CT;

  const int tiles_w = (wd + TW - 1) / TW;
  const int oy0 = (blockIdx.x / tiles_w) * th;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CT;
  const ThreadSlot s = thread_slot<CT>(th);
  float acc[PX][CPT];
  conv3x3_accumulate<T, CT, CK>(x, w, 0, n, th, blockDim.x, h, wd, cin, cout,
                                oy0, ox0, co0, s, acc, xs, ws);
  store_bias_act<T>(acc, bias, y, s.sample, oy0 + s.prow, ox0 + s.pcol,
                    co0 + s.cg * CPT, h, wd, cout, act, slope);
}

template <typename T, int CT, int CK>
static int launch(const void* x, const void* w, const float* bias, void* y,
                  int n, int h, int wd, int cin, int cout, int act,
                  float slope, cudaStream_t stream) {
  const int th = pick_th<CT>(n);
  const int threads = n * th * (TW / PX) * Tile<CT>::COUT_GROUPS;
  const size_t smem = smem_bytes<CT, CK>(n, th);
  if (threads > MAX_THREADS || smem > MAX_SMEM)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = conv3x3_bil_kernel<T, CT, CK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles =
      (long long)((h + th - 1) / th) * ((wd + TW - 1) / TW);
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (cout + CT - 1) / CT);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), n, h, wd, cin, cout, th, act, slope);
  return (int)cudaGetLastError();
}

// Input-channel chunk: 16 for wide inputs, 8 or 4 for narrow ones, so the
// staged halo of a large batch of narrow samples stays small.
template <typename T, int CT>
static int dispatch_ck(const void* x, const void* w, const float* bias,
                       void* y, int n, int h, int wd, int cin, int cout,
                       int act, float slope, cudaStream_t st) {
  if (cin >= 16)
    return launch<T, CT, 16>(x, w, bias, y, n, h, wd, cin, cout, act, slope,
                             st);
  if (cin > 4)
    return launch<T, CT, 8>(x, w, bias, y, n, h, wd, cin, cout, act, slope,
                            st);
  return launch<T, CT, 4>(x, w, bias, y, n, h, wd, cin, cout, act, slope,
                          st);
}

template <typename T>
static int dispatch_ct(const void* x, const void* w, const float* bias,
                       void* y, int n, int h, int wd, int cin, int cout,
                       int act, float slope, cudaStream_t st) {
  switch (pick_ct(cout)) {
    case 32:
      return dispatch_ck<T, 32>(x, w, bias, y, n, h, wd, cin, cout, act,
                                slope, st);
    case 16:
      return dispatch_ck<T, 16>(x, w, bias, y, n, h, wd, cin, cout, act,
                                slope, st);
    default:
      return dispatch_ck<T, 4>(x, w, bias, y, n, h, wd, cin, cout, act,
                               slope, st);
  }
}

}  // namespace bil
}  // namespace gst

extern "C" {

// bias may be null.  act: 0 none, 1 relu, 2 leaky(slope).  f32 runs the
// mma.sync 3xTF32 kernel with plan = int[11] from
// kernels/tc_plan.py::plan_f32 (no split); bf16 the FFMA core (plan unused).
// Returns cudaGetLastError() after the launch (0 on success).
int gst_conv3x3_bil(const void* x, const void* w, const float* bias, void* y,
                    int n, int h, int wd, int cin, int cout, int dtype,
                    int act, float slope, const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || act < 0 || act > 2 ||
      n * cin > gst::bil::MAX_LANES || n * cout > gst::bil::MAX_LANES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == gst::F32) {
    gst::tf32::Args a = {};
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const float*>(w);
    a.bias = bias;
    a.y = static_cast<float*>(y);
    a.n = n;
    a.h = h;
    a.wd = wd;
    a.cin = cin;
    a.cout = cout;
    a.act = act;
    a.slope = slope;
    return gst::tf32::run<3>(a, plan, st);
  }
  if (dtype == gst::BF16)
    return gst::bil::dispatch_ct<__nv_bfloat16>(x, w, bias, y, n, h, wd, cin,
                                                cout, act, slope, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
