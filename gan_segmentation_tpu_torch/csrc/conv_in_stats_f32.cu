// Kernel 1 (conv_in_stats.cu) in f32 on the Hopper body: conv_2 of every
// synthesis block in the f32 generator (ImageGenerator(dtype="fp32"): the
// train and evaluate collections, the slice and scale-out references),
// y = lrelu(conv3x3(x, w) + noise * nscale + bias) in f32 as 3xTF32, with
// the per-(image, channel) sums of v and v^2 of those f32 values.
//
// Replaces, in f32, the TPU kernel
//   experiments/pallas_archive/conv_in_stats.py::conv3x3_noise_bias_lrelu_instats
// (body _kernel, pl.pallas_call at its line 118).
//
// The f32 form of conv3x3_sm90.cuh with kernel 1's epilogue (entry 9): TMA
// boxes of the f32 halo into the mbarrier ring, wgmma k8 (A_hi [B_hi |
// B_lo], then A_lo B_hi), the noise (TW, TH, G) f32 by TMA in the item's
// last stage, the statistics from the accumulators by the bf16 body's slots,
// y from registers.  What bounds it: 3 x FLOP / 495 TFLOP/s from 4^2 to
// 512^2 (the 512-channel layers ~2,300 flop a byte), the bytes at 1024^2
// 16 -> 16.  Two things set it apart from entries 3 and 8:
//
// - The taps of a Cin-512 / 256 / 128 / 64 layer do not fit in shared
//   memory (one chunk's hi and lo at BN 64 are 72 KB, eight chunks a
//   chain), so they stream: tf32_taps_kernel below lays w (HWIO f32) out
//   once a call as [chunk][9][hi, lo][Cout][16], hi the f32 itself (the MMA
//   reads its top 19 bits) and lo = v - (v & 0xFFFFE000) (the 19 bits the
//   MMA reads are tf32_split's lo), and the producer loads each stage's
//   slice as ONE TMA box (16, BN, 2, 9) under the 64-byte swizzle beside
//   the halo box.  w is the generator's effective weight, recomputed every
//   forward, so nothing is cached: the layout lives at the front of the
//   workspace the wrapper allocates per call (torch.empty, captured into
//   the graphs with the call).  Where one wave holds every item (4^2) the
//   plan keeps them resident instead (split_taps from HWIO, no layout: a
//   block's taps serve its one item either way).
// - Split-K within the chain cap: Cin 512 in >= 4 splits, 256 in >= 2, so
//   that no accumulator chain (the tensor cores truncate it) passes 8
//   chunks, and more where the items leave SMs idle (4^2: 8 splits of
//   32-channel blocks); conv3x3_tc.cuh's finish kernel adds the f32
//   partials in a fixed order, to nearest, and runs the noise, bias, leaky
//   and the statistics, one partial per (image, tile) as the body's own
//   epilogue gives them.
//
// kernels/tc_plan.py::plan_tf32_in_stats picks it wherever TMA's rules take
// the call (Cin % 4 == 0, W % 4 == 0, 16-byte bases): every kernel-1 call
// of the f32 generator at ffhq, cars and bedrooms; the rest keeps the
// mma.sync 3xTF32 body (gst_conv3x3_in_stats, conv3x3_tf32.cuh).
//
// Its own source, so that nvcc builds its kernels beside the others'.
#include "conv3x3_core.cuh"  // DType, valid_dims
#include "conv3x3_sm90.cuh"

namespace gst {
namespace {

constexpr int TAPS_THREADS = 256;
constexpr int TAPS_CO = 64;  // output channels a block lays out

// w (HWIO f32) -> wk [chunk][9][hi, lo][Cout][16], 0 past Cin.  A block
// takes one (chunk, tap) and 64 output channels: reads along Cout, writes
// 64 rows of 16 words of hi, then of lo, each run contiguous; the tile goes
// through shared memory in rows of 17 words (against bank conflicts).
__global__ void __launch_bounds__(TAPS_THREADS)
    tf32_taps_kernel(const float* __restrict__ w, float* __restrict__ wk,
                     int cin, int cout) {
  __shared__ float t[TAPS_CO][17];
  const int ct = blockIdx.y, tap = ct % 9, chunk = ct / 9;
  const int co0 = blockIdx.x * TAPS_CO;
  for (int i = threadIdx.x; i < 16 * TAPS_CO; i += TAPS_THREADS) {
    const int ci = i / TAPS_CO, o = i % TAPS_CO;
    const int c = chunk * 16 + ci, co = co0 + o;
    t[o][ci] = c < cin && co < cout
                   ? __ldg(w + ((size_t)tap * cin + c) * cout + co)
                   : 0.f;
  }
  __syncthreads();
  float* hi = wk + ((size_t)ct * 2 * cout + co0) * 16;
  float* lo = hi + (size_t)cout * 16;
  const int rows = min(TAPS_CO, cout - co0);
  for (int i = threadIdx.x; i < rows * 16; i += TAPS_THREADS) {
    const float v = t[i / 16][i % 16];
    hi[i] = v;
    lo[i] = __fsub_rn(v, __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
  }
}

}  // namespace
}  // namespace gst

extern "C" {

// The arguments of gst_conv3x3_in_stats (dtype must be 0: f32) with plan =
// int[11] from kernels/tc_plan.py::plan_tf32_in_stats (a PlanSM90).  ws:
// where the plan streams its taps (plan[9] == 0), the K-major layout
// (chunks x 9 x 2 x Cout x 16 f32) first; then, where it splits, the
// split-K workspace (splits x N*H*W x Cout f32): PlanSM90.ws_elems.
int gst_conv3x3_in_stats_f32_sm90(const void* x, const void* w,
                                  const float* noise, const float* nscale,
                                  const float* bias, void* y, float* partial,
                                  float* ws, int n, int h, int wd, int cin,
                                  int cout, int dtype, float slope,
                                  const int* plan, void* stream) {
  if (!gst::valid_dims(n, h, wd, cin, cout) || dtype != gst::F32 ||
      plan == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gst::sm90::Args a =
      gst::sm90::args(x, w, nullptr, noise, nscale, bias, y, 0, partial, ws,
                      n, h, wd, cin, cout, gst::tc::LEAKY, slope);
  if (!plan[9]) {  // streamed taps: lay w out first, on the same stream
    const long long chunks = (cin + 15) / 16;
    if (ws == nullptr || chunks * 9 > 65535 ||
        !gst::aligned(w, 4) || !gst::aligned(ws, 16))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((cout + gst::TAPS_CO - 1) / gst::TAPS_CO,
                    (unsigned)(chunks * 9));
    gst::tf32_taps_kernel<<<grid, gst::TAPS_THREADS, 0, st>>>(
        static_cast<const float*>(w), ws, cin, cout);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
    a.wk = ws;
    a.ws = ws + chunks * 9 * 2 * cout * 16;
  }
  return gst::sm90::run<9>(a, plan, st);
}

}  // extern "C"
