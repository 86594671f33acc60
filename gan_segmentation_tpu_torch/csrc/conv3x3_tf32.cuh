// Tensor-core implicit GEMM for the f32 3x3 convolutions of kernels 1, 2
// and 3 (conv_in_stats.cu, small_conv.cu, bil_conv.cu), in the 3xTF32
// split.  The bf16 calls of kernels 1 and 2 run conv3x3_tc.cuh; this header
// is its f32 counterpart.
//
// Layout: x is NHWC, w is HWIO (3, 3, Cin, Cout), stride 1, zero pad 1.
// GEMM view: M = output pixels, N = output channels, K = 9 taps x Cin.
// Row bands (KERNEL 6 and 7: kernels 1 and 2 over one band of an image's
// rows, generate --spatial): x holds the band's H_out rows and the halo
// row above and below that the caller placed there, H_in = H_out + 2, with
// no zero pad in H; only the staging's input row differs, as in
// conv3x3_tc.cuh.
//
// Why 3xTF32.  The train step is f32 and its checks hold the kernel to
// f32 (atol 1e-4 / rtol 1e-4 against cuDNN with TF32 off).  One TF32 pass
// keeps 11 significant bits per operand: at K = 576 its error reaches
// ~1.6e-3.  Split each operand v into hi = tf32(v) and lo = tf32(v - hi)
// and sum lo*hi + hi*lo + hi*hi in f32 (the lo*lo term, ~2^-20 relative,
// is dropped): the products then keep ~21 bits and the error stays at the
// f32 level (tests/test_torch_bil_tc.py emulates both on the CPU).  The
// split here truncates (clears the low 13 mantissa bits: one LOP3, with
// the FADD of v - hi exact), so every operand the MMA sees is a valid tf32
// value.  Three MMAs per product: the bound is 3 x FLOP / 495 TFLOP/s,
// 0.725 ms over a train step's 38 calls, against 1.58 ms at the FFMA peak.
//
// Block tile.  A block of WM warps computes BM = 16 * MI * WM output pixels
// for BN output channels (all of Cout up to 64): G images x TH rows x TW
// columns at the same spatial tile (G > 1 where an image is smaller than
// the tile, which keeps the kernel's B*Cin, B*Cout <= 128 contract for
// every batch).  Each warp owns 16 * MI pixels (MI m16 fragments) and all
// BN channels: MI = 4 for the narrow layers (BN <= 16) of a large grid,
// whose warps would otherwise hold only 2 x BN/8 independent accumulator
// chains (measured on the card: 64-pixel warps took the 1024^2 16-channel
// layers from 0.120 to 0.109 ms), else MI = 2.  Blocks are persistent and
// walk the (tile, Cout block) items, Cout block fastest.  The plan (BN, WM,
// MI, CK, TW, TH, G, stages, resident, split-K) is chosen on the host by
// kernels/tc_plan.py::plan_f32 and validated here.
//
// Staging.  The loop over Cin takes CK (8 or 16) f32 channels per stage: the
// (TH+2) x (TW+2) halo of the G images with the pixel stride padded to an
// odd number of 16-byte units (ldmatrix's 8 rows then hit 8 bank groups).
// A ring of 2 or 3 stages, filled by cp.async.cg 16-byte copies with
// zero fill beyond every edge, runs over the block's whole (item, chunk)
// sequence, so the next item's halo loads while this one multiplies.
// The taps, K rows of BN channels (row stride padded so that the 4 k rows
// a B fragment reads fall in different banks), are RESIDENT where there
// is one Cout block and they fit: every chunk's taps load once per block,
// beside the ring, instead of once per item (at Cin 64 -> Cout 32 they are
// as many bytes as an item's halo).  Otherwise each stage carries its
// chunk's taps.  Where Cin % 4 != 0, Cout % 4 != 0 or a pointer is not
// 16-byte aligned, that operand is staged with scalar zero-filled loads.
//
// MMA.  mma.sync.m16n8k8.f32.tf32.tf32.f32.  A comes from ldmatrix.x4 at
// each tap's (ky, kx) shift of the halo: a pair of b16 is one 32-bit
// element, and a thread receives (row lane/4, column lane%4) of each 8 x 4
// matrix, which is the tf32 A fragment.  B cannot come through
// ldmatrix.trans (it transposes 16-bit elements), so each thread reads its
// two B elements (k = lane%4 and lane%4 + 4, n = lane/4) with 32-bit shared
// loads, conflict-free by the row padding.  hi / lo are split in registers
// after each load, three instructions per element: staging split halos
// would double the shared-memory bytes per MMA (MI ldmatrix.x4 and
// 2 x BN/8 loads per 3 x MI x BN/8 MMAs), and splitting the resident taps
// once per block into (hi, lo) pairs read by 64-bit loads measured slower
// on the card (2.93 against 2.57 ms over a train step's calls).
//
// Split-K.  Where the grid has fewer items than SMs (Cin 512 / 256 at
// 4^2-64^2 with one image, kernel 1's 512 -> 512 at 4^2 and 8^2) the plan
// splits K over Cin chunks: one block per (item, split), taps per stage,
// each split's f32 sums stored to a workspace, and a second kernel adds the
// splits in a fixed order and runs the epilogue, in blocks of FINISH_BN
// channels so that it too spreads over the SMs.  The plan also splits
// wherever one chain would sum more than 8 chunks: the MMA rounds its f32
// accumulator toward zero, so a chain's error grows with its length, one
// way (measured 2.2e-4 at K = 9 x 512 in one chain, 5e-5 in chains of 8
// chunks on an NVIDIA H100), and the finish kernel adds to nearest.
//
// Epilogue.  v = acc [+ noise * nscale] [+ bias], then none / relu / leaky,
// stored straight from the accumulators as float2 (two adjacent channels of
// one pixel), masked at the ragged edge and beyond Cout (Cout = 2 keeps 2 of
// N = 8).  Kernel 1 (STATS) reads each pixel's noise here and also takes
// the per-(image, tile) sums of v and v^2 from the accumulators: a thread
// adds its rows of a warp's (or, where a warp spans images, of an m16
// fragment's) pixels, three xor-shuffles add the 8 row lanes, the slot's
// sums go to shared memory, and one thread per (image, channel) adds the
// image's slots in order; a tile spanning G images writes one partial per
// image.  Summation order is fixed everywhere and there are no atomics:
// repeats are bit-identical.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_core.cuh"  // Act
#include "sm90_util.cuh"     // FastDiv, cp.async, ldmatrix

namespace gst {
namespace tf32 {
// internal linkage: each including file gets its own copy of the kernels
namespace {

constexpr int MAX_SMEM = 232448;  // a block's shared-memory limit on sm_90

// A pixel of ck floats padded to an odd number of 16-byte units.
__host__ __device__ constexpr int pad_px(int ck) {
  return ((ck / 4) % 2 == 0) ? ck + 4 : ck;
}

// A tap row of bn floats padded to 8 mod 16 floats: the B fragment's rows
// k .. k+3 then start 8 banks apart.
__host__ __device__ constexpr int pad_n(int bn) {
  return (bn % 16 == 0) ? bn + 8 : bn;
}

// Shared memory of one launch: the ring of `stages` stages (halo [+ taps]),
// then, where resident, every chunk's taps, then kernel 1's statistics
// slots (BN channels, sum and sum of squares): one per warp where a warp's
// 16 * MI pixels lie in one image, else one per m16 fragment.  Floats
// unless noted.
struct Layout {
  int hp, wp;   // halo rows and columns per image
  int halo;     // one stage's halo
  int taps;     // one chunk's taps: 9 x CK x pad_n(BN)
  int stage;    // halo, plus taps unless resident
  int per;      // tile pixels per image
  int frag;     // pixels per warp
  int slots;    // the statistics' slots
  int red;      // their floats
  int smem;     // bytes
};

__host__ __device__ inline Layout layout(int bn, int ck, int g, int th,
                                         int tw, int stages, int resident,
                                         int chunks, int wm, int mi,
                                         int stats) {
  Layout L;
  L.hp = th + 2;
  L.wp = tw + 2;
  L.halo = g * L.hp * L.wp * pad_px(ck);
  L.taps = 9 * ck * pad_n(bn);
  L.stage = L.halo + (resident ? 0 : L.taps);
  L.per = th * tw;
  L.frag = 16 * mi;
  L.slots = stats ? (L.per % L.frag == 0 ? wm : wm * mi) : 0;
  L.red = L.slots * bn * 2;
  L.smem = (stages * L.stage + (resident ? chunks * L.taps : 0) + L.red) * 4;
  return L;
}

constexpr int FINISH_THREADS = 256;
constexpr int FINISH_BN = 8;  // output channels per split-K finish block
constexpr int FINISH_VS = FINISH_BN + 1;  // row stride of its value tile

// Everything a launch reads; passed by value.
struct Args {
  const float* x;
  const float* w;
  const float* bias;    // (Cout,) or null
  const float* noise;   // (N, H, W), kernel 1 only
  const float* nscale;  // (Cout,) with noise
  float* y;
  float* partial;       // (N, tiles, 2, Cout), kernel 1 only
  float* ws;            // (splits, N*H*W, Cout) when splits > 1
  int n, h, wd, cin, cout;
  int act;
  float slope;
  // the plan and what follows from it (run() fills these)
  int tw, th, g, stages, resident, splits, cps;
  int chunks, tiles_x, tiles, cout_blocks, items;
  int warp_stats;  // a warp's pixels lie in one image: one slot per warp
  int spi;         // statistics slots per image
  FastDiv fd_wp, fd_hp, fd_per, fd_tw;
  int vec_x, vec_w;  // 16-byte cp.async allowed
  int vec_y;         // float2 stores allowed (y and the workspace)
};

// ---------------------------------------------------------------- PTX ----

// c += a * b on a 16 x 8 x 8 tile; a pure register op, so not volatile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ helpers ----

// One work item: a spatial tile of G images for BN output channels and one
// Cin split.
struct Item {
  int tile, ty0, tx0, co0, n0, split;
};

__device__ __forceinline__ Item item(const Args& a, int w, int bn) {
  Item t;
  const int rest = w / a.cout_blocks;
  t.co0 = (w - rest * a.cout_blocks) * bn;
  const int z = rest / a.tiles;
  t.tile = rest - z * a.tiles;
  const int ty = t.tile / a.tiles_x;
  t.ty0 = ty * a.th;
  t.tx0 = (t.tile - ty * a.tiles_x) * a.tw;
  t.split = z % a.splits;
  t.n0 = (z / a.splits) * a.g;
  return t;
}

// Pixel p of the item's tile (g-major, then row, then column) in the tensor.
struct Pix {
  size_t idx;  // (nn * H + oy) * W + ox
  bool ok;     // inside the tensor
};

__device__ __forceinline__ Pix pixel(const Args& a, int p, const Item& it) {
  const int gi = a.fd_per.div(p);
  const int rem = p - gi * a.th * a.tw;
  const int ry = a.fd_tw.div(rem);
  const int nn = it.n0 + gi;
  const int oy = it.ty0 + ry;
  const int ox = it.tx0 + rem - ry * a.tw;
  Pix q;
  q.ok = nn < a.n && oy < a.h && ox < a.wd;
  q.idx = ((size_t)nn * a.h + oy) * a.wd + ox;
  return q;
}

// The halo of chunk `chunk` of Cin for the item's G images.
template <int CK, bool ROWS>
__device__ __forceinline__ void load_halo(const Args& a, const Layout& L,
                                          float* st, int chunk,
                                          const Item& it, int tid,
                                          int threads) {
  constexpr int PS = pad_px(CK);
  const int c0 = chunk * CK;
  const int hpx = a.g * L.hp * L.wp;
  // a row band's x holds the halo rows: no pad above, H_out + 2 rows
  constexpr int PAD_Y = ROWS ? 0 : 1;
  const int h_in = ROWS ? a.h + 2 : a.h;
  if (a.vec_x) {
    constexpr int P4 = CK / 4;
    for (int i = tid; i < hpx * P4; i += threads) {
      const int px = i / P4;
      const int c4 = i - px * P4;
      const int r = a.fd_wp.div(px);
      const int hx = px - r * L.wp;
      const int gi = a.fd_hp.div(r);
      const int hy = r - gi * L.hp;
      const int nn = it.n0 + gi;
      const int iy = it.ty0 - PAD_Y + hy, ix = it.tx0 - 1 + hx,
                c = c0 + c4 * 4;
      const bool ok = nn < a.n && iy >= 0 && iy < h_in && ix >= 0 &&
                      ix < a.wd && c < a.cin;
      const float* src =
          ok ? a.x + (((size_t)nn * h_in + iy) * a.wd + ix) * a.cin + c
             : a.x;
      cp_async16(st + px * PS + c4 * 4, src, ok);
    }
  } else {
    for (int i = tid; i < hpx * CK; i += threads) {
      const int px = i / CK;
      const int ci = i - px * CK;
      const int r = a.fd_wp.div(px);
      const int hx = px - r * L.wp;
      const int gi = a.fd_hp.div(r);
      const int hy = r - gi * L.hp;
      const int nn = it.n0 + gi;
      const int iy = it.ty0 - PAD_Y + hy, ix = it.tx0 - 1 + hx, c = c0 + ci;
      float v = 0.f;
      if (nn < a.n && iy >= 0 && iy < h_in && ix >= 0 && ix < a.wd &&
          c < a.cin)
        v = a.x[(((size_t)nn * h_in + iy) * a.wd + ix) * a.cin + c];
      st[px * PS + ci] = v;
    }
  }
}

// The 9 x CK x BN taps of chunk `chunk` for output channels co0 ..
// co0 + BN - 1, as rows (tap, ci) of pad_n(BN) floats.
template <int BN, int CK>
__device__ __forceinline__ void load_taps(const Args& a, float* wt, int chunk,
                                          int co0, int tid, int threads) {
  constexpr int BNP = pad_n(BN);
  const int c0 = chunk * CK;
  if (a.vec_w) {
    constexpr int N4 = BN / 4;
    for (int i = tid; i < 9 * CK * N4; i += threads) {
      const int r = i / N4;
      const int j4 = i - r * N4;
      const int tap = r / CK;
      const int ci = r - tap * CK;
      const int c = c0 + ci, o = co0 + j4 * 4;
      const bool ok = c < a.cin && o < a.cout;
      const float* src =
          ok ? a.w + ((size_t)tap * a.cin + c) * a.cout + o : a.w;
      cp_async16(wt + (tap * CK + ci) * BNP + j4 * 4, src, ok);
    }
  } else {
    for (int i = tid; i < 9 * CK * BN; i += threads) {
      const int r = i / BN;
      const int j = i - r * BN;
      const int tap = r / CK;
      const int ci = r - tap * CK;
      const int c = c0 + ci, o = co0 + j;
      float v = 0.f;
      if (c < a.cin && o < a.cout)
        v = a.w[((size_t)tap * a.cin + c) * a.cout + o];
      wt[(tap * CK + ci) * BNP + j] = v;
    }
  }
}

// Load position q of the block's (item, chunk) sequence, nc chunks an item,
// into stage q % stages.
template <int BN, int CK, bool ROWS>
__device__ __forceinline__ void load_pos(const Args& a, const Layout& L,
                                         float* ring, int q, int nc,
                                         int first, int step, int tid,
                                         int threads) {
  const int j = q / nc;
  const Item it = item(a, first + j * step, BN);
  const int c = it.split * a.cps + q - j * nc;
  float* st = ring + (q % a.stages) * L.stage;
  load_halo<CK, ROWS>(a, L, st, c, it, tid, threads);
  if (!a.resident) load_taps<BN, CK>(a, st + L.halo, c, it.co0, tid, threads);
}

__device__ __forceinline__ float activate(const Args& a, float v) {
  if (a.act == RELU) return fmaxf(v, 0.f);
  if (a.act == LEAKY) return v >= 0.f ? v : a.slope * v;
  return v;
}

// Two adjacent channels co, co + 1 of one pixel's row of `cout` values.
__device__ __forceinline__ void store2(const Args& a, float* row, int co,
                                       float v0, float v1) {
  if (a.vec_y) {  // Cout even: co < Cout means co + 1 < Cout too
    if (co < a.cout) *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
  } else {
    if (co < a.cout) row[co] = v0;
    if (co + 1 < a.cout) row[co + 1] = v1;
  }
}

// ------------------------------------------------------------- kernels ----

template <int BN, int WM, int MI>
struct Cfg {
  // Blocks per SM asked of ptxas: two blocks of 8 warps (four of 4), which
  // caps a thread at 128 registers, except where a thread holds 64
  // accumulators (BN = 64) or four m16 fragments (MI = 4): one block of 8
  // warps (two of 4).
  static constexpr int MIN_BLOCKS =
      (BN == 64 || MI == 4 ? 1 : 2) * (8 / WM);
};

// A persistent block walks the items blockIdx.x, blockIdx.x + gridDim.x, ...
// (with a split, the grid has one block per item).  The ring runs over the
// flattened (item, chunk) sequence, so the next item's first chunks load
// while this item multiplies and stores.  KERNEL is the number of the
// kernel whose entry point launches it (1 conv_in_stats, 2 small_conv, 3
// bil_conv, 6 and 7 kernels 1 and 2 over a row band), so that a profile
// tells them apart by name; kernel 1 has its own epilogue (STATS: noise and
// the statistics' partial sums).
template <int BN, int WM, int MI, int CK, int KERNEL>
__global__ void __launch_bounds__(WM * 32, Cfg<BN, WM, MI>::MIN_BLOCKS)
    conv3x3_tf32_kernel(const Args a) {
  constexpr bool STATS = KERNEL == 1 || KERNEL == 6;
  constexpr bool ROWS = KERNEL == 6 || KERNEL == 7;
  constexpr int THREADS = WM * 32;
  constexpr int NJ = BN / 8;  // n8 fragments per warp
  constexpr int PS = pad_px(CK);
  constexpr int BNP = pad_n(BN);
  extern __shared__ __align__(128) float smem[];

  const Layout L = layout(BN, CK, a.g, a.th, a.tw, a.stages, a.resident,
                          a.chunks, WM, MI, STATS);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tig = lane % 4;

  // this thread's ldmatrix row of A in each m16 fragment, at tap (0, 0), in
  // bytes: pixel lane % 8 + 8 * ((lane / 8) % 2), channels 4 * (lane / 16)
  uint32_t a_off[MI];
  {
    const int r = lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int p = warp * 16 * MI + i * 16 + r;
      const int gi = a.fd_per.div(p), rem = p - gi * a.th * a.tw;
      const int ty = a.fd_tw.div(rem), tx = rem - ty * a.tw;
      a_off[i] = (((gi * L.hp + ty) * L.wp + tx) * PS + 4 * (lane / 16)) * 4;
    }
  }
  // ... and of B: row k = lane % 4 (+ 4 for b1), column n = lane / 4
  const int b_off = tig * BNP + lane / 4;

  const int first = blockIdx.x, step = gridDim.x;
  const int items = (a.items - 1 - first) / step + 1;
  // chunks per item: the same for every item of a block (a split has one
  // item per block)
  const int nc = min(a.chunks - item(a, first, BN).split * a.cps, a.cps);
  const int total = items * nc;
  const int NS = a.stages;
  float* const resident = smem + NS * L.stage;
  float* const red = resident + (a.resident ? a.chunks * L.taps : 0);
  if (a.resident)  // one Cout block: every item uses the same taps
    for (int c = 0; c < nc; ++c)
      load_taps<BN, CK>(a, resident + c * L.taps, c, 0, tid, THREADS);
  for (int s = 0; s < NS - 1; ++s) {
    if (s < total)
      load_pos<BN, CK, ROWS>(a, L, smem, s, nc, first, step, tid, THREADS);
    cp_async_commit();
  }

  const uint32_t smem_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float acc[MI][NJ][4];
  for (int q = 0; q < total; ++q) {
    if (NS == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk q landed; stage (q - 1) % NS is free
    if (q + NS - 1 < total)
      load_pos<BN, CK, ROWS>(a, L, smem, q + NS - 1, nc, first, step, tid,
                             THREADS);
    cp_async_commit();

    const int j = q / nc;
    const int c = q - j * nc;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
    }
    const int stage = (q % NS) * L.stage;
    const uint32_t sa = smem_base + stage * 4;
    const float* wb =
        (a.resident ? resident + c * L.taps : smem + stage + L.halo) + b_off;
    const uint32_t row_bytes = L.wp * PS * 4;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t shift = (tap / 3) * row_bytes + (tap % 3) * (PS * 4);
#pragma unroll
      for (int kk = 0; kk < CK / 8; ++kk) {
        uint32_t ah[MI][4], al[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t r[4];
          ldsm_x4(r, sa + a_off[i] + shift + kk * 32);
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split(r[e], ah[i][e], al[i][e]);
        }
        const float* wk = wb + (tap * CK + kk * 8) * BNP;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(__float_as_uint(wk[jj * 8]), bh0, bl0);
          tf32_split(__float_as_uint(wk[4 * BNP + jj * 8]), bh1, bl1);
#pragma unroll
          for (int i = 0; i < MI; ++i) {  // small terms first, then hi * hi
            mma_tf32(acc[i][jj], al[i], bh0, bh1);
            mma_tf32(acc[i][jj], ah[i], bl0, bl1);
            mma_tf32(acc[i][jj], ah[i], bh0, bh1);
          }
        }
      }
    }
    if (c != nc - 1) continue;

    // the item's last chunk: epilogue from the accumulators (the next
    // item's loads are in flight)
    const Item it = item(a, first + j * step, BN);
    if (a.splits > 1) {  // this split's sums, for the finish kernel
      float* ws = a.ws + (size_t)it.split * a.n * a.h * a.wd * a.cout;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const Pix px =
              pixel(a, warp * 16 * MI + i * 16 + lane / 4 + half * 8, it);
          if (!px.ok) continue;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            store2(a, ws + px.idx * a.cout, it.co0 + jj * 8 + 2 * tig,
                   acc[i][jj][2 * half], acc[i][jj][2 * half + 1]);
        }
      continue;
    }
    float bias[NJ][2], ns[NJ][2];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = it.co0 + jj * 8 + 2 * tig + e;
        bias[jj][e] = (a.bias != nullptr && co < a.cout) ? a.bias[co] : 0.f;
        ns[jj][e] = (STATS && co < a.cout) ? a.nscale[co] : 0.f;
      }
    float sum[NJ][2][2];  // [n8 fragment][channel of the pair][v, v^2]
    if (STATS) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[jj][e / 2][e % 2] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const Pix px =
            pixel(a, warp * 16 * MI + i * 16 + lane / 4 + half * 8, it);
        if (!px.ok) continue;
        // loading the noise ahead of the item's last chunk instead gained
        // under 1% on the card
        const float nz = STATS ? a.noise[px.idx] : 0.f;
        float* yp = a.y + px.idx * a.cout;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float t = acc[i][jj][2 * half + e];
            if (STATS) t += nz * ns[jj][e];
            v[e] = activate(a, t + bias[jj][e]);
            // channels beyond Cout hold zero taps, scales and biases
            if (STATS) {
              sum[jj][e][0] += v[e];
              sum[jj][e][1] += v[e] * v[e];
            }
          }
          store2(a, yp, it.co0 + jj * 8 + 2 * tig, v[0], v[1]);
        }
      }
      if (!STATS || (a.warp_stats && i != MI - 1)) continue;
      // this slot's sums: the 8 row lanes of each channel, then lane tig
      float* slot = red + (a.warp_stats ? warp : warp * MI + i) * BN * 2;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float t = sum[jj][e][k];
            t += __shfl_xor_sync(0xFFFFFFFFu, t, 4);
            t += __shfl_xor_sync(0xFFFFFFFFu, t, 8);
            t += __shfl_xor_sync(0xFFFFFFFFu, t, 16);
            if (lane < 4) slot[(jj * 8 + 2 * tig + e) * 2 + k] = t;
            sum[jj][e][k] = 0.f;
          }
    }
    if (!STATS) continue;
    __syncthreads();  // the slots are written; the next write to them
                      // follows the next chunk's barrier
    for (int e = tid; e < a.g * BN; e += THREADS) {
      const int gi = e / BN, ch = e - gi * BN;
      const int nn = it.n0 + gi, co = it.co0 + ch;
      if (nn >= a.n || co >= a.cout) continue;
      float s1 = 0.f, s2 = 0.f;
      for (int k = 0; k < a.spi; ++k) {
        const float* slot = red + ((gi * a.spi + k) * BN + ch) * 2;
        s1 += slot[0];
        s2 += slot[1];
      }
      float* out =
          a.partial + ((size_t)nn * a.tiles + it.tile) * 2 * a.cout + co;
      out[0] = s1;
      out[a.cout] = s2;
    }
  }
  cp_async_wait<0>();
}

// Split-K: y = epilogue(sum of the splits in order) and, for kernel 1, the
// statistics' partial sums.  grid: x = spatial tile, y = block of FINISH_BN
// channels, z = image group; bm pixels a tile.
__global__ void __launch_bounds__(FINISH_THREADS)
    conv3x3_tf32_finish_kernel(const Args a, int bm) {
  extern __shared__ __align__(16) float fsmem[];
  float* vs = fsmem;                   // [bm][FINISH_VS], zero where masked
  float* red = fsmem + bm * FINISH_VS;  // the segments' sums
  Item it;
  it.tile = blockIdx.x;
  it.ty0 = (it.tile / a.tiles_x) * a.th;
  it.tx0 = (it.tile % a.tiles_x) * a.tw;
  it.co0 = blockIdx.y * FINISH_BN;
  it.n0 = blockIdx.z * a.g;
  it.split = 0;
  const size_t plane = (size_t)a.n * a.h * a.wd * a.cout;
  for (int i = threadIdx.x; i < bm * FINISH_BN; i += FINISH_THREADS) {
    const int p = i / FINISH_BN;
    const int c = i - p * FINISH_BN;
    const int co = it.co0 + c;
    const Pix q = pixel(a, p, it);
    float v = 0.f;
    if (q.ok && co < a.cout) {
      const size_t off = q.idx * a.cout + co;
      float s = 0.f;
      for (int sp = 0; sp < a.splits; ++sp) s += a.ws[sp * plane + off];
      if (a.noise != nullptr) s += a.noise[q.idx] * a.nscale[co];
      if (a.bias != nullptr) s += a.bias[co];
      v = activate(a, s);
      a.y[off] = v;
    }
    vs[p * FINISH_VS + c] = v;
  }
  if (a.partial == nullptr) return;
  __syncthreads();
  // Statistics per (image, channel): each of S threads sums one contiguous
  // segment of the image's tile pixels, then one thread adds the S segments
  // in order.  E, S and the block's threads are powers of two.
  const int per = a.th * a.tw;
  const int E = a.g * FINISH_BN;
  const int S = E >= FINISH_THREADS ? 1 : FINISH_THREADS / E;
  const int len = (per + S - 1) / S;
  for (int i = threadIdx.x; i < E * S; i += FINISH_THREADS) {
    const int seg = i / E, e = i - seg * E;
    const int gi = e / FINISH_BN, c = e - gi * FINISH_BN;
    const int end = min(per, (seg + 1) * len);
    float s1 = 0.f, s2 = 0.f;
    for (int q = seg * len; q < end; ++q) {
      const float v = vs[(gi * per + q) * FINISH_VS + c];
      s1 += v;
      s2 += v * v;
    }
    red[(seg * E + e) * 2] = s1;
    red[(seg * E + e) * 2 + 1] = s2;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += FINISH_THREADS) {
    const int gi = e / FINISH_BN, c = e - gi * FINISH_BN;
    const int nn = it.n0 + gi, co = it.co0 + c;
    if (nn >= a.n || co >= a.cout) continue;
    float s1 = 0.f, s2 = 0.f;
    for (int seg = 0; seg < S; ++seg) {
      s1 += red[(seg * E + e) * 2];
      s2 += red[(seg * E + e) * 2 + 1];
    }
    float* out =
        a.partial + ((size_t)nn * a.tiles + it.tile) * 2 * a.cout + co;
    out[0] = s1;
    out[a.cout] = s2;
  }
}

// ---------------------------------------------------------------- host ----

template <int BN, int WM, int MI, int CK, int KERNEL>
static int launch(const Args& a, cudaStream_t st) {
  constexpr bool STATS = KERNEL == 1 || KERNEL == 6;
  constexpr int THREADS = WM * 32;
  constexpr int BM = 16 * MI * WM;
  const Layout L = layout(BN, CK, a.g, a.th, a.tw, a.stages, a.resident,
                          a.chunks, WM, MI, STATS);
  if (L.smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kern = conv3x3_tf32_kernel<BN, WM, MI, CK, KERNEL>;
  int rc = 0;
  if (L.smem > 48 * 1024 &&
      (rc = (int)cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem)))
    return rc;
  int grid = a.items;
  if (a.splits == 1) {
    // persistent: as many blocks as fit on the card, at most one per item
    int dev = 0, sms = 0, per_sm = 0;
    if ((rc = (int)cudaGetDevice(&dev)) ||
        (rc = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, THREADS, L.smem)))
      return rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if ((long long)per_sm * sms < grid) grid = per_sm * sms;
  }
  kern<<<grid, THREADS, L.smem, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc || a.splits == 1) return rc;
  // The finish blocks take FINISH_BN channels each, not BN: a split plan has
  // few tiles (that is why it splits), and the reduction is spread over
  // BN / FINISH_BN times more SMs.  The statistics are per channel, so a
  // narrower block writes the same partials.
  const int e = a.g * FINISH_BN;
  const int fsmem =
      (BM * FINISH_VS + 2 * (e > FINISH_THREADS ? e : FINISH_THREADS)) * 4;
  const dim3 fgrid(a.tiles, (a.cout + FINISH_BN - 1) / FINISH_BN,
                   (a.n + a.g - 1) / a.g);
  conv3x3_tf32_finish_kernel<<<fgrid, FINISH_THREADS, fsmem, st>>>(a, BM);
  return (int)cudaGetLastError();
}

template <int BN, int WM, int MI, int KERNEL>
static int dispatch_ck(const Args& a, int ck, cudaStream_t st) {
  return ck == 8 ? launch<BN, WM, MI, 8, KERNEL>(a, st)
                 : launch<BN, WM, MI, 16, KERNEL>(a, st);
}

// plan = {bn, wm, mi, ck, tw, th, g, stages, resident, splits, cps} from
// kernels/tc_plan.py::plan_f32.  Fills the plan's fields of `a` after
// checking them; returns a CUDA error code (cudaErrorInvalidValue for a
// plan this header does not take).  KERNEL 1 is given noise, nscale and
// partial; kernels 2 and 3 none of them.  6 and 7 are 1 and 2 over a row
// band (a.h counts the output rows, x holds a.h + 2).
template <int KERNEL>
inline int run(Args a, const int* plan, cudaStream_t st) {
  static_assert((KERNEL >= 1 && KERNEL <= 3) || KERNEL == 6 || KERNEL == 7,
                "kernel 1, 2, 3, 6 or 7");
  constexpr bool STATS = KERNEL == 1 || KERNEL == 6;
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const bool k1 =
      a.noise != nullptr && a.nscale != nullptr && a.partial != nullptr;
  if (STATS ? !k1
            : (a.noise != nullptr || a.nscale != nullptr ||
               a.partial != nullptr))
    return (int)cudaErrorInvalidValue;
  const int bn = plan[0], wm = plan[1], mi = plan[2], ck = plan[3];
  a.tw = plan[4];
  a.th = plan[5];
  a.g = plan[6];
  a.stages = plan[7];
  a.resident = plan[8];
  a.splits = plan[9];
  a.cps = plan[10];
  // the instantiated (BN, WM, MI): 4 warps of 32 or 64 pixels at BN <= 16,
  // 4 or 8 warps of 32 pixels at BN 32 and 64
  const bool tile_ok = bn == 8 || bn == 16
                           ? wm == 4 && (mi == 2 || mi == 4)
                           : (bn == 32 || bn == 64) && (wm == 4 || wm == 8) &&
                                 mi == 2;
  const bool shape_ok =
      tile_ok && (ck == 8 || ck == 16) &&
      (a.tw == 4 || a.tw == 8 || a.tw == 16) && a.th >= 1 && a.g >= 1 &&
      a.tw * a.th * a.g == 16 * mi * wm && (a.stages == 2 || a.stages == 3) &&
      (a.resident == 0 || a.resident == 1) && a.splits >= 1 && a.cps >= 1;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  a.chunks = (a.cin + ck - 1) / ck;
  // every Cin chunk in exactly one split, no split empty
  if ((long long)(a.splits - 1) * a.cps >= a.chunks ||
      (long long)a.splits * a.cps < a.chunks)
    return (int)cudaErrorInvalidValue;
  if (a.splits > 1 && (a.ws == nullptr || a.resident))
    return (int)cudaErrorInvalidValue;
  a.tiles_x = (a.wd + a.tw - 1) / a.tw;
  a.cout_blocks = (a.cout + bn - 1) / bn;
  if (a.resident && a.cout_blocks != 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)a.tiles_x * ((a.h + a.th - 1) / a.th);
  const long long groups = (a.n + a.g - 1) / a.g;
  const long long items = tiles * a.cout_blocks * groups * a.splits;
  // the finish kernel's grid is (tiles, Cout / FINISH_BN, image groups)
  if (items >= (1LL << 31) ||
      (a.splits > 1 &&
       ((a.cout + FINISH_BN - 1) / FINISH_BN > 65535 || groups > 65535)))
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.items = (int)items;
  // the statistics' slots: an m16 fragment, or a whole warp, in one image
  const int per = a.th * a.tw;
  if (STATS && per % 16 != 0) return (int)cudaErrorInvalidValue;
  a.warp_stats = per % (16 * mi) == 0;
  a.spi = per / (a.warp_stats ? 16 * mi : 16);
  a.fd_wp.set(a.tw + 2);
  a.fd_hp.set(a.th + 2);
  a.fd_per.set(per);
  a.fd_tw.set(a.tw);
  a.vec_x = a.cin % 4 == 0 && aligned(a.x, 16);
  a.vec_w = a.cout % 4 == 0 && aligned(a.w, 16);
  a.vec_y = a.cout % 2 == 0 && aligned(a.y, 8) && aligned(a.ws, 8);
  switch (bn * 10 + wm * mi / 2) {
    case 84:
      return dispatch_ck<8, 4, 2, KERNEL>(a, ck, st);
    case 88:
      return dispatch_ck<8, 4, 4, KERNEL>(a, ck, st);
    case 164:
      return dispatch_ck<16, 4, 2, KERNEL>(a, ck, st);
    case 168:
      return dispatch_ck<16, 4, 4, KERNEL>(a, ck, st);
    case 324:
      return dispatch_ck<32, 4, 2, KERNEL>(a, ck, st);
    case 328:
      return dispatch_ck<32, 8, 2, KERNEL>(a, ck, st);
    case 644:
      return dispatch_ck<64, 4, 2, KERNEL>(a, ck, st);
    default:
      return dispatch_ck<64, 8, 2, KERNEL>(a, ck, st);
  }
}

}  // namespace
}  // namespace tf32
}  // namespace gst
