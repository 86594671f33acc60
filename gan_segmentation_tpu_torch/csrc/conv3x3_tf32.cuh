// Tensor-core implicit GEMM for the f32 3x3 convolutions of kernel 3
// (bil_conv.cu), in the 3xTF32 split.  The bf16 calls of kernels 1 and 2
// run conv3x3_tc.cuh; this header is its f32 counterpart.
//
// Layout: x is NHWC, w is HWIO (3, 3, Cin, Cout), stride 1, zero pad 1.
// GEMM view: M = output pixels, N = output channels, K = 9 taps x Cin.
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
// MI, CK, TW, TH, G, stages, resident) is chosen on the host by
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
// Epilogue.  v = acc [+ bias], then none / relu / leaky, stored straight
// from the accumulators as float2 (two adjacent channels of one pixel),
// masked at the ragged edge and beyond Cout (Cout = 2 keeps 2 of N = 8).
// Summation order is fixed and there are no atomics: repeats are
// bit-identical.
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
// then, where resident, every chunk's taps.  Floats unless noted.
struct Layout {
  int hp, wp;   // halo rows and columns per image
  int halo;     // one stage's halo
  int taps;     // one chunk's taps: 9 x CK x pad_n(BN)
  int stage;    // halo, plus taps unless resident
  int smem;     // bytes
};

__host__ __device__ inline Layout layout(int bn, int ck, int g, int th,
                                         int tw, int stages, int resident,
                                         int chunks) {
  Layout L;
  L.hp = th + 2;
  L.wp = tw + 2;
  L.halo = g * L.hp * L.wp * pad_px(ck);
  L.taps = 9 * ck * pad_n(bn);
  L.stage = L.halo + (resident ? 0 : L.taps);
  L.smem = (stages * L.stage + (resident ? chunks * L.taps : 0)) * 4;
  return L;
}

// Everything a launch reads; passed by value.
struct Args {
  const float* x;
  const float* w;
  const float* bias;  // (Cout,) or null
  float* y;
  int n, h, wd, cin, cout;
  int act;
  float slope;
  // the plan and what follows from it (run() fills these)
  int tw, th, g, stages, resident;
  int chunks, tiles_x, tiles, cout_blocks, items;
  FastDiv fd_wp, fd_hp, fd_per, fd_tw;
  int vec_x, vec_w;  // 16-byte cp.async allowed
  int vec_y;         // float2 stores allowed
};

// ---------------------------------------------------------------- PTX ----

// v = hi + lo with hi = v truncated to tf32 and lo = (v - hi), exact in
// f32, truncated to tf32 too: |v - hi - lo| < 2^-20 |v|.
__device__ __forceinline__ void split(uint32_t v, uint32_t& hi,
                                      uint32_t& lo) {
  hi = v & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi)) &
       0xFFFFE000u;
}

// c += a * b on a 16 x 8 x 8 tile; a pure register op, so not volatile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ helpers ----

// One work item: a spatial tile of G images for BN output channels.
struct Item {
  int ty0, tx0, co0, n0;
};

__device__ __forceinline__ Item item(const Args& a, int w, int bn) {
  Item t;
  const int rest = w / a.cout_blocks;
  t.co0 = (w - rest * a.cout_blocks) * bn;
  const int grp = rest / a.tiles;
  const int tile = rest - grp * a.tiles;
  const int ty = tile / a.tiles_x;
  t.ty0 = ty * a.th;
  t.tx0 = (tile - ty * a.tiles_x) * a.tw;
  t.n0 = grp * a.g;
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
template <int CK>
__device__ __forceinline__ void load_halo(const Args& a, const Layout& L,
                                          float* st, int chunk,
                                          const Item& it, int tid,
                                          int threads) {
  constexpr int PS = pad_px(CK);
  const int c0 = chunk * CK;
  const int hpx = a.g * L.hp * L.wp;
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
      const int iy = it.ty0 - 1 + hy, ix = it.tx0 - 1 + hx, c = c0 + c4 * 4;
      const bool ok = nn < a.n && iy >= 0 && iy < a.h && ix >= 0 &&
                      ix < a.wd && c < a.cin;
      const float* src =
          ok ? a.x + (((size_t)nn * a.h + iy) * a.wd + ix) * a.cin + c : a.x;
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
      const int iy = it.ty0 - 1 + hy, ix = it.tx0 - 1 + hx, c = c0 + ci;
      float v = 0.f;
      if (nn < a.n && iy >= 0 && iy < a.h && ix >= 0 && ix < a.wd &&
          c < a.cin)
        v = a.x[(((size_t)nn * a.h + iy) * a.wd + ix) * a.cin + c];
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

// Load position q of the block's (item, chunk) sequence into stage q % stages.
template <int BN, int CK>
__device__ __forceinline__ void load_pos(const Args& a, const Layout& L,
                                         float* ring, int q, int first,
                                         int step, int tid, int threads) {
  const int j = q / a.chunks;
  const int c = q - j * a.chunks;
  const Item it = item(a, first + j * step, BN);
  float* st = ring + (q % a.stages) * L.stage;
  load_halo<CK>(a, L, st, c, it, tid, threads);
  if (!a.resident) load_taps<BN, CK>(a, st + L.halo, c, it.co0, tid, threads);
}

__device__ __forceinline__ float activate(const Args& a, float v) {
  if (a.act == RELU) return fmaxf(v, 0.f);
  if (a.act == LEAKY) return v >= 0.f ? v : a.slope * v;
  return v;
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
// The ring runs over the flattened (item, chunk) sequence, so the next
// item's first chunks load while this item multiplies and stores.
template <int BN, int WM, int MI, int CK>
__global__ void __launch_bounds__(WM * 32, Cfg<BN, WM, MI>::MIN_BLOCKS)
    conv3x3_tf32_kernel(const Args a) {
  constexpr int THREADS = WM * 32;
  constexpr int NJ = BN / 8;  // n8 fragments per warp
  constexpr int PS = pad_px(CK);
  constexpr int BNP = pad_n(BN);
  extern __shared__ __align__(128) float smem[];

  const Layout L = layout(BN, CK, a.g, a.th, a.tw, a.stages, a.resident,
                          a.chunks);
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
  const int nc = a.chunks;
  const int total = items * nc;
  const int NS = a.stages;
  float* const resident = smem + NS * L.stage;
  if (a.resident)  // one Cout block: every item uses the same taps
    for (int c = 0; c < nc; ++c)
      load_taps<BN, CK>(a, resident + c * L.taps, c, 0, tid, THREADS);
  for (int s = 0; s < NS - 1; ++s) {
    if (s < total)
      load_pos<BN, CK>(a, L, smem, s, first, step, tid, THREADS);
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
      load_pos<BN, CK>(a, L, smem, q + NS - 1, first, step, tid, THREADS);
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
          for (int e = 0; e < 4; ++e) split(r[e], ah[i][e], al[i][e]);
        }
        const float* wk = wb + (tap * CK + kk * 8) * BNP;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          uint32_t bh0, bl0, bh1, bl1;
          split(__float_as_uint(wk[jj * 8]), bh0, bl0);
          split(__float_as_uint(wk[4 * BNP + jj * 8]), bh1, bl1);
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
    float bias[NJ][2];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = it.co0 + jj * 8 + 2 * tig + e;
        bias[jj][e] = (a.bias != nullptr && co < a.cout) ? a.bias[co] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const Pix px =
            pixel(a, warp * 16 * MI + i * 16 + lane / 4 + half * 8, it);
        if (!px.ok) continue;
        float* yp = a.y + px.idx * a.cout;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int co = it.co0 + jj * 8 + 2 * tig;
          const float v0 = activate(a, acc[i][jj][2 * half] + bias[jj][0]);
          const float v1 =
              activate(a, acc[i][jj][2 * half + 1] + bias[jj][1]);
          if (a.vec_y) {  // Cout even: co < Cout means co + 1 < Cout too
            if (co < a.cout)
              *reinterpret_cast<float2*>(yp + co) = make_float2(v0, v1);
          } else {
            if (co < a.cout) yp[co] = v0;
            if (co + 1 < a.cout) yp[co + 1] = v1;
          }
        }
      }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- host ----

template <int BN, int WM, int MI, int CK>
static int launch(const Args& a, cudaStream_t st) {
  constexpr int THREADS = WM * 32;
  const Layout L = layout(BN, CK, a.g, a.th, a.tw, a.stages, a.resident,
                          a.chunks);
  if (L.smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kern = conv3x3_tf32_kernel<BN, WM, MI, CK>;
  int rc = 0;
  if (L.smem > 48 * 1024 &&
      (rc = (int)cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem)))
    return rc;
  // persistent: as many blocks as fit on the card, at most one per item
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) ||
      (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, L.smem)))
    return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int grid = a.items;
  if ((long long)per_sm * sms < grid) grid = per_sm * sms;
  kern<<<grid, THREADS, L.smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BN, int WM, int MI>
static int dispatch_ck(const Args& a, int ck, cudaStream_t st) {
  return ck == 8 ? launch<BN, WM, MI, 8>(a, st)
                 : launch<BN, WM, MI, 16>(a, st);
}

// plan = {bn, wm, mi, ck, tw, th, g, stages, resident} from
// kernels/tc_plan.py::plan_f32.  Fills the plan's fields of `a` after
// checking them; returns a CUDA error code (cudaErrorInvalidValue for a
// plan this header does not take).
inline int run(Args a, const int* plan, cudaStream_t st) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const int bn = plan[0], wm = plan[1], mi = plan[2], ck = plan[3];
  a.tw = plan[4];
  a.th = plan[5];
  a.g = plan[6];
  a.stages = plan[7];
  a.resident = plan[8];
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
      (a.resident == 0 || a.resident == 1);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  a.chunks = (a.cin + ck - 1) / ck;
  a.tiles_x = (a.wd + a.tw - 1) / a.tw;
  a.cout_blocks = (a.cout + bn - 1) / bn;
  if (a.resident && a.cout_blocks != 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)a.tiles_x * ((a.h + a.th - 1) / a.th);
  const long long groups = (a.n + a.g - 1) / a.g;
  const long long items = tiles * a.cout_blocks * groups;
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.items = (int)items;
  a.fd_wp.set(a.tw + 2);
  a.fd_hp.set(a.th + 2);
  a.fd_per.set(a.th * a.tw);
  a.fd_tw.set(a.tw);
  a.vec_x = a.cin % 4 == 0 && aligned(a.x, 16);
  a.vec_w = a.cout % 4 == 0 && aligned(a.w, 16);
  a.vec_y = a.cout % 2 == 0 && aligned(a.y, 8);
  switch (bn * 10 + wm * mi / 2) {
    case 84:
      return dispatch_ck<8, 4, 2>(a, ck, st);
    case 88:
      return dispatch_ck<8, 4, 4>(a, ck, st);
    case 164:
      return dispatch_ck<16, 4, 2>(a, ck, st);
    case 168:
      return dispatch_ck<16, 4, 4>(a, ck, st);
    case 324:
      return dispatch_ck<32, 4, 2>(a, ck, st);
    case 328:
      return dispatch_ck<32, 8, 2>(a, ck, st);
    case 644:
      return dispatch_ck<64, 4, 2>(a, ck, st);
    default:
      return dispatch_ck<64, 8, 2>(a, ck, st);
  }
}

}  // namespace
}  // namespace tf32
}  // namespace gst
