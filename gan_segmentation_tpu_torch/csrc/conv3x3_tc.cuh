// Tensor-core implicit GEMM for the bf16 and s8 3x3 convolutions of kernels
// 1 and 2 (conv_in_stats.cu, small_conv.cu, their *_s8.cu and *_rows.cu
// forms) where TMA's rules keep a call off the Hopper body of
// conv3x3_sm90.cuh (kernels/tc_plan.py::plan_bf16 and plan_s8 pick the
// body).  The f32 calls run the 3xTF32 kernel of conv3x3_tf32.cuh.
//
// Layout: x is NHWC, w is HWIO (3, 3, Cin, Cout), stride 1, zero pad 1.
// GEMM view: M = output pixels, N = output channels, K = 9 taps x Cin.
//
// Block tile.  A block computes BM = 32 * WM output pixels for BN output
// channels: G images x TH rows x TW columns at the same spatial tile (G > 1
// where an image is smaller than the tile, e.g. 4^2 and 8^2).  The plan
// (BN, WM, CK, TW, TH, G, split-K, stages) is chosen on the host by
// kernels/tc_plan.py and validated here.  Each warp owns 32 pixels (two m16
// fragments) and BN / WN channels: WN = 2 only for a 128-pixel block of 64
// channels; a 256-pixel block of 64 channels gives each warp a 32 x 64
// tile, which halves the ldmatrix bytes per MMA of the Cin 64-512 layers.
// Blocks are persistent: as many as fit on the card walk the list of
// (tile, Cout block) items, Cout block fastest so that the blocks in flight
// share their input tile in L2.
//
// Staging.  The loop over Cin takes CK (16 or 32) channels per stage.  A
// stage holds the (TH+2) x (TW+2) input halo of each of the G images, KEPT
// AS bf16, with the pixel stride padded to an odd number of 16-byte units so
// that the 8 rows of an ldmatrix fall in 8 different bank groups, and the
// 9 x CK x BN tap slice (row stride padded the same way), and in kernel 1
// the item's BM noise values.  Two or three stages form a ring filled by
// cp.async.cg 16-byte copies, with src-size 0 (zero fill) beyond the image
// and beyond Cin / Cout, so the pad and ragged tiles cost nothing in the
// loop.  The ring runs over the block's whole (item, chunk) sequence: where
// Cin is one or two chunks (every layer from 256^2 up) the next item's
// halo loads while this item multiplies and stores, which a ring inside
// one tile could not give.  cp.async rather than TMA: a TMA box lands
// densely (pixel stride = CK * 2 bytes, a 4-way ldmatrix conflict without a
// swizzle the shifted per-row addresses would then have to undo), a block
// of G small images would need G boxes, and Cin % 8 != 0 breaks TMA's
// 16-byte stride rule; cp.async gives the padded layout and handles all of
// these with one loop.  Where Cin % 8 != 0, Cout % 8 != 0 or a pointer is
// not 16-byte aligned, that operand is staged with scalar zero-filled loads
// instead (same layout, same kernel).
//
// MMA.  mma.sync.m16n8k16.f32.bf16.bf16 with A from ldmatrix.x4 at each
// tap's (ky, kx) shift of the halo (ldmatrix takes one address per row, so
// a one-pixel shift costs nothing) and B from ldmatrix.x4.trans of the tap
// slice.  mma.sync rather than wgmma: every path layer from 256^2 up sits
// below the bf16 ridge (17-284 flop/byte), where the bound is bytes and
// not the multiply rate, and the Cin-512 layers that sit above it are small
// (4^2-32^2) and bound by block count and latency.  Per-warp fragments let
// each warp address its own shifted halo rows, with no warpgroup-wide
// descriptor layout for A.  bf16 x bf16 products are exact in f32 and the
// sum is f32: the contract's numerics up to summation order.
//
// Small outputs.  Where the grid has fewer blocks than SMs (the Cin-512
// layers at 4^2-16^2) the plan splits K over Cin chunks: each split writes
// its f32 sums to a workspace, and a second kernel adds the splits in a
// fixed order (no float atomics, so repeats are bit-identical) and runs the
// epilogue, in blocks of FINISH_BN channels so that it too spreads over the
// SMs.
//
// Epilogue.  v = acc [+ noise * nscale] [+ bias], then none / relu / leaky,
// staged through shared memory as f32.  From there y is stored in bf16 as
// 16-byte vectors (masked at the ragged edge), and kernel 1's per-(image,
// tile) partial sums of v and v^2 are taken in a fixed pixel order from the
// f32 values before the bf16 rounding; a block spanning G images writes one
// partial per image.
//
// s8 body (int8 generation; the s8 entry points of both kernels where
// tc_plan.plan_s8 refuses the Hopper body: Cin % 16 != 0, kernel 1 at W % 4
// != 0, an unaligned view).  x and w
// are s8 and the MMA is mma.sync.m16n8k32.s32.s8.s8.s32: exact integer
// sums, in any order, so a split-K adds its s32 partials exactly too.  A
// stage holds CK = 32 or 64 channels, the same 32 or 64 bytes a pixel as
// bf16's CK = 16 or 32, so the halo, its padding and A's ldmatrix offsets
// are the bf16 body's in bytes.  B differs: ldmatrix.trans moves 16-bit
// elements and cannot transpose s8, so w comes laid out [tap][Cout][Cin]
// (K contiguous, the host lays it out once per quantization) and B's
// fragments are plain ldmatrix rows of a [n][k] tap slice.  The epilogue
// dequantizes first, v = float(acc) * deq[c], with every product and sum
// rounded separately (__fmul_rn, __fadd_rn: never a fused multiply-add), so
// its f32 values are those of the plain version's ops in the same order.
// y is stored in bf16, or in f32 where the caller asks (the f32 compute
// dtype, and the exactness check with deq = 1).
//
// Row bands (entry points 6 and 7: kernels 1 and 2 in bf16 over one band
// of an image's rows, generate --spatial).  x carries the band's rows and
// one halo row above and below it, which the caller placed there (a
// neighbour's edge row, or zeros at the image's top and bottom): H_in =
// H_out + 2, no zero pad in H, the zero pad in W as before.  Only the
// staging's input row differs (output row oy reads input rows oy..oy+2 of
// x); the tiles, the plan, the epilogue and kernel 1's statistics run over
// the H_out output rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_util.cuh"  // FastDiv, cp.async, ldmatrix, aligned

namespace gst {
namespace tc {
// internal linkage: each including file gets its own copy of the kernels
namespace {

constexpr int MAX_SMEM = 232448;  // a block's shared-memory limit on sm_90
constexpr int FINISH_THREADS = 256;
constexpr int FINISH_BN = 8;  // output channels per split-K finish block

enum Act { NONE = 0, RELU = 1, LEAKY = 2 };

// The entry point that launches a body (the kernels' last template
// argument, which a profile shows): 1 conv_in_stats and 2 small_conv in
// bf16, 4 and 5 the same two in s8, 6 and 7 the same two in bf16 over a
// row band.
__host__ __device__ constexpr bool is_s8(int kernel) {
  return kernel == 4 || kernel == 5;
}
__host__ __device__ constexpr bool is_rows(int kernel) {
  return kernel == 6 || kernel == 7;
}

// x's and w's element and the accumulator of each body.
template <bool S8>
struct Elem {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int BYTES = 2;
};
template <>
struct Elem<true> {
  using T = int8_t;
  using Acc = int;
  static constexpr int BYTES = 1;
};

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// A row of b bytes (a multiple of 16) padded to an odd number of 16-byte
// units: 8 consecutive rows then start in 8 different bank groups.
__host__ __device__ constexpr int pad16(int b) {
  return ((b / 16) % 2 == 0) ? b + 16 : b;
}

// Shared-memory layout of one launch (runtime G, TH, TW and stage count),
// in bytes: the ring of `stages` stages, then the f32 epilogue tile and the
// statistics' segment sums, which live apart from the ring so that the
// next item's loads can land while this item's epilogue runs.
struct Layout {
  int hp, wp;         // halo rows and columns per image
  int halo_bytes;     // one stage's halo
  int noise_off;      // bytes before the stage's noise (after the taps)
  int stage_bytes;    // halo + taps + noise
  int ring_bytes;
  int vs;             // f32 row stride of the epilogue tile
  int smem;           // bytes
};

__host__ __device__ inline int red_floats(int threads, int g, int bn) {
  return 2 * (threads > g * bn ? threads : g * bn);
}

// eb: bytes of an element (2 bf16, 1 s8).  The taps of a stage: bf16 as
// [tap][CK][BN], s8 as [tap][BN][CK], each row padded by pad16.
__host__ __device__ inline Layout layout(int bn, int ck, int eb, int bm,
                                         int threads, int g, int th, int tw,
                                         int stages, bool noise) {
  Layout L;
  L.hp = th + 2;
  L.wp = tw + 2;
  L.halo_bytes = g * L.hp * L.wp * pad16(ck * eb);
  L.noise_off = L.halo_bytes +
                (eb == 2 ? 9 * ck * pad16(2 * bn) : 9 * bn * pad16(ck));
  L.stage_bytes = L.noise_off + (noise ? 4 * bm : 0);  // bm f32 values
  L.ring_bytes = stages * L.stage_bytes;
  L.vs = bn + 4;
  L.smem = L.ring_bytes + (bm * L.vs + red_floats(threads, g, bn)) * 4;
  return L;
}

// Everything a launch reads; passed by value.
struct Args {
  const void* x;        // NHWC: bf16, or s8 (s8 body)
  const void* w;        // bf16 HWIO, or s8 [tap][Cout][Cin] (s8 body)
  const float* deq;     // s8 body: (Cout,) dequantization multipliers
  const float* bias;    // (Cout,) or null
  const float* noise;   // (N, H, W) or null (kernel 2)
  const float* nscale;  // (Cout,) with noise
  void* y;              // NHWC: bf16, or f32 where y_f32 (s8 body)
  int y_f32;
  float* partial;       // (N, tiles, 2, Cout) or null (kernel 2)
  float* ws;            // (splits, N*H*W, Cout) f32 (s8: s32) when splits > 1
  int n, h, wd, cin, cout;
  int act;
  float slope;
  // the plan and what follows from it (run() fills these)
  int tw, th, g, splits, cps, stages;
  int chunks, tiles_x, tiles, cout_blocks, items;
  int b_resident;  // every item's stage s holds the same taps: load once
  FastDiv fd_wp, fd_hp, fd_per, fd_tw;
  int vec_x, vec_w, vec_y;  // 16-byte paths allowed
};

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_n(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_n(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ helpers ----

// One work item: a spatial tile of G images for BN output channels and one
// Cin split.  Items run Cout-block fastest, so the blocks in flight at once
// share their input tile in L2.
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

__device__ __forceinline__ Pix pixel(const Args& a, int p, int n0, int ty0,
                                     int tx0) {
  const int gi = a.fd_per.div(p);
  const int rem = p - gi * a.th * a.tw;
  const int ry = a.fd_tw.div(rem);
  const int nn = n0 + gi;
  const int oy = ty0 + ry;
  const int ox = tx0 + rem - ry * a.tw;
  Pix q;
  q.ok = nn < a.n && oy < a.h && ox < a.wd;
  q.idx = ((size_t)nn * a.h + oy) * a.wd + ox;
  return q;
}

// A channel's noise scale, bias and dequantization multiplier (0 where
// absent or co >= cout).
struct Chan {
  float ns, b, dq;
};

__device__ __forceinline__ Chan channel(const Args& a, int co) {
  Chan ch;
  const bool ok = co < a.cout;
  ch.ns = (ok && a.noise != nullptr) ? a.nscale[co] : 0.f;
  ch.b = (ok && a.bias != nullptr) ? a.bias[co] : 0.f;
  ch.dq = (ok && a.deq != nullptr) ? a.deq[co] : 0.f;
  return ch;
}

// The epilogue of one accumulator of channel ch; nz is the pixel's noise
// (kernel 1).
__device__ __forceinline__ float epilogue(const Args& a, float v, float nz,
                                          Chan ch) {
  if (a.noise != nullptr) v += nz * ch.ns;
  if (a.bias != nullptr) v += ch.b;
  if (a.act == RELU)
    v = fmaxf(v, 0.f);
  else if (a.act == LEAKY)
    v = v >= 0.f ? v : a.slope * v;
  return v;
}

// s8: dequantize, then the same steps, each rounded on its own.
__device__ __forceinline__ float epilogue(const Args& a, int acc, float nz,
                                          Chan ch) {
  float v = __fmul_rn(__int2float_rn(acc), ch.dq);
  if (a.noise != nullptr) v = __fadd_rn(v, __fmul_rn(nz, ch.ns));
  if (a.bias != nullptr) v = __fadd_rn(v, ch.b);
  if (a.act == RELU)
    v = fmaxf(v, 0.f);
  else if (a.act == LEAKY)
    v = v >= 0.f ? v : __fmul_rn(a.slope, v);
  return v;
}

// Stage chunk `chunk` of Cin: the halo of G images, the taps (unless
// resident) and, on the item's last chunk in kernel 1, the noise of its bm
// pixels, so the epilogue reads it from shared memory.
template <int BN, int CK, bool S8, bool ROWS>
__device__ __forceinline__ void load_stage(const Args& a, const Layout& L,
                                           unsigned char* st, int chunk,
                                           const Item& it, bool taps,
                                           bool noise, int bm, int tid,
                                           int threads) {
  using T = typename Elem<S8>::T;
  constexpr int EB = Elem<S8>::BYTES;
  constexpr int PS = pad16(CK * EB);  // halo pixel stride, bytes
  constexpr int E16 = 16 / EB;        // elements in 16 bytes
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int c0 = chunk * CK;
  const int hpx = a.g * L.hp * L.wp;
  // a row band's x holds the halo rows: no pad above, H_out + 2 rows
  constexpr int PAD_Y = ROWS ? 0 : 1;
  const int h_in = ROWS ? a.h + 2 : a.h;
  if (a.vec_x) {
    constexpr int U = CK / E16;
    for (int i = tid; i < hpx * U; i += threads) {
      const int px = i / U;
      const int u = i - px * U;
      const int r = a.fd_wp.div(px);
      const int hx = px - r * L.wp;
      const int gi = a.fd_hp.div(r);
      const int hy = r - gi * L.hp;
      const int nn = it.n0 + gi;
      const int iy = it.ty0 - PAD_Y + hy, ix = it.tx0 - 1 + hx,
                c = c0 + u * E16;
      const bool ok = nn < a.n && iy >= 0 && iy < h_in && ix >= 0 &&
                      ix < a.wd && c < a.cin;
      const T* src =
          ok ? x + (((size_t)nn * h_in + iy) * a.wd + ix) * a.cin + c : x;
      cp_async16(st + px * PS + u * 16, src, ok);
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
      T v = zero<T>();
      if (nn < a.n && iy >= 0 && iy < h_in && ix >= 0 && ix < a.wd &&
          c < a.cin)
        v = x[(((size_t)nn * h_in + iy) * a.wd + ix) * a.cin + c];
      reinterpret_cast<T*>(st + px * PS)[ci] = v;
    }
  }
  if (noise) {
    float* nz = reinterpret_cast<float*>(st + L.noise_off);
    for (int p = tid; p < bm; p += threads) {
      const Pix q = pixel(a, p, it.n0, it.ty0, it.tx0);
      cp_async4(nz + p, q.ok ? a.noise + q.idx : a.noise, q.ok);
    }
  }
  if (!taps) return;
  unsigned char* wt = st + L.halo_bytes;
  if (!S8) {  // [tap][CK][BN]: w's HWIO rows
    constexpr int RB = pad16(BN * 2);
    if (a.vec_w) {
      constexpr int N8 = BN / 8;
      for (int i = tid; i < 9 * CK * N8; i += threads) {
        const int r = i / N8;
        const int j8 = i - r * N8;
        const int tap = r / CK;
        const int ci = r - tap * CK;
        const int c = c0 + ci, o = it.co0 + j8 * 8;
        const bool ok = c < a.cin && o < a.cout;
        const T* src = ok ? w + ((size_t)tap * a.cin + c) * a.cout + o : w;
        cp_async16(wt + (tap * CK + ci) * RB + j8 * 16, src, ok);
      }
    } else {
      for (int i = tid; i < 9 * CK * BN; i += threads) {
        const int r = i / BN;
        const int j = i - r * BN;
        const int tap = r / CK;
        const int ci = r - tap * CK;
        const int c = c0 + ci, o = it.co0 + j;
        T v = zero<T>();
        if (c < a.cin && o < a.cout) v = w[((size_t)tap * a.cin + c) * a.cout + o];
        reinterpret_cast<T*>(wt + (tap * CK + ci) * RB)[j] = v;
      }
    }
  } else {  // [tap][BN][CK]: w's [tap][Cout][Cin] rows, K contiguous
    constexpr int RB = pad16(CK);
    if (a.vec_w) {
      constexpr int U = CK / 16;
      for (int i = tid; i < 9 * BN * U; i += threads) {
        const int r = i / U;
        const int u = i - r * U;
        const int tap = r / BN;
        const int j = r - tap * BN;
        const int c = c0 + u * 16, o = it.co0 + j;
        const bool ok = c < a.cin && o < a.cout;
        const T* src = ok ? w + ((size_t)tap * a.cout + o) * a.cin + c : w;
        cp_async16(wt + r * RB + u * 16, src, ok);
      }
    } else {
      for (int i = tid; i < 9 * BN * CK; i += threads) {
        const int r = i / CK;
        const int ci = i - r * CK;
        const int tap = r / BN;
        const int j = r - tap * BN;
        const int c = c0 + ci, o = it.co0 + j;
        T v = zero<T>();
        if (c < a.cin && o < a.cout) v = w[((size_t)tap * a.cout + o) * a.cin + c];
        reinterpret_cast<T*>(wt + r * RB)[ci] = v;
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Store the item's f32 epilogue tile vs ([bm][vstride], followed by the
// statistics' scratch) as y (bf16, or f32 where y_f32) and, for kernel 1,
// its per-(image, tile) partial sums.  Shared by both kernels.
__device__ __forceinline__ void store_tile(const Args& a, float* vs,
                                           int vstride, int bm, int bn,
                                           const Item it, int tid,
                                           int threads) {
  if (a.vec_y) {  // Cout % 8 == 0: 8 channels (16 or 32 bytes) per store
    const int n8 = bn / 8;
    for (int i = tid; i < bm * n8; i += threads) {
      const int p = i / n8;
      const int c = (i - p * n8) * 8;
      const int co = it.co0 + c;
      const Pix q = pixel(a, p, it.n0, it.ty0, it.tx0);
      if (!q.ok || co >= a.cout) continue;
      const float4 lo = *reinterpret_cast<const float4*>(vs + p * vstride + c);
      const float4 hi =
          *reinterpret_cast<const float4*>(vs + p * vstride + c + 4);
      const size_t off = q.idx * a.cout + co;
      if (a.y_f32) {
        float4* y = reinterpret_cast<float4*>(static_cast<float*>(a.y) + off);
        y[0] = lo;
        y[1] = hi;
      } else {
        uint4 out;
        out.x = pack_bf16(lo.x, lo.y);
        out.y = pack_bf16(lo.z, lo.w);
        out.z = pack_bf16(hi.x, hi.y);
        out.w = pack_bf16(hi.z, hi.w);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y) + off) =
            out;
      }
    }
  } else {  // only the block's real channels (Cout = 2 keeps 2 of N = 8)
    const int cn = min(bn, a.cout - it.co0);
    for (int i = tid; i < bm * cn; i += threads) {
      const int p = i / cn;
      const int c = i - p * cn;
      const Pix q = pixel(a, p, it.n0, it.ty0, it.tx0);
      if (!q.ok) continue;
      const size_t off = q.idx * a.cout + it.co0 + c;
      if (a.y_f32)
        static_cast<float*>(a.y)[off] = vs[p * vstride + c];
      else
        static_cast<__nv_bfloat16*>(a.y)[off] =
            __float2bfloat16(vs[p * vstride + c]);
    }
  }
  if (a.partial == nullptr) return;
  // Statistics per (image, channel): each of S threads sums one contiguous
  // segment of the image's tile pixels (valid ones, in tile order) into
  // red[S][E][2], then one thread adds the S segments in order.  E, S and
  // the block's threads are powers of two.
  const int per = a.th * a.tw;
  const int E = a.g * bn;
  const int S = E >= threads ? 1 : threads / E;
  const int len = (per + S - 1) / S;
  float* red = vs + bm * vstride;
  for (int i = tid; i < E * S; i += threads) {
    const int seg = i / E, e = i - seg * E;
    const int gi = e / bn, c = e - gi * bn;
    const int end = min(per, (seg + 1) * len);
    float s1 = 0.f, s2 = 0.f;
    for (int q = seg * len; q < end; ++q) {
      const int ry = a.fd_tw.div(q);
      if (it.ty0 + ry >= a.h || it.tx0 + q - ry * a.tw >= a.wd) continue;
      const float v = vs[(gi * per + q) * vstride + c];
      s1 += v;
      s2 += v * v;
    }
    red[(seg * E + e) * 2] = s1;
    red[(seg * E + e) * 2 + 1] = s2;
  }
  __syncthreads();
  for (int e = tid; e < E; e += threads) {
    const int gi = e / bn, c = e - gi * bn;
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

// Load position q of the block's (item, chunk) sequence into stage q % ns.
// With resident taps, a stage's taps are loaded on its first fill only.
template <int BN, int CK, bool S8, bool ROWS, int THREADS, int BM>
__device__ __forceinline__ void load_pos(const Args& a, const Layout& L,
                                         unsigned char* ring, int q, int nc,
                                         int ns, int first, int step,
                                         int tid) {
  const int j = q / nc;
  const int c = q - j * nc;
  const Item it = item(a, first + j * step, BN);
  load_stage<BN, CK, S8, ROWS>(a, L, ring + (q % ns) * L.stage_bytes,
                         it.split * a.cps + c, it, !a.b_resident || q < ns,
                         a.noise != nullptr && a.splits == 1 && c == nc - 1,
                         BM, tid, THREADS);
}

// ------------------------------------------------------------- kernels ----

template <int BN, int WM>
struct Warps {
  // warps along N: 2 where a 128-pixel block has 64 channels, else 1 (each
  // warp then takes all BN channels of its 32 pixels)
  static constexpr int WN = BN == 64 && WM == 4 ? 2 : 1;
};

// Blocks per SM asked of ptxas: 3 for the narrow tiles (BN <= 16), which
// caps them at 80 registers (3 blocks of 256 threads per SM) with no spill;
// left without a minimum ptxas spilled the prologue's ldmatrix offsets
// there.  The s8 BN = 16 tile with CK = 64 (two k32 steps a tap) spilled 4
// bytes at 3 and asks for 2.  1 for the wide tiles, which shared memory
// holds to 1-2 blocks per SM anyway.
template <int BN, int CK, int KERNEL>
__host__ __device__ constexpr int min_blocks() {
  return BN > 16 ? 1 : (is_s8(KERNEL) && BN == 16 && CK == 64 ? 2 : 3);
}

// A persistent block walks the items blockIdx.x, blockIdx.x + gridDim.x,
// ... (with a split, the grid has one block per item).  The ring runs over
// the flattened (item, chunk) sequence, so the next item's first chunks
// load while this item multiplies and stores.  KERNEL is the number of the
// entry point that launches it (is_s8), so that a profile tells them apart
// by name; the body is bf16 or s8 by it.
template <int BN, int WM, int CK, int KERNEL>
__global__ void __launch_bounds__(WM * Warps<BN, WM>::WN * 32,
                                  min_blocks<BN, CK, KERNEL>())
    conv3x3_tc_kernel(const Args a) {
  constexpr bool S8 = is_s8(KERNEL);
  constexpr bool ROWS = is_rows(KERNEL);
  using Acc = typename Elem<S8>::Acc;
  constexpr int EB = Elem<S8>::BYTES;
  constexpr int WN = Warps<BN, WM>::WN;
  constexpr int THREADS = WM * WN * 32;
  constexpr int BM = WM * 32;
  constexpr int NW = BN / WN;  // channels per warp
  constexpr int NJ = NW / 8;   // n8 fragments per warp
  constexpr int PS = pad16(CK * EB);           // halo pixel stride, bytes
  constexpr int RB = S8 ? pad16(CK) : pad16(BN * 2);  // tap row, bytes
  constexpr int KSTEPS = CK * EB / 32;         // MMAs per tap and fragment
  static_assert(NJ >= 1, "BN too small");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;

  const Layout L = layout(BN, CK, EB, BM, THREADS, a.g, a.th, a.tw, a.stages,
                          a.noise != nullptr);
  float* vs = reinterpret_cast<float*>(smem + L.ring_bytes);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp % WM, warp_n = warp / WM;

  // this thread's ldmatrix row of A in each m16 fragment, at tap (0, 0)
  // (the same bytes for bf16's k16 and s8's k32 steps)
  uint32_t a_off[2];
  {
    const int r = lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = warp_m * 32 + i * 16 + r;
      const int gi = a.fd_per.div(p), rem = p - gi * a.th * a.tw;
      const int ty = a.fd_tw.div(rem), tx = rem - ty * a.tw;
      a_off[i] = ((gi * L.hp + ty) * L.wp + tx) * PS + 16 * (lane / 16);
    }
  }
  // ... and of B.  bf16 (ldmatrix.trans of [k][n] rows): k row (lane % 8) +
  // 8 * ((lane / 8) % 2), n block lane / 16.  s8 (ldmatrix of [n][k]
  // rows): n row lane % 8 + 8 * (lane / 16), k half (lane / 8) % 2.
  const uint32_t b_off =
      S8 ? L.halo_bytes + (warp_n * NW + (lane / 16) * 8 + lane % 8) * RB +
               ((lane / 8) % 2) * 16
         : L.halo_bytes + (lane % 8 + 8 * ((lane / 8) % 2)) * RB +
               (warp_n * NW + (lane / 16) * 8) * 2;

  const int first = blockIdx.x, step = gridDim.x;
  const int items = (a.items - 1 - first) / step + 1;
  // chunks per item: the same for every item of a block (a split has one
  // item per block)
  const int nc = min(a.chunks - item(a, first, BN).split * a.cps, a.cps);
  const int total = items * nc;
  const int NS = a.stages;
  for (int s = 0; s < NS - 1; ++s) {
    if (s < total)
      load_pos<BN, CK, S8, ROWS, THREADS, BM>(a, L, ring, s, nc, NS, first,
                                              step, tid);
    cp_async_commit();
  }

  Acc acc[2][NJ][4];
  for (int q = 0; q < total; ++q) {
    if (NS == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk q landed; stage (q - 1) % NS is free
    if (q + NS - 1 < total)
      load_pos<BN, CK, S8, ROWS, THREADS, BM>(a, L, ring, q + NS - 1, nc,
                                              NS, first, step, tid);
    cp_async_commit();

    const int j = q / nc;
    const int c = q - j * nc;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj][e] = Acc(0);
    }
    const uint32_t sbase = static_cast<uint32_t>(
        __cvta_generic_to_shared(ring + (q % NS) * L.stage_bytes));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t shift = ((tap / 3) * L.wp + tap % 3) * PS;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(af[i], sbase + a_off[i] + shift + kk * 32);
        uint32_t bf[NJ][2];
        if (S8) {
          const uint32_t brow = sbase + b_off + tap * BN * RB + kk * 32;
#pragma unroll
          for (int jj = 0; jj + 1 < NJ; jj += 2)
            ldsm_x4_n(bf[jj][0], bf[jj][1], bf[jj + 1][0], bf[jj + 1][1],
                      brow + jj * 8 * RB);
          if (NJ % 2)
            ldsm_x2_n(bf[NJ - 1][0], bf[NJ - 1][1], brow + (NJ - 1) * 8 * RB);
        } else {
          const uint32_t brow = sbase + b_off + (tap * CK + kk * 16) * RB;
#pragma unroll
          for (int jj = 0; jj + 1 < NJ; jj += 2)
            ldsm_x4_t(bf[jj][0], bf[jj][1], bf[jj + 1][0], bf[jj + 1][1],
                      brow + jj * 16);
          if (NJ % 2)
            ldsm_x2_t(bf[NJ - 1][0], bf[NJ - 1][1], brow + (NJ - 1) * 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            mma(acc[i][jj], af[i], bf[jj][0], bf[jj][1]);
      }
    }
    if (c != nc - 1) continue;

    // the item's last chunk: epilogue (the next item's loads are in flight)
    const Item it = item(a, first + j * step, BN);
    Acc* ws = reinterpret_cast<Acc*>(a.ws) +
              (size_t)it.split * a.n * a.h * a.wd * a.cout;
    const float* snoise = reinterpret_cast<const float*>(
        ring + (q % NS) * L.stage_bytes + L.noise_off);
    Chan ch[NJ][2];  // this thread's channels, read once per item
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ch[jj][e] = channel(
            a, it.co0 + warp_n * NW + jj * 8 + (lane % 4) * 2 + e);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = warp_m * 32 + i * 16 + lane / 4 + half * 8;
        const Pix px = pixel(a, p, it.n0, it.ty0, it.tx0);
        const float nz =
            (a.noise != nullptr && a.splits == 1) ? snoise[p] : 0.f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = warp_n * NW + jj * 8 + (lane % 4) * 2 + e;
            const int co = it.co0 + cc;
            const Acc v = acc[i][jj][half * 2 + e];
            const bool ok = px.ok && co < a.cout;
            if (a.splits == 1)
              vs[p * L.vs + cc] = ok ? epilogue(a, v, nz, ch[jj][e]) : 0.f;
            else if (ok)
              ws[px.idx * a.cout + co] = v;
          }
      }
    if (a.splits > 1) continue;
    __syncthreads();
    store_tile(a, vs, L.vs, BM, BN, it, tid, THREADS);
  }
  cp_async_wait<0>();
}

// Split-K: y = epilogue(sum of the splits in order), then the same stores.
// grid: x = spatial tile, y = block of bn (FINISH_BN) channels, z = image
// group.  s8 sums the s32 partials (exact).
template <bool S8>
__global__ void __launch_bounds__(FINISH_THREADS)
    conv3x3_tc_finish_kernel(const Args a, int bm, int bn) {
  using Acc = typename Elem<S8>::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  float* vs = reinterpret_cast<float*>(smem);
  const Acc* wsp = reinterpret_cast<const Acc*>(a.ws);
  const int vstride = bn + 4;
  Item it;
  it.tile = blockIdx.x;
  it.ty0 = (it.tile / a.tiles_x) * a.th;
  it.tx0 = (it.tile % a.tiles_x) * a.tw;
  it.co0 = blockIdx.y * bn;
  it.n0 = blockIdx.z * a.g;
  it.split = 0;
  const size_t plane = (size_t)a.n * a.h * a.wd * a.cout;
  for (int i = threadIdx.x; i < bm * bn; i += FINISH_THREADS) {
    const int p = i / bn;
    const int c = i - p * bn;
    const int co = it.co0 + c;
    const Pix q = pixel(a, p, it.n0, it.ty0, it.tx0);
    float v = 0.f;
    if (q.ok && co < a.cout) {
      const size_t off = q.idx * a.cout + co;
      Acc s = Acc(0);
      for (int sp = 0; sp < a.splits; ++sp) s += wsp[sp * plane + off];
      v = epilogue(a, s, a.noise != nullptr ? a.noise[q.idx] : 0.f,
                   channel(a, co));
    }
    vs[p * vstride + c] = v;
  }
  __syncthreads();
  store_tile(a, vs, vstride, bm, bn, it, threadIdx.x, FINISH_THREADS);
}

// ---------------------------------------------------------------- host ----

template <typename K>
static int set_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BN, int WM, int CK, int KERNEL>
static int launch(const Args& a, cudaStream_t st) {
  constexpr bool S8 = is_s8(KERNEL);
  constexpr int BM = WM * 32;
  constexpr int THREADS = WM * Warps<BN, WM>::WN * 32;
  const Layout L = layout(BN, CK, Elem<S8>::BYTES, BM, THREADS, a.g, a.th,
                          a.tw, a.stages, a.noise != nullptr);
  if (L.smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kern = conv3x3_tc_kernel<BN, WM, CK, KERNEL>;
  int rc = set_smem(kern, L.smem);
  if (rc) return rc;
  int grid = a.items;
  if (a.splits == 1) {  // persistent: as many blocks as fit on the card
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
  const int fsmem =
      (BM * (FINISH_BN + 4) + red_floats(FINISH_THREADS, a.g, FINISH_BN)) * 4;
  auto fin = conv3x3_tc_finish_kernel<S8>;
  rc = set_smem(fin, fsmem);
  if (rc) return rc;
  const dim3 fgrid(a.tiles, (a.cout + FINISH_BN - 1) / FINISH_BN,
                   (a.n + a.g - 1) / a.g);
  fin<<<fgrid, FINISH_THREADS, fsmem, st>>>(a, BM, FINISH_BN);
  return (int)cudaGetLastError();
}

// CK: bf16 16 or 32 channels a stage, s8 32 or 64 (32 or 64 bytes either)
template <int BN, int WM, int KERNEL>
static int dispatch_ck(const Args& a, int ck, cudaStream_t st) {
  if (is_s8(KERNEL))
    return ck == 32 ? launch<BN, WM, 32, KERNEL>(a, st)
                    : launch<BN, WM, 64, KERNEL>(a, st);
  return ck == 16 ? launch<BN, WM, 16, KERNEL>(a, st)
                  : launch<BN, WM, 32, KERNEL>(a, st);
}

// plan = {bn, wm, ck, tw, th, g, splits, cps, stages} from
// kernels/tc_plan.py.  Fills the plan's fields of `a` after checking them;
// returns a CUDA error code (cudaErrorInvalidValue for a plan this header
// does not take).  KERNEL: 1 or 2 (bf16), 4 or 5 (s8), 6 or 7 (bf16 row
// bands: a.h counts the output rows, x holds a.h + 2), the caller's number
// (see the kernel).
template <int KERNEL>
inline int run(Args a, const int* plan, cudaStream_t st) {
  static_assert(KERNEL == 1 || KERNEL == 2 || is_s8(KERNEL) ||
                    is_rows(KERNEL),
                "kernel 1, 2, 4, 5, 6 or 7");
  constexpr bool S8 = is_s8(KERNEL);
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const int bn = plan[0], wm = plan[1], ck = plan[2];
  a.tw = plan[3];
  a.th = plan[4];
  a.g = plan[5];
  a.splits = plan[6];
  a.cps = plan[7];
  a.stages = plan[8];
  const bool ck_ok = S8 ? (ck == 32 || ck == 64) : (ck == 16 || ck == 32);
  const bool shape_ok =
      (bn == 8 || bn == 16 || bn == 32 || bn == 64) &&
      (wm == 4 || wm == 8) && ck_ok &&
      (a.tw == 4 || a.tw == 8 || a.tw == 16) && a.th >= 1 && a.g >= 1 &&
      a.tw * a.th * a.g == wm * 32 && (a.stages == 2 || a.stages == 3);
  if (!shape_ok || a.splits < 1 || a.cps < 1) return (int)cudaErrorInvalidValue;
  if (S8 ? a.deq == nullptr : (a.deq != nullptr || a.y_f32))
    return (int)cudaErrorInvalidValue;
  a.chunks = (a.cin + ck - 1) / ck;
  if ((long long)(a.splits - 1) * a.cps >= a.chunks ||
      (long long)a.splits * a.cps < a.chunks)
    return (int)cudaErrorInvalidValue;
  if (a.splits > 1 && a.ws == nullptr) return (int)cudaErrorInvalidValue;
  a.tiles_x = (a.wd + a.tw - 1) / a.tw;
  a.cout_blocks = (a.cout + bn - 1) / bn;
  const long long tiles = (long long)a.tiles_x * ((a.h + a.th - 1) / a.th);
  const long long groups = (a.n + a.g - 1) / a.g;
  const long long items = tiles * a.cout_blocks * groups * a.splits;
  // the finish kernel's grid is (tiles, Cout / FINISH_BN, image groups)
  if (items >= (1LL << 31) ||
      (a.splits > 1 && (a.cout + FINISH_BN - 1) / FINISH_BN > 65535))
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.items = (int)items;
  a.fd_wp.set(a.tw + 2);
  a.fd_hp.set(a.th + 2);
  a.fd_per.set(a.th * a.tw);
  a.fd_tw.set(a.tw);
  // one Cout block, no split and a 2-stage ring over items of one or two
  // chunks: stage s always holds chunk s % chunks of the same taps
  a.b_resident = a.cout_blocks == 1 && a.splits == 1 && a.stages == 2 &&
                 a.chunks <= 2;
  // 16 bytes: 8 bf16 or 16 s8 channels; the s8 taps' rows run along Cin
  const int e16 = S8 ? 16 : 8;
  a.vec_x = a.cin % e16 == 0 && aligned(a.x, 16);
  a.vec_w = (S8 ? a.cin % 16 : a.cout % 8) == 0 && aligned(a.w, 16);
  a.vec_y = a.cout % 8 == 0 && aligned(a.y, 16);
  switch (bn * 10 + wm) {
    case 84:
      return dispatch_ck<8, 4, KERNEL>(a, ck, st);
    case 88:
      return dispatch_ck<8, 8, KERNEL>(a, ck, st);
    case 164:
      return dispatch_ck<16, 4, KERNEL>(a, ck, st);
    case 168:
      return dispatch_ck<16, 8, KERNEL>(a, ck, st);
    case 324:
      return dispatch_ck<32, 4, KERNEL>(a, ck, st);
    case 328:
      return dispatch_ck<32, 8, KERNEL>(a, ck, st);
    case 644:
      return dispatch_ck<64, 4, KERNEL>(a, ck, st);
    default:
      return dispatch_ck<64, 8, KERNEL>(a, ck, st);
  }
}

}  // namespace
}  // namespace tc
}  // namespace gst
