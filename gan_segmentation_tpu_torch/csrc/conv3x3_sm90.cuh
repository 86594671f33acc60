// The bf16, s8 and f32 (3xTF32) body of kernels 1, 2 and 3 written for
// Hopper (sm_90a): TMA loads into an mbarrier ring, wgmma, and the epilogue
// and statistics from the accumulators.  It serves entries 1 and 2
// (conv_in_stats.cu, small_conv.cu), their row-band forms 6 and 7
// (*_rows.cu) and their s8 forms 4 and 5 (conv_in_stats_s8.cu,
// small_conv_s8.cu) wherever kernels/tc_plan.py::plan_sm90 takes the shape,
// the f32 calls of kernel 3 and kernel 2 (entries 3 and 8:
// bil_conv_sm90.cu, small_conv_f32.cu) wherever tc_plan.plan_tf32 does, and
// kernel 1's f32 calls (entry 9: conv_in_stats_f32.cu) wherever
// tc_plan.plan_tf32_in_stats does; the mma.sync bodies of conv3x3_tc.cuh and
// conv3x3_tf32.cuh keep what the rules refuse (x's rows not a multiple of 16
// bytes, an unaligned view, a ragged noise row; in f32, kernels 2 and 3 at
// Cin > 128).
//
// Replaces the TPU kernels
//   experiments/pallas_archive/conv_in_stats.py::conv3x3_noise_bias_lrelu_instats
//   (pl.pallas_call at its line 118), bf16: conv3x3 + noise * nscale + bias
//   + leaky, with the per-(image, channel) sums of v and v^2;
//   experiments/pallas_archive/small_conv.py::conv3x3_small
//   (pl.pallas_call at its line 84), bf16: conv3x3 + bias + relu / leaky;
// their int8 forms (entries 4 and 5, below); and in f32 (entries 3, 8 and
// 9, below) experiments/pallas_archive/bil_conv.py::conv3x3_bil
// (pl.pallas_call at its line 115), kernel 2's and kernel 1's f32 calls.
//
// Layout: x NHWC, w HWIO (3, 3, Cin, Cout), stride 1, zero pad 1 (a row
// band: x holds H_out + 2 rows, no pad in H).  GEMM view: M = output
// pixels, N = output channels, K = 9 taps x Cin.
//
// What bounds it on this card.  The wide layers (kernel 1 at 16^2-128^2,
// Cout 128-512, ~400-2,300 flop per byte) are bound by the multiply rate;
// everything from 256^2 up (Cout 2-64, 17-284 flop per byte) by bytes.
// The mma.sync body reached 0.10-0.33 of those bounds.  Its ablations on
// the card (PERF_SHAPES.md) showed where the time went: at 1024^2 16 -> 16
// (kernel 1) its loads, its MMAs and its epilogue each cost 0.17-0.25 ms of
// 0.77 and did not overlap (every thread computed load addresses, then
// multiplied, then stored through shared memory behind two block barriers);
// at 32^2 512 -> 512 loads and MMAs cost 0.06 ms each of 0.15, again
// serialised.  This body separates the three:
//
// - Loads.  One producer warp (lane 0) walks the block's (item, Cin chunk)
//   sequence and fills a ring of `stages` stages, each guarded by a
//   full / empty mbarrier pair.  A stage's halo is ONE TMA box over NHWC x,
//   (CK, TW + 2, TH + 2, G) at (c0, tx0 - 1, ty0 - 1, n0): the start may
//   be negative at the top and left edges and the box may run past the
//   bottom and right ones, and TMA's zero fill is the conv's zero pad (a
//   row band starts at its first input row, ty0, which holds the caller's
//   halo row).  Cin past the end and images past N read zeros too.  The
//   tap slice [9][CK][BN] comes by TMA as well, or stays resident for the
//   block (one Cout block, no split: loaded once, by every thread, before
//   the loop); kernel 1's noise, (TW, TH, G) f32, rides in the item's last
//   stage.  The consumers never compute a load address.  Depth: stages
//   keep ~24 KB a block in flight (3.35 TB/s x ~1 us over 132 SMs, by
//   Little's law), within the shared memory (tc_plan.plan_sm90).
// - Swizzle.  The halo box lands with TMA's swizzle for its row of CK
//   channels (32 B for CK = 16, 64 B for CK = 32): 16-byte chunk j of
//   pixel p sits at chunk j ^ ((p * CK * 2 >> 7) & mask).  A lane's
//   ldmatrix address applies the same XOR, so a tap's one-pixel shift
//   stays a per-lane address and the 8 rows of an ldmatrix (8 neighbouring
//   pixels) fall in 8 bank groups (a 4-wide tile, 4^2 images only, in 4).
// - MMA.  wgmma.mma_async m64nBNk16, A from registers (ldmatrix.x4 from the
//   tap-shifted halo, the mma.sync m16n8k16 A fragment per warp), B the tap
//   slice from shared memory through a descriptor (N-major, the swizzle of
//   its BN-channel rows; BN = 128 as two 64-channel atoms).  Two consumer
//   warpgroups each own MI m64 tiles of the block's 128 * MI pixels and
//   all BN channels; in the wide tiles A's registers are double-buffered
//   so the next ldmatrix overlaps the wgmma in flight.  BN rises to 128 for
//   Cout >= 128,
//   so an input halo is staged once for 128 output channels (64 before).
//   The narrow layers take wgmma too (n16 / n32 / n64): one body, no B
//   fragments in registers, and at 256^2 and up the time is in the loads
//   and the epilogue, not in the multiply (the ablations above).
// - Epilogue from registers.  noise * nscale + bias and the activation are
//   applied to the accumulators.  Kernel 1's sums of v and v^2 come from
//   these f32 values before the bf16 rounding: each thread adds its two
//   rows of a 16-row fragment, three xor-shuffles add the fragment's 8
//   row pairs, and one slot per (fragment, channel) lands in shared
//   memory; the slots of an image are added in fragment order, one partial
//   per (image, tile), so repeats are bit-identical (a fragment lies in one
//   image: a tile keeps >= 16 pixels per image).  y goes in bf16 to a
//   shared tile (the store box's swizzle) and out by a TMA store, which
//   clips a ragged edge and runs while the next item multiplies.  TMA's
//   16-byte stride rule forbids it at Cout % 8 != 0 (main_8_conv, Cout 2):
//   there y is stored from registers, a channel pair (4 bytes) per pixel.
// - Persistent blocks walk the items (spatial tile, Cout block, image
//   group, Cin split), Cout block fastest.  Split-K (the Cin-512 layers at
//   4^2-16^2) writes f32 sums to a workspace and conv3x3_tc.cuh's finish
//   kernel adds the splits in a fixed order and runs the epilogue: no
//   float atomics.
//
// s8 (entries 4 and 5, generate --quant int8 | int8-full).  x and w are s8
// and the MMA is wgmma.mma_async m64nBNk32.s32.s8.s8: exact integer sums in
// s32 accumulators (as many registers as f32's), so a split-K adds its s32
// partials exactly.  A k32 step is 32 bytes a pixel, like bf16's k16: a
// stage holds CK = 32 or 64 channels, the same bytes as bf16's 16 or 32,
// so the halo box, its swizzle and A's ldmatrix rows are the bf16 body's
// counted in bytes (the 8-bit A fragment of wgmma is mma.sync m16n8k32's,
// which ldmatrix.x4 gives from 16-byte rows).  B differs: wgmma transposes
// only 16-bit operands, so both are K-major.  w comes as [tap][Cout][Cin]
// (the host lays it out once per quantization), so a chunk's tap slice is
// [9][BN][CK], ONE TMA box (CK, BN, 9) swizzled by its CK-byte rows (32 B
// or 64 B), read through a K-major descriptor (SBO = 8 rows, a k32 step
// inside a 64-byte row by the start address).  TMA has no s8 type: x and w
// travel as u8, whose zero fill is s8's zero pad.  Cin 16 (the 1024^2
// layers) would leave half of each k32 step zero: there a stage holds the
// 16 channels (16-byte pixels, no swizzle: 8 neighbouring pixels are 128
// contiguous bytes) and a k32 step takes two taps, lanes 0-15 of each
// ldmatrix.x4 pointing at tap 2j's shifted pixel (k bytes 0-15) and lanes
// 16-31 at tap 2j + 1's (bytes 16-31): 5 steps instead of 9, over taps
// kept resident as [5 pairs][BN][32] (tap 9 zero).  The epilogue
// dequantizes first, v = float(acc) * deq[c], and rounds every step on its
// own (__int2float_rn, __fmul_rn, __fadd_rn: never a fused multiply-add;
// |acc| reaches 127^2 x 9 x 512 > 2^24, so the int -> float rounding is
// part of the function), so y equals the mma.sync s8 body's and the plain
// version's bit for bit.  y is bf16 (TMA store as above), or f32 where the
// caller asks (the f32 compute dtype, the exactness check with deq = 1),
// then stored from registers.  The s8 layers from 256^2 up are bound by
// bytes and their MMAs run at int8's rate, so one wide block an SM left
// the epilogue exposed: the s8 plan takes 32-channel tiles where Cin <= 64,
// two blocks an SM, one block's epilogue beside the other's loads and MMAs
// (tc_plan.plan_sm90).
//
// f32 (entries 3 and 8: kernel 3's train-step convs and their input
// gradients, kernel 2's evaluate and predict convs; entry 9: kernel 1 in
// the f32 generator, with its noise and statistics), as 3xTF32: the train
// step holds them to f32 (conv3x3_tf32.cuh says why one TF32 pass does
// not), so each product is lo*hi + hi*lo + hi*hi of tf32 operands, split by
// truncation (tf32_split, the split of conv3x3_tf32.cuh).  A k8 tf32 step
// is 32 bytes, like s8's k32: a stage holds CK = 16 f32 (64-byte pixels),
// so the halo box (FLOAT32), its 64-byte swizzle and A's ldmatrix rows are
// the s8 body's counted in bytes (a pair of b16 is one tf32 element, and
// ldmatrix.x4 gives the m16n8k8 tf32 A fragment, which is wgmma m64k8's per
// warp).  A is split in registers after each ldmatrix: lo = v - trunc(v);
// hi is v itself, whose low 13 bits the MMA does not read.  B
// is K-major, as s8's (wgmma transposes only 16-bit operands), and both its
// hi and lo must sit in shared memory; TMA cannot transpose HWIO's
// Cout-contiguous rows.  So either the consumers split the block's taps
// themselves, once: w (HWIO f32) for the block's Cout block and Cin split
// into [chunk][9][hi, lo][BN][16] tf32 under the 64-byte swizzle
// (resident, split_taps; a block whose next item has another Cout block or
// split splits again, which the host's grid, a multiple of the Cout blocks,
// avoids without a split); tc_plan.plan_tf32 keeps a split's taps within
// SM90_RESIDENT_MAX by its BN (or, for a narrow BN on a grid that fills the
// card, within 160 KB at one block an SM: 64 -> 32 from 256^2 up, cvt_5).
// Or (streamed: kernel 1's layers but 4^2, where one wave holds every item
// and the taps stay resident) the
// entry first lays w out K-major in device memory, [chunk][9][hi, lo][Cout]
// [16] (conv_in_stats_f32.cu's tf32_taps_kernel: hi the f32 itself, lo = v -
// (v & 0xFFFFE000)), and the producer loads each stage's taps as ONE TMA box
// (16, BN, 2, 9) beside the halo, under the 64-byte swizzle: the resident
// slice's layout, so the consumers read both alike and never split B.
// Each k8 step
// issues two wgmmas per m64 tile: A_hi [B_hi | B_lo] (m64n(2 BN)k8) and
// A_lo B_hi (m64nBNk8) into the first half of its accumulators; the
// epilogue adds the halves.  Split-K, where a plan asks for it, stores f32
// partials and conv3x3_tc.cuh's finish kernel adds them in a fixed order,
// to nearest, and runs the epilogue (plan_tf32 asks for none: at the small
// layers 8-channel blocks beat it on the card; kernel 1 splits Cin 512 at
// least 4 ways and Cin 256 2, so that no chain passes 8 chunks: the
// tensor cores truncate the f32 accumulator).  Kernel 1's epilogue adds
// the two halves first, then noise * nscale + bias and the leaky relu, and
// takes its sums of v and v^2 from those f32 values by the bf16 body's
// slots; split, the finish kernel takes them, one partial per (image,
// tile) either way.  y is f32, stored from registers (two channels a
// store).  What bounds it: 3 x FLOP at 495 TFLOP/s, or the bytes at the
// 1024^2 16-channel layers.
//
// Tensor maps are encoded on the host for every call
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion, so the
// library links only against the runtime, as before) and passed by value as
// a __grid_constant__ kernel argument.  A CUDA graph captures them by value
// with that call's addresses; the graphed paths replay fixed addresses, so
// a replay reads the tensors the capture saw, as for any kernel argument.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "conv3x3_tc.cuh"  // the split-K finish kernel
#include "sm90_util.cuh"

namespace gst {
namespace sm90 {
// internal linkage: each including file gets its own copy of the kernels
namespace {

constexpr int MAX_SMEM = 232448;       // a block's shared-memory limit
constexpr int CONSUMERS = 256;         // two warpgroups multiply
constexpr int MAX_STAGES = 8;
// The wide tiles (BN >= 64) run one block an SM whose accumulators need
// more than the 168 registers a thread that 288 or 384 threads leave: their
// loader is a whole warpgroup that drops to PRODUCER_REGS so that the
// consumers rise to CONSUMER_REGS (4 x 56 + 8 x 224 = 12 x 168, the
// registers a thread of __launch_bounds__(384, 1) launches with; at 40 /
// 232 kernel 1's wide tiles spilled).  The narrow tiles run two blocks an
// SM with one loader warp.
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

__host__ __device__ constexpr bool wide(int bn) { return bn >= 64; }
__host__ __device__ constexpr int threads(int bn) {
  return CONSUMERS + (wide(bn) ? 128 : 32);
}

// The entry point that launches the body (the kernel's last template
// argument): 1 conv_in_stats, 2 small_conv, 4 and 5 the same in s8, 6 and
// 7 the same over a row band, 3 bil_conv, 8 small_conv and 9 conv_in_stats
// in f32 (3xTF32).
__host__ __device__ constexpr bool is_s8(int k) { return k == 4 || k == 5; }
__host__ __device__ constexpr bool is_rows(int k) { return k == 6 || k == 7; }
__host__ __device__ constexpr bool is_tf32(int k) {
  return k == 3 || k == 8 || k == 9;
}
__host__ __device__ constexpr bool has_stats(int k) {
  return k == 1 || k == 4 || k == 6 || k == 9;
}
// bytes of an element of x and w
__host__ __device__ constexpr int elem_bytes(int k) {
  return is_s8(k) ? 1 : (is_tf32(k) ? 4 : 2);
}

// The accumulators: f32 (bf16 operands) or s32 (s8)
template <bool S8>
struct Accum {
  using T = float;
};
template <>
struct Accum<true> {
  using T = int;
};

// An accumulator register's f32 value once the epilogue has run (s8 keeps
// the f32 bits in its s32 registers)
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }
// ... and its 32 bits as they are (a split's partial in the workspace)
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }

__host__ __device__ constexpr int align_up(int v, int a) {
  return (v + a - 1) / a * a;
}

// The y tile and the statistics' slots: two of each for the narrow tiles,
// so that one block barrier an item suffices and the TMA store of one item
// reads its tile while the next item writes the other; one for the wide
// tiles, whose 64 KB tile leaves no room for a second (and whose items are
// long enough that a second barrier costs nothing).
__host__ __device__ constexpr int out_bufs(int bn) { return wide(bn) ? 1 : 2; }

// Shared memory of one launch, in bytes from a 1024-aligned base: the ring
// (each stage: halo box, tap slice unless resident, kernel 1's noise), the
// resident taps, the output tile (TMA store, bf16), the statistics' slots,
// the barriers.  eb: bytes of an element of x and w (2 bf16, 1 s8, 4 f32).
// chunks: the resident taps' chunks (a split's, in f32).
// kernels/tc_plan.py::PlanSM90.smem_bytes mirrors it.
struct Layout {
  int halo;       // bytes of a stage's halo box (the TMA transaction)
  int taps;       // bytes of one chunk's tap slice: bf16 [atom][9][CK][BNA],
                  // s8 [9][BN][CK] (CK 16: [5][BN][32], taps in pairs),
                  // f32 [9][hi, lo][BN][CK] tf32
  int tap_off;    // in a stage
  int noise_off;  // in a stage
  int stage;
  int res_off, out_off, slot_off, bar_off, smem;
};

__host__ __device__ inline Layout layout(int bn, int bm, int ck, int eb,
                                         int g, int th, int tw, int stages,
                                         int resident, int chunks,
                                         bool noise, int tma_y, bool stats) {
  Layout L;
  L.halo = g * (th + 2) * (tw + 2) * ck * eb;
  // 16-byte pixels (s8 Cin 16): the taps in pairs, [5][BN][32]
  L.taps = ck * eb == 16 ? 5 * 32 * bn : 9 * ck * bn * eb * (eb == 4 ? 2 : 1);
  L.tap_off = align_up(L.halo, 1024);
  L.noise_off = L.tap_off + (resident ? 0 : align_up(L.taps, 1024));
  L.stage = align_up(L.noise_off + (noise ? bm * 4 : 0), 1024);
  L.res_off = stages * L.stage;
  L.out_off = L.res_off + (resident ? align_up(chunks * L.taps, 1024) : 0);
  L.slot_off = L.out_off + (tma_y ? out_bufs(bn) * bm * bn * 2 : 0);
  L.bar_off = L.slot_off + (stats ? out_bufs(bn) * (bm / 16) * bn * 2 * 4 : 0);
  L.smem = L.bar_off + 2 * stages * 8 + 1024;  // + the base's alignment
  return L;
}

// Everything a launch reads; passed by value (__grid_constant__, so TMA
// reads the maps in the kernel's parameter space).
struct Args {
  CUtensorMap tm_x;      // NHWC x: box (CK, TW + 2, TH + 2, G)
  CUtensorMap tm_w;      // bf16: HWIO w as (Cout, Cin, 9), box (BNA, CK, 9);
                         // s8: [tap][Cout][Cin] as (Cin, Cout, 9), box
                         // (CK, BN, 9); f32 streamed: wk as (16, Cout, 2,
                         // 9 x chunks), box (16, BN, 2, 9)
  CUtensorMap tm_noise;  // (N, H, W) f32 as (W, H, N): box (TW, TH, G)
  CUtensorMap tm_y;      // NHWC y (bf16): box (BNA, TW, TH, G)
  const void* x;           // NHWC: bf16, or s8
  const void* w;           // resident taps are read through it (f32: HWIO,
                           // split by the block)
  const void* wk;          // f32 streamed: the K-major taps, [chunk][9]
                           // [hi, lo][Cout][16] (the tm_w of its TMA boxes)
  const float* deq;        // s8: (Cout,) dequantization multipliers
  const float* bias;       // (Cout,) or null
  const float* noise;      // kernel 1: (N, H, W)
  const float* nscale;     // kernel 1: (Cout,)
  void* y;                 // NHWC: bf16, or f32 where y_f32 (s8, f32)
  int y_f32;
  float* partial;  // kernel 1: (N, tiles, 2, Cout)
  void* ws;        // (splits, N*H*W, Cout) f32 (s8: s32) when splits > 1
  int n, h, wd, cin, cout;  // h: output rows (a band's x holds h + 2)
  int act;
  float slope;
  // the plan and what follows from it (run() fills these)
  int tw, th, g, splits, cps, stages, resident, tma_y;
  int chunks, tiles_x, tiles, cout_blocks, items;
  int vec_w;  // resident taps by 16-byte loads
  FastDiv fd_per, fd_tw;
};

// One work item: a spatial tile of G images for BN output channels and one
// Cin split (conv3x3_tc.cuh's order: Cout block fastest).
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

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (BN == 16)
    wgmma_m64n16k16(d, a, desc);
  else if constexpr (BN == 32)
    wgmma_m64n32k16(d, a, desc);
  else if constexpr (BN == 64)
    wgmma_m64n64k16(d, a, desc);
  else
    wgmma_m64n128k16(d, a, desc);
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2],
                                      const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (BN == 16)
    wgmma_m64n16k32(d, a, desc);
  else if constexpr (BN == 32)
    wgmma_m64n32k32(d, a, desc);
  else if constexpr (BN == 64)
    wgmma_m64n64k32(d, a, desc);
  else
    wgmma_m64n128k32(d, a, desc);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (N == 8)
    wgmma_m64n8k8_tf32(d, a, desc);
  else if constexpr (N == 16)
    wgmma_m64n16k8_tf32(d, a, desc);
  else if constexpr (N == 32)
    wgmma_m64n32k8_tf32(d, a, desc);
  else if constexpr (N == 64)
    wgmma_m64n64k8_tf32(d, a, desc);
  else
    wgmma_m64n128k8_tf32(d, a, desc);
}

// The byte offset `off` (from a base aligned to the pattern) under TMA's
// swizzle of rows of `mask + 1` 16-byte chunks: chunk bits [4, 7) xor
// address bits [7, 10).
__host__ __device__ constexpr uint32_t swizzle(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// One Cin chunk: 9 taps x (CK bytes / 32) k steps (bf16 k16, s8 k32), each
// MI wgmmas of 64 x BN x 32 bytes; s8 at CK 16: 5 steps of a tap pair (a
// lane's tap by its half of the warp).  hb: the stage's halo, tb: the chunk's
// tap slice.  A's rows: the BN 64 tiles (registers to spare) keep every
// lane's swizzled row per m64 tile and tap in asw[i][t] (the second k step
// of a 64-byte chunk is the next 32 bytes: chunk bit 1, which the
// swizzle's xor leaves alone); the others compute the row from aoff[i]
// (tap (0, 0)) and row (a halo row in bytes) at each step, from the
// stage's offset soff so that no address stays live across the loop (BN
// 128 has 128 accumulators a thread, the narrow tiles 96 registers).  The
// wide tiles double-buffer A, so the next ldmatrix overlaps the wgmma in
// flight; the narrow ones (bound by bytes) wait for each step.
template <int BN, int MI, int CK, bool S8, typename Acc>
__device__ __forceinline__ void mma_chunk(Acc (&acc)[MI][BN / 2],
                                          uint32_t hb, uint32_t soff,
                                          uint32_t tb,
                                          const uint32_t (&asw)[MI][9],
                                          const uint32_t (&aoff)[MI],
                                          uint32_t row) {
  constexpr int PS = CK * (S8 ? 1 : 2);         // halo pixel, bytes
  constexpr bool PAIRS = PS == 16;              // two taps a k32 step
  constexpr int TAPS = PAIRS ? 5 : 9;           // steps of the outer loop
  constexpr int KS = PAIRS ? 1 : PS / 32;       // k steps of 32 bytes a tap
  // halo swizzle: 32 B, 64 B (16-byte pixels: none)
  constexpr uint32_t XSW = PS == 16 ? 0 : (PS == 32 ? 1 : 3);
  constexpr int BNA = BN < 64 ? BN : 64;        // channels of a B atom
  constexpr int RB = BNA * 2;                   // a tap row of an atom
  constexpr int BSW = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  constexpr int NBUF = wide(BN) ? 2 : 1;        // A's register buffers
  // bf16, N-major B: LBO = the stride of 64-channel atoms, SBO = 8 k rows.
  // s8, K-major B: rows of CK bytes (tap pairs: 32) under that width's
  // swizzle, SBO = 8 rows (channels); LBO unused.
  constexpr int KROW = PAIRS ? 32 : CK;         // s8: a B row, bytes
  const uint64_t d0 = S8 ? gmma_desc(tb, 16, 8 * KROW, KROW == 32 ? 3 : 2)
                         : gmma_desc(tb, 9 * CK * RB, 8 * RB, BSW);
  const bool hi = PAIRS && (threadIdx.x & 16);  // the pair's second tap
  const uint32_t base = hb - soff;  // the shared memory's base
  uint32_t af[NBUF][MI][4];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int b = (t * KS + kk) % NBUF;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t addr;
        if constexpr (PAIRS) {  // taps 2t and 2t + 1 (tap 9: B is zero)
          const int t0 = 2 * t, t1 = 2 * t + 1 < 9 ? 2 * t + 1 : 8;
          addr = base + soff + aoff[i] +
                 (hi ? (t1 / 3) * row + (t1 % 3) * PS
                     : (t0 / 3) * row + (t0 % 3) * PS);
        } else if constexpr (BN == 64) {
          addr = hb + (asw[i][t] ^ (kk * 32));
        } else {
          addr = base + swizzle(soff + aoff[i] + (t / 3) * row +
                                    (t % 3) * PS + kk * 32,
                                XSW);
        }
        ldsm_x4(af[b][i], addr);
      }
      wgmma_fence();
      // the step's B: tap t's slice (s8 at CK 16: pair t's), k step kk
      // (s8: 32 bytes into the row)
      const uint64_t d =
          d0 + ((S8 ? t * BN * KROW + kk * 32 : (t * CK + kk * 16) * RB) >>
                4);
#pragma unroll
      for (int i = 0; i < MI; ++i) wgmma<BN>(acc[i], af[b][i], d);
      wgmma_commit();
      // the step before (wide) or this one (narrow) is done: its A
      // buffer is free
      wgmma_wait<NBUF - 1>();
    }
  }
  wgmma_wait<0>();
}

// f32 (3xTF32): one Cin chunk of 16 f32, 9 taps x 2 k8 steps of 32 bytes.
// A: ldmatrix.x4 of the 64-byte halo pixels (the bf16 body's CK 32 rows,
// its swizzle and its wide tiles' per-tap rows asw), split into hi and lo
// in registers (hi is read truncated by the MMA itself).  B: the chunk's
// resident slice tb, [9][hi, lo][BN][16] K-major under the 64-byte swizzle
// (s8's descriptor: SBO = 8 rows of 64 bytes, a k step 32 bytes into the
// row by the start address), a tap's hi and lo rows one 2 BN-row matrix.
// The three products of a m64 tile's step take two wgmmas: A_hi [B_hi |
// B_lo] (m64n(2 BN)k8) into the accumulators' two halves, then A_lo B_hi
// (m64nBNk8) into the first half, whose registers hold its columns
// (acc[i][0 .. BN/2)); the epilogue adds the halves.  The narrow tf32
// wgmmas cost per instruction more than per column (on the card an n16
// one took ~80% of an n32's time), so two instead of three a step.  The
// unit of issue is one m64 tile's step (one commit group), and A's
// registers alternate between two buffers unit by unit: the next unit's
// ldmatrix and split overlap the wgmmas in flight, for as many registers
// as one step of two m64 tiles.
template <int BN, int MI>
__device__ __forceinline__ void mma_chunk_tf32(float (&acc)[MI][BN],
                                               uint32_t hb, uint32_t soff,
                                               uint32_t tb,
                                               const uint32_t (&asw)[MI][9],
                                               const uint32_t (&aoff)[MI],
                                               uint32_t row) {
  constexpr int PS = 64;       // halo pixel: 16 f32
  constexpr uint32_t XSW = 3;  // its swizzle: 64 B
  const uint64_t d0 = gmma_desc(tb, 16, 8 * PS, 2);
  const uint32_t base = hb - soff;  // the shared memory's base
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int b = ((t * 2 + kk) * MI + i) % 2;
        uint32_t addr;
        if constexpr (BN == 64)
          addr = hb + (asw[i][t] ^ (kk * 32));
        else
          addr = base + swizzle(soff + aoff[i] + (t / 3) * row +
                                    (t % 3) * PS + kk * 32,
                                XSW);
        ldsm_x4(ah[b], addr);
        // A_hi is the f32 itself: a tf32 operand's low 13 bits are not
        // read (truncation, the split's own), so only lo = v - hi is
        // computed (bit-identical to tf32_split's operands on the card,
        // 10-15% less time at the narrow layers)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          al[b][e] = __float_as_uint(__uint_as_float(ah[b][e]) -
                                     __uint_as_float(ah[b][e] & 0xFFFFE000u));
        wgmma_fence();
        const uint64_t d = d0 + ((t * 2 * BN * PS + kk * 32) >> 4);
        wgmma_tf32<2 * BN>(acc[i], ah[b], d);
        wgmma_tf32<BN>(reinterpret_cast<float(&)[BN / 2]>(acc[i][0]), al[b],
                       d);
        wgmma_commit();
        // the unit before is done: its buffer is the next unit's
        wgmma_wait<1>();
      }
    }
  }
  wgmma_wait<0>();
}

// f32: the block's resident taps, w (HWIO f32) for output channels co0 ..
// co0 + BN - 1 and the nc Cin chunks from chunk c0, split into tf32 hi and
// lo and stored K-major, [chunk][9][hi, lo][BN][16] under the 64-byte
// swizzle (one chunk every `taps` bytes, a tap's lo rows LO bytes after its
// hi rows), by the CONSUMERS threads; zero past Cin and Cout.  w's reads
// go along Cout (16 bytes where vec_w: Cout % 4 == 0, a 16-byte w), U of
// them issued before their stores, so that a block's split costs a few L2
// round trips, not one a value (the small layers' blocks run one item).
template <int BN>
__device__ __forceinline__ void split_taps(const Args& a, unsigned char* res,
                                           int taps, int co0, int c0,
                                           int nc, int tid) {
  constexpr int CK = 16, U = 4;
  constexpr uint32_t LO = BN * CK * 4;
  const float* w = static_cast<const float*>(a.w);
  // element j of w's reads: (chunk, tap, ci, o) with o fastest; a vector
  // read covers 4 channels
  const int V = a.vec_w ? 4 : 1;
  const int nv = BN / V, total = nc * 9 * CK * nv;
  for (int i0 = tid; i0 < total; i0 += U * CONSUMERS) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CONSUMERS;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i >= total) continue;
      const int o = (i % nv) * V, r = i / nv;
      const int ci = r % CK, ct = r / CK;
      const int c = (c0 + ct / 9) * CK + ci, co = co0 + o;
      if (c >= a.cin || co >= a.cout) continue;
      const float* src = w + ((size_t)(ct % 9) * a.cin + c) * a.cout + co;
      if (V == 4)
        v[u] = __ldg(reinterpret_cast<const float4*>(src));
      else
        v[u].x = __ldg(src);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CONSUMERS;
      if (i >= total) continue;
      const int o = (i % nv) * V, r = i / nv;
      const int ci = r % CK, ct = r / CK;
      const int tap = ct % 9, chunk = ct / 9;
      const float vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= V) break;
        uint32_t hi, lo;
        tf32_split(__float_as_uint(vals[e]), hi, lo);
        const uint32_t off =
            chunk * taps +
            swizzle((tap * 2 * BN + o + e) * CK * 4 + ci * 4, 3);
        *reinterpret_cast<uint32_t*>(res + off) = hi;
        *reinterpret_cast<uint32_t*>(res + off + LO) = lo;
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Blocks per SM asked of ptxas: 2 for the narrow tiles (288 threads: at
// most 96 registers; 3 blocks of bf16 BN 16, at most 72, spilled kernel 1
// and ran it slower), but 3 for s8 kernel 1 at BN 16 (72 registers, no
// spill: a third block's loads and MMAs beside two blocks' statistics),
// 1 for kernel 1's BN 32 tiles, which spilled at 96 and need ~100 (two
// blocks of that still share an SM), and 1 for the wide.
__host__ __device__ constexpr int min_blocks(int bn, int kernel) {
  return wide(bn) || (bn == 32 && has_stats(kernel))        ? 1
         : (is_s8(kernel) && has_stats(kernel) && bn == 16) ? 3
                                                            : 2;
}

// Warps 0-7 (two warpgroups) multiply, warp 8 loads (with warps 9-11 idle
// beside it in the wide tiles).  KERNEL is the number of the entry point
// that launches it (kernel 1, 4 or 6 takes the noise and the statistics, 4
// and 5 run s8, 6 and 7 a row band, 3 and 8 f32 as 3xTF32), so a profile
// tells them apart.
template <int BN, int MI, int CK, int KERNEL>
__global__ void __launch_bounds__(threads(BN), min_blocks(BN, KERNEL))
    conv3x3_sm90_kernel(const __grid_constant__ Args a) {
  constexpr bool ROWS = is_rows(KERNEL);
  constexpr bool STATS = has_stats(KERNEL);
  constexpr bool S8 = is_s8(KERNEL);
  constexpr bool TF32 = is_tf32(KERNEL);
  using Acc = typename Accum<S8>::T;
  constexpr int BM = 128 * MI;
  // accumulators per m64 tile (f32: the two halves of [B_hi | B_lo])
  constexpr int NF = TF32 ? BN : BN / 2;
  constexpr int BNA = BN < 64 ? BN : 64;
  constexpr int NATOM = BN / BNA;
  constexpr int RB = BNA * 2;
  constexpr uint32_t OSW = RB == 128 ? 7 : (RB == 64 ? 3 : 1);
  constexpr int ATOM = 9 * CK * RB;            // bytes of a tap-slice atom
  constexpr int PS = CK * elem_bytes(KERNEL);  // halo pixel, bytes
  // its swizzle (s8 taps too): 32 B, 64 B; 16-byte pixels none (their
  // tap pairs' 32-byte rows: 32 B)
  constexpr uint32_t XSW = PS == 16 ? 0 : (PS == 32 ? 1 : 3);
  constexpr int THREADS = threads(BN);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const bool noise = STATS && a.splits == 1;
  const Layout L = layout(BN, BM, CK, elem_bytes(KERNEL), a.g, a.th, a.tw,
                          a.stages, a.resident, a.cps, noise, a.tma_y,
                          STATS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + a.stages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  // bf16 and s8: every thread loads the resident taps (f32: the consumers
  // split them, below, while the producer's first loads fly)
  if (!TF32 && a.resident) {
    unsigned char* res = smem + L.res_off;
    if constexpr (S8 && PS == 16) {
      // Cin 16, one chunk: the taps in pairs, [5][BN][32] under the 32-byte
      // swizzle, row (j, o) = w[2j][o][:] then w[2j + 1][o][:] (tap 9 zero)
      const int8_t* w = static_cast<const int8_t*>(a.w);
      for (int i = tid; i < 5 * BN * 2; i += THREADS) {
        const int hf = i % 2, r = i / 2;
        const int o = r % BN, j = r / BN, tap = 2 * j + hf;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (tap < 9 && o < a.cout)
          v = *reinterpret_cast<const uint4*>(
              w + ((size_t)tap * a.cout + o) * a.cin);
        const uint32_t off = (j * BN + o) * 32 + hf * 16;
        *reinterpret_cast<uint4*>(res + swizzle(off, 1)) = v;
      }
    } else if constexpr (S8) {
      // every chunk's taps: [chunk][tap][BN][CK], w's [tap][Cout][Cin] rows
      // under the CK-byte swizzle (run() asks Cin % 16 and a 16-byte w)
      constexpr int U = CK / 16;
      const int8_t* w = static_cast<const int8_t*>(a.w);
      for (int i = tid; i < a.chunks * 9 * BN * U; i += THREADS) {
        const int u = i % U, r = i / U;
        const int o = r % BN, ct = r / BN;
        const int tap = ct % 9, chunk = ct / 9;
        const int c = chunk * CK + u * 16;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (c < a.cin && o < a.cout)
          v = *reinterpret_cast<const uint4*>(
              w + ((size_t)tap * a.cout + o) * a.cin + c);
        const uint32_t off = chunk * L.taps + (tap * BN + o) * CK + u * 16;
        *reinterpret_cast<uint4*>(res + swizzle(off, XSW)) = v;
      }
    } else if (a.vec_w) {  // [chunk][atom][tap][ci][BNA]
      const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
      constexpr int N8 = BN / 8;
      for (int i = tid; i < a.chunks * 9 * CK * N8; i += THREADS) {
        const int j8 = i % N8, r = i / N8;
        const int ci = r % CK, ct = r / CK;
        const int tap = ct % 9, chunk = ct / 9;
        const int c = chunk * CK + ci, o = j8 * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (c < a.cin && o < a.cout)
          v = *reinterpret_cast<const uint4*>(
              w + ((size_t)tap * a.cin + c) * a.cout + o);
        const uint32_t off = chunk * L.taps + (o / BNA) * ATOM +
                             (tap * CK + ci) * RB + (o % BNA) * 2;
        *reinterpret_cast<uint4*>(res + swizzle(off, OSW)) = v;
      }
    } else {
      const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
      for (int i = tid; i < a.chunks * 9 * CK * BN; i += THREADS) {
        const int o = i % BN, r = i / BN;
        const int ci = r % CK, ct = r / CK;
        const int tap = ct % 9, chunk = ct / 9;
        const int c = chunk * CK + ci;
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (c < a.cin && o < a.cout)
          v = w[((size_t)tap * a.cin + c) * a.cout + o];
        const uint32_t off = chunk * L.taps + (o / BNA) * ATOM +
                             (tap * CK + ci) * RB + (o % BNA) * 2;
        *reinterpret_cast<__nv_bfloat16*>(res + swizzle(off, OSW)) = v;
      }
    }
    fence_proxy_async();  // the generic stores, seen by wgmma
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- the producer: warp 8's lane 0 keeps the ring full
    if constexpr (wide(BN)) setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      const uint32_t tx = L.halo + (a.resident ? 0 : L.taps);
      for (int w = blockIdx.x; w < a.items; w += gridDim.x) {
        const Item it = item(a, w, BN);
        const int c0 = it.split * a.cps;
        const int nc = min(a.chunks - c0, a.cps);
        for (int c = 0; c < nc; ++c) {
          mbar_wait(empty + s, ph ^ 1);
          unsigned char* st = smem + s * L.stage;
          const bool nz = noise && c == nc - 1;
          mbar_expect_tx(full + s, tx + (nz ? BM * 4 : 0));
          const int ch = (c0 + c) * CK;
          tma_load_4d(st, &a.tm_x, full + s, ch, it.tx0 - 1,
                      ROWS ? it.ty0 : it.ty0 - 1, it.n0);
          if (!a.resident) {
            if constexpr (TF32)  // one box: [9][hi, lo][BN][16]
              tma_load_4d(st + L.tap_off, &a.tm_w, full + s, 0, it.co0, 0,
                          (c0 + c) * 9);
            else if constexpr (S8)  // one box: [9][BN][CK]
              tma_load_3d(st + L.tap_off, &a.tm_w, full + s, ch, it.co0, 0);
            else
              for (int t = 0; t < NATOM; ++t)
                tma_load_3d(st + L.tap_off + t * ATOM, &a.tm_w, full + s,
                            it.co0 + t * BNA, ch, 0);
          }
          if (nz)
            tma_load_3d(st + L.noise_off, &a.tm_noise, full + s, it.tx0,
                        it.ty0, it.n0);
          if (++s == a.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg, warp wq of it
  if constexpr (wide(BN)) setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, wq = warp % 4;
  const int per = a.th * a.tw;
  const int wp = a.tw + 2;
  // this lane's ldmatrix row of each m64 tile at tap (0, 0), and (wide
  // tiles) at every tap, swizzled
  uint32_t aoff[MI], asw[MI][9];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = (wg * MI + i) * 64 + wq * 16 + lane % 8 + 8 * ((lane / 8) % 2);
    const int gi = a.fd_per.div(m), rem = m - gi * per;
    const int ty = a.fd_tw.div(rem), tx = rem - ty * a.tw;
    // lanes 16-31 give k bytes 16-31: the pixel's next 16 bytes (16-byte
    // pixels: the same pixel, in the pair's second tap, mma_chunk)
    aoff[i] = ((gi * (a.th + 2) + ty) * wp + tx) * PS +
              (PS == 16 ? 0 : 16 * (lane / 16));
    if constexpr (BN == 64) {
#pragma unroll
      for (int t = 0; t < 9; ++t)
        asw[i][t] = swizzle(aoff[i] + ((t / 3) * wp + t % 3) * PS, XSW);
    }
  }
  const uint32_t row = wp * PS;
  const uint32_t base = smem_u32(smem);
  const int lr = lane / 4, lc = (lane % 4) * 2;
  constexpr int NB = out_bufs(BN);
  int nitem = 0;  // this block's items so far: the y tile and slots in use

  Acc acc[MI][NF];
  float nzr[MI][2];
  int s = 0;
  uint32_t ph = 0;
  // f32: whose taps are resident (streamed ones come in each stage)
  int taps_co = -1, taps_split = -1;
  for (int w = blockIdx.x; w < a.items; w += gridDim.x) {
    const Item it = item(a, w, BN);
    const int c0 = it.split * a.cps;
    const int nc = min(a.chunks - c0, a.cps);
    if constexpr (TF32) {
      if (a.resident && (it.co0 != taps_co || it.split != taps_split)) {
        // the last item's wgmmas have read the taps (each warpgroup waited
        // for its own); split this item's
        if (taps_co >= 0) named_bar_sync(2, CONSUMERS);
        split_taps<BN>(a, smem + L.res_off, L.taps, it.co0, c0, nc, tid);
        fence_proxy_async();  // the generic stores, seen by wgmma
        named_bar_sync(2, CONSUMERS);
        taps_co = it.co0;
        taps_split = it.split;
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[i][f] = Acc(0);
    for (int c = 0; c < nc; ++c) {
      mbar_wait(full + s, ph);
      unsigned char* st = smem + s * L.stage;
      if (noise && c == nc - 1) {
        const float* sn = reinterpret_cast<const float*>(st + L.noise_off);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            nzr[i][hf] = sn[(wg * MI + i) * 64 + wq * 16 + lr + 8 * hf];
      }
      // resident: every chunk (bf16, s8: c0 is 0) or the split's (f32)
      const uint32_t tb =
          a.resident
              ? smem_u32(smem + L.res_off + (TF32 ? c : c0 + c) * L.taps)
              : smem_u32(st + L.tap_off);
      if constexpr (TF32)
        mma_chunk_tf32<BN, MI>(acc, base + s * L.stage, s * L.stage, tb, asw,
                               aoff, row);
      else
        mma_chunk<BN, MI, CK, S8>(acc, base + s * L.stage, s * L.stage, tb,
                                  asw, aoff, row);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
    }

    // f32: A_hi B_lo's half added to the other (A_hi B_hi + A_lo B_hi)
    if constexpr (TF32) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int f = 0; f < BN / 2; ++f) acc[i][f] += acc[i][f + BN / 2];
    }
    // ---- the item's epilogue, from the accumulators.  This thread holds
    // rows m = (wg * MI + i) * 64 + wq * 16 + lr + 8 * hf, columns j * 8 +
    // lc + e, in acc[i][j * 4 + hf * 2 + e].
    bool ok[MI][2];
    int pix[MI][2];  // (image, row, column) as one index
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = (wg * MI + i) * 64 + wq * 16 + lr + 8 * hf;
        const int gi = a.fd_per.div(m), rem = m - gi * per;
        const int ty = a.fd_tw.div(rem);
        const int nn = it.n0 + gi, oy = it.ty0 + ty,
                  ox = it.tx0 + rem - ty * a.tw;
        ok[i][hf] = nn < a.n && oy < a.h && ox < a.wd;
        pix[i][hf] = (nn * a.h + oy) * a.wd + ox;
      }
    if (a.splits > 1) {  // the finish kernel adds the splits in order
      Acc* ws = static_cast<Acc*>(a.ws) +
                (size_t)it.split * a.n * a.h * a.wd * a.cout;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = it.co0 + j * 8 + lc;
            if (!ok[i][hf] || co >= a.cout) continue;
            Acc* wp = ws + (size_t)pix[i][hf] * a.cout + co;
            const Acc v0 = acc[i][j * 4 + hf * 2];
            const Acc v1 = acc[i][j * 4 + hf * 2 + 1];
            if (a.cout % 2 == 0) {  // the channel pair, 8 bytes at once
              *reinterpret_cast<uint2*>(wp) = make_uint2(bits(v0), bits(v1));
            } else {
              wp[0] = v0;
              if (co + 1 < a.cout) wp[1] = v1;
            }
          }
      continue;
    }
    const bool shared_out = STATS || a.tma_y;
    const int ob = NB == 2 ? (nitem++ & 1) : 0;
    float* slots = reinterpret_cast<float*>(smem + L.slot_off) +
                   ob * (BM / 16) * BN * 2;
    unsigned char* out = smem + L.out_off + ob * BM * BN * 2;
    if (NB == 1 && shared_out) {
      // the last item's TMA store has read the tile, and every thread has
      // read the last item's slots
      if (tid == 0 && a.tma_y) bulk_wait_read<0>();
      named_bar_sync(1, CONSUMERS);
    }
    // kernel 1: where the block holds one image (g == 1, every layer from
    // 16^2 up) a warp adds its m64 tiles' rows in registers first and
    // keeps one slot (of 8); else one slot per 16-row fragment
    const bool one = a.g == 1;
    // one 8-channel column block at a time: v = acc [+ noise * nscale]
    // [+ bias] and the activation (s8: v = float(acc) * deq first, every
    // step rounded on its own, conv3x3_tc.cuh's s8 epilogue), kernel 1's
    // slots, y.  s8 keeps v's f32 bits in the s32 registers.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      // keep each block's nscale and bias loads in it: hoisted, the wide
      // tiles' 64 of each spilled beside 128 accumulators
      asm volatile("" ::: "memory");
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = it.co0 + j * 8 + lc + e;
        const bool cok = co < a.cout;
        const float ns = (STATS && cok) ? __ldg(a.nscale + co) : 0.f;
        const float bb = (a.bias != nullptr && cok) ? __ldg(a.bias + co) : 0.f;
        const float dq = (S8 && cok) ? __ldg(a.deq + co) : 0.f;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            Acc& r = acc[i][j * 4 + hf * 2 + e];
            if constexpr (S8) {
              float v = __fmul_rn(__int2float_rn(r), dq);
              if (STATS) v = __fadd_rn(v, __fmul_rn(nzr[i][hf], ns));
              if (a.bias != nullptr) v = __fadd_rn(v, bb);
              if (a.act == tc::RELU)
                v = fmaxf(v, 0.f);
              else if (a.act == tc::LEAKY)
                v = v >= 0.f ? v : __fmul_rn(a.slope, v);
              r = __float_as_int(v);
            } else {
              float v = r;
              if (STATS) v += nzr[i][hf] * ns;
              if (a.bias != nullptr) v += bb;
              if (a.act == tc::RELU)
                v = fmaxf(v, 0.f);
              else if (a.act == tc::LEAKY)
                v = v >= 0.f ? v : a.slope * v;
              r = v;
            }
          }
      }
      if (STATS) {  // slots of the sums of v and v^2 per channel
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            if (one && i > 0) break;
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int k = 0; k < MI; ++k) {
              if (!one && k != i) continue;
              const float v0 = ok[k][0] ? as_f32(acc[k][j * 4 + e]) : 0.f;
              const float v1 =
                  ok[k][1] ? as_f32(acc[k][j * 4 + 2 + e]) : 0.f;
              s1 += v0 + v1;
              s2 += v0 * v0 + v1 * v1;
            }
#pragma unroll
            for (int sh = 4; sh < 32; sh *= 2) {
              s1 += __shfl_xor_sync(0xffffffffu, s1, sh);
              s2 += __shfl_xor_sync(0xffffffffu, s2, sh);
            }
            if (lr == 0) {
              const int f = one ? wg * 4 + wq : (wg * MI + i) * 4 + wq;
              float* sl = slots + (f * BN + j * 8 + lc + e) * 2;
              sl[0] = s1;
              sl[1] = s2;
            }
          }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float v0 = as_f32(acc[i][j * 4 + hf * 2]);
          const float v1 = as_f32(acc[i][j * 4 + hf * 2 + 1]);
          if (a.tma_y) {  // to the tile [atom][BM][BNA], swizzled
            const int m = (wg * MI + i) * 64 + wq * 16 + lr + 8 * hf;
            const int col = j * 8 + lc;
            const uint32_t off =
                (col / BNA) * BM * RB + m * RB + (col % BNA) * 2;
            *reinterpret_cast<uint32_t*>(out + swizzle(off, OSW)) =
                pack2(v0, v1);
          } else if (ok[i][hf]) {
            // Cout % 8 != 0 or an f32 y: a channel pair a store
            const int co = it.co0 + j * 8 + lc;
            const size_t off = (size_t)pix[i][hf] * a.cout + co;
            const bool pair = a.cout % 2 == 0 && co + 1 < a.cout;
            if ((S8 || TF32) && a.y_f32) {
              float* yp = static_cast<float*>(a.y) + off;
              if (pair) {
                *reinterpret_cast<float2*>(yp) = make_float2(v0, v1);
              } else {
                if (co < a.cout) yp[0] = v0;
                if (co + 1 < a.cout) yp[1] = v1;
              }
            } else {
              __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(a.y) + off;
              if (pair) {
                *reinterpret_cast<uint32_t*>(yp) = pack2(v0, v1);
              } else {
                if (co < a.cout) yp[0] = __float2bfloat16(v0);
                if (co + 1 < a.cout) yp[1] = __float2bfloat16(v1);
              }
            }
          }
        }
    }
    if (a.tma_y) fence_proxy_async();  // the tile, seen by the TMA store
    if (shared_out) {
      // with two tiles: the store issued an item ago has read its tile,
      // which the next item writes
      if (NB == 2 && tid == 0 && a.tma_y) bulk_wait_read<0>();
      named_bar_sync(1, CONSUMERS);
    }
    if (a.tma_y && tid == 0) {
      for (int t = 0; t < NATOM; ++t)
        tma_store_4d(&a.tm_y, out + t * BM * RB, it.co0 + t * BNA, it.tx0,
                     it.ty0, it.n0);
      bulk_commit();
    }
    if (STATS) {  // per (image, channel): its slots in order
      const int fpi = one ? CONSUMERS / 32 : per / 16;
      for (int e = tid; e < a.g * BN; e += CONSUMERS) {
        const int gi = e / BN, cc = e - gi * BN;
        const int nn = it.n0 + gi, co = it.co0 + cc;
        if (nn >= a.n || co >= a.cout) continue;
        float s1 = 0.f, s2 = 0.f;
        for (int f = gi * fpi; f < (gi + 1) * fpi; ++f) {
          s1 += slots[(f * BN + cc) * 2];
          s2 += slots[(f * BN + cc) * 2 + 1];
        }
        float* o = a.partial + ((size_t)nn * a.tiles + it.tile) * 2 * a.cout +
                   co;
        o[0] = s1;
        o[a.cout] = s2;
      }
    }
  }
  if (tid == 0 && a.tma_y) bulk_wait_all();
}

// ---------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled map of `rank` dims (innermost first), byte strides of dims 1..,
// the box, TMA's swizzle for the box's inner row (32, 64, 128 bytes; none
// else); zero fill out of bounds.
inline bool encode(CUtensorMap* m, CUtensorMapDataType dt, int rank,
                   const void* base, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   int row_bytes) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                        : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(m, dt, rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int MI, int CK, int KERNEL>
static int launch(const Args& a, cudaStream_t st) {
  constexpr int BM = 128 * MI;
  const Layout L = layout(BN, BM, CK, elem_bytes(KERNEL), a.g, a.th, a.tw,
                          a.stages, a.resident, a.cps,
                          has_stats(KERNEL) && a.splits == 1, a.tma_y,
                          has_stats(KERNEL));
  if (L.smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kern = conv3x3_sm90_kernel<BN, MI, CK, KERNEL>;
  int rc = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
  if (rc) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) ||
      (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads(BN), L.smem)))
    return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int grid = (long long)per_sm * sms < a.items ? per_sm * sms : a.items;
  // f32, resident: a grid of whole Cout blocks keeps each block on one Cout
  // block (item w's is w % cout_blocks), so its split taps stay valid
  if (is_tf32(KERNEL) && a.resident && grid < a.items &&
      grid > a.cout_blocks)
    grid -= grid % a.cout_blocks;
  kern<<<grid, threads(BN), L.smem, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc || a.splits == 1) return rc;
  // split-K: conv3x3_tc.cuh's finish kernel adds the splits in order (s8:
  // the s32 partials, exactly; f32 to nearest, y in f32) and runs the
  // epilogue (and kernel 1's partials) in blocks of FINISH_BN channels over
  // the same tiles
  tc::Args f = {};
  f.deq = a.deq;
  f.bias = a.bias;
  f.noise = a.noise;
  f.nscale = a.nscale;
  f.y = a.y;
  f.y_f32 = a.y_f32;
  f.partial = a.partial;
  f.ws = static_cast<float*>(a.ws);
  f.n = a.n;
  f.h = a.h;
  f.wd = a.wd;
  f.cin = a.cin;
  f.cout = a.cout;
  f.act = a.act;
  f.slope = a.slope;
  f.tw = a.tw;
  f.th = a.th;
  f.g = a.g;
  f.splits = a.splits;
  f.tiles_x = a.tiles_x;
  f.tiles = a.tiles;
  f.fd_per = a.fd_per;
  f.fd_tw = a.fd_tw;
  f.vec_y = a.cout % 8 == 0 && aligned(a.y, 16);
  const int fsmem = (BM * (tc::FINISH_BN + 4) +
                     tc::red_floats(tc::FINISH_THREADS, a.g, tc::FINISH_BN)) *
                    4;
  auto fin = tc::conv3x3_tc_finish_kernel<is_s8(KERNEL)>;
  rc = tc::set_smem(fin, fsmem);
  if (rc) return rc;
  const dim3 fgrid(a.tiles, (a.cout + tc::FINISH_BN - 1) / tc::FINISH_BN,
                   (a.n + a.g - 1) / a.g);
  fin<<<fgrid, tc::FINISH_THREADS, fsmem, st>>>(f, BM, tc::FINISH_BN);
  return (int)cudaGetLastError();
}

// The s8 tiles tc_plan.plan_sm90(s8=True) can return, and so the only s8
// kernels built (tc_plan.S8_SM90_TILES lists them): BN 16 and 32 at 16-
// (Cin 16, tap pairs), 32- or 64-byte stages (kernel 1 at BN 32 in 16- or
// 32-byte stages and 128-pixel blocks), BN 64 at 64 (Cin > 64 only), BN
// 128 at 32, or at 64 in one m64 tile a warpgroup (a split).
__host__ __device__ constexpr bool s8_tile(int bn, int mi, int ck,
                                           int kernel) {
  return bn <= 32 ? !(has_stats(kernel) && bn == 32 && (ck == 64 || mi == 2))
                  : (ck != 16 &&
                     (bn == 64 ? ck == 64 : (ck == 32 || mi == 1)));
}

// The f32 tiles tc_plan.plan_tf32 can return (tc_plan.TF32_SM90_TILES):
// BN 8 to 64 in one or two m64 tiles a warpgroup, CK 16; not BN 32 in two
// (its 96 registers a thread spilled; the rule gives the 32-channel
// layers 128-pixel blocks, whose resident taps leave two blocks an SM).
// Kernel 1 (entry 9, tc_plan.TF32_K1_SM90_TILES): BN 16 to 64 in one or
// two, BN 32 too (one block an SM, min_blocks).
__host__ __device__ constexpr bool tf32_tile(int bn, int mi, int kernel) {
  return kernel == 9
             ? bn >= 16 && bn <= 64 && (mi == 1 || mi == 2)
             : bn >= 8 && bn <= 64 && (mi == 1 || (mi == 2 && bn != 32));
}

// ck: a stage of 32 or 64 bytes a pixel (bf16 16 or 32 channels, s8 32 or
// 64, f32 16).
template <int BN, int MI, int KERNEL>
static int dispatch_ck(const Args& a, int ck, cudaStream_t st) {
  if constexpr (is_tf32(KERNEL)) {
    if constexpr (tf32_tile(BN, MI, KERNEL))
      if (ck == 16) return launch<BN, MI, 16, KERNEL>(a, st);
    return (int)cudaErrorInvalidValue;
  } else if constexpr (BN == 8) {  // f32 only
    return (int)cudaErrorInvalidValue;
  } else if constexpr (is_s8(KERNEL)) {
    if (ck == 16) {
      if constexpr (s8_tile(BN, MI, 16, KERNEL))
        return launch<BN, MI, 16, KERNEL>(a, st);
    } else if (ck == 32) {
      if constexpr (s8_tile(BN, MI, 32, KERNEL))
        return launch<BN, MI, 32, KERNEL>(a, st);
    } else {
      if constexpr (s8_tile(BN, MI, 64, KERNEL))
        return launch<BN, MI, 64, KERNEL>(a, st);
    }
    return (int)cudaErrorInvalidValue;  // a tile the rule never returns
  } else {
    return ck == 16 ? launch<BN, MI, 16, KERNEL>(a, st)
                    : launch<BN, MI, 32, KERNEL>(a, st);
  }
}

// plan = {bn, mi, ck, tw, th, g, splits, cps, stages, resident, tma_y}
// from kernels/tc_plan.py::plan_sm90.  Checks the plan and TMA's rules
// (16-byte strides and bases, boxes <= 256), encodes the tensor maps and
// launches; returns a CUDA error code (cudaErrorInvalidValue for a plan or
// a tensor this body does not take).  KERNEL: 1, 2, 6 or 7 (bf16; a row
// band: h counts the output rows, x holds h + 2), 4 or 5 (s8: deq given, y
// in f32 where y_f32, then from registers whatever the plan's tma_y), 3, 8
// or 9 (f32: resident taps split by the blocks, or streamed from wk; y in
// f32 from registers).
template <int KERNEL>
inline int run(Args a, const int* plan, cudaStream_t st) {
  static_assert(KERNEL == 1 || KERNEL == 2 || is_s8(KERNEL) ||
                    is_rows(KERNEL) || is_tf32(KERNEL),
                "kernel 1 to 9");
  constexpr bool STATS = has_stats(KERNEL);
  constexpr bool S8 = is_s8(KERNEL);
  constexpr bool TF32 = is_tf32(KERNEL);
  constexpr int EB = elem_bytes(KERNEL);
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  if (TF32) a.y_f32 = 1;
  const int bn = plan[0], mi = plan[1], ck = plan[2];
  a.tw = plan[3];
  a.th = plan[4];
  a.g = plan[5];
  a.splits = plan[6];
  a.cps = plan[7];
  a.stages = plan[8];
  a.resident = plan[9];
  a.tma_y = plan[10] && !a.y_f32;
  const bool shape_ok =
      (TF32 ? tf32_tile(bn, mi, KERNEL) && ck == 16
            : (bn == 16 || bn == 32 || bn == 64 || bn == 128) &&
                  (mi == 1 || mi == 2)) &&
      (ck * EB == 32 || ck * EB == 64 || (S8 && ck == 16)) &&
      (a.tw == 4 || a.tw == 8 || a.tw == 16) && a.th >= 1 &&
      a.th + 2 <= 256 && a.g >= 1 && a.g <= 256 &&
      a.tw * a.th * a.g == 128 * mi && (a.th * a.tw) % 16 == 0 &&
      a.stages >= 2 && a.stages <= MAX_STAGES;
  if (!shape_ok || a.splits < 1 || a.cps < 1 || a.n < 1 || a.h < 1 ||
      a.wd < 1 || a.cin < 1 || a.cout < 1)
    return (int)cudaErrorInvalidValue;
  if (S8 ? a.deq == nullptr : (a.deq != nullptr || (a.y_f32 && !TF32)))
    return (int)cudaErrorInvalidValue;
  // f32: the taps resident (a block's Cout block and split), or streamed
  // from the K-major layout wk
  if (TF32 && !a.resident && (a.wk == nullptr || !aligned(a.wk, 16)))
    return (int)cudaErrorInvalidValue;
  // s8 at 16-byte stages: Cin 16 exactly, its tap pairs resident
  if (ck * EB == 16 && (a.cin != 16 || !a.resident))
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
  if (items >= (1LL << 31) ||
      (a.splits > 1 &&
       (a.cout + tc::FINISH_BN - 1) / tc::FINISH_BN > 65535))
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.items = (int)items;
  a.fd_per.set(a.th * a.tw);
  a.fd_tw.set(a.tw);
  // TMA's rules: global strides multiples of 16 bytes, 16-byte bases.  x's
  // rows are Cin elements; bf16 w's rows Cout (unless resident), s8 w's
  // Cin (always 16-byte loads, by TMA or resident)
  const bool noise = STATS && a.splits == 1;
  if ((a.cin * EB) % 16 != 0 || !aligned(a.x, 16) ||
      (S8 && !aligned(a.w, 16)) ||
      (!TF32 && a.resident && (a.splits != 1 || a.cout_blocks != 1)) ||
      (!S8 && !TF32 && !a.resident &&
       (a.cout % 8 != 0 || !aligned(a.w, 16))) ||
      (a.tma_y && (a.cout % 8 != 0 || !aligned(a.y, 16))) ||
      (a.y_f32 && !aligned(a.y, 8)) ||
      (noise && (a.wd % 4 != 0 || !aligned(a.noise, 16))))
    return (int)cudaErrorInvalidValue;
  // 16-byte reads of resident taps: 8 bf16 channels, 4 f32 (tf32's split)
  a.vec_w = a.cout % (TF32 ? 4 : 8) == 0 && aligned(a.w, 16);
  const int h_in = is_rows(KERNEL) ? a.h + 2 : a.h;
  const int bna = bn < 64 ? bn : 64;
  const cuuint64_t n = a.n, h = a.h, hi = h_in, wd = a.wd, cin = a.cin,
                   cout = a.cout, eb = EB;
  // TMA has no s8 type: u8 moves the same bytes, and its zero fill is s8's
  const CUtensorMapDataType xw =
      S8     ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : TF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  {
    const cuuint64_t dims[4] = {cin, wd, hi, n};
    const cuuint64_t strides[3] = {cin * eb, wd * cin * eb,
                                   hi * wd * cin * eb};
    const cuuint32_t box[4] = {(cuuint32_t)ck, (cuuint32_t)a.tw + 2,
                               (cuuint32_t)a.th + 2, (cuuint32_t)a.g};
    if (!encode(&a.tm_x, xw, 4, a.x, dims, strides, box, ck * EB))
      return (int)cudaErrorInvalidValue;
  }
  if (!a.resident && TF32) {  // wk: box (16, BN, 2, 9), 64-byte rows
    const cuuint64_t dims[4] = {16, cout, 2, 9 * (cuuint64_t)a.chunks};
    const cuuint64_t strides[3] = {64, cout * 64, 2 * cout * 64};
    const cuuint32_t box[4] = {16, (cuuint32_t)bn, 2, 9};
    if (!encode(&a.tm_w, xw, 4, a.wk, dims, strides, box, 64))
      return (int)cudaErrorInvalidValue;
  } else if (!a.resident && S8) {  // [tap][Cout][Cin]: box (CK, BN, 9)
    const cuuint64_t dims[3] = {cin, cout, 9};
    const cuuint64_t strides[2] = {cin, cout * cin};
    const cuuint32_t box[3] = {(cuuint32_t)ck, (cuuint32_t)bn, 9};
    if (!encode(&a.tm_w, xw, 3, a.w, dims, strides, box, ck))
      return (int)cudaErrorInvalidValue;
  } else if (!a.resident) {  // HWIO: box (BNA, CK, 9)
    const cuuint64_t dims[3] = {cout, cin, 9};
    const cuuint64_t strides[2] = {cout * 2, cin * cout * 2};
    const cuuint32_t box[3] = {(cuuint32_t)bna, (cuuint32_t)ck, 9};
    if (!encode(&a.tm_w, xw, 3, a.w, dims, strides, box, bna * 2))
      return (int)cudaErrorInvalidValue;
  }
  if (noise) {
    const cuuint64_t dims[3] = {wd, h, n};
    const cuuint64_t strides[2] = {wd * 4, h * wd * 4};
    const cuuint32_t box[3] = {(cuuint32_t)a.tw, (cuuint32_t)a.th,
                               (cuuint32_t)a.g};
    if (!encode(&a.tm_noise, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.noise,
                dims, strides, box, 0))
      return (int)cudaErrorInvalidValue;
  }
  if (a.tma_y) {
    const cuuint64_t dims[4] = {cout, wd, h, n};
    const cuuint64_t strides[3] = {cout * 2, wd * cout * 2, h * wd * cout * 2};
    const cuuint32_t box[4] = {(cuuint32_t)bna, (cuuint32_t)a.tw,
                               (cuuint32_t)a.th, (cuuint32_t)a.g};
    if (!encode(&a.tm_y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.y, dims,
                strides, box, bna * 2))
      return (int)cudaErrorInvalidValue;
  }
  switch (bn * 10 + mi) {
    case 81:
      return dispatch_ck<8, 1, KERNEL>(a, ck, st);
    case 82:
      return dispatch_ck<8, 2, KERNEL>(a, ck, st);
    case 161:
      return dispatch_ck<16, 1, KERNEL>(a, ck, st);
    case 162:
      return dispatch_ck<16, 2, KERNEL>(a, ck, st);
    case 321:
      return dispatch_ck<32, 1, KERNEL>(a, ck, st);
    case 322:
      return dispatch_ck<32, 2, KERNEL>(a, ck, st);
    case 641:
      return dispatch_ck<64, 1, KERNEL>(a, ck, st);
    case 642:
      return dispatch_ck<64, 2, KERNEL>(a, ck, st);
    case 1281:
      return dispatch_ck<128, 1, KERNEL>(a, ck, st);
    default:
      return dispatch_ck<128, 2, KERNEL>(a, ck, st);
  }
}

// An entry point's arguments into Args: the bf16 ones of conv_in_stats.cu,
// small_conv.cu and their *_rows.cu forms (deq null, y_f32 0), the s8 ones
// of conv_in_stats_s8.cu and small_conv_s8.cu (deq (Cout,), y_f32 for an
// f32 y; ws holds s32), the f32 ones of bil_conv_sm90.cu,
// small_conv_f32.cu and conv_in_stats_f32.cu (deq null; run() sets y_f32;
// conv_in_stats_f32.cu sets wk where the taps stream).
inline Args args(const void* x, const void* w, const float* deq,
                 const float* noise, const float* nscale, const float* bias,
                 void* y, int y_f32, float* partial, void* ws, int n, int h,
                 int wd, int cin, int cout, int act, float slope) {
  Args a;
  memset(&a, 0, sizeof(a));
  a.x = x;
  a.w = w;
  a.deq = deq;
  a.noise = noise;
  a.nscale = nscale;
  a.bias = bias;
  a.y = y;
  a.y_f32 = y_f32;
  a.partial = partial;
  a.ws = ws;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.act = act;
  a.slope = slope;
  return a;
}

}  // namespace
}  // namespace sm90
}  // namespace gst
