"""Launch plans of the tensor-core 3x3 convs: ``plan_sm90`` for the bf16
and s8 Hopper body (``csrc/conv3x3_sm90.cuh``, kernels 1 and 2, their
row-band and their s8 forms), ``plan_tf32`` for its f32 (3xTF32) form
(kernels 3 and 2) and ``plan_tf32_in_stats`` for kernel 1's, ``plan``
for the mma.sync bf16 and s8 bodies (``csrc/conv3x3_tc.cuh``),
``plan_f32`` for the mma.sync f32 3xTF32 kernel
(``csrc/conv3x3_tf32.cuh``, kernels 1, 2 and 3).  ``plan_bf16``,
``plan_s8`` and ``plan_f32_body`` are the rules that pick a bf16, s8 or
f32 call's body.

Pure functions of the layer's shape, so the CPU tests can check every
path shape's plan without a card.  ``h`` is always the OUTPUT rows: the
row-band forms of kernels 1 and 2 (``generate --spatial``) read ``h + 2``
input rows (the band's halo), and plan, tile, split and size kernel 1's
partial axis (``tiles``) by the band's output rows alone; the halo staged
per tile is ``th + 2`` rows either way.  A band's split-K may differ from
the whole image's, so a band's bf16 sums round differently.  The kernels validate the plan they are
given and compute their shared memory by the same formulas as
``smem_bytes``.

``plan``:

- ``bn``: output channels per block, Cout rounded up to a power of two in
  8..64, so a narrow layer (2-64 channels) reads each input pixel once; Cout
  = 2 runs at N = 8 with zero taps and masked stores.
- ``wm``: warps along M, 32 pixels each; 8 (256 pixels) where that grid
  still fills the card (twice over for ``bn <= 32``, whose layers are
  bound by bytes; once for ``bn == 64``, where a warp's 32 x 64 tile reads
  half the shared memory per MMA of the 32 x 32 warps of a 128-pixel
  block), else 4.  ``bn == 64`` at ``wm == 4`` runs 2 warps along N.
- ``ck``: input channels per pipeline stage, 16 for Cin <= 16, else 32;
  with ``s8``, 32 for Cin <= 32, else 64 (the same 32 or 64 bytes a pixel).
- ``tw``, ``th``, ``g``: the block's pixels as g images x th rows x tw
  columns at the same spatial tile (``tw * th * g == 32 * wm``).
- ``splits``, ``cps``: split-K over Cin chunks (``cps`` chunks per split)
  where the grid has fewer blocks than SMs; a second kernel reduces the
  splits in a fixed order.
- ``stages``: the cp.async ring's depth, 2 where an item has one or two
  chunks (double buffering across the persistent block's items), else 3.

Where a plan would exceed the shared memory, the ring drops to 2 stages,
then the block to 4 warps.

``plan_f32``: ``bn``, ``tw``, ``th``, ``g`` as above; ``wm`` warps of
``16 * mi`` pixels each, all ``bn`` channels per warp: 256-pixel blocks
where that grid fills the card twice over (8 warps of 32 pixels, or, for
``bn <= 16``, 4 warps of 64 pixels, ``mi`` 4), else 4 warps of 32; ``ck``
8 for Cin <= 8, else 16 (f32 stages twice the bytes of bf16);
``resident``: with one Cout block and no split, every chunk's taps load
once per block beside the ring instead of once per item; ``stages`` 2, or 3
where an item (a split's share of it) has more than two chunks.  It takes
the first of (resident taps, then per stage) and (3 stages, then 2) whose
shared memory lets the blocks per SM that the kernel's launch bounds ask
for share one SM, else the first that fits in a block's limit.  ``splits``,
``cps``: split-K over Cin chunks as in ``plan``, as many splits as keep the
blocks within the SM count, each with at least ``MIN_CPS_F32`` chunks, and
never more than ``MAX_CPS_F32`` chunks in one accumulator chain (kernels 1
and 2; kernel 3 passes ``splits=1`` and has at most 8 chunks).  ``stats`` (kernel 1): the plan
reserves the statistics' slots and keeps a tile's pixels per image a
multiple of 16, so that an m16 fragment lies in one image.
"""

from dataclasses import dataclass, replace
from typing import Optional, Union

MAX_SMEM = 232448        # a block's shared-memory limit on sm_90
SM_SMEM = 233472         # an SM's shared memory; each block reserves 1 KB
NUM_SMS = 132            # H100 SXM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def pad16(b: int) -> int:
    """A row of ``b`` bytes (a multiple of 16) padded to an odd number of
    16-byte units (``pad16`` in conv3x3_tc.cuh)."""
    return b + 16 if (b // 16) % 2 == 0 else b


@dataclass(frozen=True)
class Plan:
    sm90 = False  # the mma.sync body (entries gst_conv3x3_*)
    bn: int
    wm: int
    ck: int
    tw: int
    th: int
    g: int
    splits: int
    cps: int
    stages: int
    noise: bool   # kernel 1: each stage also holds the item's noise
    s8: bool      # the s8 body: ck counts s8 channels, taps [tap][BN][CK]
    tiles_x: int
    tiles_y: int
    groups: int
    cout_blocks: int

    @property
    def bm(self) -> int:
        return 32 * self.wm

    @property
    def threads(self) -> int:
        return 32 * self.wm * (2 if self.bn == 64 and self.wm == 4 else 1)

    @property
    def tiles(self) -> int:
        """Spatial tiles per image: the extent of kernel 1's partial axis."""
        return self.tiles_x * self.tiles_y

    @property
    def blocks(self) -> int:
        return self.tiles * self.cout_blocks * self.groups * self.splits

    @property
    def smem_bytes(self) -> int:
        eb = 1 if self.s8 else 2
        halo = self.g * (self.th + 2) * (self.tw + 2) * pad16(self.ck * eb)
        taps = (9 * self.bn * pad16(self.ck) if self.s8
                else 9 * self.ck * pad16(2 * self.bn))
        stage = halo + taps + (4 * self.bm if self.noise else 0)
        epilogue = self.bm * (self.bn + 4) + 2 * max(self.threads,
                                                     self.g * self.bn)
        return self.stages * stage + epilogue * 4

    def args(self):
        """The int[9] the C entry points take."""
        return (self.bn, self.wm, self.ck, self.tw, self.th, self.g,
                self.splits, self.cps, self.stages)

    def ws_elems(self, n: int, h: int, w: int, cout: int) -> int:
        """f32 (s8: s32) elements of the split-K workspace (0 without a
        split)."""
        return self.splits * n * h * w * cout if self.splits > 1 else 0


def _geometry(n, h, w, bm, tw, min_th=1):
    th = min(bm // tw, max(_pow2ceil(h), min_th))
    g = bm // (tw * th)
    return th, g, _cdiv(w, tw), _cdiv(h, th), _cdiv(n, g)


def _plan(n, h, w, cin, cout, wm, stages, noise=False, s8=False):
    bn = min(64, max(8, _pow2ceil(cout)))
    ck = (32 if cin <= 32 else 64) if s8 else (16 if cin <= 16 else 32)
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    cout_blocks = _cdiv(cout, bn)
    th, g, tiles_x, tiles_y, groups = _geometry(n, h, w, 32 * wm, tw)
    blocks = tiles_x * tiles_y * groups * cout_blocks
    chunks = _cdiv(cin, ck)
    splits = 1
    if blocks < NUM_SMS:
        splits = min(chunks, _cdiv(2 * NUM_SMS, blocks))
    cps = _cdiv(chunks, splits)
    splits = _cdiv(chunks, cps)
    return Plan(bn=bn, wm=wm, ck=ck, tw=tw, th=th, g=g, splits=splits,
                cps=cps, stages=stages or (2 if cps <= 2 else 3), noise=noise,
                s8=s8, tiles_x=tiles_x, tiles_y=tiles_y, groups=groups,
                cout_blocks=cout_blocks)


def plan(n: int, h: int, w: int, cin: int, cout: int,
         noise: bool = False, s8: bool = False) -> Plan:
    """The plan of one call; ``noise`` for kernel 1 (its stages hold the
    noise too), ``s8`` for the s8 body."""
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    bn = min(64, max(8, _pow2ceil(cout)))
    _, _, tx, ty, gr = _geometry(n, h, w, 256, tw)
    fill = NUM_SMS if bn == 64 else 2 * NUM_SMS
    wms = [8, 4] if tx * ty * gr * _cdiv(cout, bn) >= fill else [4]
    for wm in wms:
        for stages in (None, 2):
            p = _plan(n, h, w, cin, cout, wm, stages, noise, s8)
            if p.smem_bytes <= MAX_SMEM:
                return p
    return p


def pad_px(ck: int) -> int:
    """A pixel of ``ck`` f32 padded to an odd number of 16-byte units
    (``pad_px`` in conv3x3_tf32.cuh)."""
    return ck + 4 if (ck // 4) % 2 == 0 else ck


def pad_n(bn: int) -> int:
    """A tap row of ``bn`` f32 padded to 8 mod 16 floats (``pad_n`` in
    conv3x3_tf32.cuh)."""
    return bn + 8 if bn % 16 == 0 else bn


MIN_CPS_F32 = 2          # Cin chunks a split keeps at least
# ... and at most.  The tensor cores round the f32 accumulator toward zero
# after every MMA, so a chain's error grows with its length, one-sided:
# measured on the card at K = 9 x 512 in one chain, 2.2e-4 at |y| ~ 4, most
# of chip_smoke.py's f32 tolerance, against 4e-5 in chains of 8 chunks
# (432 MMAs) added in f32 round-to-nearest by the finish kernel
# (tests/test_torch_f32_tc.py emulates both).
MAX_CPS_F32 = 8


@dataclass(frozen=True)
class PlanF32:
    sm90 = False  # the 3xTF32 body (entries gst_conv3x3_*)
    bn: int
    wm: int
    ck: int
    tw: int
    th: int
    g: int
    stages: int
    resident: bool
    chunks: int
    tiles_x: int
    tiles_y: int
    groups: int
    cout_blocks: int
    mi: int
    splits: int = 1
    cps: int = 0          # chunks per split; 0 stands for all of them
    stats: bool = False   # kernel 1: statistics slots after the ring

    def __post_init__(self):
        if self.cps == 0:
            object.__setattr__(self, "cps", self.chunks)

    @property
    def bm(self) -> int:
        return 16 * self.mi * self.wm

    @property
    def tiles(self) -> int:
        """Spatial tiles per image: the extent of kernel 1's partial axis."""
        return self.tiles_x * self.tiles_y

    @property
    def blocks(self) -> int:
        """Items: (spatial tile, Cout block, image group, split)."""
        return self.tiles * self.cout_blocks * self.groups * self.splits

    @property
    def min_blocks(self) -> int:
        """Blocks per SM that the kernel's launch bounds ask of ptxas
        (``Cfg::MIN_BLOCKS`` in conv3x3_tf32.cuh)."""
        return (1 if self.bn == 64 or self.mi == 4 else 2) * (8 // self.wm)

    @property
    def stat_slots(self) -> int:
        """Kernel 1's statistics slots: one per warp where a warp's pixels
        lie in one image, else one per m16 fragment."""
        if not self.stats:
            return 0
        warp_px = 16 * self.mi
        return self.wm if (self.th * self.tw) % warp_px == 0 else (
            self.wm * self.mi)

    @property
    def smem_bytes(self) -> int:
        halo = self.g * (self.th + 2) * (self.tw + 2) * pad_px(self.ck)
        taps = 9 * self.ck * pad_n(self.bn)
        red = self.stat_slots * self.bn * 2
        if self.resident:
            return (self.stages * halo + self.chunks * taps + red) * 4
        return (self.stages * (halo + taps) + red) * 4

    def args(self):
        """The int[11] the C entry points take."""
        return (self.bn, self.wm, self.mi, self.ck, self.tw, self.th, self.g,
                self.stages, int(self.resident), self.splits, self.cps)

    def ws_elems(self, n: int, h: int, w: int, cout: int) -> int:
        """f32 elements of the split-K workspace (0 without a split)."""
        return self.splits * n * h * w * cout if self.splits > 1 else 0


def _splits_f32(items: int, chunks: int) -> int:
    """Split-K where the items leave SMs idle: as many splits as keep the
    blocks within the SM count (one wave), each with MIN_CPS_F32 chunks or
    more (measured on the card, more splits than that lost to the
    workspace's round trip, and one chunk per split to the blocks' fixed
    cost); and everywhere enough splits that none sums more than
    MAX_CPS_F32 chunks in one accumulator chain."""
    fill = min(chunks // MIN_CPS_F32, NUM_SMS // items)
    return max(1, fill, _cdiv(chunks, MAX_CPS_F32))


def plan_f32(n: int, h: int, w: int, cin: int, cout: int,
             stats: bool = False,
             splits: Optional[int] = None) -> PlanF32:
    """The plan of one f32 call: ``stats`` for kernel 1; ``splits`` fixes
    the number of Cin splits asked for (kernel 3 passes 1) instead of the
    rule's."""
    bn = min(64, max(8, _pow2ceil(cout)))
    ck = 8 if cin <= 8 else 16
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    min_th = 16 // tw if stats else 1
    chunks = _cdiv(cin, ck)
    cout_blocks = _cdiv(cout, bn)
    _, _, tx, ty, gr = _geometry(n, h, w, 256, tw, min_th)
    if tx * ty * gr * cout_blocks < 2 * NUM_SMS:
        tiles = [(4, 2)]                      # (wm, mi): 128-pixel blocks
    elif bn <= 16:
        tiles = [(4, 4), (4, 2)]
    else:
        tiles = [(8, 2), (4, 2)]
    plans = []
    for wm, mi in tiles:
        th, g, tiles_x, tiles_y, groups = _geometry(n, h, w, 16 * mi * wm, tw,
                                                    min_th)
        want = splits or _splits_f32(tiles_x * tiles_y * groups * cout_blocks,
                                     chunks)
        cps = _cdiv(chunks, want)
        nsplit = _cdiv(chunks, cps)
        one = cout_blocks == 1 and nsplit == 1
        for resident in ((True, False) if one else (False,)):
            for stages in ((3, 2) if cps > 2 else (2,)):
                plans.append(PlanF32(
                    bn=bn, wm=wm, ck=ck, tw=tw, th=th, g=g, stages=stages,
                    resident=resident, chunks=chunks, tiles_x=tiles_x,
                    tiles_y=tiles_y, groups=groups, cout_blocks=cout_blocks,
                    mi=mi, splits=nsplit, cps=cps, stats=stats))
    for p in plans:
        if p.smem_bytes <= SM_SMEM // p.min_blocks - 1024:
            return p
    for p in plans:
        if p.smem_bytes <= MAX_SMEM:
            return p
    raise ValueError(f"no f32 tensor-core plan fits ({n}, {h}, {w}, {cin}, "
                     f"{cout})")


# ---------------------------------------------------------------------------
# The Hopper body (csrc/conv3x3_sm90.cuh), bf16 and s8

SM90_MAX_STAGES = 8
SM90_INFLIGHT = 24 * 1024  # bytes a block keeps loading: Little's law,
#                           3.35 TB/s x ~1 us over 132 SMs is ~25 KB an SM
SM90_RESIDENT_MAX = 96 * 1024  # a block's resident taps, at most
# ... and a narrow tf32 block's that runs one to an SM instead
TF32_RESIDENT_ONE_BLOCK = 160 * 1024
TMA_BOX_MAX = 256          # elements along any box dimension


# The s8 tiles (bn, mi, ck) plan_sm90(s8=True) can return, by kernel (True:
# kernel 1): the s8 kernels conv3x3_sm90.cuh builds (its s8_tile)
_S8_NARROW = {(bn, mi, ck) for bn in (16, 32) for mi in (1, 2)
              for ck in (16, 32, 64)}
_S8_WIDE = {(64, 1, 64), (64, 2, 64), (128, 1, 32), (128, 1, 64),
            (128, 2, 32)}
S8_SM90_TILES = {False: frozenset(_S8_NARROW | _S8_WIDE),
                 True: frozenset({t for t in _S8_NARROW
                                  if t[0] == 16 or t[1:] in ((1, 16),
                                                             (1, 32))}
                                 | _S8_WIDE)}


def _align(v: int, a: int) -> int:
    return _cdiv(v, a) * a


@dataclass(frozen=True)
class PlanSM90:
    """A call's plan on the Hopper body; ``smem_bytes`` mirrors
    ``layout()`` in conv3x3_sm90.cuh.  ``s8``: x and w are s8 (entries 4
    and 5), ``ck`` counts s8 channels (the same 32 or 64 bytes a pixel as
    bf16's 16 or 32; or Cin 16's 16 bytes, ``pairs``) and the taps come
    K-major, [9][bn][ck] (``pairs``: [5][bn][32])."""
    sm90 = True  # entries gst_conv3x3_*_sm90
    bn: int
    mi: int
    ck: int
    tw: int
    th: int
    g: int
    splits: int
    cps: int
    stages: int
    resident: bool
    tma_y: bool
    noise: bool   # kernel 1 (statistics; the noise when splits == 1)
    chunks: int
    tiles_x: int
    tiles_y: int
    groups: int
    cout_blocks: int
    s8: bool = False
    tf32: bool = False

    @property
    def eb(self) -> int:
        """Bytes of an element of x and w."""
        return 4 if self.tf32 else (1 if self.s8 else 2)

    @property
    def bm(self) -> int:
        return 128 * self.mi

    @property
    def bna(self) -> int:
        """Channels of one swizzle atom of the tap slice and the y tile."""
        return min(self.bn, 64)

    @property
    def tiles(self) -> int:
        """Spatial tiles per image: the extent of kernel 1's partial axis."""
        return self.tiles_x * self.tiles_y

    @property
    def blocks(self) -> int:
        """Items: (spatial tile, Cout block, image group, split)."""
        return self.tiles * self.cout_blocks * self.groups * self.splits

    @property
    def min_blocks(self) -> int:
        """Blocks per SM the kernel's launch bounds ask of ptxas: 2 for the
        narrow tiles (288 threads), 3 for s8 kernel 1 at ``bn`` 16, 1 for
        the wide ones (BN >= 64, 384 threads: a loader warpgroup that hands
        its registers over)."""
        if self.bn >= 64:
            return 1
        return 3 if self.s8 and self.noise and self.bn == 16 else 2

    @property
    def out_bufs(self) -> int:
        """y tiles and statistics slots: two for the narrow tiles (one
        block barrier an item), one for the wide."""
        return 2 if self.bn <= 32 else 1

    @property
    def halo_bytes(self) -> int:
        """One stage's halo box: the TMA transaction."""
        return self.g * (self.th + 2) * (self.tw + 2) * self.ck * self.eb

    @property
    def pairs(self) -> bool:
        """s8 at Cin 16: 16-byte pixels, a k32 step over two taps."""
        return self.ck * self.eb == 16

    @property
    def tap_bytes(self) -> int:
        """One Cin chunk's tap slice: bf16 [9][ck][bn], s8 [9][bn][ck], s8
        in pairs [5][bn][32], tf32 [9][2][bn][ck] (a tap's hi rows, then its
        lo rows)."""
        if self.pairs:
            return 5 * 32 * self.bn
        return 9 * self.ck * self.bn * self.eb * (2 if self.tf32 else 1)

    @property
    def streamed(self) -> bool:
        """tf32 taps by TMA, one box a stage from the K-major (hi, lo)
        layout of w that the entry lays out first (kernel 1's plans); else
        the blocks split their taps into shared memory (resident)."""
        return self.tf32 and not self.resident

    def layout_elems(self, cout: int) -> int:
        """f32 words of the K-major tap layout, [chunk][9][hi, lo][cout]
        [16] (0 unless ``streamed``)."""
        return self.chunks * 9 * 2 * cout * 16 if self.streamed else 0

    @property
    def stage_load_bytes(self) -> int:
        """Bytes TMA brings into one stage (the noise on an item's last)."""
        return (self.halo_bytes + (0 if self.resident else self.tap_bytes)
                + (4 * self.bm if self.noise and self.splits == 1 else 0))

    @property
    def smem_bytes(self) -> int:
        halo = _align(self.halo_bytes, 1024)
        taps = 0 if self.resident else _align(self.tap_bytes, 1024)
        noise = 4 * self.bm if self.noise and self.splits == 1 else 0
        stage = _align(halo + taps + noise, 1024)
        # resident: a block's chunks (all of them without a split)
        res = _align(self.cps * self.tap_bytes, 1024) if self.resident \
            else 0
        out = self.out_bufs * self.bm * self.bn * 2 if self.tma_y else 0
        slots = (self.out_bufs * (self.bm // 16) * self.bn * 2 * 4
                 if self.noise else 0)
        return self.stages * stage + res + out + slots + 16 * self.stages \
            + 1024

    def boxes(self):
        """The TMA boxes of x, w, the noise and y, innermost first (s8's w
        is one K-major box of all ``bn`` channels, tf32's the (hi, lo) rows
        of the K-major layout where ``streamed``)."""
        return {"x": (self.ck, self.tw + 2, self.th + 2, self.g),
                "w": (self.ck, self.bn, 9) if self.s8
                else (self.ck, self.bn, 2, 9) if self.tf32
                else (self.bna, self.ck, 9),
                "noise": (self.tw, self.th, self.g),
                "y": (self.bna, self.tw, self.th, self.g)}

    def args(self):
        """The int[11] the C entry points take."""
        return (self.bn, self.mi, self.ck, self.tw, self.th, self.g,
                self.splits, self.cps, self.stages, int(self.resident),
                int(self.tma_y))

    def ws_elems(self, n: int, h: int, w: int, cout: int) -> int:
        """f32 (s8: s32) elements of the workspace: the K-major tap layout
        where ``streamed``, then the split-K partials (none without a
        split)."""
        return self.layout_elems(cout) + (
            self.splits * n * h * w * cout if self.splits > 1 else 0)


def tma_refuses(cin: int, w: int, noise: bool, aligned: bool = True,
                s8: bool = False, tf32: bool = False) -> Optional[str]:
    """Why TMA's rules keep a call off the Hopper body, or None.  Global
    strides are multiples of 16 bytes (x's rows of Cin elements, the
    noise's rows of W f32) and bases 16-byte aligned.  bf16: w's and y's
    rows of Cout bf16 too, unless the taps are resident and y is stored
    from registers (``plan_sm90`` decides that).  s8: w's rows are Cin
    bytes ([tap][Cout][Cin]), so Cin % 16 covers x and w.  tf32: x's rows
    of Cin f32 and kernel 1's noise rows (the taps are split into the
    block or come from the entry's own K-major layout, 64-byte rows; y
    leaves from registers)."""
    if not aligned:
        return "a base not 16-byte aligned"
    if tf32:
        if cin % 4:
            return "Cin % 4 != 0 (x's row stride)"
        if noise and w % 4:
            return "W % 4 != 0 (the noise's row stride)"
        return None
    if s8 and cin % 16:
        return "Cin % 16 != 0 (x's and w's row strides)"
    if cin % 8:
        return "Cin % 8 != 0 (x's row stride)"
    if noise and w % 4:
        return "W % 4 != 0 (the noise's row stride)"
    return None


def plan_sm90(n: int, h: int, w: int, cin: int, cout: int,
              noise: bool = False, aligned: bool = True, s8: bool = False
              ) -> Optional[PlanSM90]:
    """The Hopper body's plan of one call (``noise``: kernel 1; ``s8``: x
    and w s8), or None where TMA's rules refuse it (``tma_refuses``, or, in
    bf16, Cout % 8 != 0 with taps too many to stay resident).  ``h`` is the
    output rows.  s8 takes bf16's plan in bytes (a stage of 32 or 64 bytes
    a pixel: ``ck`` 32 or 64 s8 channels; the same splits and ring) but for
    the two tile rules marked s8 below.

    - ``bn``: 128 for Cout > 64 (an input halo staged once for 128 output
      channels, wgmma n128 as two 64-channel atoms), else Cout rounded up
      to a power of two, at least 16 (Cout 2 runs n16 on zero taps).  s8
      at Cin <= 64 (a pixel's channels in one 64-byte stage: the layers
      bound by bytes) caps it at 32: two blocks an SM, one block's
      epilogue beside the other's loads and MMAs, beat one wide block by
      26-42% at 256^2 64 -> 128 and 512^2 64 -> 64 and 32 -> 64
      (chip_smoke.phase_s8_sweep), though each halo is staged once per 32
      channels (from L2).
    - ``mi``: m64 tiles per consumer warpgroup: 2 (256-pixel blocks, half
      the tap-slice traffic per pixel of 128) where that grid still fills
      7/8 of the SMs (32^2 x 512: 128 items, one wave), else 1.  s8 kernel
      1 at ``bn`` 32 keeps 1 (128-pixel blocks; 256-pixel ones, 111
      registers a thread, ran slower at 512^2 32 -> 32 and are not built).
    - ``ck``: Cin per stage, 16 for Cin <= 16 and for ``bn`` 128 (a stage of
      128 channels' taps stays 37 KB), else 32; 32 for a split ``bn`` 128
      (no y tile then: half the splits, each twice the chunk); 16 for
      kernel 1 at ``bn`` 32 (at 32 its kernel needs 120 registers, and two
      blocks of that do not share an SM).  s8: twice these, in channels;
      but Cin 16 with resident taps (Cout <= 32) takes 16 (16-byte pixels,
      a k32 step over two taps: 5 steps instead of 9 half-empty ones,
      8-14% less at 1024^2 16 -> 16).
    - ``tw``, ``th``, ``g``: as ``plan``, with >= 16 pixels per image in a
      tile (a 16-row fragment lies in one image: kernel 1's statistics).
    - ``splits``, ``cps``: split-K where the items fill less than 7/8 of
      the SMs, as ``plan``; a wide split keeps >= 2 chunks (64 channels)
      per split (fewer, longer splits measured faster at 4^2 and 8^2).
    - ``resident``: one Cout block and no split, and every chunk's taps
      within ``SM90_RESIDENT_MAX``: the taps load once per block.
    - ``tma_y``: y leaves by TMA store (Cout % 8 == 0, no split), else from
      registers (Cout 2) or by the split's finish kernel.
    - ``stages``: enough that ``stages - 1`` stages in flight hold
      ``SM90_INFLIGHT`` bytes, 2 to ``SM90_MAX_STAGES``, fewer where the
      shared memory would not let ``min_blocks`` blocks share an SM (on
      the card more blocks beat a deeper ring: 2 stages in two blocks an
      SM ran 512^2 32 -> 32 in 0.300 ms, 3 in one 0.332).
    """
    if tma_refuses(cin, w, noise, aligned, s8):
        return None
    eb = 1 if s8 else 2     # bytes of an element of x and w
    per16 = 2 // eb         # channels in a bf16's two bytes
    bn = 128 if cout > 64 else max(16, _pow2ceil(cout))
    if s8 and cin <= 64:
        bn = min(bn, 32)
    ck = per16 * (16 if cin <= 16 * per16 or bn == 128 or (noise and bn == 32)
                  else 32)
    if s8 and cin <= 16 and cout <= bn:  # the taps in pairs, resident
        ck = 16
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    min_th = 16 // tw
    cout_blocks = _cdiv(cout, bn)
    chunks = _cdiv(cin, ck)
    _, _, tx, ty, gr = _geometry(n, h, w, 256, tw, min_th)
    fill = NUM_SMS - NUM_SMS // 8
    mi = 2 if tx * ty * gr * cout_blocks >= fill else 1
    if s8 and noise and bn == 32:
        mi = 1
    th, g, tiles_x, tiles_y, groups = _geometry(n, h, w, 128 * mi, tw,
                                                min_th)
    blocks = tiles_x * tiles_y * groups * cout_blocks
    splits = 1
    if blocks < fill:
        if bn == 128:
            ck = 32 * per16
            chunks = _cdiv(cin, ck)
        splits = min(max(1, chunks // 2) if bn == 128 else chunks,
                     _cdiv(2 * NUM_SMS, blocks))
    cps = _cdiv(chunks, splits)
    splits = _cdiv(chunks, cps)
    resident = (cout_blocks == 1 and splits == 1
                and chunks * 9 * ck * bn * eb <= SM90_RESIDENT_MAX)
    if cout % 8 and not resident and not s8:
        return None
    p = PlanSM90(bn=bn, mi=mi, ck=ck, tw=tw, th=th, g=g, splits=splits,
                 cps=cps, stages=2, resident=resident,
                 tma_y=cout % 8 == 0 and splits == 1, noise=noise,
                 chunks=chunks, tiles_x=tiles_x, tiles_y=tiles_y,
                 groups=groups, cout_blocks=cout_blocks, s8=s8)
    want = min(SM90_MAX_STAGES,
               max(2, 1 + _cdiv(SM90_INFLIGHT, p.stage_load_bytes)))
    budget = min(MAX_SMEM, SM_SMEM // p.min_blocks - 1024)
    for stages in range(want, 1, -1):
        q = replace(p, stages=stages)
        if q.smem_bytes <= budget:
            return q
    q = replace(p, stages=2)
    return q if q.smem_bytes <= MAX_SMEM else None


def plan_bf16(n: int, h: int, w: int, cin: int, cout: int,
              noise: bool = False, aligned: bool = True
              ) -> Union[PlanSM90, Plan]:
    """The body of a bf16 call of kernel 1 (``noise``) or 2, full image or
    row band, by one rule: the Hopper body wherever ``plan_sm90`` takes
    the shape (every generate path shape at ffhq, cars and bedrooms and
    every band shape of N = 2 and 4), the mma.sync body (``plan``) where
    TMA's rules refuse it."""
    return plan_sm90(n, h, w, cin, cout, noise, aligned) or plan(
        n, h, w, cin, cout, noise)


def plan_s8(n: int, h: int, w: int, cin: int, cout: int,
            noise: bool = False, aligned: bool = True
            ) -> Union[PlanSM90, Plan]:
    """The body of an s8 call of kernel 1 (``noise``) or 2, by one rule as
    in bf16: the Hopper body wherever ``plan_sm90(s8=True)`` takes the
    shape (every int8 and int8-full shape of ffhq, cars and bedrooms), the
    mma.sync s8 body (``plan(s8=True)``) where TMA's rules refuse it
    (``tma_refuses``: Cin % 16 != 0, kernel 1 at W % 4 != 0, an unaligned
    view).  The Hopper body's y equals the mma.sync body's bit for bit."""
    return plan_sm90(n, h, w, cin, cout, noise, aligned, s8=True) or plan(
        n, h, w, cin, cout, noise, s8=True)


# The tf32 tiles (bn, mi, ck) plan_tf32 can return: the only tf32 kernels
# conv3x3_sm90.cuh builds (its tf32_tile), for entries 3 and 8; BN 32 only
# in 128-pixel blocks (in 256 its kernel spilled at 96 registers a thread)
TF32_SM90_TILES = frozenset((bn, mi, 16) for bn in (8, 16, 32, 64)
                            for mi in (1, 2) if (bn, mi) != (32, 2))


def plan_tf32(n: int, h: int, w: int, cin: int, cout: int,
              aligned: bool = True) -> Optional[PlanSM90]:
    """The Hopper body's plan of one f32 call of kernel 3 or kernel 2 in
    its 3xTF32 form (entries 3 and 8 of conv3x3_sm90.cuh), or None where
    the rule refuses it: TMA's rules (``tma_refuses(tf32=True)``: Cin % 4,
    an unaligned view) and Cin > 16 * MAX_CPS_F32 (the long-K layers,
    cvt_0..4 at 4^2-64^2, which need split-K for their chains' sake and
    stay on the mma.sync 3xTF32 body with its 16-way splits).

    - ``ck``: 16 f32 (a 64-byte pixel, two k8 steps a tap).
    - ``bn``: Cout rounded up to a power of two in 8..64, but the widest
      whose grid of 128-pixel blocks fills the SMs, else 8: on the card
      the 8^2-64^2 layers took 0.0055-0.0093 ms in 8-channel blocks
      against 0.0094-0.0155 in one or two wide ones (split or not), and
      128^2 32 -> 32 0.0092 in 16-channel blocks against 0.0099
      (``chip_smoke.phase_tf32_sweep``).
    - No split-K: Cin <= 128 keeps every chain within MAX_CPS_F32, and two
      Cin splits lost to one wherever the sweep tried them (16^2 64 -> 32
      in 8-channel blocks: 0.0103 against 0.0086 ms).
    - The taps are always resident: each block splits its own Cout
      block's w, HWIO f32, into K-major tf32 hi and lo, [9][2][bn][16] a
      chunk, once, beside the ring (a block whose next item has another
      Cout block splits again).  ``bn`` halves while the taps would exceed
      ``SM90_RESIDENT_MAX``; but a narrow ``bn`` (<= 32) keeps taps up to
      ``TF32_RESIDENT_ONE_BLOCK`` and runs one block an SM (512^2 64 ->
      32 took 0.139 ms so against 0.156 in two 16-channel blocks two an
      SM, cvt_5 0.0333 at ``bn`` 16 against 0.0379 in four blocks of 8).
      So 64 -> 32 takes ``bn`` 32 from 256^2 up and two blocks of 16 at
      128^2, 32 -> 64 two of 32.
    - ``mi``: 2 (256-pixel blocks) where their grid fills two blocks an
      SM (1024^2 16 -> 16: 0.0914 ms against 0.0978), else 1 (64^2 32 ->
      32 in 8-channel blocks: 0.0061 against 0.0079), and never at ``bn``
      32 (that tile spilled in 256-pixel blocks); ``tw``, ``th``, ``g``,
      ``stages`` as ``plan_sm90``, the ring one stage shallower where the
      blocks would not share an SM as they ask.
    - y leaves from registers, a channel pair a store (no y tile)."""
    if tma_refuses(cin, w, False, aligned, tf32=True):
        return None
    ck = 16
    chunks = _cdiv(cin, ck)
    if chunks > MAX_CPS_F32:
        return None
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    min_th = 16 // tw
    _, _, tx1, ty1, gr1 = _geometry(n, h, w, 128, tw, min_th)
    bn = min(64, max(8, _pow2ceil(cout)))
    while bn > 8 and tx1 * ty1 * gr1 * _cdiv(cout, bn) < NUM_SMS:
        bn //= 2
    plans = []
    while bn >= 8:
        cout_blocks = _cdiv(cout, bn)
        _, _, tx, ty, gr = _geometry(n, h, w, 256, tw, min_th)
        wide_ok = tx * ty * gr * cout_blocks >= 2 * NUM_SMS and bn != 32
        for mi in ((2, 1) if wide_ok else (1,)):
            th, g, tiles_x, tiles_y, groups = _geometry(n, h, w, 128 * mi,
                                                        tw, min_th)
            p = PlanSM90(bn=bn, mi=mi, ck=ck, tw=tw, th=th, g=g, splits=1,
                         cps=chunks, stages=2, resident=True, tma_y=False,
                         noise=False, chunks=chunks, tiles_x=tiles_x,
                         tiles_y=tiles_y, groups=groups,
                         cout_blocks=cout_blocks, tf32=True)
            taps = chunks * p.tap_bytes
            if taps <= SM90_RESIDENT_MAX:
                plans.append((p, False))
            elif (bn <= 32 and p.blocks >= NUM_SMS
                  and taps <= TF32_RESIDENT_ONE_BLOCK):
                plans.append((p, True))
        bn //= 2
    # the first whose blocks share an SM as they ask (or run one an SM)
    for p, one in plans:
        want = min(SM90_MAX_STAGES,
                   max(2, 1 + _cdiv(SM90_INFLIGHT, p.stage_load_bytes)))
        budget = MAX_SMEM if one else min(MAX_SMEM,
                                          SM_SMEM // p.min_blocks - 1024)
        for stages in range(want, 1, -1):
            q = replace(p, stages=stages)
            if q.smem_bytes <= budget:
                return q
    for p, _ in plans:
        if p.smem_bytes <= MAX_SMEM:
            return p
    return None


# Kernel 1's tf32 tiles (bn, mi, ck): the only entry-9 kernels
# conv3x3_sm90.cuh builds (its tf32_tile for kernel 9).  BN 32 in 256-pixel
# blocks is built here: kernel 1's BN 32 kernels run one block an SM
# (min_blocks), so its registers are not held to 112.
TF32_K1_SM90_TILES = frozenset((bn, mi, 16) for bn in (16, 32, 64)
                               for mi in (1, 2))


def tf32_in_stats_plan(n: int, h: int, w: int, cin: int, cout: int,
                       bn: int, mi: int, splits: Optional[int] = None,
                       resident: Optional[bool] = None
                       ) -> Optional[PlanSM90]:
    """Kernel 1's plan on the Hopper body's 3xTF32 form (entry 9) with its
    tile set, (``bn``, ``mi``): ``splits`` Cin splits (None: as many as
    ``_splits_f32`` asks, at least enough that no chain passes
    ``MAX_CPS_F32`` chunks); taps ``resident`` (split by the blocks from
    HWIO w) or streamed (one TMA box a stage from the entry's K-major
    layout; None: resident where one wave holds every item and a split's
    taps fit in ``TF32_RESIDENT_ONE_BLOCK``); the deepest ring, 2 to
    ``SM90_MAX_STAGES`` stages, that lets ``min_blocks`` blocks share an
    SM, else one block an SM.  None where a chain would pass the cap or
    nothing fits."""
    ck = 16
    chunks = _cdiv(cin, ck)
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    th, g, tiles_x, tiles_y, groups = _geometry(n, h, w, 128 * mi, tw,
                                                16 // tw)
    cout_blocks = _cdiv(cout, bn)
    want = splits or _splits_f32(tiles_x * tiles_y * groups * cout_blocks,
                                 chunks)
    cps = _cdiv(chunks, want)
    if cps > MAX_CPS_F32:
        return None
    p = PlanSM90(bn=bn, mi=mi, ck=ck, tw=tw, th=th, g=g,
                 splits=_cdiv(chunks, cps), cps=cps, stages=2, resident=True,
                 tma_y=False, noise=True, chunks=chunks, tiles_x=tiles_x,
                 tiles_y=tiles_y, groups=groups, cout_blocks=cout_blocks,
                 tf32=True)
    if resident is None:  # resident where a wave holds every item (each
        # block's taps are its one item's, so the layout pass would buy
        # nothing) and they fit at one block an SM; else streamed
        resident = (p.blocks <= NUM_SMS
                    and cps * p.tap_bytes <= TF32_RESIDENT_ONE_BLOCK)
    p = replace(p, resident=resident)
    want = min(SM90_MAX_STAGES,
               max(2, 1 + _cdiv(SM90_INFLIGHT, p.stage_load_bytes)))
    for budget in (min(MAX_SMEM, SM_SMEM // p.min_blocks - 1024), MAX_SMEM):
        for stages in range(want, 1, -1):
            q = replace(p, stages=stages)
            if q.smem_bytes <= budget:
                return q
    return None


def plan_tf32_in_stats(n: int, h: int, w: int, cin: int, cout: int,
                       aligned: bool = True) -> Optional[PlanSM90]:
    """Kernel 1's plan on the Hopper body's 3xTF32 form (entry 9:
    csrc/conv_in_stats_f32.cu), or None where TMA's rules refuse the call
    (``tma_refuses(noise=True, tf32=True)``: Cin % 4, W % 4 (the noise's
    rows), an unaligned view).

    - ``bn``: 64 for Cout > 32 (the 512-channel layers run 8 Cout blocks),
      else Cout rounded up to a power of two, at least 16; 32 where 64
      would take more than 8 splits to fill the card (4^2: 0.0238 ms in 8
      splits of 32 channels against 0.0271-0.0310 in 16 of 64 on an H100
      80GB HBM3 at 700 W, ``chip_smoke.phase_tf32_sweep``).
    - ``mi``: 2 (256-pixel blocks: half the tap bytes per pixel) where
      their grid fills 7/8 of the SMs, else 1.
    - ``splits``: ``_splits_f32``'s fill rule within the chain cap (Cin 512
      >= 4 splits, Cin 256 >= 2); the finish kernel of conv3x3_tc.cuh adds
      them in order, to nearest, and runs the noise, bias, leaky and the
      statistics.
    - ``resident`` where one wave holds every item and a split's hi and
      lo fit in ``TF32_RESIDENT_ONE_BLOCK`` (4^2: no layout pass, 0.0238
      ms against 0.0270 streamed), else streamed: the entry lays w out once
      a call as [chunk][9][hi, lo][Cout][16] and each stage takes its (16,
      bn, 2, 9) box beside the halo (where the taps would fit, at 512^2 and
      1024^2, the two routes measured within 1-3% of each other, the sign
      changing from run to run).
    - ``tw``, ``th``, ``g`` as ``plan_sm90`` (>= 16 pixels per image in a
      tile: a fragment lies in one image), y from registers."""
    if tma_refuses(cin, w, True, aligned, tf32=True):
        return None
    bn = 64 if cout > 32 else max(16, _pow2ceil(cout))
    tw = 4 if w <= 4 else (8 if w <= 8 else 16)
    _, _, tx, ty, gr = _geometry(n, h, w, 256, tw, 16 // tw)
    mi = 2 if tx * ty * gr * _cdiv(cout, bn) >= NUM_SMS - NUM_SMS // 8 else 1
    p = tf32_in_stats_plan(n, h, w, cin, cout, bn, mi)
    if p is not None and bn == 64 and p.splits > MAX_CPS_F32:
        # more Cout blocks instead of more splits (4^2: 8 splits of
        # 32-channel blocks, resident, against 16 of 64 streamed)
        p = tf32_in_stats_plan(n, h, w, cin, cout, 32, mi)
    return p


def plan_f32_body(n: int, h: int, w: int, cin: int, cout: int,
                  aligned: bool = True, kernel3: bool = False,
                  noise: bool = False) -> Union[PlanSM90, PlanF32]:
    """The body of an f32 call of kernel 1 (``noise``), 2 or (``kernel3``)
    kernel 3, by one rule as in bf16 and s8: the Hopper body's 3xTF32 form
    wherever ``plan_tf32`` (kernel 1: ``plan_tf32_in_stats``) takes the
    shape (every kernel-3 call of a train step but main_8_conv's input
    gradient, Cin 2; every kernel-2 call of evaluate but cvt_0..4; every
    kernel-1 call of the f32 generator), else the mma.sync 3xTF32 body
    (``plan_f32``; kernel 3 without a split, kernel 1 with its
    statistics)."""
    if noise:
        return plan_tf32_in_stats(n, h, w, cin, cout, aligned) or plan_f32(
            n, h, w, cin, cout, stats=True)
    return plan_tf32(n, h, w, cin, cout, aligned) or plan_f32(
        n, h, w, cin, cout, splits=1 if kernel3 else None)
