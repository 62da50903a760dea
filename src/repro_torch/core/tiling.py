"""Accumulator tiling for the Hopper GEMM kernel (port of ``repro.core.tiling``).

The DGEMM case study (paper section V-A) builds a *virtual* accumulator out
of all architected accumulators so that each streamed (X, Y) panel pair
amortizes over the largest output tile the register budget allows.  On the
TPU the budget was 16 MiB of VMEM and a 128-wide MXU; those constants do not
carry over.  On an H100 the budget is

  * 227 KB of shared memory per block (``SMEM_PER_BLOCK``), holding the
    (bm, bk) and (bk, bn) panels during the k-loop and, aliased onto the
    same bytes, the fp32 (bm, bn) tile for the seed load and the epilogue;
  * the register file, holding the accumulator itself: each warp owns a
    (bm / warps_m, bn / warps_n) slice of it as 16x16 fp32 fragments.

The GEMM has five kernels.  The integer families and F64GER each have
their own (:func:`choose_gemm_path` sends them there by family):

  * "imma" (``csrc/gemm_imma.cu``): I8GER4, I4GER8 and I16GER2 on the
    int8 tensor cores, in one of three forms :func:`imma_plan` picks: the
    wgmma tile (:class:`ImmaTileConfig`) for every unmasked product TMA
    can read, I8GER4's weight stream (:class:`ImmaStreamConfig`) for
    ``quant.qdot``'s decode (N <= 64 columns, X the weight), and the
    mma.sync kernel (its one ``GEMM_TILES`` tile a family) for the
    masked forms, pitches TMA cannot read and an explicit block;
  * "dmma" (``csrc/gemm_dmma.cu``): F64GER on the fp64 tensor cores
    (DMMA m16n8k8, m16n8k4 on X panels, from a ``DMMA_STAGES``-deep
    cp.async ring on mbarriers), on a 128 x 128 or a 64 x 64 tile picked
    by :func:`choose_blocks`.

The 16-bit and fp32 families take one of three, picked by shape:

  * "stream" (``csrc/gemm_stream.cu``): M <= 64 rows (decode, the SSD's
    M = 1 products, the MoE expert banks), bound by the weight's bytes;
    the (K, N) weight is streamed once, split over K so that a single
    product holds two blocks per SM (:func:`stream_plan`); bf16/f16 on
    the tensor cores behind a TMA producer, in work units sized to the
    card whatever the batch (:meth:`StreamConfig.run`), F32GER on the
    CUDA cores (true fp32 FMAs);
  * "wgmma" (``csrc/gemm_wgmma.cu``): larger 16-bit M (prefill), bound by
    the tensor cores; a (128, 64 / 128 / 192 / 256) tile a block, fed by
    TMA, the width :func:`wgmma_plan`'s; TMA needs 16-byte pitches (K and
    N multiples of 8) and bases;
  * "wmma" (``csrc/mma_gemm.cu``): what the two do not take -- unaligned
    pitches at large M, K below one MMA step (the SSD's K = 1 outer
    product), F32GER at M > 64 (true fp32, a register-blocked SIMT tile),
    the pm* masked forms, and an explicit or tuned block -- on the fixed
    set of tiles in ``GEMM_TILES``; ``choose_blocks`` picks among exactly
    those, and a block the kernel was not compiled for raises.

A call's path is one choice (:func:`choose_gemm_path`): an explicit
``Plan.block`` wins, then a tuned winner (``core/autotune.py``'s cache,
consulted by ``core.lowering.resolve_block``: a (path, config) pair this
module's kernels are compiled for), else the shape heuristic above.  A
winner the call cannot take (a wgmma tile met by an unaligned pitch, the
weight stream met by a masked call or by M > 64) gives way to the
heuristic; the kernel wrapper counts it.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import precision

Ger = precision.Ger

SMEM_PER_BLOCK = 232_448     # bytes a block may opt in to (227 KB)
NUM_SMS = 132                # H100 SXM streaming multiprocessors

# Row padding (in elements) of the shared-memory tiles, as in csrc/: 16-bit
# panels pad by 8 (16 bytes: conflict-free ldmatrix rows, and room for a
# realigned row's spare word), fp32 by 4.
_PAD16, _PAD32 = 8, 4
# The 16-bit tile's cp.async ring (csrc/tile_gemm.cuh's TILE16_STAGES).
TILE16_STAGES = 4
# The DMMA tiles' cp.async ring (csrc/gemm_dmma.cu's DMMA_STAGES).
DMMA_STAGES = 3

# The tile shapes csrc/mma_gemm.cu (16-bit, fp32), csrc/gemm_imma.cu
# (integer; bk counts unpacked K, two nibbles a byte for I4GER8) and
# csrc/gemm_dmma.cu (F64GER) instantiate, largest first.
GEMM_TILES: dict[Ger, tuple[tuple[int, int, int], ...]] = {
    Ger.BF16GER2: ((128, 128, 32), (64, 64, 64)),
    Ger.F16GER2: ((128, 128, 32), (64, 64, 64)),
    Ger.F32GER: ((128, 128, 16), (64, 64, 16)),
    Ger.I8GER4: ((128, 128, 64),),
    Ger.I4GER8: ((128, 128, 64),),
    Ger.I16GER2: ((64, 128, 64),),
    Ger.F64GER: ((128, 128, 32), (64, 64, 16)),
}

# The families of csrc/gemm_imma.cu, in the order of its family codes.
IMMA_GERS = (Ger.I8GER4, Ger.I4GER8, Ger.I16GER2)


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    bm: int
    bn: int
    bk: int

    def grid(self, m: int, n: int, b: int = 1) -> tuple[int, int, int]:
        """CUDA grid (n tiles, m tiles, batch) of one launch."""
        return (-(-n // self.bn), -(-m // self.bm), b)

    def smem_bytes(self, pol: precision.GerPolicy) -> int:
        """Dynamic shared memory of one block: the panels (the 16-bit
        tile's ring of ``TILE16_STAGES`` panel pairs, the DMMA tiles' ring
        of ``DMMA_STAGES``, the fp32 tile's two stages), or the
        accumulator tile that aliases them, whichever is larger
        (csrc/tile_gemm.cuh's wmma_smem_bytes, csrc/gemm_dmma.cu's
        Tile::SMEM)."""
        c_tile = self.bm * (self.bn + _PAD32) * pol.acc_dtype.itemsize
        if pol.ger in IMMA_GERS:
            # two buffers of byte planes (hi and lo for I16GER2): X rows
            # padded by 16 bytes, Y^T rows unpadded (XOR-swizzled)
            planes = 2 if pol.ger == Ger.I16GER2 else 1
            panels = 2 * planes * (self.bm * (self.bk + 16)
                                   + self.bn * self.bk)
        elif pol.ger == Ger.F64GER:   # fp64 rows padded by 4 doubles
            panels = DMMA_STAGES * (self.bm * (self.bk + _PAD32)
                                    + self.bk * (self.bn + _PAD32)) * 8
        elif pol.in_bytes == 2:
            panels = TILE16_STAGES * (self.bm * (self.bk + _PAD16)
                                      + self.bk * (self.bn + _PAD16)) * 2
        else:  # fp32: two stages, the X panel stored k-major
            panels = 2 * (self.bk * (self.bm + _PAD32)
                          + self.bk * (self.bn + _PAD32)) * 4
        return max(c_tile, panels)


@functools.lru_cache(maxsize=None)
def tiles_for(ger: Ger) -> tuple[BlockConfig, ...]:
    if ger not in GEMM_TILES:
        raise NotImplementedError(
            f"the GEMM kernel has no {ger.value} instantiation (an "
            f"expansion hook: lower it through facility.contract)")
    return tuple(BlockConfig(*t) for t in GEMM_TILES[ger])


def choose_blocks(m: int, n: int, k: int, ger: Ger, b: int = 1) -> BlockConfig:
    """Pick the compiled tile for an accumulator-resident GEMM.

    The largest tile reuses each streamed panel byte most; it is taken
    when its grid still puts a block on every SM.  Otherwise the smallest
    tile is taken, so that skinny products (decode: M = batch) spread
    their weight stream over as many SMs as the grid allows.
    """
    del k  # the k-loop runs inside the block; K does not shape the grid
    tiles = tiles_for(ger)
    for cfg in tiles:
        gx, gy, gz = cfg.grid(m, n, b)
        if gx * gy * gz >= NUM_SMS:
            return cfg
    return tiles[-1]


# ----------------------------------------------------------------------
# The integer families' forms (csrc/gemm_imma.cu)
# ----------------------------------------------------------------------

# The wgmma tile (form A): 128 rows, 128 logical k a stage, BN columns;
# the widths it is compiled for, widest first (I16GER2's three s32
# accumulators a column bound it: at 96 and 128 columns ptxas spilled
# 584 and 968 bytes within the launch's 168 registers, and the tile ran
# 1.7-4.4x slower than at 64: PERF.md).
IMMA_TILE_BM, IMMA_TILE_BK = 128, 128
IMMA_TILE_WIDTHS = {Ger.I8GER4: (256, 128), Ger.I4GER8: (256, 128),
                    Ger.I16GER2: (64,)}
# csrc/gemm_imma.cu's TaCfg: a block's shared memory less 2 KB of slack
# and barriers, at most IMMA_TILE_MAX_STAGES stages; the pre-pass's planes
# have a K pitch of a multiple of IMMA_TILE_KPAD bytes.
IMMA_TILE_BUDGET = SMEM_PER_BLOCK - 2048
IMMA_TILE_MAX_STAGES = 8
IMMA_TILE_KPAD = 64
# A wave of tiles costs its columns times this, relative to the widest
# tile's (the narrow tile reads each X stage twice as often).
IMMA_COLUMN_COST = {256: 1.0, 128: 1.15, 64: 1.3}
# I8GER4's weight stream (form B): 128 weight rows a block, 128 k a stage
# on a ring of IMMA_STREAM_STAGES, N <= 64 columns padded to a compiled
# width, the K-major Y slice at most IMMA_STREAM_YT bytes, staged through
# IMMA_STREAM_RAW bytes of Y's rows; as many blocks an SM as shared memory
# holds, at most IMMA_STREAM_OCC (its launch bounds: ptxas gives each
# instance 48-58 registers a thread).
IMMA_STREAM_BM, IMMA_STREAM_BK = 128, 128
IMMA_STREAM_WIDTHS = (8, 16, 32, 64)
IMMA_STREAM_STAGES = 3
IMMA_STREAM_YT = 65536
IMMA_STREAM_RAW = 8192
IMMA_STREAM_OCC = 3
# The split's cost model (fitted to scripts on the H100, PERF.md): a
# block's fixed cost in stages of its stream (the ring's first fill and
# the deprime) besides its Y columns' bytes, and the stages an SM keeps in
# flight to draw its share of the card's bandwidth (fewer: a slower SM).
IMMA_STREAM_FIXED = 2
IMMA_STREAM_INFLIGHT = 9
# The forms, as csrc/gemm_imma.cu's launcher codes them.
IMMA_FORMS = ("mma", "tile", "stream")


@dataclasses.dataclass(frozen=True)
class ImmaTileConfig:
    """Form A: (128, bn) output tiles, one block each, K in stages of 128
    (logical) k, over the planes its pre-pass writes."""
    bn: int
    bm: int = IMMA_TILE_BM
    bk: int = IMMA_TILE_BK

    def tiles(self, m: int, n: int, b: int = 1) -> int:
        return b * -(-m // self.bm) * -(-n // self.bn)

    def waves(self, m: int, n: int, b: int = 1) -> int:
        """Rounds of the grid on the card: one block an SM."""
        return -(-self.tiles(m, n, b) // NUM_SMS)

    def stage_bytes(self, ger: Ger) -> int:
        """A ring stage: each byte plane's (128 x 128) X box and (bn x
        128) Y^T box (two planes for I16GER2)."""
        planes = 2 if ger == Ger.I16GER2 else 1
        return planes * (self.bm + self.bn) * self.bk

    def stages(self, ger: Ger) -> int:
        """The ring's depth (TaCfg::STAGES)."""
        return min(IMMA_TILE_MAX_STAGES,
                   IMMA_TILE_BUDGET // self.stage_bytes(ger))

    def smem_bytes(self, ger: Ger) -> int:
        """Dynamic shared memory of one block (TaCfg::smem): the ring, 1 KB
        of alignment slack, a full and an empty barrier a stage."""
        stages = self.stages(ger)
        return stages * self.stage_bytes(ger) + 1024 + 2 * stages * 8

    def prep_bytes(self, ger: Ger, m: int, n: int, k: int, bx: int = 1,
                   by: int = 1) -> tuple[int, int]:
        """The pre-pass's workspace: X's planes (none for I8GER4, whose X
        the tile reads as it lies) and Y^T's, (B, planes, rows, kp) bytes;
        ``k`` logical, ``bx`` / ``by`` the batch where the operand is
        batched, else 1."""
        kp = -(-k // IMMA_TILE_KPAD) * IMMA_TILE_KPAD
        planes = 2 if ger == Ger.I16GER2 else 1
        xb = 0 if ger == Ger.I8GER4 else bx * planes * m * kp
        return xb, by * planes * n * kp


@dataclasses.dataclass(frozen=True)
class ImmaStreamConfig:
    """Form B: 128 weight rows a block, bn (>= N) columns, K cut into
    ``split`` slices of whole 64-k stages (slice s owns stages
    [s*S/split, (s+1)*S/split)); the slices' int32 partials add exactly,
    so the split moves no bit."""
    bn: int
    split: int
    bm: int = IMMA_STREAM_BM
    bk: int = IMMA_STREAM_BK

    def blocks(self, m: int, b: int = 1) -> int:
        return b * -(-m // self.bm) * self.split

    def slice_stages(self, k: int) -> int:
        """The longest slice's stages (its Y columns' shared memory)."""
        return -(-(-(-k // self.bk)) // self.split)

    def smem_bytes(self, k: int) -> int:
        """Dynamic shared memory of one block (tb_smem): 1 KB of slack,
        the ring, the slice's K-major Y columns, the raw block of Y's rows
        and the barriers."""
        return (1024 + IMMA_STREAM_STAGES * self.bm * self.bk
                + self.bn * self.bk * self.slice_stages(k) + IMMA_STREAM_RAW
                + 2 * IMMA_STREAM_STAGES * 8)

    def blocks_per_sm(self, k: int) -> int:
        """Blocks an SM runs: what shared memory holds (1 KB reserved a
        block), at most IMMA_STREAM_OCC."""
        return max(1, min(IMMA_STREAM_OCC,
                          SM_SMEM // (self.smem_bytes(k) + 1024)))


def imma_form(cfg) -> str:
    """The form a configuration runs: "tile", "stream" or "mma"."""
    if isinstance(cfg, ImmaTileConfig):
        return "tile"
    return "stream" if isinstance(cfg, ImmaStreamConfig) else "mma"


def imma_stream_plan(m: int, n: int, k: int, b: int = 1) -> ImmaStreamConfig:
    """The weight stream's width (the narrowest compiled one >= N) and
    split: of the splits that keep a slice's Y columns within
    IMMA_STREAM_YT bytes, the one whose grid costs least, in stages of
    the stream: the busiest SM's blocks, each its slice, its Y columns and
    IMMA_STREAM_FIXED stages, slowed where the SM holds fewer than
    IMMA_STREAM_INFLIGHT stages in flight, plus the int32 partials
    (written and read back, in L2: a quarter of a stage's cost a stage's
    bytes); the fewest slices among equals."""
    bn = next(w for w in IMMA_STREAM_WIDTHS if n <= w)
    stages = -(-k // IMMA_STREAM_BK)
    tiles = b * -(-m // IMMA_STREAM_BM)
    fit = -(-stages // (IMMA_STREAM_YT // (bn * IMMA_STREAM_BK)))
    stage = IMMA_STREAM_BM * IMMA_STREAM_BK

    def cost(split: int) -> tuple:
        cfg = ImmaStreamConfig(bn, split)
        per_sm = -(-tiles * split // NUM_SMS)
        live = min(cfg.blocks_per_sm(k), per_sm)
        slow = max(1.0, IMMA_STREAM_INFLIGHT / (live * IMMA_STREAM_STAGES))
        block = (cfg.slice_stages(k) + IMMA_STREAM_FIXED
                 + bn * IMMA_STREAM_BK * cfg.slice_stages(k) / stage)
        parts = (2 * 4 * split * b * m * n / NUM_SMS / stage / 4
                 if split > 1 else 0.0)
        return per_sm * block * slow + parts, split

    return ImmaStreamConfig(bn, min(range(fit, stages + 1), key=cost))


def imma_plan(m: int, n: int, k: int, ger: Ger, b: int = 1,
              aligned: bool = True, masked: bool = False,
              x_aligned: bool | None = None):
    """The form of an integer product, by op-class and shape, never as a
    retry: the mma.sync kernel's tile (a ``BlockConfig``) for the masked
    forms and pitches TMA cannot read; I8GER4's weight stream where N <=
    64 and X (the weight) is TMA-read (``x_aligned``, else ``aligned``);
    else the wgmma tile whose grid costs least in waves x bn x
    ``IMMA_COLUMN_COST``, the widest among equals.  ``aligned``: both
    operands' bases and row pitches are 16-byte multiples."""
    x_ok = aligned if x_aligned is None else x_aligned
    if not masked:
        if ger == Ger.I8GER4 and n <= IMMA_STREAM_WIDTHS[-1] and x_ok:
            return imma_stream_plan(m, n, k, b)
        if aligned:
            def cost(c: ImmaTileConfig) -> tuple:
                return (c.waves(m, n, b) * c.bn * IMMA_COLUMN_COST[c.bn],
                        -c.bn)
            return min((ImmaTileConfig(w) for w in IMMA_TILE_WIDTHS[ger]),
                       key=cost)
    return tiles_for(ger)[0]


def imma_takes(cfg, m: int, n: int, k: int, ger: Ger, aligned: bool = True,
               masked: bool = False, x_aligned: bool | None = None) -> bool:
    """Whether a product can run on the IMMA configuration ``cfg``: the
    mma.sync kernel's tile always; the wgmma tile at a compiled width,
    unmasked, TMA-read; the weight stream in I8GER4, unmasked, X TMA-read,
    N within its width and its split within K's stages and shared
    memory."""
    x_ok = aligned if x_aligned is None else x_aligned
    if isinstance(cfg, ImmaTileConfig):
        return (not masked and aligned and cfg.bn in IMMA_TILE_WIDTHS[ger]
                and cfg == ImmaTileConfig(cfg.bn))
    if isinstance(cfg, ImmaStreamConfig):
        return (not masked and x_ok and ger == Ger.I8GER4
                and cfg.bn in IMMA_STREAM_WIDTHS and n <= cfg.bn
                and cfg == ImmaStreamConfig(cfg.bn, cfg.split)
                and 1 <= cfg.split <= -(-k // IMMA_STREAM_BK)
                and cfg.bn * IMMA_STREAM_BK * cfg.slice_stages(k)
                <= IMMA_STREAM_YT)
    return cfg in tiles_for(ger)


def imma_configs(m: int, n: int, k: int, ger: Ger, b: int = 1,
                 aligned: bool = True, x_aligned: bool | None = None
                 ) -> list:
    """The compiled IMMA configurations an unmasked product can take: each
    wgmma tile width (TMA-read operands), the weight stream's plan
    (I8GER4 at N <= 64, X TMA-read) and the mma.sync kernel's tile."""
    x_ok = aligned if x_aligned is None else x_aligned
    out: list = []
    if aligned:
        out += [ImmaTileConfig(w) for w in IMMA_TILE_WIDTHS[ger]]
    if ger == Ger.I8GER4 and n <= IMMA_STREAM_WIDTHS[-1] and x_ok:
        out.append(imma_stream_plan(m, n, k, b))
    return out + list(tiles_for(ger))


# ----------------------------------------------------------------------
# The path of a product (csrc/gemm_stream.cu, gemm_wgmma.cu, mma_gemm.cu)
# ----------------------------------------------------------------------

STREAM_MAX_M = 64            # the weight stream's largest compiled M
STREAM_BK = 32               # K rows per cp.async stage (gemm_stream.cu)
MIN_K = 16                   # one MMA step: below it the WMMA tile runs
BLOCKS_PER_SM = 2            # the weight stream's grid target
# The families each shape-picked kernel is compiled for: the weight stream
# bf16/f16 (tensor cores) and F32GER (CUDA cores), the wgmma tile 16-bit.
WGMMA_GERS = (Ger.BF16GER2, Ger.F16GER2)
STREAM_GERS = WGMMA_GERS + (Ger.F32GER,)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """A weight-stream product: BN weight columns a tile, K cut into
    ``split`` slices (slice s owns stages [s*S/split, (s+1)*S/split) of
    the S = ceil(K / STREAM_BK) stages).  The slices fix the sums' order,
    and so every bit; which block runs which slice does not
    (:meth:`run`)."""
    bn: int
    split: int

    def grid(self, n: int, b: int = 1) -> tuple[int, int, int]:
        """(N tiles, split, batch): the slices of every tile, the
        cp.async kernel's grid (one block a slice)."""
        return (-(-n // self.bn), self.split, b)

    def blocks(self, n: int, b: int = 1) -> int:
        """The TMA kernel's work units (its grid, where the card holds
        them all at once)."""
        return b * -(-n // self.bn) * -(-self.split // self.run(n, b))

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The [k0, k1) rows of each split, in split order."""
        stages = -(-k // STREAM_BK)
        cuts = [s * stages // self.split for s in range(self.split + 1)]
        return [(min(k, a * STREAM_BK), min(k, c * STREAM_BK))
                for a, c in zip(cuts, cuts[1:])]

    def run(self, n: int, b: int = 1) -> int:
        """Slices a work unit of csrc/gemm_stream.cu's TMA kernel: every
        slice of a tile (the unit folds them in registers and writes no
        partial) where b products' tiles alone put BLOCKS_PER_SM units on
        every SM, else the tile's slices cut into as few runs as fill the
        card (one slice a unit at batch 1, the split's own target)."""
        tiles = b * -(-n // self.bn)
        runs = min(self.split, max(1, -(-BLOCKS_PER_SM * NUM_SMS // tiles)))
        return -(-self.split // runs)

    def units(self, n: int, b: int = 1) -> list[tuple[int, int, int, int]]:
        """(product, N tile, first slice, end slice) of each work unit, in
        the kernel's unit order (csrc/gemm_stream.cu's stream_unit)."""
        run, tiles = self.run(n, b), -(-n // self.bn)
        runs = -(-self.split // run)
        return [(u // runs // tiles, u // runs % tiles, u % runs * run,
                 min(self.split, u % runs * run + run))
                for u in range(b * tiles * runs)]

    def partials(self, n: int, b: int = 1) -> bool:
        """Whether the TMA kernel writes split-K partials: where a tile's
        slices span units."""
        return self.run(n, b) < self.split


@dataclasses.dataclass(frozen=True)
class WgmmaConfig:
    """A TMA + wgmma launch: (128, bn) output tiles, one block each."""
    bm: int
    bn: int

    def grid(self, m: int, n: int, b: int = 1) -> tuple[int, int]:
        return (-(-m // self.bm) * -(-n // self.bn), b)

    def tiles(self, m: int, n: int, b: int = 1) -> int:
        gx, gy = self.grid(m, n, b)
        return gx * gy

    def waves(self, m: int, n: int, b: int = 1) -> int:
        """Rounds of the grid on the card: one block an SM (a block's
        ring takes an SM's shared memory)."""
        return -(-self.tiles(m, n, b) // NUM_SMS)

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block of csrc/gemm_wgmma.cu
        (wgmma_tile.cuh's WgCfg::smem): the ring of ``wgmma_stages``
        stages, 1 KB of alignment slack, a full and an empty mbarrier a
        stage."""
        stages = wgmma_stages(self.bn)
        return stages * wgmma_stage_bytes(self.bn) + 1024 + 2 * stages * 8


def stream_plan(m: int, n: int, k: int, b: int = 1,
                in_bytes: int = 2) -> StreamConfig:
    """Fill the card with at least BLOCKS_PER_SM blocks an SM and as few
    K splits as that allows (each split costs a partial's write and read,
    which must stay below the weight's own bytes, ``in_bytes`` an element:
    2 for bf16/f16, 4 for F32GER, whose ceiling at a given row count is
    twice as high): 128-column tiles where they alone fill it, else
    64-column tiles with K split: within 4% of the fastest tile and split
    that scripts/port_kernel_times.py sweeps at decode's products on the
    H100 (PERF.md).

    The split is one product's: b does not enter it, and a batch of
    products fills the card through the units of :meth:`StreamConfig.run`
    instead (the split they fold in registers gives the same bits); b
    only widens a 16-bit tile where its 128-column tiles alone fill the
    card, which moves no bit either (a column's sum does not see the
    tile).
    For the 16-bit families M enters only through the kernel's row bucket
    (1-8, 9-16, 17-32, 33-64 rows) and b not in the split, so a row's result is
    the same at batch 1 as at batch 4, in both the 2-D and the batched
    products (mamba2's exact per-slot prefill handoff, chip_smoke.py,
    relies on it).  For F32GER M does not enter at all: its ceiling is
    reckoned at the top bucket (64 rows), so a row is summed in one order
    at every M <= 64 (the tight-parity config's gradient accumulation over
    microbatches of 32 rows then matches one batch of 64 to fp32
    rounding: tests/test_torch_train.py)."""
    want = BLOCKS_PER_SM * NUM_SMS
    if -(-n // 128) >= want:
        return StreamConfig(bn=128, split=1)
    if b > 1 and in_bytes == 2 and b * -(-n // 128) >= want:
        # a 16-bit batch whose 128-column tiles fill the card alone (the
        # expert banks): one product's split, on the wider tile (the same
        # k slices, so the same bits; half the units, each streaming
        # whole 256-byte runs of a weight row)
        return StreamConfig(bn=128, split=stream_plan(m, n, k, 1,
                                                      in_bytes).split)
    tiles = -(-n // 64)
    stages = -(-k // STREAM_BK)
    # fp32 partials: 8 * split * M * N bytes against the weight's
    # in_bytes * K * N
    rows = row_bucket(m) if in_bytes == 2 else STREAM_MAX_M
    most = max(1, min(stages, k * in_bytes // (8 * rows)))
    return StreamConfig(bn=64, split=max(1, min(most, -(-want // tiles))))


# csrc/gemm_stream.cu's TMA kernel (StreamTmaCfg): blocks an SM by tile
# and row bucket (what the instance's registers allow at 160 threads), and
# a ring that fills the rest of a block's share of the SM's shared memory
# (SM_SMEM, less 2 KB of reserve and slack, the fp32 tile and the
# barriers), at most STREAM_TMA_MAX_STAGES stages; a stage is BN / 64 (32
# x 64) weight boxes and a (rows x 32) X box, in 1 KB units (the 128-byte
# swizzle's alignment).
SM_SMEM = 233_472
STREAM_TMA_MAX_STAGES = 16


def stream_tma_blocks_per_sm(bn: int, rows: int) -> int:
    """Blocks an SM runs of the TMA stream's (bn, row bucket) instance
    (StreamTmaCfg::OCC)."""
    if bn == 64 and rows == 8:
        return 4
    return 2 if bn == 128 and rows == 64 else 3


def stream_tma_stage_bytes(bn: int, rows: int) -> int:
    """A stage of the TMA stream's ring at row bucket ``rows``."""
    return -(-(bn // 64 * STREAM_BK * 128 + rows * STREAM_BK * 2) // 1024) \
        * 1024


def stream_tma_stages(bn: int, rows: int) -> int:
    """The TMA stream's ring depth (StreamTmaCfg::STAGES)."""
    share = SM_SMEM // stream_tma_blocks_per_sm(bn, rows)
    fit = (share - 2048 - rows * (bn + _PAD32) * 4
           - 2 * STREAM_TMA_MAX_STAGES * 8) // stream_tma_stage_bytes(bn, rows)
    return min(STREAM_TMA_MAX_STAGES, fit)


def stream_tma_smem_bytes(bn: int, rows: int) -> int:
    """Dynamic shared memory of a TMA stream block (StreamTmaCfg::smem):
    the ring, the (rows, bn + 4) fp32 tile, a full and an empty mbarrier
    a stage, 1 KB of alignment slack."""
    stages = stream_tma_stages(bn, rows)
    return (stages * stream_tma_stage_bytes(bn, rows)
            + rows * (bn + _PAD32) * 4 + 2 * stages * 8 + 1024)


def row_bucket(m: int) -> int:
    """The weight stream's row bucket of M <= 64 (the kernel is compiled
    for 8, 16, 32 and 64 rows): a row's sum runs in the same order for
    every M in one bucket."""
    return next(r for r in (8, 16, 32, STREAM_MAX_M) if m <= r)


WGMMA_BK = 64                 # K step of the wgmma tile
WGMMA_MAX_STAGES = 8          # csrc/wgmma_tile.cuh's WG_MAX_STAGES


def wgmma_stage_bytes(bn: int) -> int:
    """A ring stage: a (128 x 64) X box and a (64 x bn) Y box, 16-bit."""
    return (128 * WGMMA_BK + WGMMA_BK * bn) * 2


def wgmma_stages(bn: int) -> int:
    """The wgmma ring's depth (wgmma_tile.cuh's WgCfg::STAGES): as many
    stages as a block's shared memory holds beside 1 KB of alignment
    slack, 1 KB of K3's row offsets and 16 bytes of mbarriers a stage, at
    most ``WGMMA_MAX_STAGES``."""
    fit = (SMEM_PER_BLOCK - 2048) // (wgmma_stage_bytes(bn) + 16)
    return min(fit, WGMMA_MAX_STAGES)


# The tiles csrc/gemm_wgmma.cu is compiled for, widest first; K3's wgmma
# conv (csrc/mma_conv.cu's launch_conv_wgmma_t) is compiled for the same.
WGMMA_TILES = tuple(WgmmaConfig(128, bn) for bn in (256, 192, 128, 64))
CONV_WGMMA_TILES = WGMMA_TILES


# The wgmma plan's cost model, from scripts/gemm_path_times.py --tiles on
# the H100 (PERF.md, run X17): a wave of tiles costs its columns times
# WGMMA_COLUMN_COST, relative to the 256-column tile's (the narrower
# tiles issue smaller wgmmas a K step and read each X box more often; a
# wave's time over its columns, at 1024 x 4096 x 11008, 2048 x 4096 x
# 4096, 4096 x 2048 x 4096 and 6000 x 768 x 3072, came out 1.02-1.08 at
# 192 columns, 1.20-1.25 at 128 and 1.66-1.94 at 64: the means).
WGMMA_COLUMN_COST = {256: 1.0, 192: 1.05, 128: 1.2, 64: 1.8}


def wgmma_plan(m: int, n: int, k: int, b: int = 1) -> WgmmaConfig:
    """The tile whose grid costs least by the model above: waves x bn x
    WGMMA_COLUMN_COST; the widest among equals.  K does not shape the
    grid (every tile walks all of it).  At deepseek-7b's prefill (M =
    256) the 128-column tile left 68 of 132 SMs idle at N = 4096: the
    64-column tile puts 128 tiles on the card there, and at N = 11008
    the 192-column tile 116 (one wave, where 128 columns took two).  A
    pure function of (m, n, k, b)."""
    del k

    def cost(c: WgmmaConfig) -> tuple:
        return (c.waves(m, n, b) * c.bn * WGMMA_COLUMN_COST[c.bn], -c.bn)

    return min(WGMMA_TILES, key=cost)


# K3's wgmma conv's cost model: a wave of tiles costs its columns times
# CONV_WGMMA_COLUMN_COST, relative to the 256-column tile's, fitted to
# scripts/gemm_path_times.py --tiles at whisper-small's conv1 and conv2
# and qwen2-vl-7b's patch embed on the H100 (PERF.md, run Q1: a wave's
# time over its columns came out 1.12-1.53 at 128 columns, 1.13-1.33 at
# 192 -- whose 5-stage ring starves the conv's producer at conv2 -- and
# 1.49-2.66 at 64).  These values pick the fastest tile at all three.
CONV_WGMMA_COLUMN_COST = {256: 1.0, 192: 1.25, 128: 1.2, 64: 1.8}


def conv_wgmma_plan(m: int, f: int) -> WgmmaConfig:
    """K3's wgmma conv (one block a tile), planned by waves as
    :func:`wgmma_plan` plans K1's tile: the tile whose grid costs least
    in waves x bn x ``CONV_WGMMA_COLUMN_COST``; the widest among equals.
    At whisper-small's conv2 (M = 6000, F = 768) that is still the
    128-column tile (282 tiles, 2.14 waves), at conv1 the 192-column one
    (376 tiles, 2.85 waves), at qwen2-vl-7b's patch embed the 256-column
    one (448 tiles, 3.4 waves)."""
    def cost(c: WgmmaConfig) -> tuple:
        return (c.waves(m, f) * c.bn * CONV_WGMMA_COLUMN_COST[c.bn], -c.bn)

    return min(CONV_WGMMA_TILES, key=cost)


@functools.lru_cache(maxsize=4096)
def choose_gemm_path(m: int, n: int, k: int, ger: Ger, b: int = 1,
                     aligned: bool = True,
                     block: tuple[int, int, int] | None = None,
                     masked: bool = False, tuned: tuple | None = None,
                     x_aligned: bool | None = None):
    """("stream" | "wgmma" | "wmma" | "imma" | "dmma", config) for one
    product.

    ``tuned`` is an autotune winner, a (path, config) pair as this
    function returns them: it is the call's path where the call can take
    it (:func:`takes`), else the heuristic below decides (an explicit
    ``block`` is resolved before any winner, and wins).

    The integer families go to the IMMA kernel in the form
    :func:`imma_plan` picks (``x_aligned``: X alone is TMA-read, which
    I8GER4's weight stream needs; None: as ``aligned``), or on the
    mma.sync kernel's tile an explicit ``block`` names, and F64GER to the
    DMMA kernel on the tile
    :func:`choose_blocks` picks (an explicit ``block`` must name a
    compiled tile; both DMMA tiles sum each output in the same order, so
    the choice never changes a bit).  For the others: ``aligned``: both
    operands'
    bases and row pitches are 16-byte multiples (TMA's rule); ``block`` an
    explicit ``Plan.block``, which names a WMMA tile.  The weight stream
    takes any pitch (a scalar path covers unaligned rows); the wgmma tile
    only aligned ones.

    F32GER takes the weight stream at M <= 64 and the fp32 tile (the
    "wmma" path's F32GER tiles) above: it never runs on the tensor cores.

    ``masked`` (the pm* forms, K1b) is a static route by op-class: a
    masked 16-bit or fp32 product takes the WMMA tile
    (``csrc/mma_gemm.cu``, whose panel loaders apply the predicates) at
    every M, the integer families IMMA and F64GER DMMA as above.  The
    weight stream and the wgmma tile take no predicates."""
    if tuned is not None and block is None and takes(
            tuned, m, n, k, ger, aligned, masked, x_aligned):
        return tuned
    if ger in IMMA_GERS:
        return "imma", (check_block(block, ger) if block is not None
                        else imma_plan(m, n, k, ger, b, aligned, masked,
                                       x_aligned))
    if ger == Ger.F64GER:
        return "dmma", (check_block(block, ger) if block is not None
                        else choose_blocks(m, n, k, ger, b))
    if block is not None:
        return "wmma", check_block(block, ger)
    if masked:
        return "wmma", choose_blocks(m, n, k, ger, b)
    if ger in STREAM_GERS and k >= MIN_K:
        if m <= STREAM_MAX_M:
            return "stream", stream_plan(m, n, k, b,
                                         precision.policy(ger).in_bytes)
        if aligned and ger in WGMMA_GERS:
            return "wgmma", wgmma_plan(m, n, k, b)
    return "wmma", choose_blocks(m, n, k, ger, b)


def takes(tuned: tuple, m: int, n: int, k: int, ger: Ger,
          aligned: bool = True, masked: bool = False,
          x_aligned: bool | None = None) -> bool:
    """Whether a product can run on the winner ``tuned`` = (path,
    config): a configuration the path's kernel is compiled for, on the
    operands' family, pitches and predicates."""
    path, cfg = tuned
    if ger in IMMA_GERS:
        return path == "imma" and imma_takes(cfg, m, n, k, ger, aligned,
                                             masked, x_aligned)
    if ger == Ger.F64GER:
        return path == "dmma" and cfg in tiles_for(ger)
    if path == "wmma":
        return cfg in tiles_for(ger)
    if masked or ger not in STREAM_GERS or k < MIN_K:
        return False
    if path == "stream":
        return (m <= STREAM_MAX_M and isinstance(cfg, StreamConfig)
                and cfg.bn in (64, 128)
                and 1 <= cfg.split <= -(-k // STREAM_BK))
    return (path == "wgmma" and ger in WGMMA_GERS and m > STREAM_MAX_M
            and aligned and cfg in WGMMA_TILES)


def tile16_row_shift(base: int, pitch: int, row: int) -> int:
    """How csrc/tile_gemm.cuh's 16-bit tile copies row ``row`` of a
    natural operand at byte address ``base`` with a row pitch of ``pitch``
    bytes, row by row: 0, in 16-byte cp.async copies as it lies; else the
    16-byte aligned words that cover the row are copied whole and shifted
    by this many bytes once they land (seven rows in eight of whisper's
    51865-column logits, a pitch of 103730 bytes).  A pitch of a multiple
    of 16 keeps every row at the base's shift."""
    return (base + row * pitch) % 16


def check_block(block: tuple[int, int, int], ger: Ger) -> BlockConfig:
    """An explicit ``Plan.block`` must be a tile the kernel was built for."""
    cfg = BlockConfig(*block)
    if cfg not in tiles_for(ger):
        raise ValueError(
            f"block {tuple(block)} is not a compiled {ger.value} tile; "
            f"have {GEMM_TILES[ger]}")
    return cfg


# ----------------------------------------------------------------------
# The convolutions (csrc/mma_conv.cu): K3's path, K4's launch plan
# ----------------------------------------------------------------------

# The tiles K3's WMMA and F32GER kernels are compiled for, (bm, bf, bk),
# largest first; an explicit Plan.block names one by its filter tile bf.
# F32GER's are K1's fp32 SIMT tiles (csrc/tile_gemm.cuh's f32_simt_tile).
CONV_TILES: dict[Ger, tuple[BlockConfig, ...]] = {
    Ger.BF16GER2: (BlockConfig(64, 128, 32),),
    Ger.F16GER2: (BlockConfig(64, 128, 32),),
    Ger.F32GER: tuple(BlockConfig(*t) for t in GEMM_TILES[Ger.F32GER]),
}


# K3's fp32 tiles on the H100: the blocks an SM holds (ptxas: the 128 x
# 128 tile's 128 registers a thread allow two, the 64 x 64 tile's 77-79
# three) and each tile's output rate an SM relative to the large tile's
# (the small one streams twice the panel bytes an output): the mean of
# its fits to scripts/gemm_path_times.py --tiles at whisper-small's conv1
# and conv2 (natural and packed) and qwen2-vl-7b's patch embed, 0.60 to
# 0.75 (PERF.md, run X17).  Any value in that range picks the faster
# tile at all three.
F32_CONV_BLOCKS = {128: 2, 64: 3}
F32_CONV_RATE = {128: 1.0, 64: 0.68}


def f32_conv_tile(m: int, f: int) -> BlockConfig:
    """F32GER's conv tile for an M x F implicit GEMM, wave by wave: the
    tile whose grid costs least in waves (``F32_CONV_BLOCKS`` blocks on
    each SM) x the outputs a wave puts on an SM / its rate; the larger
    among equals.  Whisper-small's conv2 (M = 6000, F = 768) runs 282
    large tiles, two waves of which the second is 7% full: there the
    small tile's three waves cost less."""
    def cost(c: BlockConfig) -> tuple:
        per = F32_CONV_BLOCKS[c.bm]
        gx, gy, _ = c.grid(m, f, 1)
        waves = -(-(gx * gy) // (NUM_SMS * per))
        return waves * per * c.bm * c.bn / F32_CONV_RATE[c.bm], -c.bm

    return min(CONV_TILES[Ger.F32GER], key=cost)


def conv_smem_bytes(cfg: BlockConfig, pol: precision.GerPolicy) -> int:
    """Dynamic shared memory of one block of K3's WMMA or fp32 tile: the
    GEMM tile's (:meth:`BlockConfig.smem_bytes`) and the tile rows' pixel
    offsets after it, 8 bytes a row (csrc/mma_conv.cu's
    conv_wmma_smem_bytes, conv_f32_smem_bytes)."""
    return cfg.smem_bytes(pol) + cfg.bm * 8


def conv_gather_bytes(c: int, kw: int, w: int, sw: int, base: int) -> int:
    """The widest copy that gathers K3's image panel, as csrc/mma_conv.cu
    picks it: 16 bytes where the channel vector of 8 divides C at a
    16-byte ``base`` (every 8-column chunk of a patch row then lies in one
    pixel), 4-byte pairs where every (j, c) run, row pitch and pixel step
    is even at a 4-byte base (qwen2-vl's C = 3), else 0: no copy the wgmma
    producer makes."""
    if c % 8 == 0 and base % 16 == 0:
        return 16
    if (kw * c) % 2 == 0 and (w * c) % 2 == 0 and (sw * c) % 2 == 0 \
            and base % 4 == 0:
        return 4
    return 0


@functools.lru_cache(maxsize=1024)
def choose_conv_path(m: int, f: int, ger: Ger, aligned: bool = True,
                     gathered: bool = True, bf: int | None = None,
                     tuned: tuple | None = None):
    """("wgmma" | "wmma" | "f32", config) for one dense conv, the implicit
    GEMM of M = N*OH*OW output pixels by F filters.

    F32GER stays on true fp32 FMAs (never TF32), on the fp32 SIMT tile
    :func:`f32_conv_tile` picks (both tiles sum each output in the same
    order).  bf16/f16 take the
    wgmma kernel where TMA can read the (K, F) filter view (``aligned``:
    F % 8 == 0 and a 16-byte filter base) and its producer can gather the
    image panel in 16- or 4-byte copies (``gathered``: see
    ``conv_gather_bytes``); its tile follows ``conv_wgmma_plan``.  K does
    not choose: every kernel runs the whole K loop in the block.  An explicit
    filter tile ``bf`` names the WMMA tile (F32GER: the fp32 tile), as an
    explicit block does for the GEMM; it must be a compiled one
    (ValueError otherwise).
    ``tuned`` is a GEMM winner's filter tile as K3 has it
    (:func:`conv_tuned`), taken where the conv can take it, else the
    heuristic decides."""
    if ger not in CONV_TILES:
        raise NotImplementedError(f"the conv kernel has no {ger.value} "
                                  f"instantiation")
    tiles = CONV_TILES[ger]
    if bf is not None and bf not in [t.bn for t in tiles]:
        raise ValueError(f"the conv kernel is compiled for the filter "
                         f"tiles {[t.bn for t in tiles]} in {ger.value}, "
                         f"not bf={bf}")
    if ger == Ger.F32GER:
        return "f32", (next(t for t in tiles if t.bn == bf) if bf
                       else f32_conv_tile(m, f))
    if bf is None and tuned is not None and (
            tuned[0] == "wmma" or (aligned and gathered)):
        return tuned
    if bf is None and aligned and gathered:
        return "wgmma", conv_wgmma_plan(m, f)
    return "wmma", tiles[0]


def conv_tuned(winner: tuple, ger: Ger) -> tuple | None:
    """K3's counterpart of a GEMM winner at (OW, F, KW*C), as the
    reference applies one (only the winner's N tile, the filter tile):
    a wgmma tile where K3's wgmma kernel has its width, the WMMA filter
    tile where the winner's N tile is K3's, else None (K3 has no such
    tile: the heuristic runs, as with no winner).  F32GER's fp32 tile
    follows the shape rule alone."""
    if ger not in CONV_TILES or ger == Ger.F32GER:
        return None
    path, cfg = winner
    if path == "wgmma" and cfg in CONV_WGMMA_TILES:
        return winner
    if path == "wmma" and cfg.bn == CONV_TILES[ger][0].bn:
        return "wmma", CONV_TILES[ger][0]
    return None


@functools.lru_cache(maxsize=1024)
def depthwise_plan(c: int, dtype, aligned: bool = True) -> int:
    """K4's path as the channels a thread owns: 16 bytes of them (4 f32,
    8 bf16/f16; the vector path, whose warp reads 512 contiguous bytes)
    where that vector divides C and the image and taps have 16-byte bases
    (``aligned``), else 0 (the scalar path, one output element a
    thread).  Either way a thread owns one output pixel, and
    csrc/mma_conv.cu fixes the block at 64 threads."""
    vec = 16 // dtype.itemsize
    return vec if aligned and c % vec == 0 else 0
