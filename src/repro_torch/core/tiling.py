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
    int8 tensor cores (IMMA m16n8k32), one fixed tile a family;
  * "dmma" (``csrc/gemm_dmma.cu``): F64GER on the fp64 tensor cores
    (DMMA m16n8k8, m16n8k4 on X panels, from a ``DMMA_STAGES``-deep
    cp.async ring on mbarriers), on a 128 x 128 or a 64 x 64 tile picked
    by :func:`choose_blocks`.

The 16-bit and fp32 families take one of three, picked by shape:

  * "stream" (``csrc/gemm_stream.cu``): M <= 64 rows (decode, the SSD's
    M = 1 products), bound by the weight's bytes; the (K, N) weight is
    streamed once through a cp.async ring, split over K so that the grid
    holds two blocks per SM (:func:`stream_plan`); bf16/f16 on the tensor
    cores, F32GER on the CUDA cores (true fp32 FMAs);
  * "wgmma" (``csrc/gemm_wgmma.cu``): larger 16-bit M (prefill), bound by
    the tensor cores; a (128, 128 or 256) tile fed by TMA, which needs
    16-byte pitches (K and N multiples of 8) and bases;
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
    """A weight-stream launch: BN weight columns a block, K split over
    ``split`` blocks (split s owns stages [s*S/split, (s+1)*S/split) of
    the S = ceil(K / STREAM_BK) stages)."""
    bn: int
    split: int

    def grid(self, n: int, b: int = 1) -> tuple[int, int, int]:
        return (-(-n // self.bn), self.split, b)

    def blocks(self, n: int, b: int = 1) -> int:
        gx, gy, gz = self.grid(n, b)
        return gx * gy * gz

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The [k0, k1) rows of each split, in split order."""
        stages = -(-k // STREAM_BK)
        cuts = [s * stages // self.split for s in range(self.split + 1)]
        return [(min(k, a * STREAM_BK), min(k, c * STREAM_BK))
                for a, c in zip(cuts, cuts[1:])]


@dataclasses.dataclass(frozen=True)
class WgmmaConfig:
    """A TMA + wgmma launch: (128, bn) output tiles."""
    bm: int
    bn: int

    def grid(self, m: int, n: int, b: int = 1) -> tuple[int, int]:
        return (-(-m // self.bm) * -(-n // self.bn), b)


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

    The plan is one product's: a batch of products runs b times its grid.
    For the 16-bit families M enters only through the kernel's row bucket
    (1-8, 9-16, 17-32, 33-64 rows) and b not at all, so a row's result is
    the same at batch 1 as at batch 4, in both the 2-D and the batched
    products (mamba2's exact per-slot prefill handoff, chip_smoke.py,
    relies on it).  For F32GER M does not enter at all: its ceiling is
    reckoned at the top bucket (64 rows), so a row is summed in one order
    at every M <= 64 (the tight-parity config's gradient accumulation over
    microbatches of 32 rows then matches one batch of 64 to fp32
    rounding: tests/test_torch_train.py)."""
    del b
    want = BLOCKS_PER_SM * NUM_SMS
    if -(-n // 128) >= want:
        return StreamConfig(bn=128, split=1)
    tiles = -(-n // 64)
    stages = -(-k // STREAM_BK)
    # fp32 partials: 8 * split * M * N bytes against the weight's
    # in_bytes * K * N
    rows = row_bucket(m) if in_bytes == 2 else STREAM_MAX_M
    most = max(1, min(stages, k * in_bytes // (8 * rows)))
    return StreamConfig(bn=64, split=max(1, min(most, -(-want // tiles))))


def row_bucket(m: int) -> int:
    """The weight stream's row bucket of M <= 64 (the kernel is compiled
    for 8, 16, 32 and 64 rows): a row's sum runs in the same order for
    every M in one bucket."""
    return next(r for r in (8, 16, 32, STREAM_MAX_M) if m <= r)


# The tiles csrc/gemm_wgmma.cu is compiled for.
WGMMA_TILES = (WgmmaConfig(128, 128), WgmmaConfig(128, 256))


def wgmma_plan(m: int, n: int, b: int = 1) -> WgmmaConfig:
    """The 256-column tile reuses each X box twice as often; it is taken
    where its grid runs three or more waves on the card, so that the last,
    partial wave costs little; else the 128-column tile."""
    wide = WgmmaConfig(128, 256)
    gx, gy = wide.grid(m, n, b)
    return wide if gx * gy >= 3 * NUM_SMS else WgmmaConfig(128, 128)


@functools.lru_cache(maxsize=4096)
def choose_gemm_path(m: int, n: int, k: int, ger: Ger, b: int = 1,
                     aligned: bool = True,
                     block: tuple[int, int, int] | None = None,
                     masked: bool = False, tuned: tuple | None = None):
    """("stream" | "wgmma" | "wmma" | "imma" | "dmma", config) for one
    product.

    ``tuned`` is an autotune winner, a (path, config) pair as this
    function returns them: it is the call's path where the call can take
    it (:func:`takes`), else the heuristic below decides (an explicit
    ``block`` is resolved before any winner, and wins).

    The integer families go to the IMMA kernel, whatever the shape, on
    their one compiled tile, and F64GER to the DMMA kernel on the tile
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
            tuned, m, n, k, ger, aligned, masked):
        return tuned
    if ger in IMMA_GERS:
        return "imma", (check_block(block, ger) if block is not None
                        else tiles_for(ger)[0])
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
            return "wgmma", wgmma_plan(m, n, b)
    return "wmma", choose_blocks(m, n, k, ger, b)


def takes(tuned: tuple, m: int, n: int, k: int, ger: Ger,
          aligned: bool = True, masked: bool = False) -> bool:
    """Whether a product can run on the winner ``tuned`` = (path,
    config): a configuration the path's kernel is compiled for, on the
    operands' family, pitches and predicates."""
    path, cfg = tuned
    if ger in IMMA_GERS or ger == Ger.F64GER:
        return (path == ("imma" if ger in IMMA_GERS else "dmma")
                and cfg in tiles_for(ger))
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

# The tiles K3's WMMA and F32GER kernels are compiled for, (bm, bf, bk);
# an explicit Plan.block names one by its filter tile bf.
CONV_TILES: dict[Ger, BlockConfig] = {
    Ger.BF16GER2: BlockConfig(64, 128, 32),
    Ger.F16GER2: BlockConfig(64, 128, 32),
    Ger.F32GER: BlockConfig(64, 64, 16),
}


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

    F32GER stays on true fp32 FMAs (never TF32).  bf16/f16 take the
    wgmma kernel where TMA can read the (K, F) filter view (``aligned``:
    F % 8 == 0 and a 16-byte filter base) and its producer can gather the
    image panel in 16- or 4-byte copies (``gathered``: see
    ``conv_gather_bytes``); its tile follows ``wgmma_plan``.  K does not
    choose: every kernel runs the whole K loop in the block.  An explicit
    filter tile ``bf`` names the WMMA tile, as an explicit block does for
    the GEMM; it must be the compiled one (ValueError otherwise).
    ``tuned`` is a GEMM winner's filter tile as K3 has it
    (:func:`conv_tuned`), taken where the conv can take it, else the
    heuristic decides."""
    if ger not in CONV_TILES:
        raise NotImplementedError(f"the conv kernel has no {ger.value} "
                                  f"instantiation")
    tile = CONV_TILES[ger]
    if bf is not None and bf != tile.bn:
        raise ValueError(f"the conv kernel is compiled for the filter tile "
                         f"{tile.bn} in {ger.value}, not bf={bf}")
    if ger == Ger.F32GER:
        return "f32", tile
    if bf is None and tuned is not None and (
            tuned[0] == "wmma" or (aligned and gathered)):
        return tuned
    if bf is None and aligned and gathered:
        return "wgmma", wgmma_plan(m, f)
    return "wmma", tile


def conv_tuned(winner: tuple, ger: Ger) -> tuple | None:
    """K3's counterpart of a GEMM winner at (OW, F, KW*C), as the
    reference applies one (only the winner's N tile, the filter tile):
    a wgmma tile where K3's wgmma kernel has its width, the WMMA filter
    tile where the winner's N tile is K3's, else None (K3 has no such
    tile: the heuristic runs, as with no winner).  F32GER's one fp32
    tile takes no choice."""
    if ger not in CONV_TILES or ger == Ger.F32GER:
        return None
    path, cfg = winner
    if path == "wgmma" and cfg in WGMMA_TILES:
        return winner
    if path == "wmma" and cfg.bn == CONV_TILES[ger].bn:
        return "wmma", CONV_TILES[ger]
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
