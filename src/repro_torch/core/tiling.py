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

The GEMM has three kernels, and :func:`choose_gemm_path` picks one by
shape:

  * "stream" (``csrc/gemm_stream.cu``): M <= 64 rows (decode, the SSD's
    M = 1 products), bound by the weight's bytes; the (K, N) weight is
    streamed once through a cp.async ring, split over K so that the grid
    holds two blocks per SM (:func:`stream_plan`);
  * "wgmma" (``csrc/gemm_wgmma.cu``): larger M (prefill), bound by the
    tensor cores; a (128, 128 or 256) tile fed by TMA, which needs 16-byte
    pitches (K and N multiples of 8) and bases;
  * "wmma" (``csrc/mma_gemm.cu``): what the two do not take -- unaligned
    pitches at large M, K below one MMA step (the SSD's K = 1 outer
    product), F32GER (true fp32) and an explicit ``Plan.block`` -- on the
    fixed set of tiles in ``GEMM_TILES``; ``choose_blocks`` picks among
    exactly those, and a block the kernel was not compiled for raises.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import precision

Ger = precision.Ger

SMEM_PER_BLOCK = 232_448     # bytes a block may opt in to (227 KB)
NUM_SMS = 132                # H100 SXM streaming multiprocessors

# Row padding (in elements) of the shared-memory tiles, as in csrc/: 16-bit
# panels pad by 8 (keeps WMMA's 32-byte fragment alignment), fp32 by 4.
_PAD16, _PAD32 = 8, 4

# The tile shapes csrc/mma_gemm.cu instantiates, largest first.
GEMM_TILES: dict[Ger, tuple[tuple[int, int, int], ...]] = {
    Ger.BF16GER2: ((128, 128, 32), (64, 64, 64)),
    Ger.F16GER2: ((128, 128, 32), (64, 64, 64)),
    Ger.F32GER: ((64, 64, 16),),
}


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    bm: int
    bn: int
    bk: int

    def grid(self, m: int, n: int, b: int = 1) -> tuple[int, int, int]:
        """CUDA grid (n tiles, m tiles, batch) of one launch."""
        return (-(-n // self.bn), -(-m // self.bm), b)

    def smem_bytes(self, pol: precision.GerPolicy) -> int:
        """Dynamic shared memory of one block: the panel pair, or the fp32
        output tile that aliases it, whichever is larger."""
        c_tile = self.bm * (self.bn + _PAD32) * 4
        if pol.in_bytes == 2:
            panels = (self.bm * (self.bk + _PAD16)
                      + self.bk * (self.bn + _PAD16)) * 2
        else:  # fp32: the X panel is stored k-major
            panels = (self.bk * (self.bm + _PAD32)
                      + self.bk * (self.bn + _PAD32)) * 4
        return max(c_tile, panels)


def tiles_for(ger: Ger) -> tuple[BlockConfig, ...]:
    if ger not in GEMM_TILES:
        raise NotImplementedError(
            f"the GEMM kernel has no {ger.value} instantiation "
            f"(ROADMAP queue 2, K1c/K1f)")
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


def stream_plan(m: int, n: int, k: int, b: int = 1) -> StreamConfig:
    """Fill the card with at least BLOCKS_PER_SM blocks an SM and as few
    K splits as that allows (each split costs a partial's write and read,
    which must stay below the weight's own bytes): 128-column tiles where
    they alone fill it, else 64-column tiles with K split: within 4% of
    the fastest tile and split that scripts/port_kernel_times.py sweeps
    at decode's products on the H100 (PERF.md).

    The plan is one product's: a batch of products runs b times its grid.
    M enters only through the kernel's row bucket (1-8, 9-16, 17-32,
    33-64 rows) and b not at all, so a row's result is the same at batch
    1 as at batch 4, in both the 2-D and the batched products (mamba2's
    exact per-slot prefill handoff, chip_smoke.py, relies on it)."""
    del b
    want = BLOCKS_PER_SM * NUM_SMS
    if -(-n // 128) >= want:
        return StreamConfig(bn=128, split=1)
    tiles = -(-n // 64)
    stages = -(-k // STREAM_BK)
    # fp32 partials: 8 * split * M * N bytes against the weight's 2 * K * N
    bucket = next(r for r in (8, 16, 32, STREAM_MAX_M) if m <= r)
    most = max(1, min(stages, k // (4 * bucket)))
    return StreamConfig(bn=64, split=max(1, min(most, -(-want // tiles))))


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
                     block: tuple[int, int, int] | None = None):
    """("stream" | "wgmma" | "wmma", config) for one product.

    ``aligned``: both operands' bases and row pitches are 16-byte
    multiples (TMA's rule); ``block`` an explicit ``Plan.block``, which
    names a WMMA tile.  The weight stream takes any pitch (a scalar path
    covers unaligned rows); the wgmma tile only aligned ones."""
    if block is not None:
        return "wmma", check_block(block, ger)
    if ger in (Ger.BF16GER2, Ger.F16GER2) and k >= MIN_K:
        if m <= STREAM_MAX_M:
            return "stream", stream_plan(m, n, k, b)
        if aligned:
            return "wgmma", wgmma_plan(m, n, b)
    return "wmma", choose_blocks(m, n, k, ger, b)


def check_block(block: tuple[int, int, int], ger: Ger) -> BlockConfig:
    """An explicit ``Plan.block`` must be a tile the kernel was built for."""
    cfg = BlockConfig(*block)
    if cfg not in tiles_for(ger):
        raise ValueError(
            f"block {tuple(block)} is not a compiled {ger.value} tile; "
            f"have {GEMM_TILES[ger]}")
    return cfg
