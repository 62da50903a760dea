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

The CUDA kernel (``csrc/mma_gemm.cu``) is compiled for a fixed set of tile
shapes per family; ``choose_blocks`` picks among exactly those, and a block
the kernel was not compiled for raises.
"""

from __future__ import annotations

import dataclasses

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


def check_block(block: tuple[int, int, int], ger: Ger) -> BlockConfig:
    """An explicit ``Plan.block`` must be a tile the kernel was built for."""
    cfg = BlockConfig(*block)
    if cfg not in tiles_for(ger):
        raise ValueError(
            f"block {tuple(block)} is not a compiled {ger.value} tile; "
            f"have {GEMM_TILES[ger]}")
    return cfg
