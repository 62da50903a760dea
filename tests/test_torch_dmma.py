"""F64GER's DMMA kernel (``csrc/gemm_dmma.cu``) on its two compiled tiles,
on the CPU: the Python side that mirrors the kernel, against the JAX
reference where the reference has a counterpart.

  * the tile choice: ``tiling.choose_blocks``' wave rule picks the 128 x
    128 tile where its grid puts a block on every SM, else the 64 x 64
    one; an explicit block and a planted autotune winner still win;
  * ``BlockConfig.smem_bytes`` against the kernel's ring and deprime tile,
    read from the source's own constants;
  * the ABFT sidecar's bands at each tile, reduced, against the
    reference kernel's (interpret mode, ``jax.enable_x64``);
  * ``contract`` in F64GER at the fringes a 128 tile adds (M = 129, N =
    130, K = 17, batched) against the reference's kernel and xla lowering;
  * the roofline prior and the autotune candidates of both tiles.

On the CPU the wrapper runs the plain version of the path it picks, so
these tests hold what the CPU can show: the choice, the shapes, the
sidecar's bands and the arithmetic.  The kernel itself is held against
its plain version on the card (``tests/test_torch_cuda.py``,
``test_dmma_redesign_forms``).  Tolerances: F64GER within rtol = atol =
1e-12 of the reference (fp64 sums in another order); the sidecar's sums
within ABFT's own bound (``abft.ATOL + abft.FACTOR * eps * sum|x||y|``).
"""

from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import facility as jfac
from repro.core.precision import Ger as JGer
from repro.kernels import mma_gemm as jgemm
from repro_torch.core import abft, autotune, tiling
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.roofline import analysis as roofline
from test_torch_families import x64

Ger = tprec.Ger
F64 = Ger.F64GER
LARGE, SMALL = tiling.tiles_for(F64)
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "csrc" / "gemm_dmma.cu")
CPU = tfac.FacilityConfig(device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _block(cfg):
    return (cfg.bm, cfg.bn, cfg.bk)


@pytest.fixture(autouse=True)
def _hermetic_cache(tmp_path, monkeypatch):
    """Every test dispatches against a fresh temporary autotune cache."""
    cache = autotune.AutotuneCache(tmp_path / "default.json")
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", cache)
    yield cache


# ----------------------------------------------------------------------
# the tile choice
# ----------------------------------------------------------------------

# (M, N, K, batch, the tile): the 128 x 128 tile where its grid holds a
# block for each of the 132 SMs, else the 64 x 64 one
WAVE_CASES = [
    ((2048, 2048, 2048, 1), LARGE),      # 16 x 16 = 256 blocks
    ((8192, 8192, 8192, 1), LARGE),
    ((1536, 1536, 64, 1), LARGE),        # 12 x 12 = 144
    ((1408, 1408, 64, 1), SMALL),        # 11 x 11 = 121
    ((4, 11008, 4096, 1), SMALL),        # 86 large blocks, 172 small
    ((1000, 1001, 999, 1), SMALL),       # 8 x 8 = 64
    ((1024, 128, 1024, 64), LARGE),      # the dft's stacks: 8 x 1 x 64
    ((129, 130, 17, 3), SMALL),          # 2 x 2 x 3
]


@pytest.mark.parametrize("shape,want", WAVE_CASES,
                         ids=[f"{m}x{n}x{k}b{b}" for (m, n, k, b), _ in
                              WAVE_CASES])
def test_f64ger_tile_follows_the_wave_rule(shape, want):
    m, n, k, b = shape
    path, cfg = tiling.choose_gemm_path(m, n, k, F64, b)
    assert path == "dmma" and cfg == want
    assert cfg == tiling.choose_blocks(m, n, k, F64, b)
    gx, gy, gz = LARGE.grid(m, n, b)
    assert (cfg == LARGE) == (gx * gy * gz >= tiling.NUM_SMS)
    # a masked product takes the same DMMA tile
    assert tiling.choose_gemm_path(m, n, k, F64, b, True, None,
                                   True) == (path, cfg)


def test_f64ger_explicit_block_wins_and_must_be_compiled():
    assert tiling.choose_gemm_path(2048, 2048, 2048, F64,
                                   block=(64, 64, 16)) == ("dmma", SMALL)
    assert tiling.choose_gemm_path(4, 11008, 4096, F64,
                                   block=(128, 128, 32)) == ("dmma", LARGE)
    for bad in ((64, 64, 32), (128, 128, 16), (128, 64, 32)):
        with pytest.raises(ValueError, match="not a compiled"):
            tiling.choose_gemm_path(64, 64, 64, F64, block=bad)


def _spy_paths(monkeypatch):
    seen = []
    choose = tiling.choose_gemm_path

    def spy(*args, **kw):
        got = choose(*args, **kw)
        seen.append(got)
        return got
    monkeypatch.setattr(tiling, "choose_gemm_path", spy)
    return seen


@pytest.mark.parametrize("m,n,k", [(256, 1536, 64), (1536, 1536, 32)])
def test_f64ger_planted_winner_routes_contract(_hermetic_cache, monkeypatch,
                                               m, n, k):
    """A planted DMMA winner, the tile the wave rule does not pick, is the
    tile ``contract`` takes; an explicit block beats it; the result is the
    same either way (both tiles sum in one order)."""
    heur = tiling.choose_gemm_path(m, n, k, F64)
    winner = ("dmma", SMALL if heur[1] == LARGE else LARGE)
    key = autotune.cache_key(F64, autotune.tune_rows(F64, m), n, k, "none",
                             "cpu", 1)
    _hermetic_cache.put(key, winner, source=autotune.PRIOR, score=0.0)
    x, y = _t(_rand((m, k), 1)), _t(_rand((k, n), 2))
    plan = tfac.Plan(ger=F64, out_dtype=tfac.ACC)
    seen = _spy_paths(monkeypatch)
    with tfac.configure(CPU):
        tuned = tfac.contract("mk,kn->mn", x, y, plan=plan)
        explicit = tfac.contract("mk,kn->mn", x, y, plan=tfac.Plan(
            ger=F64, out_dtype=tfac.ACC, block=_block(heur[1])))
    assert seen == [winner, heur]
    assert torch.equal(tuned, explicit)


# ----------------------------------------------------------------------
# shared memory: the Python mirror against the kernel's own constants
# ----------------------------------------------------------------------

def _kernel_constants():
    """DMMA_STAGES, PAD and the compiled tiles (bm, bn, bk, warps, blocks
    an SM), as csrc/gemm_dmma.cu declares them."""
    src = CSRC.read_text()
    stages = int(re.search(r"constexpr int DMMA_STAGES = (\d+);",
                           src).group(1))
    pad = int(re.search(r"constexpr int PAD = (\d+);", src).group(1))
    tiles = {name: tuple(int(v) for v in vals.split(","))
             for name, vals in re.findall(
                 r"using (Large|Small) = Tile<([\d, ]+)>;", src)}
    return stages, pad, tiles


def test_dmma_tiles_and_ring_mirror_the_kernel():
    stages, pad, tiles = _kernel_constants()
    assert stages == tiling.DMMA_STAGES
    assert pad == 4                          # tiling's _PAD32 for fp64
    assert {t[:3] for t in tiles.values()} == set(tiling.GEMM_TILES[F64])
    assert tiles["Large"][:3] == tiling.GEMM_TILES[F64][0]
    pol = tprec.policy(F64)
    for bm, bn, bk, wm, wn, minb in tiles.values():
        ring = stages * (bm * (bk + pad) + bk * (bn + pad)) * 8
        ctile = bm * (bn + pad) * 8
        cfg = tiling.BlockConfig(bm, bn, bk)
        assert cfg.smem_bytes(pol) == max(ring, ctile)
        assert cfg.smem_bytes(pol) <= tiling.SMEM_PER_BLOCK
        # the blocks an SM the launch bounds ask for fit its 228 KB (1 KB
        # of each block reserved), and its warps own whole m16n8 tiles
        assert minb * (cfg.smem_bytes(pol) + 1024) <= 233_472
        assert (bm // wm) % 16 == 0 and (bn // wn) % 8 == 0
        assert 65536 // (wm * wn * 32 * minb) >= 128


# ----------------------------------------------------------------------
# the ABFT sidecar at each tile
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tile", [LARGE, SMALL], ids=["128", "64"])
@pytest.mark.parametrize("shape", [(None, 200, 40, 260), (2, 129, 17, 130)],
                         ids=["2d", "batched"])
def test_dmma_sidecar_bands_match_reference(tile, shape):
    """``checksum=True`` at an explicit DMMA tile: bands of bm rows and bn
    columns (fringes past M and N left out), ``out`` bit for bit the
    ``checksum=False`` result, and the reduced sums within ABFT's bound of
    the reference kernel's."""
    b, m, k, n = shape
    lead = () if b is None else (b,)
    x, y = _rand(lead + (m, k), 3), _rand(lead + (k, n), 4)
    block = _block(tile)
    out, ck_col, ck_row = tgemm.mma_gemm(_t(x), _t(y), kind=F64,
                                         block=block, checksum=True)
    assert torch.equal(out, tgemm.mma_gemm(_t(x), _t(y), kind=F64,
                                           block=block))
    assert tgemm.sidecar_tile("dmma", tile, m) == (tile.bm, tile.bn)
    assert tuple(ck_col.shape) == lead + (-(-m // tile.bm), n)
    assert tuple(ck_row.shape) == lead + (m, -(-n // tile.bn))
    want_col, want_row = tgemm.checksum_tiles(out, tile.bm, tile.bn)
    assert torch.equal(ck_col, want_col) and torch.equal(ck_row, want_row)
    slot = {}
    abft.deposit(slot, ck_col, ck_row)
    with x64(True):
        _, jc, jr = jgemm.mma_gemm(jnp.asarray(x), jnp.asarray(y),
                                   kind=JGer.F64GER, interpret=True,
                                   checksum=True)
        jslot = {}
        jabft.deposit(jslot, jc, jr)
        ref_col = np.asarray(jslot["col"], np.float64)
        ref_row = np.asarray(jslot["row"], np.float64)
    eps = torch.finfo(torch.float64).eps
    ax, ay = np.abs(x), np.abs(y)
    mag_col = np.einsum("...k,...kn->...n", ax.sum(-2), ay)
    mag_row = np.einsum("...mk,...k->...m", ax, ay.sum(-1))
    for got, want, mag in ((slot["col"], ref_col, mag_col),
                           (slot["row"], ref_row, mag_row)):
        err = np.abs(got.numpy() - want)
        assert np.all(err <= abft.ATOL + abft.FACTOR * eps * mag), err.max()


# ----------------------------------------------------------------------
# contract at the fringes a 128 tile adds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(None, 129, 17, 130), (3, 129, 17, 130),
                                   (None, 130, 33, 129)],
                         ids=["129x17x130", "batched", "130x33x129"])
def test_f64ger_contract_at_tile_fringes_matches_reference(shape):
    """contract in F64GER on the port's kernel backend (the plain version
    on the CPU) against the reference's interpret-mode kernel and its xla
    lowering, with a seed and the np form; then the same call at each
    explicit tile, bit for bit the tile the heuristic picked."""
    b, m, k, n = shape
    lead = () if b is None else (b,)
    spec = "mk,kn->mn" if b is None else "bmk,bkn->bmn"
    x, y = _rand(lead + (m, k), 5), _rand(lead + (k, n), 6)
    c = _rand(lead + (m, n), 7)
    forms = dict(neg_product=True, alpha=0.75, beta=-1.5)
    with tfac.configure(CPU):
        got = tfac.contract(spec, _t(x), _t(y), acc=_t(c), plan=tfac.Plan(
            ger=F64, out_dtype=tfac.ACC, **forms))
        for tile in (LARGE, SMALL):
            at = tfac.contract(spec, _t(x), _t(y), acc=_t(c),
                               plan=tfac.Plan(ger=F64, out_dtype=tfac.ACC,
                                              block=_block(tile),
                                              **forms))
            assert torch.equal(at, got)
    with x64(True):
        kernel = jgemm.mma_gemm(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(c), kind=JGer.F64GER,
                                interpret=True, **forms)
        xla = jfac.contract(spec, jnp.asarray(x), jnp.asarray(y),
                            acc=jnp.asarray(c), plan=jfac.Plan(
                                ger=JGer.F64GER, out_dtype=jfac.ACC,
                                backend="xla", **forms))
        for want in (kernel, xla):
            want = np.asarray(want)
            assert got.dtype == torch.float64 and want.dtype == np.float64
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-12)


# ----------------------------------------------------------------------
# the roofline prior and the autotune candidates
# ----------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(2048, 2048, 2048), (4, 11008, 4096),
                                   (1000, 1001, 999)])
def test_dmma_candidates_are_both_tiles(m, n, k):
    cands = autotune.candidate_blocks(m, n, k, F64)
    assert cands == [("dmma", LARGE), ("dmma", SMALL)]
    assert tiling.choose_gemm_path(m, n, k, F64) in cands
    for cand in cands:
        assert tiling.takes(cand, m, n, k, F64)
        assert tiling.takes(cand, m, n, k, F64, masked=True)


def test_dmma_prior_counts_each_tiles_traffic():
    """The prior reads each X panel once per N tile and each Y panel once
    per M tile of the tile it ranks: at 2048^3 the 64 x 64 tile moves
    twice the 128 x 128 tile's operand bytes, and ranks below it."""
    pol = tprec.policy(F64)
    m = n = k = 2048
    traffic = {}
    for tile in (LARGE, SMALL):
        gm, gn, gk = -(-m // tile.bm), -(-n // tile.bn), -(-k // tile.bk)
        want = (gm * gn * gk * (tile.bm * tile.bk + tile.bk * tile.bn) * 8
                + m * n * 8)
        traffic[tile] = roofline.gemm_traffic_bytes(m, n, k, tile, pol)
        assert traffic[tile] == want
        assert roofline.gemm_blocks(m, n, k, tile) == gm * gn
    c_write = m * n * 8
    assert traffic[SMALL] - c_write == 2 * (traffic[LARGE] - c_write)
    t = {tile: autotune.predicted_time(m, n, k, ("dmma", tile), F64)
         for tile in (LARGE, SMALL)}
    assert 0 < t[LARGE] < t[SMALL]
    # the fp64 tensor cores' 67 TFLOP/s bound the large tile's time
    assert t[LARGE] >= 2 * m * n * k / roofline.PEAK_FLOPS[F64]
