"""The 16-bit weight stream's plan on Hopper (``core/tiling.py``'s
``stream_plan`` and ``StreamConfig``'s work units; ``csrc/gemm_stream.cu``'s
TMA kernel), on the CPU: the units cover every (batch, N tile, K slice)
once, the K partition (which fixes every bit) does not move with the batch
or with M inside a row bucket, deepseek-moe-16b's expert banks fold whole
tiles, the ring's mirror equals the source's constants, and the kernel's
sum -- each unit folding its slices in split order, or the last unit of a
tile summing the partials -- is the split-K plain version bit for bit.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.core import autotune, precision, tiling
from repro_torch.kernels import mma_gemm as G
from repro_torch.models import moe as tmoe
from repro_torch.roofline import analysis

BF = precision.Ger.BF16GER2
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"

# (M, K, N, b): deepseek-7b's decode products and logits, deepseek-moe-16b's
# banks at decode and at a prefill's cap of 30, batches whose units span
# slices, the SSD's batched M = 1 product, ragged K and N
_SHAPES = [(4, 4096, 11008, 1), (4, 11008, 4096, 1), (4, 4096, 102400, 1),
           (1, 2048, 1408, 64), (30, 1408, 2048, 64), (2, 2048, 1408, 4),
           (1, 128, 1536, 4), (5, 999, 1001, 3), (64, 768, 2048, 2)]


@pytest.mark.parametrize("m,k,n,b", _SHAPES)
def test_units_cover_every_slice_once(m, k, n, b):
    """Every (product, N tile, slice) belongs to exactly one unit, a unit's
    slices are consecutive, and a unit folds every slice of its tile or
    none of the tiles' units does (one run length a launch)."""
    cfg = tiling.choose_gemm_path(m, n, k, BF, b)[1]
    units = cfg.units(n, b)
    tiles = -(-n // cfg.bn)
    seen = [(bz, nt, s) for bz, nt, s0, s1 in units for s in range(s0, s1)]
    assert sorted(seen) == [(bz, nt, s) for bz in range(b)
                            for nt in range(tiles)
                            for s in range(cfg.split)]
    run = cfg.run(n, b)
    assert all(s1 - s0 == min(run, cfg.split - s0)
               for _, _, s0, s1 in units)
    assert len(units) == cfg.blocks(n, b)
    assert cfg.partials(n, b) == (run < cfg.split)


@pytest.mark.parametrize("n,k", [(4096, 4096), (11008, 4096), (4096, 11008),
                                 (1408, 2048), (2048, 1408), (102400, 4096),
                                 (3352, 768), (1536, 128), (51865, 768)])
def test_k_slices_do_not_depend_on_the_batch_or_rows_in_a_bucket(n, k):
    """The partition that fixes a row's bits is one product's: the same at
    every b (1 to 64) and every M of a row bucket."""
    for bucket in (range(1, 9), range(9, 17), range(17, 33), range(33, 65)):
        slices = {tuple(tiling.choose_gemm_path(m, n, k, BF, b)[1]
                        .k_slices(k))
                  for m in bucket for b in (1, 2, 4, 8, 64)}
        assert len(slices) == 1


@pytest.mark.parametrize("cap", [1, 30])
def test_moe_banks_fold_whole_tiles(cap):
    """deepseek-moe-16b's expert banks (64 experts on the batch axis, at
    decode's cap of 1 and a 256-token prefill's 30) put a whole tile in
    each unit: no split-K partial, however the one-product plan splits K;
    one expert alone splits it over units of one slice."""
    cfg = get("deepseek-moe-16b")
    # a decode step of 4 tokens, a 256-token prompt
    assert tmoe.capacity({1: 4, 30: 256}[cap], cfg) == cap
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    for k, n in ((d, f), (f, d)):
        path, plan = tiling.choose_gemm_path(cap, n, k, BF, e)
        assert path == "stream" and plan.split > 1
        assert plan.run(n, e) == plan.split and not plan.partials(n, e)
        assert plan.run(n) == 1 and plan.partials(n)
        assert plan.blocks(n, e) == e * -(-n // plan.bn)


def _source_int(src, name):
    """The value of ``constexpr int NAME = <product of ints>`` in src."""
    expr = re.search(rf"\b{name} = ([\d\s*]+)[,;]", src).group(1)
    return int(np.prod([int(t) for t in expr.split("*")]))


def test_tma_ring_equals_the_source():
    """core/tiling.py's mirror of the TMA kernel's blocks an SM, ring
    depth and shared memory holds the constants csrc/gemm_stream.cu
    declares, and each instance's blocks fit an SM's shared memory."""
    src = (CSRC / "gemm_stream.cu").read_text()
    assert _source_int(src, "S2_MAX_STAGES") == tiling.STREAM_TMA_MAX_STAGES
    assert _source_int(src, "ST_BK") == tiling.STREAM_BK
    assert _source_int(src, "SM_SMEM_BYTES") == tiling.SM_SMEM
    occ = re.search(r"OCC =\s+BN == 64 && MT == 1 \? (\d) : \(BN == 128 && "
                    r"MT == 8 \? (\d) : (\d)\);", src)
    for bn in (64, 128):
        for rows in (8, 16, 32, 64):
            want = int(occ.group(1) if (bn, rows) == (64, 8) else
                       occ.group(2) if (bn, rows) == (128, 64) else
                       occ.group(3))
            per = tiling.stream_tma_blocks_per_sm(bn, rows)
            assert per == want
            smem = tiling.stream_tma_smem_bytes(bn, rows)
            assert smem <= tiling.SMEM_PER_BLOCK
            assert tiling.SM_SMEM // (smem + 1024) >= per
    want = {(64, 8): 10, (64, 16): 13, (64, 32): 10, (64, 64): 7,
            (128, 8): 7, (128, 16): 7, (128, 32): 5, (128, 64): 6}
    assert {key: tiling.stream_tma_stages(*key) for key in want} == want
    # the launcher's instances: BN 64 and 128, the four row buckets
    assert set(re.findall(r"launch_stream_tma_m<T, (\d+)>", src)) == \
        {"64", "128"}
    assert re.findall(r"launch_stream_tma<T, BN, (\d)>", src) == \
        ["1", "2", "4", "8"]


def _fold(x, y, cfg, k, b, n):
    """The kernel's sum in plain torch: each unit of ``cfg.units`` either
    folds its slices' fp32 products in split order from 0 (a whole tile) or
    writes one partial a slice, which the tile's last unit sums in split
    order from 0."""
    pol = precision.policy(BF)
    slices = cfg.k_slices(k)
    parts = [torch.matmul(x[..., k0:k1].to(pol.acc_dtype),
                          y[..., k0:k1, :].to(pol.acc_dtype))
             for k0, k1 in slices]
    out = torch.empty_like(parts[0])
    whole = not cfg.partials(n, b)
    for bz, nt, s0, s1 in cfg.units(n, b):
        cols = slice(nt * cfg.bn, (nt + 1) * cfg.bn)
        if not whole and s1 < cfg.split:
            continue     # the tile's last unit sums every partial
        if cfg.split == 1:
            out[bz, :, cols] = parts[0][bz, :, cols]
            continue
        tot = torch.zeros_like(parts[0][bz, :, cols])
        for s in range(cfg.split):
            tot = tot + parts[s][bz, :, cols]
        out[bz, :, cols] = tot
    return out


@pytest.mark.parametrize("m,k,n,b", [(1, 2048, 1408, 64), (2, 2048, 1408, 4),
                                     (4, 1000, 520, 1), (3, 256, 4000, 2),
                                     (9, 777, 300, 3)])
def test_fold_is_the_splitk_plain_version(m, k, n, b):
    """The sum the kernel forms, in plain torch on the CPU (whole tiles
    folding in registers, or partials summed by the last unit), equals
    ``mma_gemm_splitk_plain`` bit for bit: both are 0 + p0 + p1 + ... over
    the plan's slices (the plain version starts from p0, which differs
    only in the sign of a zero)."""
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.standard_normal((b, m, k), np.float32)).to(
        torch.bfloat16)
    y = torch.from_numpy(rng.standard_normal((b, k, n), np.float32)
                         * k ** -0.5).to(torch.bfloat16)
    cfg = tiling.choose_gemm_path(m, n, k, BF, b)[1]
    want = G.mma_gemm_splitk_plain(x, y, kind=BF,
                                   k_slices=cfg.k_slices(k))
    assert torch.equal(_fold(x, y, cfg, k, b, n), want)
    # the wrapper's CPU path is that plain version
    assert torch.equal(G.mma_gemm(x, y, kind=BF), want)


def test_stream_tma_reads_natural_rows_at_16_byte_pitches():
    """The wrapper's mirror of the launcher's choice: TMA reads natural
    rows whose pitch and base are 16-byte (K for X, N for the weight) and
    every packed panel; whisper's 51865 columns go to the cp.async
    kernel."""
    x = torch.zeros(4, 768, dtype=torch.bfloat16)
    for n, want in ((3352, True), (51865, False)):
        y = torch.zeros(768, n, dtype=torch.bfloat16)
        assert G.stream_tma_reads(x, y, 768, n, 0, (0, 0)) == want
        assert G.stream_tma_reads(x, y, 768, n, 2, (0, 0))
    odd = torch.zeros(4, 770, dtype=torch.bfloat16)[:, 1:]
    y = torch.zeros(769, 4096, dtype=torch.bfloat16)
    assert not G.stream_tma_reads(odd, y, 769, 4096, 0, (0, 0))
    assert G.stream_tma_reads(odd, y, 769, 4096, 1, (0, 0))


def test_stream_candidates_follow_the_work_units():
    """The autotune prior ranks stream candidates by the new plan: at the
    b = 64 bank every candidate folds its tiles, so none is charged
    partials (the traffic is the weight once); at b = 1 the split ones
    are, and the heuristic's split is a candidate either way."""
    pol = precision.policy(BF)
    m, k, n = 1, 2048, 1408
    once = (m * k + k * n) * 2 + m * n * 4
    for b in (1, 64):
        heur = tiling.choose_gemm_path(m, n, k, BF, b)
        cands = [c for p, c in autotune.candidate_blocks(m, n, k, BF, b)
                 if p == "stream"]
        assert heur[1] in cands
        for cfg in cands:
            traffic = analysis.gemm_traffic_bytes(m, n, k, cfg, pol, b)
            if b == 64 or cfg.split == 1:
                assert traffic == b * once
            else:
                assert traffic > once and cfg.partials(n, b)


def test_conv_wgmma_tiles_are_the_compiled_ones():
    """K3's wgmma conv is compiled for K1's four tile widths
    (csrc/mma_conv.cu's launch_conv_wgmma_t) and planned over all four."""
    src = (CSRC / "mma_conv.cu").read_text()
    compiled = {int(v) for v in
                re.findall(r"if \(bn == (\d+)\) return launch_conv_wgmma<",
                           src)}
    assert compiled == {c.bn for c in tiling.CONV_WGMMA_TILES} \
        == {64, 128, 192, 256}
    assert set(tiling.CONV_WGMMA_COLUMN_COST) == compiled
