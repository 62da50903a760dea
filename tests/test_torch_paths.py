"""The GEMM's, attention's and convolutions' choice of kernel on the card,
and the plain versions of the split arithmetic those kernels run, on the
CPU.

``core.tiling.choose_gemm_path`` is pinned on the shapes of the five
full-width runs (their weights' shapes are read from the port's own
``init_params`` with the allocations stubbed out); ``split_kv_plan`` on
whisper-small's decode cross-attention; ``choose_conv_path`` on the main
path's three dense convs and ``depthwise_plan`` on mamba2's causal conv.
The split-K plain version is held
against the unsplit product (within fp32 rounding: ``rtol=1e-5,
atol=1e-5 * max|ref|``, since bf16 products are exact in fp32 and only the
order of the fp32 sums differs) and against the reference's Pallas kernel
in interpret mode (within the BF16GER2 tolerance of test_torch_gemm.py:
``rtol=2e-5, atol=2e-5 * max|ref|`` for an f32 store, one bf16 ulp plus
that for a bf16 store).  The split-KV plain merge is held against the
reference's ``ref_attention`` within ``2^-7 * max|v|`` (it rounds
P = exp(S - m_split) to v's dtype per split, the reference the normalised
P once: each weight may differ by a half-ulp of bf16) and exactly in f32
inputs up to ``1e-5``; fully masked rows must be exact zeros.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro.kernels import epilogue as jep
from repro.kernels import mma_attention as jattn
from repro.kernels import mma_gemm as jgemm
from repro_torch.configs import get
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import mma_attention as tattn
from repro_torch.kernels import mma_conv as tconv
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.models import layers as L
from repro_torch.models import model as M

BF = tprec.Ger.BF16GER2
RUNS = ("deepseek-7b", "zamba2-1.2b", "mamba2-130m", "whisper-small",
        "qwen2-vl-7b")
DECODE_BATCH = 4
FULL_GRID = tiling.BLOCKS_PER_SM * tiling.NUM_SMS      # 264 blocks


def _weight_shapes(arch: str, monkeypatch) -> set[tuple[int, int]]:
    """The (K, N) of every projection weight of ``arch`` at full width, as
    ``init_params`` draws them (one layer of each kind: every layer has the
    same shapes); nothing is allocated."""
    shapes = set()

    def dense(gen, shape, *, device, dtype):
        shapes.add(tuple(shape))
        return torch.empty(0)

    def embed(gen, cfg, *, device, dtype):
        shapes.add((cfg.d_model, cfg.vocab_size))    # the logits product
        return L.Embed(torch.empty(0), None)

    monkeypatch.setattr(L, "_dense_init", dense)
    monkeypatch.setattr(L, "init_embed", embed)
    cfg = get(arch)
    cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, 1),
                              encoder_layers=min(cfg.encoder_layers, 1))
    M.init_params(cfg, device="cpu")
    return {s for s in shapes if len(s) == 2}


@pytest.mark.parametrize("arch", RUNS)
def test_decode_products_take_the_weight_stream(arch, monkeypatch):
    shapes = _weight_shapes(arch, monkeypatch)
    big = [(k, n) for k, n in shapes if k >= 768]
    assert big, arch
    for k, n in big:
        aligned = k % 8 == 0 and n % 8 == 0
        path, cfg = tiling.choose_gemm_path(DECODE_BATCH, n, k, BF, 1,
                                            aligned)
        assert path == "stream", (arch, k, n)
        assert cfg.blocks(n) >= FULL_GRID, (arch, k, n, cfg)
        # every split owns at least one stage of K
        assert all(k1 > k0 for k0, k1 in cfg.k_slices(k))


@pytest.mark.parametrize("arch,heads,state", [("zamba2-1.2b", 64, 64),
                                              ("mamba2-130m", 24, 128)])
def test_ssd_decode_products_take_the_weight_stream(arch, heads, state):
    """The SSD's batched decode products (models/mamba2.py): y = C h, one
    row per batch element over the (N, H * P) state; the K = 1 outer
    product of the state update stays on the WMMA tile."""
    hp = heads * 64
    path, _ = tiling.choose_gemm_path(1, hp, state, BF, DECODE_BATCH, True)
    assert path == "stream"
    path, _ = tiling.choose_gemm_path(state, hp, 1, BF, DECODE_BATCH, True)
    assert path == "wmma"


@pytest.mark.parametrize("m,k,n", [
    (256, 4096, 4096), (256, 4096, 11008), (256, 11008, 4096),
    (256, 4096, 102400),                                   # deepseek-7b
    (4352, 3584, 3584), (4352, 3584, 512), (4352, 3584, 18944),
    (4352, 18944, 3584), (4352, 3584, 152064),             # qwen2-vl-7b
    (6000, 768, 768), (6000, 768, 3072), (6000, 3072, 768)])  # whisper enc
def test_prefill_products_take_the_wgmma_tile(m, k, n):
    path, cfg = tiling.choose_gemm_path(m, n, k, BF, 1, True)
    assert path == "wgmma" and cfg in tiling.WGMMA_TILES
    assert cfg == tiling.wgmma_plan(m, n, k)


@pytest.mark.parametrize("k,n,want", [
    (4096, 4096, tiling.WgmmaConfig(128, 64)),          # q, k, v, o
    (4096, 11008, tiling.WgmmaConfig(128, 192)),        # gate, up
    (11008, 4096, tiling.WgmmaConfig(128, 64)),         # down
])
def test_wgmma_plan_fills_the_card_at_deepseek_prefill(k, n, want):
    """deepseek-7b's prefill products at M = 256: the plan puts a tile on
    at least 7/8 of the card's SMs in one wave (the 128-column tile left
    68 of 132 idle at N = 4096), and it is a pure function of (m, n, k,
    b): the same answer on every call, the batch counted as more tiles."""
    m = 256
    cfg = tiling.wgmma_plan(m, n, k)
    assert cfg == want == tiling.choose_gemm_path(m, n, k, BF, 1, True)[1]
    assert 7 * tiling.NUM_SMS <= 8 * cfg.tiles(m, n) <= 8 * tiling.NUM_SMS
    assert cfg.waves(m, n) == 1
    if n == 4096:   # the parent's 128-column plan: 64 tiles
        assert tiling.WgmmaConfig(128, 128).tiles(m, n) == 64
    assert tiling.wgmma_plan(m, n, k) == cfg
    # K does not shape the grid; a batch adds tiles
    assert tiling.wgmma_plan(m, n, 2 * k) == cfg
    two = tiling.wgmma_plan(m, n, k, 2)
    assert two.tiles(m, n, 2) == 2 * two.tiles(m, n)


@pytest.mark.parametrize("m,k,n,bn", [
    (1024, 4096, 11008, 256), (2048, 4096, 4096, 256),
    (4096, 2048, 4096, 256), (6000, 768, 3072, 192), (6000, 768, 768, 192),
    (256, 4096, 102400, 256)])
def test_wgmma_plan_keeps_wide_tiles_where_they_fill_the_card(m, k, n, bn):
    """Prefill and train products that fill the card several times over
    stay on wide tiles."""
    assert tiling.wgmma_plan(m, n, k) == tiling.WgmmaConfig(128, bn)


def test_wgmma_configs_fit_a_block():
    """Every compiled wgmma tile's shared memory, as csrc/wgmma_tile.cuh's
    WgCfg reckons it: the ring (4 stages of a 16 KB X box and a 64 x bn Y
    box at bn = 256, 5 at 192, 7 at 128, 8 at 64), 1 KB of alignment slack
    and two mbarriers a stage, within 232,448 bytes with K3's 1 KB of
    row offsets beside it; the ring holds the epilogue's staged fp32
    tile; and K3's wgmma conv tiles are among them."""
    ring = {256: 4 * 49152, 192: 5 * 40960, 128: 7 * 32768, 64: 8 * 24576}
    for cfg in tiling.WGMMA_TILES:
        stages = tiling.wgmma_stages(cfg.bn)
        got = cfg.smem_bytes()
        assert got == ring[cfg.bn] + 1024 + 16 * stages
        assert got + 128 * 8 <= tiling.SMEM_PER_BLOCK
        # one stage more would not fit, or the ring is at its most
        assert got + 128 * 8 + tiling.wgmma_stage_bytes(cfg.bn) + 16 > \
            tiling.SMEM_PER_BLOCK or stages == tiling.WGMMA_MAX_STAGES
        assert ring[cfg.bn] >= 128 * (cfg.bn + 8) * 4
    assert set(tiling.CONV_WGMMA_TILES) <= set(tiling.WGMMA_TILES)


def test_what_the_new_paths_do_not_take_stays_on_wmma():
    # whisper's prefill logits at large M: a 51865-column pitch TMA refuses
    assert tiling.choose_gemm_path(6000, 51865, 768, BF, 1, False)[0] == \
        "wmma"
    # ... which the weight stream takes at decode M (a scalar fringe path)
    assert tiling.choose_gemm_path(16, 51865, 768, BF, 1, False)[0] == \
        "stream"
    # F32GER decode takes the fp32 weight stream (its test below)
    assert tiling.choose_gemm_path(4, 4096, 4096, tprec.Ger.F32GER)[0] == \
        "stream"
    for m in (4, 300):
        path, cfg = tiling.choose_gemm_path(m, 256, 512, BF, 1, True,
                                            (64, 64, 64))
        assert path == "wmma" and cfg == tiling.BlockConfig(64, 64, 64)


F32 = tprec.Ger.F32GER


@pytest.mark.parametrize("m", [1, 4, 9, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("k,n,aligned", [(4096, 11008, True),
                                         (4096, 4096, True),
                                         (4096, 102400, True),
                                         (768, 51865, False)])
def test_f32ger_row_buckets_take_the_fp32_stream(m, k, n, aligned):
    """F32GER at M <= 64 (every row bucket; deepseek-7b's decode MLP,
    projections and logits, whisper's unaligned logits) takes the weight
    stream, on true fp32 FMAs, with its grid on two blocks an SM and each
    split at least one stage of K; its plan does not depend on M, so a
    row sums in one order at every M <= 64."""
    path, cfg = tiling.choose_gemm_path(m, n, k, F32, 1, aligned)
    assert path == "stream"
    assert cfg.blocks(n) >= FULL_GRID
    assert all(k1 > k0 for k0, k1 in cfg.k_slices(k))
    assert cfg == tiling.choose_gemm_path(1, n, k, F32, 1, aligned)[1]
    assert cfg == tiling.stream_plan(m, n, k, 1, 4)


def test_f32ger_below_one_mma_step_and_above_64_rows_takes_the_fp32_tile():
    # K < MIN_K: the SSD's K = 1 outer product, as in bf16
    assert tiling.choose_gemm_path(4, 4096, 1, F32)[0] == "wmma"
    # M > 64 never takes a tensor-core path, aligned or not
    for aligned in (True, False):
        path, cfg = tiling.choose_gemm_path(65, 4096, 4096, F32, 1, aligned)
        assert path == "wmma" and cfg.bk == 16


@pytest.mark.parametrize("m", [4, 64, 1024])
def test_masked_f32ger_stays_on_the_fp32_tile(m):
    """A masked F32GER product takes the fp32 tile at every M, as masked
    bf16 takes WMMA: the weight stream takes no predicates; decode's
    skinny grid the 64 x 64 tile, prefill's the 128 x 128 one."""
    path, cfg = tiling.choose_gemm_path(m, 11008, 4096, F32, 1, True,
                                        masked=True)
    want = (128, 128, 16) if m == 1024 else (64, 64, 16)
    assert path == "wmma" and cfg == tiling.BlockConfig(*want)


@pytest.mark.parametrize("m,k,n,want", [
    (1024, 4096, 11008, (128, 128, 16)),    # deepseek-7b prefill MLP
    (1024, 4096, 4096, (128, 128, 16)),     # its projections: 256 blocks
    (2048, 11008, 4096, (128, 128, 16)),    # training's down projection
    (256, 4096, 4096, (64, 64, 16)),        # 64 blocks of 128: too few
    (160, 768, 768, (64, 64, 16))])         # whisper's reduced encoder
def test_f32ger_prefill_takes_the_larger_fp32_tile(m, k, n, want):
    """The 128 x 128 fp32 tile where its grid still puts a block on every
    SM, else the 64 x 64 one (choose_blocks' rule)."""
    path, cfg = tiling.choose_gemm_path(m, n, k, F32)
    assert path == "wmma" and cfg == tiling.BlockConfig(*want)
    assert tiling.GEMM_TILES[F32][0] == (128, 128, 16)


def test_stream_plan_fp32_split_ceiling():
    """The partials budget (8 * split * M * N bytes of fp32 partials
    against the weight's in_bytes * K * N) lets 4-byte weights split K
    twice as far as 16-bit ones at a row count: at bucket 64 over K = 512
    bf16 stops at 2 splits, F32GER at 4.  F32GER reckons it at 64 rows
    for every M (one order a row at every M), so at M = 4 it stops at 4
    where bf16's bucket of 8 allows the grid target's 5; where the grid
    target binds first the two agree."""
    assert tiling.stream_plan(64, 4096, 512) == tiling.StreamConfig(64, 2)
    fp32 = tiling.stream_plan(64, 4096, 512, 1, 4)
    assert fp32 == tiling.StreamConfig(64, 4)
    assert 8 * fp32.split * 64 * 4096 <= 4 * 512 * 4096
    assert tiling.choose_gemm_path(64, 4096, 512, F32)[1] == fp32
    assert tiling.stream_plan(4, 4096, 512) == tiling.StreamConfig(64, 5)
    for m in (1, 4, 16, 32):
        assert tiling.stream_plan(m, 4096, 512, 1, 4) == fp32
    # deepseek-7b's decode MLP: the grid target binds (2 splits of 172
    # tiles) in both families
    assert tiling.stream_plan(4, 11008, 4096, 1, 4) == \
        tiling.stream_plan(4, 11008, 4096) == tiling.StreamConfig(64, 2)


def test_takes_an_f32ger_stream_winner():
    won = ("stream", tiling.StreamConfig(64, 16))
    assert tiling.takes(won, 4, 4096, 4096, F32)
    assert tiling.choose_gemm_path(4, 4096, 4096, F32, tuned=won) == won
    # not masked, not above 64 rows, not past K's stages
    assert not tiling.takes(won, 4, 4096, 4096, F32, masked=True)
    assert not tiling.takes(won, 65, 4096, 4096, F32)
    assert not tiling.takes(("stream", tiling.StreamConfig(64, 200)), 4,
                            4096, 4096, F32)
    # no tensor-core tile for F32GER; both fp32 tiles at any M
    assert not tiling.takes(("wgmma", tiling.WgmmaConfig(128, 128)), 1024,
                            4096, 4096, F32)
    for t in tiling.tiles_for(F32):
        assert tiling.takes(("wmma", t), 4, 4096, 4096, F32)
        assert tiling.takes(("wmma", t), 1024, 4096, 4096, F32)


def test_split_kv_plan_fills_the_card_at_whisper_cross_attention():
    h, sk = 12, 1500                        # q (4, 1, 12, 64) over 1500
    n_split, per = tattn.split_kv_plan(h, 1, sk)
    nk = -(-sk // tattn.BLOCK_K)
    assert n_split * per >= nk and (n_split - 1) * per < nk
    # splits of at least SPLIT_MIN_BLOCKS blocks: whisper's batch of 4
    # puts its (b, h, split) blocks on the card in one wave
    assert per >= tattn.SPLIT_MIN_BLOCKS and n_split > 1
    assert 4 * h * n_split <= FULL_GRID
    # prefill shapes do not split
    assert tattn.split_kv_plan(32, 256, 256) == (1, 4)
    assert tattn.split_kv_plan(12, 1500, 1500)[0] == 1
    # the plan reads no batch: more heads than SMs still split, into
    # splits of at least SPLIT_MIN_BLOCKS blocks
    assert tattn.split_kv_plan(33, 1, 1500) == (4, 6)
    # many blocks: at most DECODE_CLUSTER_MAX splits (one cluster merges
    # them), each longer
    n_split, per = tattn.split_kv_plan(8, 1, 64 * 1024)
    assert n_split == tattn.DECODE_CLUSTER_MAX and per == 1024 // 8
    assert 8 * n_split <= 2 * tiling.NUM_SMS


# ----------------------------------------------------------------------
# The convolutions' paths (csrc/mma_conv.cu): K3's kernel, K4's plan
# ----------------------------------------------------------------------

# (M = N*OH*OW, F) of the main path's dense convs at batch 4
_STEMS = {"whisper conv1": (4 * 3000, 768),
          "whisper conv2": (4 * 1500, 768),
          "qwen2-vl patch embed": (4 * 32 * 32, 3584)}
# the filter tile conv_wgmma_plan gives each: the fastest of the four
# at each stem on the H100 (PERF.md, run Q1)
_STEM_TILES = {"whisper conv1": 192, "whisper conv2": 128,
               "qwen2-vl patch embed": 256}


@pytest.mark.parametrize("stem", sorted(_STEMS))
def test_conv_stems_take_the_wgmma_kernel(stem):
    m, f = _STEMS[stem]
    path, cfg = tiling.choose_conv_path(m, f, BF, True)
    assert path == "wgmma" and cfg == tiling.conv_wgmma_plan(m, f)
    # the tile whose waves cost least (conv_wgmma_plan's model)
    assert cfg.bn == _STEM_TILES[stem]
    assert tiling.choose_conv_path(m, f, tprec.Ger.F16GER2, True)[0] == \
        "wgmma"


def test_conv_paths_the_wgmma_kernel_does_not_take():
    m, f = _STEMS["whisper conv2"]
    # F32GER stays true fp32, on its own kernel, whatever the alignment
    for aligned in (True, False):
        assert tiling.choose_conv_path(m, f, tprec.Ger.F32GER,
                                       aligned) == \
            ("f32", tiling.BlockConfig(64, 64, 16))
    # an explicit filter tile names the WMMA tile, as a block does the GEMM's
    assert tiling.choose_conv_path(m, f, BF, True, True, 128) == \
        ("wmma", tiling.CONV_TILES[BF][0])
    # a bank TMA cannot read (F % 8 != 0, or an unaligned base)
    assert tiling.choose_conv_path(m, 100, BF, False)[0] == "wmma"
    # an image the producer gathers in neither 16- nor 4-byte copies
    assert tiling.choose_conv_path(m, f, BF, True, False)[0] == "wmma"
    with pytest.raises(ValueError, match="filter tile"):
        tiling.choose_conv_path(m, f, BF, True, True, 64)


@pytest.mark.parametrize("m,f,want", [
    (4 * 1500, 768, 64),           # whisper conv2: 282 large tiles
    (4 * 3000, 768, 128),          # whisper conv1: 564
    (4 * 32 * 32, 3584, 128),      # qwen2-vl's patch embed: 896
    (2 * 149, 144, 64),            # a short grid: 3 x 2 large tiles
    (128, 1024, 64),               # 8 large tiles, 32 small
])
def test_f32_conv_takes_the_fp32_simt_tile_by_the_wave_rule(m, f, want):
    """F32GER's conv runs K1's fp32 SIMT tiles, wave by wave
    (tiling.f32_conv_tile): 128 x 128 where its waves of two blocks an SM
    are full enough (conv1, the patch embed), else 64 x 64 (whisper's
    conv2, whose second wave of large tiles is 7% full, and short grids);
    an explicit filter tile names either, and no other."""
    F32 = tprec.Ger.F32GER
    path, cfg = tiling.choose_conv_path(m, f, F32)
    assert path == "f32" and (cfg.bm, cfg.bn, cfg.bk) == (want, want, 16)
    assert cfg == tiling.f32_conv_tile(m, f)
    gx, gy, _ = tiling.BlockConfig(128, 128, 16).grid(m, f)
    if m == 4 * 1500:
        assert gx * gy - 2 * tiling.NUM_SMS == 18
    assert tiling.CONV_TILES[F32] == tiling.tiles_for(F32)
    for bf in (128, 64):
        assert tiling.choose_conv_path(m, f, F32, True, True, bf) == \
            ("f32", tiling.BlockConfig(bf, bf, 16))
    for bf in (32, 256):
        with pytest.raises(ValueError, match="filter tiles"):
            tiling.choose_conv_path(m, f, F32, True, True, bf)


@pytest.mark.parametrize("kind", [BF, tprec.Ger.F16GER2,
                                  tprec.Ger.F32GER])
def test_conv_tiles_fit_a_block(kind):
    """K3's compiled WMMA and fp32 tiles with the rows' pixel offsets
    (csrc/mma_conv.cu's conv_wmma_smem_bytes / conv_f32_smem_bytes): the
    fp32 tiles' two stages or their fp32 tile, whichever is larger, and
    8 bytes a row, within 232,448 bytes and two blocks an SM."""
    pol = tprec.policy(kind)
    want = {(64, 128, 32): 4 * (64 * 40 + 32 * 136) * 2 + 64 * 8,
            (128, 128, 16): 128 * 132 * 4 + 128 * 8,         # 68608
            (64, 64, 16): 2 * (16 * 68 + 16 * 68) * 4 + 64 * 8}
    for cfg in tiling.CONV_TILES[kind]:
        got = tiling.conv_smem_bytes(cfg, pol)
        assert got == want[(cfg.bm, cfg.bn, cfg.bk)]
        assert got <= tiling.SMEM_PER_BLOCK
        assert 2 * (got + 1024) <= 228 * 1024


# (C, KW, W, SW, image base) -> the widest copy that gathers K3's image
# panel: the main path's stems, then the cases around each rule
_GATHERS = [
    ((80, 3, 3002, 1, 0), 16),       # whisper conv1
    ((768, 3, 3001, 2, 0), 16),      # whisper conv2
    ((3, 14, 448, 14, 0), 4),        # qwen2-vl patch embed: runs of 42
    ((8, 3, 10, 1, 8), 4),           # C % 8 == 0 at an 8-byte base: pairs
    ((5, 3, 11, 2, 0), 0),           # odd (j, c) runs
    ((6, 3, 11, 1, 2), 0),           # even runs at a 2-byte base
    ((3, 2, 7, 2, 0), 0),            # odd row pitch W*C
    ((4, 3, 9, 1, 4), 4),            # C = 4 at a 4-byte base
    ((3, 14, 448, 14, 2), 0),        # the patch embed at a 2-byte base
    ((16, 1, 5, 3, 32), 16),         # stride above the width: 16 bytes
]


@pytest.mark.parametrize("geometry,want", _GATHERS)
def test_conv_gather_bytes_picks_the_producers_copy(geometry, want):
    """``conv_gather_bytes`` mirrors mma_conv2d_launch's rule, and an image
    it cannot gather (0) keeps the bank off the wgmma kernel."""
    assert tiling.conv_gather_bytes(*geometry) == want
    path = tiling.choose_conv_path(4 * 1500, 768, BF, True, want > 0)[0]
    assert path == ("wgmma" if want else "wmma")


# (base, pitch, row), in bytes -> the shift csrc/tile_gemm.cuh's 16-bit
# tile realigns that natural row by (0: copied as it lies): whisper-small's
# logits weight (N = 51865, a 103730-byte pitch) on even and odd rows, then
# a 16-byte pitch at three bases, K = 333 (666-byte rows) and the SSD's
# K = 1 (2-byte rows)
_TILE16_ROWS = [
    ((0, 103730, 0), 0),
    ((0, 103730, 1), 2),
    ((0, 103730, 2), 4),
    ((0, 103730, 3), 6),
    ((0, 103730, 4), 8),
    ((0, 103730, 6), 12),
    ((0, 103730, 8), 0),
    ((0, 103730, 767), 14),
    ((0, 8192, 5), 0),
    ((2, 8192, 5), 2),
    ((4, 8192, 5), 4),
    ((0, 666, 1), 10),
    ((0, 666, 2), 4),
    ((0, 2, 7), 14),
    ((0, 2, 8), 0),
]


@pytest.mark.parametrize("row,want", _TILE16_ROWS)
def test_tile16_row_shift_follows_each_rows_offset(row, want):
    """``tile16_row_shift`` mirrors the 16-bit tile's rule, row by row (no
    longer one rule for the whole matrix): a row at a 16-byte offset of 0
    is copied as it lies, any other offset is the shift its whole words
    are realigned by in shared memory."""
    assert tiling.tile16_row_shift(*row) == want


def test_tile16_row_shift_on_whisper_logits():
    """Whisper-small's 768 logits rows, 8 at a time: one row copied as it
    lies, seven realigned by 2, 4, ..., 14 bytes, wherever the weight
    starts on a 16-byte boundary."""
    for base in (0, 16, 4096):
        shifts = [tiling.tile16_row_shift(base, 2 * 51865, r)
                  for r in range(768)]
        assert shifts.count(0) == 96
        assert shifts[:8] == [0, 2, 4, 6, 8, 10, 12, 14]
        assert shifts[8:16] == shifts[:8]


@pytest.mark.parametrize("kind", [BF, tprec.Ger.F16GER2])
def test_wmma_tile_smem_counts_the_ring(kind):
    """``BlockConfig.smem_bytes`` of the 16-bit tiles counts what
    csrc/tile_gemm.cuh's wmma_smem_bytes does: ``TILE16_STAGES`` panel
    pairs with rows padded by 8 elements, or the fp32 tile (rows padded
    by 4) that aliases the ring, whichever is larger.  Each tile fits a
    block and two blocks an SM (228 KB, 1 KB a block reserved); K3's
    (64, 128, 32) filter tile too."""
    pol = tprec.policy(kind)
    assert tiling.TILE16_STAGES >= 3
    want = {(128, 128, 32): 4 * (128 * 40 + 32 * 136) * 2,      # 75776
            (64, 64, 64): 4 * (64 * 72 + 64 * 72) * 2,          # 73728
            (64, 128, 32): 4 * (64 * 40 + 32 * 136) * 2}        # 55296
    assert want[(128, 128, 32)] > 128 * 132 * 4    # the ring > the fp32 tile
    for cfg in (*tiling.tiles_for(kind), *tiling.CONV_TILES[kind]):
        got = cfg.smem_bytes(pol)
        assert got == want[(cfg.bm, cfg.bn, cfg.bk)]
        assert 2 * (got + 1024) <= 228 * 1024 and got <= tiling.SMEM_PER_BLOCK


def test_wmma_tile_routes_are_unchanged():
    """The products and convs the 16-bit tile takes, each on the tile it
    took before: whisper-small's logits at prefill and train M (a pitch
    TMA refuses), the SSD's K = 1 outer product, masked products at every
    M, an explicit block; K3 at an explicit filter tile or an image no
    copy of the wgmma producer gathers."""
    big, small = tiling.BlockConfig(128, 128, 32), tiling.BlockConfig(
        64, 64, 64)
    for m in (4 * 4, 4 * 448):
        want = "stream" if m <= tiling.STREAM_MAX_M else "wmma"
        path, cfg = tiling.choose_gemm_path(m, 51865, 768, BF, 1, False)
        assert path == want
        if path == "wmma":
            assert cfg == big
    assert tiling.choose_gemm_path(64, 4096, 1, BF, 4, True) == ("wmma",
                                                                 small)
    assert tiling.choose_gemm_path(4, 11008, 4096, BF, 1, True, None,
                                   True) == ("wmma", small)
    assert tiling.choose_gemm_path(1024, 11008, 4096, BF, 1, True, None,
                                   True) == ("wmma", big)
    conv = tiling.CONV_TILES[BF][0]
    assert tiling.choose_conv_path(6000, 768, BF, True, True,
                                   128) == ("wmma", conv)
    assert tiling.choose_conv_path(6000, 768, BF, True, False) == ("wmma",
                                                                   conv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4224, 1792])
def test_depthwise_plan_takes_the_vector_path_on_mamba2(dtype, c):
    """mamba2's causal conv at zamba2's and mamba2-130m's widths (prefill
    and decode alike: the plan does not depend on the pixels)."""
    vec = tiling.depthwise_plan(c, dtype, True)
    assert vec == 16 // dtype.itemsize and c % vec == 0
    # an unaligned base takes the scalar path
    assert tiling.depthwise_plan(c, dtype, False) == 0


@pytest.mark.parametrize("c", [4227, 131, 77])
def test_depthwise_plan_takes_the_scalar_path_where_no_vector_divides(c):
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert tiling.depthwise_plan(c, dtype, True) == 0


def test_conv_wrappers_run_their_plain_versions_on_the_cpu():
    """On the CPU both wrappers run their plain versions, whatever path
    the card would take, and count no launch."""
    rng = np.random.default_rng(9)
    counts = (tconv.mma_conv2d.launches,
              dict(tconv.mma_conv2d.launches_by_path),
              tconv.mma_depthwise_conv2d.launches,
              dict(tconv.mma_depthwise_conv2d.launches_by_path))
    x = torch.from_numpy(rng.standard_normal((2, 1, 20, 16),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 3, 16, 24),
                                             dtype=np.float32) * 0.2)
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(tconv.mma_conv2d(x.to(dt), w.to(dt)),
                           tconv.mma_conv2d_plain(x.to(dt), w.to(dt)))
    taps = torch.from_numpy(rng.standard_normal((1, 4, 16),
                                                dtype=np.float32))
    assert torch.equal(tconv.mma_depthwise_conv2d(x, taps),
                       tconv.mma_depthwise_conv2d_plain(x, taps))
    assert counts == (tconv.mma_conv2d.launches,
                      dict(tconv.mma_conv2d.launches_by_path),
                      tconv.mma_depthwise_conv2d.launches,
                      dict(tconv.mma_depthwise_conv2d.launches_by_path))


# ----------------------------------------------------------------------
# The split-K plain version
# ----------------------------------------------------------------------

def _gemm_inputs(seed, m, k, n, b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    x = rng.standard_normal(lead + (m, k)).astype(np.float32)
    y = (rng.standard_normal(lead + (k, n)) * k ** -0.5).astype(np.float32)
    return x, y


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        torch.bfloat16)


def _bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    tol = np.exp2(np.floor(np.log2(mag)) - 7) + 2e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("forms", [
    dict(), dict(neg_product=True, alpha=0.5),
    dict(neg_acc=True, beta=-2.0), dict(neg_product=True, neg_acc=True,
                                        alpha=-1.5, beta=0.25)])
@pytest.mark.parametrize("epi", [None, "bias", "relu", "silu", "gelu",
                                 "residual", "bias+gelu+residual"])
def test_splitk_plain_matches_unsplit_and_pallas(forms, epi):
    m, k, n = 4, 1000, 136
    x, y = _gemm_inputs(len(epi or "") + 7 * len(forms), m, k, n)
    rng = np.random.default_rng(3)
    c = rng.standard_normal((m, n)).astype(np.float32) if forms else None
    bias = rng.standard_normal((n,)).astype(np.float32) \
        if epi and "bias" in epi else None
    res = rng.standard_normal((m, n)).astype(np.float32) \
        if epi and "residual" in epi else None
    act = next((a for a in ("relu", "silu", "gelu") if epi and a in epi),
               None)
    cfg = tiling.stream_plan(m, n, k)
    assert cfg.split > 1
    kw = dict(kind=BF, ep=tep.Epilogue(bias=bias is not None, activation=act,
                                       residual=res is not None),
              bias=None if bias is None else torch.from_numpy(bias),
              residual=None if res is None else torch.from_numpy(res),
              out_dtype=torch.float32, **forms)
    ct = None if c is None else torch.from_numpy(c)
    got = tgemm.mma_gemm_splitk_plain(_bf(x), _bf(y), ct,
                                      k_slices=cfg.k_slices(k), **kw)
    unsplit = tgemm.mma_gemm_plain(_bf(x), _bf(y), ct, **kw)
    scale = unsplit.abs().max().item()
    torch.testing.assert_close(got, unsplit, rtol=1e-5, atol=1e-5 * scale)
    # the CPU path of the wrapper is the split-K plain version here
    assert torch.equal(tgemm.mma_gemm(_bf(x), _bf(y), ct, **kw), got)
    want = jgemm.mma_gemm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
        None if c is None else jnp.asarray(c), kind=jprec.Ger.BF16GER2,
        ep=jep.Epilogue(bias=bias is not None, activation=act,
                        residual=res is not None),
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res),
        out_dtype=jnp.float32, interpret=True, **forms)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(1, 768, 768, None), (16, 3072, 768, None),
                                   (1, 128, 1536, 4), (5, 999, 257, None)])
def test_splitk_plain_bf16_store_matches_pallas(shape):
    """Decode-shaped products (one row; whisper's decoder prefill; the
    SSD's batched M = 1 product; ragged K and N) stored in bf16."""
    m, k, n, b = shape
    x, y = _gemm_inputs(m + k + n, m, k, n, b)
    cfg = tiling.stream_plan(m, n, k, b or 1)
    got = tgemm.mma_gemm_splitk_plain(_bf(x), _bf(y), kind=BF,
                                      k_slices=cfg.k_slices(k),
                                      out_dtype=torch.bfloat16)
    want = jgemm.mma_gemm(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(y, jnp.bfloat16),
                          kind=jprec.Ger.BF16GER2, out_dtype=jnp.bfloat16,
                          interpret=True)
    _bf16_close(got.float().numpy(), np.asarray(want, np.float32))


def test_stream_plan_is_the_same_for_every_decode_batch():
    """A row's product must not depend on how many rows or products ride
    with it: the plan's K split (the slices that fix the sums' order) is
    the same for 1 to 8 rows and for a batch of 1 to 8 products; the tile
    is too, but where a 16-bit batch's 128-column tiles alone fill the
    card (4 and more products at N = 11008), which moves no bit."""
    for n, k in ((4096, 4096), (11008, 4096), (4096, 11008), (768, 768),
                 (102400, 4096), (3352, 768), (1536, 128), (4096, 64)):
        one = tiling.stream_plan(1, n, k)
        for m in range(1, 9):
            for b in range(1, 9):
                plan = tiling.stream_plan(m, n, k, b)
                assert plan.k_slices(k) == one.k_slices(k)
                assert plan == one or (
                    plan.bn == 128 and b * -(-n // 128) >= 2 * 132)


def test_k_slices_cover_k_in_order():
    for k in (1, 31, 32, 999, 4096, 11008):
        for split in {1, 2, 7, -(-k // tiling.STREAM_BK)}:
            sl = tiling.StreamConfig(128, split).k_slices(k)
            assert len(sl) == split and sl[0][0] == 0 and sl[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))


# ----------------------------------------------------------------------
# The split-KV plain merge
# ----------------------------------------------------------------------

def _attn_inputs(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("name,shape,kw", [
    ("cross", (2, 1, 300, 6, 6, 32), dict(causal=False)),
    ("gqa", (2, 1, 300, 8, 2, 32), dict(causal=False)),
    ("q_offset", (1, 64, 320, 4, 4, 32), dict(causal=True, q_offset=256)),
    ("window", (1, 16, 400, 4, 1, 32),
     dict(causal=True, q_offset=384, window=100)),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_splitkv_plain_matches_reference(name, shape, kw, dtype):
    b, sq, sk, h, kvh, d = shape
    q, k, v = _attn_inputs(sum(map(ord, name)), b, sq, sk, h, kvh, d)
    n_split, per = tattn.split_kv_plan(h, sq, sk)
    assert n_split > 1
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = np.asarray(jattn.ref_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        **kw), np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if dtype == "bf16":
        tq, tk, tv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    got = tattn.flash_attention_splitkv_plain(
        tq, tk, tv, n_split=n_split, per=per, out_dtype=torch.float32, **kw)
    assert torch.equal(tattn.mma_flash_attention(
        tq, tk, tv, out_dtype=torch.float32, **kw), got)   # the CPU path
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7 * float(np.abs(v).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_splitkv_plain_masked_splits_and_rows_are_exact_zeros():
    """Batch 0 has no valid slot at all (its rows must be exact zeros);
    batch 1's first split's KV blocks are invalid, so a whole split
    carries no live slot and must drop out of the merge."""
    b, sq, sk, h, kvh, d = 2, 1, 600, 6, 3, 32
    q, k, v = _attn_inputs(5, b, sq, sk, h, kvh, d)
    n_split, per = tattn.split_kv_plan(h, sq, sk)
    assert n_split > 1
    valid = np.ones((b, sk), bool)
    valid[0] = False
    valid[1, :per * tattn.BLOCK_K] = False
    want = np.asarray(jattn.ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        valid=jnp.asarray(valid)), np.float32)
    got = tattn.flash_attention_splitkv_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        n_split=n_split, per=per, causal=False, valid=torch.from_numpy(valid),
        out_dtype=torch.float32)
    assert bool((got[0] == 0).all()) and np.all(want[0] == 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_splitkv_plain_epilogue_matches_pallas():
    b, sq, sk, h, kvh, d = 1, 2, 272, 4, 4, 32
    q, k, v = _attn_inputs(8, b, sq, sk, h, kvh, d)
    rng = np.random.default_rng(9)
    bias = rng.standard_normal((d,)).astype(np.float32)
    res = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    n_split, per = tattn.split_kv_plan(h, sq, sk)
    assert n_split > 1
    want = jattn.mma_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        block_q=16, block_k=16,
        ep=jep.Epilogue(bias=True, activation="silu", residual=True),
        bias=jnp.asarray(bias), residual=jnp.asarray(res),
        out_dtype=jnp.float32, interpret=True)
    got = tattn.flash_attention_splitkv_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        n_split=n_split, per=per, causal=False,
        ep=tep.Epilogue(bias=True, activation="silu", residual=True),
        bias=torch.from_numpy(bias), residual=torch.from_numpy(res),
        out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("skip", [0, 11, 23])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rounding_budget_holds_split_kv_and_catches_a_skipped_block(
        dtype, skip):
    """At whisper's decode cross-attention (4, 1, 12, 64) over 1500
    positions: the split-KV plain version, which rounds P against each
    split's max, stays within ``rounding_budget`` of the plain version,
    which rounds the normalised P; the same merge with one of the 24 KV
    blocks left out (as a kernel that skipped it would compute) does
    not.  A row with no valid slot has a budget of 0."""
    b, sq, sk, h, d = 4, 1, 1500, 12, 64
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _attn_inputs(11 + skip, b, sq, sk, h, h, d))
    n_split, per = tattn.split_kv_plan(h, sq, sk)
    assert n_split > 1
    want = tattn.flash_attention_plain(q, k, v, causal=False,
                                       out_dtype=torch.float32)
    budget = tattn.rounding_budget(q, k, v, causal=False)
    got = tattn.flash_attention_splitkv_plain(
        q, k, v, n_split=n_split, per=per, causal=False,
        out_dtype=torch.float32)
    assert bool(((got - want).abs() <= budget).all())
    valid = torch.ones((b, sk), dtype=torch.bool)
    valid[:, skip * tattn.BLOCK_K:(skip + 1) * tattn.BLOCK_K] = False
    skipped = tattn.flash_attention_splitkv_plain(
        q, k, v, n_split=n_split, per=per, causal=False, valid=valid,
        out_dtype=torch.float32)
    assert bool(((skipped - want).abs() > budget).any())
    valid[0] = False
    assert bool((tattn.rounding_budget(q, k, v, causal=False,
                                       valid=valid)[0] == 0).all())
