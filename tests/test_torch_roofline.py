"""The port's roofline models (``repro_torch.roofline.analysis``) against
the reference's (``repro.roofline.analysis``), on the CPU.

Held equal to the reference, where the two models coincide: the
hardware-free counts of ``gemm_traffic_bytes`` for a tile's (bm, bn, bk)
(each X panel once per N tile, each Y panel once per M tile, C once),
``attn_flops`` and ``attn_traffic_bytes`` (no split) over causal, window
and q_offset schedules, and ``model_flops_for`` for every arch at train,
prefill and decode shapes.

Where the port's per-path model differs, the difference is stated and
held: the weight stream reads X and the weight once and, with K split,
writes and reads back fp32 partials; a split-KV attention launch adds its
partials; the projected times charge whole waves of 132 SMs and move
bytes at the share of the card a small grid occupies, on H100 peaks.
"""

from __future__ import annotations

import pytest

from repro.configs import get as jget
from repro.core import precision as jprec
from repro.core import tiling as jtiling
from repro.roofline import analysis as janalysis
from repro_torch.configs import get as tget
from repro_torch.configs import ARCHS
from repro_torch.core import precision, tiling
from repro_torch.roofline import analysis

Ger = precision.Ger

KINDS = ("BF16GER2", "F32GER", "I8GER4", "F64GER", "I16GER2", "I4GER8")
BLOCKS = [(128, 128, 32), (64, 64, 64), (64, 64, 16), (128, 256, 64),
          (8, 128, 128)]
GEMM_SHAPES = [(4, 4096, 11008), (1024, 4096, 11008), (100, 300, 130),
               (1, 51865, 768)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("b", [1, 3])
def test_gemm_traffic_bytes_matches_reference(kind, m, n, k, b):
    pol, jpol = precision.policy(Ger[kind]), jprec.policy(jprec.Ger[kind])
    for blk in BLOCKS:
        got = analysis.gemm_traffic_bytes(m, n, k, tiling.BlockConfig(*blk),
                                          pol, b)
        want = janalysis.gemm_traffic_bytes(m, n, k,
                                            jtiling.BlockConfig(*blk),
                                            jpol, b)
        assert got == want, (blk, got, want)


def test_wgmma_tile_counts_as_its_k_step_tile():
    pol = precision.policy(Ger.BF16GER2)
    jpol = jprec.policy(jprec.Ger.BF16GER2)
    for bn in (128, 256):
        got = analysis.gemm_traffic_bytes(1024, 4096, 11008,
                                          tiling.WgmmaConfig(128, bn), pol)
        want = janalysis.gemm_traffic_bytes(
            1024, 4096, 11008, jtiling.BlockConfig(128, bn, 64), jpol)
        assert got == want


def test_stream_traffic_reads_the_weight_once_plus_partials():
    """The port's own count: X and W once, C once, and 8 bytes a partial
    element a split (written, then read by the reduction)."""
    pol = precision.policy(Ger.BF16GER2)
    m, n, k = 4, 4096, 11008
    one = analysis.gemm_traffic_bytes(m, n, k, tiling.StreamConfig(64, 1),
                                      pol)
    assert one == (m * k + k * n) * 2 + m * n * 4
    five = analysis.gemm_traffic_bytes(m, n, k, tiling.StreamConfig(64, 5),
                                       pol, b=2)
    assert five == 2 * one + 2 * 4 * 2 * 5 * m * n


_ATTN = [dict(causal=True), dict(causal=False),
         dict(causal=True, window=100), dict(causal=True, q_offset=37)]


@pytest.mark.parametrize("kw", _ATTN)
@pytest.mark.parametrize("sq,sk,bq,bk", [(256, 256, 128, 64),
                                         (1, 1500, 64, 64),
                                         (300, 700, 64, 64)])
def test_attn_counts_match_reference(kw, sq, sk, bq, bk):
    bh, d = 32, 128
    for kind in ("BF16GER2", "F32GER"):
        pol, jpol = (precision.policy(Ger[kind]),
                     jprec.policy(jprec.Ger[kind]))
        assert analysis.attn_flops(bh, sq, sk, d, bq, bk, **kw) == \
            janalysis.attn_flops(bh, sq, sk, d, bq, bk, **kw)
        assert analysis.attn_traffic_bytes(bh, sq, sk, d, bq, bk, pol,
                                           **kw) == \
            janalysis.attn_traffic_bytes(bh, sq, sk, d, bq, bk, jpol, **kw)
    # the port's split adds each split's fp32 (d + 2)-wide partial row,
    # written and read back
    split = analysis.attn_traffic_bytes(bh, sq, sk, d, bq, bk, pol,
                                        n_split=3, **kw)
    assert split - analysis.attn_traffic_bytes(bh, sq, sk, d, bq, bk, pol,
                                               **kw) == \
        2 * 4 * bh * sq * 3 * (d + 2)


def test_attn_prior_counts_the_steps_the_kernel_walks():
    """The port's own count: the 16-bit tile mode at D <= 128 walks steps
    of 128 keys aligned to multiples of 128 (``kv_step``), so the prior
    charges those: 6 steps a (b, h) for the 64-row tile's 4 q tiles at a
    causal 256 (1 + 1 + 2 + 2; 10 blocks of 64), each 64 x 128 x 128
    twice.  The fp32 tile, the padded 192 and split-KV keep 64."""
    pol = precision.policy(Ger.BF16GER2)
    f32 = precision.policy(Ger.F32GER)
    bh, s, d = 32, 256, 128
    flops = analysis.attn_flops(bh, s, s, d, 64, 128, causal=True)
    assert flops == 4.0 * bh * 6 * 64 * 128 * d
    nbytes = analysis.attn_traffic_bytes(bh, s, s, d, 64, 128, pol,
                                         causal=True)
    assert analysis.attn_projected_time(bh, s, s, d, 64, 64, pol,
                                        causal=True) == \
        analysis._waved_time(bh * 4, 1, flops, nbytes,
                             analysis.peak_flops(pol), analysis.H100)
    for p, dd, n_split in ((f32, d, 1), (pol, 192, 1), (pol, d, 2)):
        assert analysis.attn_projected_time(bh, s, s, dd, 64, 64, p,
                                            causal=True, n_split=n_split) == \
            analysis._waved_time(
                bh * 4 * n_split, 1,
                analysis.attn_flops(bh, s, s, dd, 64, 64, causal=True),
                analysis.attn_traffic_bytes(bh, s, s, dd, 64, 64, p,
                                            causal=True, n_split=n_split),
                analysis.peak_flops(p), analysis.H100)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_for_every_arch_matches_reference(arch):
    tcfg, jcfg = tget(arch), jget(arch)
    for kind in ("train", "prefill", "decode"):
        info = {"kind": kind, "batch": 4, "seq": 3000 if
                tcfg.is_enc_dec else 512}
        assert analysis.model_flops_for(tcfg, info) == \
            janalysis.model_flops_for(jcfg, info)
    if tcfg.is_enc_dec:
        assert analysis._encdec_split(tcfg) == janalysis._encdec_split(jcfg)


def test_projected_time_charges_whole_waves_on_h100_peaks():
    """132 SMs a wave: a 133-tile grid costs two waves of compute; a grid
    of a quarter of the card moves bytes at a quarter of 3.35 TB/s."""
    pol = precision.policy(Ger.BF16GER2)
    cfg = tiling.BlockConfig(128, 128, 32)
    tile = 2.0 * 128 * 128 * 4096
    t132 = analysis.gemm_projected_time(128, 128 * 132, 4096, cfg, pol)
    t133 = analysis.gemm_projected_time(128, 128 * 133, 4096, cfg, pol)
    assert t132 == pytest.approx(max(132 * tile / 989e12, analysis
                                     .gemm_traffic_bytes(128, 128 * 132,
                                                         4096, cfg, pol)
                                     / 3.35e12))
    assert t133 >= 2 * 132 * tile / 989e12
    f32 = precision.policy(Ger.F32GER)
    small = tiling.BlockConfig(64, 64, 16)
    nbytes = analysis.gemm_traffic_bytes(64, 64 * 33, 16, small, f32)
    assert analysis.gemm_projected_time(64, 64 * 33, 16, small, f32) == \
        pytest.approx(nbytes / (3.35e12 * 33 / 132))
    assert analysis.peak_flops(f32) == 67e12
    assert analysis.peak_flops(precision.policy(Ger.I16GER2)) == \
        1979e12 / 4


def test_prior_ranks_the_stream_ahead_of_the_tiles_at_decode():
    """At decode the weight stream's split grid fills the card and reads
    the weight once; the WMMA tiles leave most SMs idle: the prior ranks
    the heuristic's stream first, and projected utilisation stays <= 1."""
    kind = Ger.BF16GER2
    pol = precision.policy(kind)
    m, n, k = 4, 4096, 11008
    heur = tiling.choose_gemm_path(m, n, k, kind)
    t = {c: analysis.gemm_projected_time(m, n, k, c[1], pol)
         for c in (heur, ("wmma", tiling.BlockConfig(128, 128, 32)),
                   ("wmma", tiling.BlockConfig(64, 64, 64)))}
    assert min(t, key=t.get) == heur
    for c in t:
        assert 0 < analysis.gemm_projected_util(m, n, k, c[1], pol) <= 1


def test_roofline_terms_on_h100():
    terms = analysis.RooflineTerms(
        arch="deepseek-7b", shape="train_4k", mesh="1", chips=1,
        flops_per_chip=989e12, bytes_per_chip=3.35e12 * 2,
        collective_bytes_per_chip=0.0, model_flops=494.5e12)
    assert terms.t_compute == pytest.approx(1.0)
    assert terms.t_memory == pytest.approx(2.0)
    assert terms.bottleneck == "memory"
    assert terms.step_time_lower_bound == pytest.approx(2.0)
    assert terms.roofline_fraction == pytest.approx(0.25)
    assert terms.useful_flops_ratio == pytest.approx(0.5)
    assert terms.to_json()["bottleneck"] == "memory"
