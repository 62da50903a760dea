"""The port's autotuned dispatch (``repro_torch.core.autotune``) on the CPU,
mirroring the reference's ``tests/test_autotune.py`` case for case where it
applies, and the port's own cases.

Mirrored: candidates are compiled configurations and include the
heuristic; the JSON cache round-trips with the reference's schema (plus
``path``/``split``), a miss and a stale or oversized entry read as None,
``force`` retunes; a corrupt cache degrades to the heuristic and heals; a
torn write under the ``autotune.save`` fault stays atomic and a failed
save leaves memory and disk consistent; a load fault degrades, a transient
one is retried, corrupt JSON is not retried; the tuned pick is never below
the heuristic under the prior; dispatch consults the cache.

The port's cases: a planted winner routes ``contract`` to its path (a spy
on the wrapper's one path choice), in GEMM, conv and attention; an
explicit ``Plan.block`` beats the winner; a winner the call cannot take
falls back to the heuristic, counted; a planted cache leaves a row's
result independent of the batch, for the weight stream's split and for
split-KV attention; ``cache_key`` strings are the reference's, with the
backend named by device; ``packing.plan_gemm_block`` takes explicit, then
winner, then heuristic, and a tuned prepacked dispatch repacks nothing.

Every test runs against a temporary cache (the autouse fixture plants
``autotune._DEFAULT_CACHE``): no test reads or writes the default path.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core.precision import Ger as JGer
from repro_torch.core import autotune, packing, tiling
from repro_torch.core import facility as tfac
from repro_torch.core.precision import Ger, policy
from repro_torch.kernels import mma_attention as tattn
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.kernels import ops
from repro_torch.roofline.analysis import gemm_projected_util
from repro_torch.runtime import faults

CPU = tfac.FacilityConfig(device="cpu")

SHAPES = [(128, 128, 128), (512, 512, 128), (100, 300, 130),
          (2048, 2048, 128), (33, 64, 257), (4, 4096, 11008),
          (1000000, 256, 512)]
KINDS = [Ger.BF16GER2, Ger.F32GER, Ger.I8GER4, Ger.F64GER, Ger.I4GER8]


@pytest.fixture(autouse=True)
def _hermetic_cache(tmp_path, monkeypatch):
    """Every test of this file dispatches against a fresh temporary cache,
    never the default path."""
    cache = autotune.AutotuneCache(tmp_path / "default.json")
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", cache)
    packing.clear_state()
    yield cache
    packing.clear_state()


def _rand(shape, seed, dtype=torch.float32):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def _spy_paths(monkeypatch):
    """Record the path of every product the GEMM wrapper chooses."""
    seen = []
    choose = tiling.choose_gemm_path

    def spy(*args, **kw):
        got = choose(*args, **kw)
        seen.append(got)
        return got
    monkeypatch.setattr(tiling, "choose_gemm_path", spy)
    return seen


def _plant(cache, kind, m, n, k, winner, b=1, ep="none"):
    key = autotune.cache_key(kind, autotune.tune_rows(kind, m), n, k, ep,
                             "cpu", b)
    cache.put(key, winner, source=autotune.PRIOR, score=0.0)
    return key


# ----------------------------------------------------------------------
# Mirrors of the reference's tests
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_candidates_are_compiled_configurations(kind, m, n, k):
    """The reference's "always fit VMEM": every candidate, hence every
    possible winner, is a configuration the port's kernels are compiled
    for and this shape can take."""
    cands = autotune.candidate_blocks(m, n, k, kind)
    assert cands
    for path, cfg in cands:
        assert tiling.takes((path, cfg), m, n, k, kind)
        if path == "stream":
            assert cfg.bn in (64, 128)
            assert 1 <= cfg.split <= -(-k // tiling.STREAM_BK)
        elif path == "wgmma":
            assert cfg in tiling.WGMMA_TILES
        elif path == "imma":
            assert cfg in tiling.imma_configs(m, n, k, kind)
        else:
            assert cfg in tiling.tiles_for(kind)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_candidates_include_heuristic(kind, m, n, k, aligned):
    heur = tiling.choose_gemm_path(m, n, k, kind, 1, aligned)
    assert heur in autotune.candidate_blocks(m, n, k, kind, 1, aligned)


def test_autotuned_is_cached_and_round_trips(tmp_path):
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    won = autotune.autotune(Ger.BF16GER2, 512, 512, 256, cache=cache,
                            backend="cpu")
    assert tiling.takes(won, 512, 512, 256, Ger.BF16GER2)
    blob = json.loads((tmp_path / "at.json").read_text())
    assert blob["version"] == autotune.CACHE_VERSION
    [(key, ent)] = blob["entries"].items()
    assert key == "xvbf16ger2|512x512x256|none|cpu"
    assert ent["path"] == won[0]
    assert ent["block"] == list(autotune.block_of(won))
    assert ent["source"] == autotune.PRIOR
    assert ent["score"] == pytest.approx(autotune.predicted_time(
        512, 512, 256, won, Ger.BF16GER2))
    fresh = autotune.AutotuneCache(tmp_path / "at.json")
    assert autotune.lookup(Ger.BF16GER2, 512, 512, 256, backend="cpu",
                           cache=fresh) == won
    # the weight stream's entry names its split
    won = autotune.autotune(Ger.BF16GER2, 4, 4096, 4096, cache=cache,
                            backend="cpu")
    ent = json.loads((tmp_path / "at.json").read_text())["entries"][
        "xvbf16ger2|8x4096x4096|none|cpu"]
    assert won[0] == ent["path"] == "stream"
    assert ent["split"] == won[1].split


def test_narrow_wgmma_winner_round_trips(tmp_path):
    """A winner on a 64-column wgmma tile reads back as the same
    configuration; every compiled wgmma tile is a candidate of an aligned
    prefill product, batched or not; K3's wgmma conv takes only the
    tiles it is compiled for."""
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    won = ("wgmma", tiling.WgmmaConfig(128, 64))
    key = _plant(cache, Ger.BF16GER2, 256, 4096, 11008, won)
    ent = json.loads((tmp_path / "at.json").read_text())["entries"][key]
    assert ent["path"] == "wgmma" and ent["block"] == [128, 64, 64]
    assert "split" not in ent
    fresh = autotune.AutotuneCache(tmp_path / "at.json")
    assert autotune.lookup(Ger.BF16GER2, 256, 4096, 11008, backend="cpu",
                           cache=fresh) == won
    for b in (1, 2):
        got = autotune.candidate_blocks(256, 4096, 11008, Ger.BF16GER2, b=b)
        assert {c for p, c in got if p == "wgmma"} == set(tiling.WGMMA_TILES)
    for cfg in tiling.WGMMA_TILES:
        want = ("wgmma", cfg) if cfg in tiling.CONV_WGMMA_TILES else None
        assert tiling.conv_tuned(("wgmma", cfg), Ger.BF16GER2) == want


def test_cache_miss_returns_none(tmp_path):
    cache = autotune.AutotuneCache(tmp_path / "empty.json")
    assert autotune.lookup(Ger.BF16GER2, 64, 64, 64, cache=cache) is None


def test_cache_rejects_oversized_stale_entry(tmp_path):
    """A tile the kernels were not built for, a split past K's stages, a
    stream winner at M > 64 or an entry with no path (the reference's
    format) reads as a miss."""
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    key = autotune.cache_key(Ger.BF16GER2, 64, 64, 64, backend="cpu")
    cache.put_raw(key, [4096, 4096, 1024], source="prior", score=0.0,
                  path="wmma")
    assert autotune.lookup(Ger.BF16GER2, 64, 64, 64, backend="cpu",
                           cache=cache) is None
    key = autotune.cache_key(Ger.BF16GER2, 8, 64, 64, backend="cpu")
    cache.put_raw(key, [64, 64, 32], source="prior", score=0.0,
                  path="stream", split=3)            # K = 64: 2 stages
    assert autotune.lookup(Ger.BF16GER2, 4, 64, 64, backend="cpu",
                           cache=cache) is None
    key = autotune.cache_key(Ger.BF16GER2, 256, 64, 64, backend="cpu")
    cache.put_raw(key, [64, 64, 32], source="prior", score=0.0,
                  path="stream", split=1)
    assert autotune.lookup(Ger.BF16GER2, 256, 64, 64, backend="cpu",
                           cache=cache) is None
    cache.put_raw(key, [128, 128, 32], source="traced", score=0.0)
    assert autotune.lookup(Ger.BF16GER2, 256, 64, 64, backend="cpu",
                           cache=cache) is None


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048])
def test_tuned_never_below_heuristic_on_bench_sweep(n, tmp_path):
    """The dgemm acceptance invariant, held under the H100 prior."""
    kind = Ger.BF16GER2
    pol = policy(kind)
    for m, k in ((n, 128), (4, n)):
        cache = autotune.AutotuneCache(tmp_path / f"at{m}.json")
        heur = tiling.choose_gemm_path(m, n, k, kind)
        tuned = autotune.autotune(kind, m, n, k, cache=cache, backend="cpu")
        assert gemm_projected_util(m, n, k, tuned[1], pol) >= \
            gemm_projected_util(m, n, k, heur[1], pol)


def test_tuned_beats_heuristic_on_fringe(tmp_path):
    """Where the heuristic's wgmma tile leaves most of the card idle (a
    196-row, 1024-column prefill: 16 tiles of 128 x 128) the prior ranks
    the 64 x 64 WMMA tile's 64 blocks ahead, and the tuner takes it: it
    strictly wins under the shared model."""
    kind = Ger.BF16GER2
    pol = policy(kind)
    m, n, k = 196, 1024, 4096
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    heur = tiling.choose_gemm_path(m, n, k, kind)
    tuned = autotune.autotune(kind, m, n, k, cache=cache, backend="cpu")
    assert heur[0] == "wgmma" and tuned != heur
    ut = gemm_projected_util(m, n, k, tuned[1], pol)
    uh = gemm_projected_util(m, n, k, heur[1], pol)
    assert ut > uh, (tuned, heur, ut, uh)


def test_dispatch_consults_cache(_hermetic_cache, monkeypatch):
    """ops._resolve_block and contract read the default cache: plant a
    distinctive winner and watch dispatch take it, with the winner's
    arithmetic (the weight stream's split K) on the CPU."""
    x = _rand((4, 512), 1, torch.bfloat16)
    y = _rand((512, 256), 2, torch.bfloat16)
    won = ("stream", tiling.StreamConfig(64, 8))
    _plant(_hermetic_cache, Ger.BF16GER2, 4, 256, 512, won)
    assert ops._resolve_block(x, y, Ger.BF16GER2, None) == \
        (tiling.STREAM_MAX_M, 64, tiling.STREAM_BK)
    assert ops._resolve_block(x, y, Ger.BF16GER2, (64, 64, 64)) == \
        (64, 64, 64)
    seen = _spy_paths(monkeypatch)
    with tfac.configure(CPU):
        got = tfac.contract("mk,kn->mn", x, y,
                            plan=tfac.Plan(out_dtype=tfac.ACC))
    assert seen == [won]
    want = tgemm.mma_gemm_splitk_plain(x, y, kind=Ger.BF16GER2,
                                       k_slices=won[1].k_slices(512))
    assert torch.equal(got, want)


def test_autotune_force_retunes(tmp_path):
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    key = autotune.cache_key(Ger.BF16GER2, 256, 256, 128, backend="cpu")
    pinned = ("wmma", tiling.BlockConfig(128, 128, 32))
    cache.put(key, pinned, source="prior", score=1e9)
    assert autotune.autotune(Ger.BF16GER2, 256, 256, 128, cache=cache,
                             backend="cpu") == pinned        # cache wins
    retuned = autotune.autotune(Ger.BF16GER2, 256, 256, 128, cache=cache,
                                backend="cpu", force=True)
    assert retuned != pinned


def _store_one(cache):
    key = autotune.cache_key(Ger.BF16GER2, 128, 128, 128, backend="cpu")
    cache.put(key, ("wmma", tiling.BlockConfig(64, 64, 64)),
              source="prior", score=1.0)
    return key


@pytest.mark.parametrize("garbage", [
    b"",                                   # empty file
    b"{\"version\": 3, \"entri",           # truncated mid-write
    b"not json at all \x00\xff",           # binary garbage
    b"[1, 2, 3]",                          # valid JSON, wrong shape
    b"{\"version\": 1, \"entries\": 7}",   # entries not a mapping
])
def test_corrupt_cache_degrades_to_heuristic_and_heals(tmp_path, garbage):
    path = tmp_path / "at.json"
    path.write_bytes(garbage)
    cache = autotune.AutotuneCache(path)
    assert len(cache) == 0
    assert autotune.lookup(Ger.BF16GER2, 128, 128, 128, backend="cpu",
                           cache=cache) is None
    key = _store_one(cache)
    blob = json.loads(path.read_text())
    assert blob["version"] == autotune.CACHE_VERSION
    assert key in blob["entries"]
    fresh = autotune.AutotuneCache(path)
    assert fresh.get(key) == ("wmma", tiling.BlockConfig(64, 64, 64))


def test_save_is_atomic_under_torn_write_fault(tmp_path):
    path = tmp_path / "at.json"
    cache = autotune.AutotuneCache(path)
    key = _store_one(cache)
    before = path.read_text()
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.AUTOTUNE_SAVE, kind=faults.TORN)])
    with faults.install(plan):
        cache.put(autotune.cache_key(Ger.F32GER, 64, 64, 64),
                  ("wmma", tiling.BlockConfig(64, 64, 16)),
                  source="prior", score=2.0)
    assert plan.fired(faults.AUTOTUNE_SAVE)
    assert path.read_text() == before
    assert not list(tmp_path.glob("*.tmp"))
    fresh = autotune.AutotuneCache(path)
    assert fresh.get(key) == ("wmma", tiling.BlockConfig(64, 64, 64))


def test_save_failure_keeps_memory_and_disk_consistent(tmp_path):
    path = tmp_path / "at.json"
    cache = autotune.AutotuneCache(path)
    key = _store_one(cache)
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.AUTOTUNE_SAVE, kind=faults.RAISE)])
    key2 = autotune.cache_key(Ger.F32GER, 64, 64, 64)
    won2 = ("wmma", tiling.BlockConfig(64, 64, 16))
    with faults.install(plan):
        cache.put(key2, won2, source="prior", score=2.0)   # must not raise
    assert cache.get(key2) == won2
    assert key2 not in json.loads(path.read_text())["entries"]
    assert not list(tmp_path.glob("*.tmp"))
    cache.put(autotune.cache_key(Ger.F64GER, 32, 32, 32),
              ("dmma", tiling.BlockConfig(64, 64, 16)), source="prior",
              score=3.0)
    blob = json.loads(path.read_text())
    assert key in blob["entries"] and key2 in blob["entries"]


def test_load_fault_degrades_like_corruption(tmp_path):
    path = tmp_path / "at.json"
    cache = autotune.AutotuneCache(path)
    key = _store_one(cache)
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.AUTOTUNE_LOAD, kind=faults.RAISE,
        every=1, max_fires=None)])
    victim = autotune.AutotuneCache(path)
    with faults.install(plan):
        assert victim.get(key) is None
    assert len(plan.fired(faults.AUTOTUNE_LOAD)) == \
        autotune.AutotuneCache.LOAD_RETRIES
    assert autotune.AutotuneCache(path).get(key) is not None


def test_load_transient_fault_is_retried_and_heals(tmp_path):
    path = tmp_path / "at.json"
    cache = autotune.AutotuneCache(path)
    key = _store_one(cache)
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.AUTOTUNE_LOAD, kind=faults.RAISE, max_fires=1)])
    victim = autotune.AutotuneCache(path)
    with faults.install(plan):
        assert victim.get(key) == ("wmma", tiling.BlockConfig(64, 64, 64))
    assert len(plan.fired(faults.AUTOTUNE_LOAD)) == 1


def test_load_corrupt_json_is_not_retried(tmp_path, monkeypatch):
    path = tmp_path / "at.json"
    path.write_bytes(b"{\"version\": 1, \"entri")
    sleeps = []
    monkeypatch.setattr(autotune.time, "sleep", lambda s: sleeps.append(s))
    cache = autotune.AutotuneCache(path)
    assert len(cache) == 0
    assert sleeps == []


# ----------------------------------------------------------------------
# The port's cases
# ----------------------------------------------------------------------

@pytest.mark.parametrize("m,winner", [
    (4, ("wmma", tiling.BlockConfig(128, 128, 32))),
    (4, ("stream", tiling.StreamConfig(128, 2))),
    (256, ("wgmma", tiling.WgmmaConfig(128, 256))),
    (256, ("wmma", tiling.BlockConfig(64, 64, 64)))])
def test_planted_winner_routes_contract_to_its_path(_hermetic_cache,
                                                    monkeypatch, m, winner):
    """A planted winner is the path the wrapper takes, through contract,
    with a fused epilogue keyed as the reference keys it."""
    k, n = 256, 384
    x = _rand((m, k), 3, torch.bfloat16)
    y = _rand((k, n), 4, torch.bfloat16)
    bias = _rand((n,), 5)
    _plant(_hermetic_cache, Ger.BF16GER2, m, n, k, winner, ep="bias")
    heur = tiling.choose_gemm_path(m, n, k, Ger.BF16GER2)
    seen = _spy_paths(monkeypatch)
    with tfac.configure(CPU):
        tfac.contract("mk,kn->mn", x, y, bias=bias)
        tfac.contract("mk,kn->mn", x, y)          # another key: heuristic
    assert seen == [winner, heur]


def test_explicit_block_beats_the_winner(_hermetic_cache, monkeypatch):
    x = _rand((4, 256), 6, torch.bfloat16)
    y = _rand((256, 384), 7, torch.bfloat16)
    _plant(_hermetic_cache, Ger.BF16GER2, 4, 384, 256,
           ("stream", tiling.StreamConfig(64, 4)))
    seen = _spy_paths(monkeypatch)
    with tfac.configure(CPU):
        tfac.contract("mk,kn->mn", x, y,
                      plan=tfac.Plan(block=(64, 64, 64)))
    assert seen == [("wmma", tiling.BlockConfig(64, 64, 64))]


def test_winner_the_call_cannot_take_falls_back_counted(_hermetic_cache,
                                                        monkeypatch):
    """A wgmma winner met by an unaligned pitch (N = 1001) and a stream
    winner met by a masked call run the heuristic, each counted once."""
    m, k, n = 256, 128, 1001
    heur = tiling.choose_gemm_path(m, n, k, Ger.BF16GER2, 1, False)
    seen = _spy_paths(monkeypatch)
    x = _rand((m, k), 8, torch.bfloat16)
    y = _rand((k, n), 9, torch.bfloat16)
    _plant(_hermetic_cache, Ger.BF16GER2, m, n, k,
           ("wgmma", tiling.WgmmaConfig(128, 128)))
    before = tgemm.mma_gemm.tuned_fallbacks
    with tfac.configure(CPU):
        tfac.contract("mk,kn->mn", x, y)
    assert tgemm.mma_gemm.tuned_fallbacks == before + 1
    assert seen[-1] == heur
    x4 = _rand((4, 256), 10, torch.bfloat16)
    y4 = _rand((256, 384), 11, torch.bfloat16)
    _plant(_hermetic_cache, Ger.BF16GER2, 4, 384, 256,
           ("stream", tiling.StreamConfig(64, 4)))
    ym = torch.from_numpy(np.random.default_rng(12).random(384) > 0.3)
    with tfac.configure(CPU):
        tfac.contract("mk,kn->mn", x4, y4, masks=(None, ym, None))
    assert tgemm.mma_gemm.tuned_fallbacks == before + 2
    assert seen[-1][0] == "wmma"


def test_planted_cache_keeps_a_row_independent_of_the_batch_stream(
        _hermetic_cache, monkeypatch):
    """The stream winner is keyed by the row bucket: decode rows at batch
    1 and batch 4 read one winner and run its split, so a row is summed in
    one order at both (an M-keyed winner would have split one batch and
    not the other).  On the CPU each runs the split plain version; the
    card test holds the bits (tests/test_torch_cuda.py)."""
    k, n = 512, 384
    x = _rand((4, k), 13, torch.bfloat16)
    y = _rand((k, n), 14, torch.bfloat16)
    won = ("stream", tiling.StreamConfig(64, 16))
    _plant(_hermetic_cache, Ger.BF16GER2, 4, n, k, won)
    assert autotune.tune_rows(Ger.BF16GER2, 1) == \
        autotune.tune_rows(Ger.BF16GER2, 4) == 8
    seen = _spy_paths(monkeypatch)
    plan = tfac.Plan(out_dtype=tfac.ACC)
    with tfac.configure(CPU):
        one = tfac.contract("mk,kn->mn", x[:1], y, plan=plan)
        four = tfac.contract("mk,kn->mn", x, y, plan=plan)
    assert seen == [won, won]
    for rows, got in ((x[:1], one), (x, four)):
        assert torch.equal(got, tgemm.mma_gemm_splitk_plain(
            rows, y, kind=Ger.BF16GER2, k_slices=won[1].k_slices(k)))


def test_f32ger_keys_decode_by_the_row_bucket_and_offers_stream_splits():
    """F32GER takes the weight stream at M <= 64 as the 16-bit families
    do: its winner is keyed by the row bucket, and its candidates are the
    stream's tiles and splits beside both fp32 tiles; at M > 64 its two
    fp32 tiles alone (no tensor-core tile)."""
    assert [autotune.tune_rows(Ger.F32GER, m) for m in (1, 4, 16, 17, 64,
                                                        65, 1024)] == \
        [8, 8, 16, 32, 64, 65, 1024]
    cands = autotune.candidate_blocks(4, 4096, 4096, Ger.F32GER)
    streams = {cfg for path, cfg in cands if path == "stream"}
    assert streams == {tiling.StreamConfig(bn, s) for bn in (64, 128)
                       for s in autotune.SPLIT_LADDER} | {
        tiling.choose_gemm_path(4, 4096, 4096, Ger.F32GER)[1]}
    assert {cfg for path, cfg in cands if path == "wmma"} == \
        set(tiling.tiles_for(Ger.F32GER))
    big = autotune.candidate_blocks(1024, 4096, 4096, Ger.F32GER)
    assert sorted(big, key=str) == sorted(
        [("wmma", t) for t in tiling.tiles_for(Ger.F32GER)], key=str)
    key = autotune.cache_key(Ger.F32GER, autotune.tune_rows(Ger.F32GER, 4),
                             4096, 4096, backend="cpu")
    assert key == "xvf32ger|8x4096x4096|none|cpu"


def test_planted_cache_keeps_an_f32ger_row_independent_of_the_batch_stream(
        _hermetic_cache, monkeypatch):
    """The F32GER mirror of the stream case above: a stream winner keyed
    by the row bucket, read at batch 1 and batch 4, runs its split at
    both, so a decode row is summed in one order."""
    k, n = 512, 384
    x = _rand((4, k), 17)
    y = _rand((k, n), 18)
    won = ("stream", tiling.StreamConfig(64, 8))
    _plant(_hermetic_cache, Ger.F32GER, 4, n, k, won)
    assert autotune.tune_rows(Ger.F32GER, 1) == \
        autotune.tune_rows(Ger.F32GER, 4) == 8
    seen = _spy_paths(monkeypatch)
    plan = tfac.Plan(ger=Ger.F32GER, out_dtype=torch.float32)
    with tfac.configure(CPU):
        one = tfac.contract("mk,kn->mn", x[:1], y, plan=plan)
        four = tfac.contract("mk,kn->mn", x, y, plan=plan)
    assert seen == [won, won]
    for rows, got in ((x[:1], one), (x, four)):
        assert torch.equal(got, tgemm.mma_gemm_splitk_plain(
            rows, y, kind=Ger.F32GER, k_slices=won[1].k_slices(k)))


def test_planted_cache_keeps_a_row_independent_of_the_batch_split_kv(
        _hermetic_cache, monkeypatch):
    """An attention winner is keyed by heads, not batch x heads: a
    one-query row runs the winner's split at batch 1 and batch 4 and is
    the same bits at both."""
    h, sk, d = 4, 640, 32
    q = _rand((4, 1, h, d), 15)
    kv = _rand((4, sk, h, d), 16)
    key = autotune.attn_cache_key(Ger.F32GER, h, 1, sk, d, backend="cpu")
    _hermetic_cache.put_raw(key, [64, 64], source="prior", score=0.0,
                            split=3)
    splits = []
    plain = tattn.flash_attention_splitkv_plain

    def spy(*a, n_split, per, **kw):
        splits.append(n_split)
        return plain(*a, n_split=n_split, per=per, **kw)
    monkeypatch.setattr(tattn, "flash_attention_splitkv_plain", spy)
    plan = tfac.Plan(ger=Ger.F32GER, out_dtype=torch.float32, causal=False)
    with tfac.configure(CPU):
        one = tfac.contract(tfac.ATTN, q[:1], kv[:1], kv[:1], plan=plan)
        four = tfac.contract(tfac.ATTN, q, kv, kv, plan=plan)
    assert splits == [3, 3]
    assert tattn.split_kv_plan(h, 1, sk)[0] != 3
    assert torch.equal(one[0], four[0])


def test_attention_winner_serves_every_mask_at_a_shape(_hermetic_cache,
                                                       monkeypatch):
    """The attention key holds (heads, Sq, Sk, D) and no mask or KV-head
    count, as the reference's: one winner serves a causal, a windowed, an
    unmasked and a grouped-query call at the shape alike."""
    h, sk, d = 4, 640, 32
    key = autotune.attn_cache_key(Ger.F32GER, h, 1, sk, d, backend="cpu")
    _hermetic_cache.put_raw(key, [64, 64], source="prior", score=0.0,
                            split=3)
    splits = []
    plain = tattn.flash_attention_splitkv_plain

    def spy(*a, n_split, per, **kw):
        splits.append(n_split)
        return plain(*a, n_split=n_split, per=per, **kw)
    monkeypatch.setattr(tattn, "flash_attention_splitkv_plain", spy)
    q = _rand((2, 1, h, d), 18)
    masks = [dict(causal=False), dict(causal=True, q_offset=sk - 1),
             dict(causal=True, q_offset=sk - 1, window=128)]
    before = tattn.mma_flash_attention.tuned_fallbacks
    with tfac.configure(CPU):
        for kvh, mask in [(h, m) for m in masks] + [(2, masks[1])]:
            kv = _rand((2, sk, kvh, d), 19)
            tfac.contract(tfac.ATTN, q, kv, kv, plan=tfac.Plan(
                ger=Ger.F32GER, out_dtype=torch.float32, **mask))
    assert splits == [3] * 4
    assert tattn.mma_flash_attention.tuned_fallbacks == before


def test_attention_winner_explicit_block_and_fallback(_hermetic_cache):
    """A 128-row winner for a call that splits KV is not a tile the kernel
    runs (the split-KV kernel has one 64-row q tile): lookup reads it as a
    miss; at a prefill shape the fp32 tile runs both tiles, so a 128-row
    winner is taken there; an explicit (64, 64) Plan.block is taken; a
    128-row block on a call that splits falls back, counted."""
    h, sq, sk, d = 2, 1, 640, 32
    key = autotune.attn_cache_key(Ger.F32GER, h, sq, sk, d, backend="cpu")
    _hermetic_cache.put_raw(key, [128, 64], source="prior", score=0.0,
                            split=2)
    assert autotune.lookup_attn(Ger.F32GER, h, sq, sk, d,
                                backend="cpu") is None
    key = autotune.attn_cache_key(Ger.F32GER, h, 128, 128, d, backend="cpu")
    _hermetic_cache.put_raw(key, [128, 64], source="prior", score=0.0,
                            split=1)
    assert autotune.lookup_attn(Ger.F32GER, h, 128, 128, d,
                                backend="cpu") == (128, 1)
    assert tattn.attn_plan(1, h, sq, sk, d, False, (64, None))[0] == 64
    q = _rand((1, sq, h, d), 17)
    kv = _rand((1, sk, h, d), 18)
    before = tattn.mma_flash_attention.tuned_fallbacks
    with tfac.configure(CPU):
        tfac.contract(tfac.ATTN, q, kv, kv, plan=tfac.Plan(
            ger=Ger.F32GER, out_dtype=torch.float32, block=(64, 64)))
        assert tattn.mma_flash_attention.tuned_fallbacks == before
        tfac.contract(tfac.ATTN, q, kv, kv, plan=tfac.Plan(
            ger=Ger.F32GER, out_dtype=torch.float32, block=(128, 64)))
    assert tattn.mma_flash_attention.tuned_fallbacks == before + 1


def test_autotune_attn_round_trip(_hermetic_cache):
    """On the CPU the attention search stores the prior's pick with its
    split, under a heads-keyed entry that lookup_attn reads back."""
    won = autotune.autotune_attn(Ger.BF16GER2, 12, 1, 1500, 64, b=4,
                                 causal=False, backend="cpu")
    assert won in autotune.attn_candidate_blocks(12, 1, 1500, 64,
                                                 Ger.BF16GER2)
    ent = _hermetic_cache.get_raw("xvbf16ger2|attn12x1x1500x64|none|cpu")
    assert ent["block"] == [won[0], tattn.BLOCK_K]
    assert ent["split"] == won[1] and ent["source"] == autotune.PRIOR
    assert autotune.lookup_attn(Ger.BF16GER2, 12, 1, 1500, 64,
                                backend="cpu") == won
    # the heuristic is among the candidates
    heur = tattn.attn_plan(4, 12, 1, 1500, 64, False)[:2]
    assert heur in autotune.attn_candidate_blocks(12, 1, 1500, 64,
                                                  Ger.BF16GER2)


def test_conv_consults_the_gemm_cache_at_ow_f_kwc(_hermetic_cache,
                                                  monkeypatch):
    """As the reference does, the conv consults the GEMM cache at (OW, F,
    KW*C) and applies the winner's filter tile where K3 has one: a WMMA
    winner 128 columns wide sends the bf16 conv to K3's WMMA tile; a
    winner K3 has no tile for (the 64-column WMMA tile) leaves the
    heuristic."""
    seen = []
    choose = tiling.choose_conv_path

    def spy(*a, **kw):
        got = choose(*a, **kw)
        seen.append(got)
        return got
    monkeypatch.setattr(tiling, "choose_conv_path", spy)
    img = _rand((1, 1, 40, 16), 18, torch.bfloat16)
    w = _rand((3, 16, 128), 19, torch.bfloat16) * 0.1
    ow = 40 - 3 + 1
    plan = tfac.Plan(out_dtype=torch.float32)
    with tfac.configure(CPU):
        tfac.contract(tfac.CONV1D, img[:, 0], w, plan=plan)
        _plant(_hermetic_cache, Ger.BF16GER2, ow, 128, 3 * 16,
               ("wmma", tiling.BlockConfig(128, 128, 32)))
        tfac.contract(tfac.CONV1D, img[:, 0], w, plan=plan)
        _plant(_hermetic_cache, Ger.BF16GER2, ow, 128, 3 * 16,
               ("wmma", tiling.BlockConfig(64, 64, 64)))
        tfac.contract(tfac.CONV1D, img[:, 0], w, plan=plan)
    assert [p for p, _ in seen] == ["wgmma", "wmma", "wgmma"]


def test_cache_key_matches_reference_format():
    for kind, jkind in ((Ger.BF16GER2, JGer.BF16GER2),
                        (Ger.F32GER, JGer.F32GER), (Ger.I8GER4, JGer.I8GER4)):
        for b in (1, 64):
            for ep in ("none", "bias+silu"):
                assert autotune.cache_key(kind, 256, 4096, 11008, ep,
                                          "cuda", b) == \
                    jautotune.cache_key(jkind, 256, 4096, 11008, ep,
                                        "cuda", b)
        assert autotune.attn_cache_key(kind, 32, 256, 256, 128, "none",
                                       "cuda") == \
            jautotune.attn_cache_key(jkind, 32, 256, 256, 128, "none",
                                     "cuda")
    assert autotune.cache_key(Ger.BF16GER2, 8, 64, 64, backend="cpu") \
        .endswith("|cpu")


def test_plan_gemm_block_order_and_panels_do_not_follow(_hermetic_cache):
    """packing.plan_gemm_block: explicit, then winner, then heuristic; a
    packed weight's panel is the kernels' whatever the winner, so a tuned
    prepacked dispatch repacks and demotes nothing and gives the natural
    tuned bits."""
    kind = Ger.BF16GER2
    heur = tiling.choose_gemm_path(4, 384, 256, kind)
    assert packing.plan_gemm_block(kind, 4, 384, 256, device="cpu") == \
        (heur[0], *heur[1].__dict__.values())
    won = ("wmma", tiling.BlockConfig(128, 128, 32))
    _plant(_hermetic_cache, kind, 4, 384, 256, won)
    assert packing.plan_gemm_block(kind, 4, 384, 256, device="cpu") == \
        ("wmma", 128, 128, 32)
    assert packing.plan_gemm_block(kind, 4, 384, 256, device="cpu",
                                   block=(64, 64, 64)) == \
        ("wmma", 64, 64, 64)
    x = _rand((4, 256), 20, torch.bfloat16)
    w = _rand((256, 384), 21, torch.bfloat16)
    po = packing.pack_gemm(w, packing.gemm_layout(kind, 256, 384))
    assert po.layout.block == packing.PANEL_BLOCK
    with tfac.configure(CPU):
        nat = tfac.contract("mk,kn->mn", x, w)
        base = dict(packing.COUNTERS)
        pk = tfac.contract("mk,kn->mn", x, po)
    assert torch.equal(nat, pk)
    assert dict(packing.COUNTERS) == base
