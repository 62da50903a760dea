"""The GEMM's and attention's choice of kernel on the card, and the plain
versions of the split arithmetic those kernels run, on the CPU.

``core.tiling.choose_gemm_path`` is pinned on the shapes of the five
full-width runs (their weights' shapes are read from the port's own
``init_params`` with the allocations stubbed out); ``split_kv_plan`` on
whisper-small's decode cross-attention.  The split-K plain version is held
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
    assert path == "wgmma" and cfg.bm == 128 and cfg.bn in (128, 256)


def test_what_the_new_paths_do_not_take_stays_on_wmma():
    # whisper's prefill logits at large M: a 51865-column pitch TMA refuses
    assert tiling.choose_gemm_path(6000, 51865, 768, BF, 1, False)[0] == \
        "wmma"
    # ... which the weight stream takes at decode M (a scalar fringe path)
    assert tiling.choose_gemm_path(16, 51865, 768, BF, 1, False)[0] == \
        "stream"
    assert tiling.choose_gemm_path(4, 4096, 4096, tprec.Ger.F32GER)[0] == \
        "wmma"
    for m in (4, 300):
        path, cfg = tiling.choose_gemm_path(m, 256, 512, BF, 1, True,
                                            (64, 64, 64))
        assert path == "wmma" and cfg == tiling.BlockConfig(64, 64, 64)


def test_split_kv_plan_fills_the_card_at_whisper_cross_attention():
    b, h, sk = 4, 12, 1500                  # q (4, 1, 12, 64) over 1500
    n_split, per = tattn.split_kv_plan(b, h, 1, sk)
    nk = -(-sk // tattn.BLOCK_K)
    assert n_split * per >= nk and (n_split - 1) * per < nk
    assert tiling.NUM_SMS <= b * h * n_split <= FULL_GRID
    # prefill shapes and full grids do not split
    assert tattn.split_kv_plan(1, 32, 256, 256) == (1, 4)
    assert tattn.split_kv_plan(4, 12, 1500, 1500)[0] == 1
    assert tattn.split_kv_plan(4, 33, 1, 1500)[0] == 1


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
    with it: the plan (tile and K split) is the same for 1 to 8 rows and
    for a batch of 1 to 8 products."""
    for n, k in ((4096, 4096), (11008, 4096), (4096, 11008), (768, 768),
                 (102400, 4096), (3352, 768), (1536, 128), (4096, 64)):
        assert len({tiling.stream_plan(m, n, k, b) for m in range(1, 9)
                    for b in range(1, 9)}) == 1


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
    n_split, per = tattn.split_kv_plan(b, h, sq, sk)
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
    batch 1's first two KV blocks are invalid, so whole splits carry no
    live slot and must drop out of the merge."""
    b, sq, sk, h, kvh, d = 2, 1, 600, 6, 3, 32
    q, k, v = _attn_inputs(5, b, sq, sk, h, kvh, d)
    valid = np.ones((b, sk), bool)
    valid[0] = False
    valid[1, :128] = False
    n_split, per = tattn.split_kv_plan(b, h, sq, sk)
    assert n_split > 1 and per * tattn.BLOCK_K <= 128
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
    n_split, per = tattn.split_kv_plan(b, h, sq, sk)
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
    n_split, per = tattn.split_kv_plan(b, h, sq, sk)
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
