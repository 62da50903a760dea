"""The port's CUDA kernels and serving path on the card.

These tests need an NVIDIA card (they skip elsewhere: a CUDA kernel has no
CPU mode) and import nothing of JAX, so they also run where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up the JAX package's autotune
cache.)  Each kernel is held against its plain version on the same inputs;
tolerances as in chip_smoke.py: f32 outputs within ``rtol=2e-5,
atol=2e-5 * max|ref|``, attention within ``2^-7 * max|v|`` plus one bf16 ulp
(the kernel rounds the unnormalised P per block, the plain version the
normalised P once) and, tighter, within each output's own rounding budget
(``mma_attention.rounding_budget``: at most ``2u * sum p|v|``) plus
``2^-20 * max|ref|``; the depthwise conv within ``rtol=1e-5, atol=1e-6 *
max|ref|`` for an f32 store (the same products summed in the same order;
only silu/gelu's exp/erf differ) and one ulp plus that for a 16-bit store;
the dense conv (K3) within one ulp of a 16-bit store at |ref| plus
``1e-5 * max|ref|`` (its fp32 sum runs in another order than the plain
version's single fp32 matmul, which can move an output near zero by more
than its own tiny ulp) and within ``1e-4 * max|ref|`` for an f32 store.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.base import reduced
from repro_torch.core import facility
from repro_torch.core import precision
from repro_torch.core import tiling
from repro_torch.kernels import epilogue as E
from repro_torch.kernels import mma_attention as A
from repro_torch.kernels import mma_conv as K
from repro_torch.kernels import mma_gemm as G
from repro_torch.launch import serve
from repro_torch.models import model as M

Ger = precision.Ger


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(chip_smoke.py and this file run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # true-fp32 plain versions
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _assert_f32_close(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-5,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("case", ["ragged", "batched", "forms", "f32ger",
                                  "epilogue"])
def test_gemm_kernel_matches_plain(gen, case):
    if case == "ragged":
        x, y, c = _randn(gen, 5, 999), _randn(gen, 999, 1001, scale=0.03), None
        kw = dict(kind=Ger.BF16GER2)
    elif case == "batched":
        x, y, c = (_randn(gen, 3, 77, 200), _randn(gen, 3, 200, 130,
                                                   scale=0.07), None)
        kw = dict(kind=Ger.BF16GER2)
    elif case == "forms":
        x, y = _randn(gen, 70, 256), _randn(gen, 256, 90, scale=0.06)
        c = _randn(gen, 70, 90, dtype=torch.float32)
        kw = dict(kind=Ger.BF16GER2, neg_product=True, neg_acc=True,
                  alpha=0.5, beta=-2.0)
    elif case == "f32ger":
        x = _randn(gen, 100, 300, dtype=torch.float32)
        y = _randn(gen, 300, 70, dtype=torch.float32, scale=0.05)
        c = _randn(gen, 100, 70, dtype=torch.float32)
        kw = dict(kind=Ger.F32GER, beta=0.5)
    else:
        x, y, c = _randn(gen, 300, 512), _randn(gen, 512, 260, scale=0.04), None
        kw = dict(kind=Ger.BF16GER2, block=(128, 128, 32),
                  ep=E.Epilogue(bias=True, activation="gelu", residual=True),
                  bias=_randn(gen, 260, dtype=torch.float32),
                  residual=_randn(gen, 300, 260, dtype=torch.float32))
    kw["out_dtype"] = torch.float32
    before = G.mma_gemm.launches
    got = G.mma_gemm(x, y, c, **kw)
    assert G.mma_gemm.launches == before + 1
    kw.pop("block", None)
    _assert_f32_close(got, G.mma_gemm_plain(x, y, c, **kw))


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=50),
                                dict(causal=True, q_offset=130),
                                dict(causal=False)])
def test_attention_kernel_matches_plain(gen, kw):
    """Batch 1's first 150 slots are invalid: under the plain causal mask
    its 70 query rows see no live slot and must be exact zeros."""
    q = _randn(gen, 2, 70, 8, 128)
    k, v = _randn(gen, 2, 200, 2, 128), _randn(gen, 2, 200, 2, 128)
    valid = torch.ones((2, 200), dtype=torch.bool, device="cuda")
    valid[1, :150] = False
    got = A.mma_flash_attention(q, k, v, valid=valid, out_dtype=torch.float32,
                                **kw)
    want = A.flash_attention_plain(q, k, v, valid=valid,
                                   out_dtype=torch.float32, **kw)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((got - want).abs() <= 2.0 ** -7 * v.float().abs().max()
                 + ulp).all())
    _assert_attn_close(got, want, A.rounding_budget(q, k, v, valid=valid,
                                                    **kw))
    if kw == dict(causal=True):
        assert bool((got[1] == 0).all())


def _assert_attn_close(got, want, budget):
    """f32 attention outputs within their rounding budget, plus 2^-20 *
    max|ref| for fp32 arithmetic in another order."""
    err = (got.float() - want.float()).abs()
    tol = budget + 2.0 ** -20 * want.float().abs().max()
    assert bool((err <= tol).all()), (err / tol).max()


def _assert_store_close(got, want, out_dtype):
    """f32 stores as _assert_f32_close; a 16-bit store within one ulp of
    its dtype at |ref| plus 1e-4 * max|ref| (fp32 sums in another order)."""
    if out_dtype == torch.float32:
        _assert_f32_close(got, want)
        return
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - (7 if out_dtype == torch.bfloat16 else 10))
    err = (got.float() - want).abs()
    assert bool((err <= ulp + 1e-4 * want.abs().max()).all()), err.max()


# (path, x shape, y shape, seed?, kwargs): each GEMM path at ragged M/N/K,
# batch, the accumulate forms, every epilogue and f16
_PATH_CASES = {
    "stream ragged unaligned": ("stream", (5, 999), (999, 1001), False,
                                dict(out_dtype=torch.float32)),
    "stream M=64 aligned": ("stream", (64, 1024), (1024, 776), False,
                            dict(out_dtype=torch.bfloat16)),
    "stream one split": ("stream", (3, 256), (256, 40000), False,
                         dict(out_dtype=torch.float32)),
    "stream batched M=1": ("stream", (4, 1, 64), (4, 64, 4096), False,
                           dict(out_dtype=torch.bfloat16)),
    "stream forms": ("stream", (40, 768), (768, 520), True,
                     dict(neg_product=True, neg_acc=True, alpha=0.5,
                          beta=-2.0, out_dtype=torch.float32)),
    "stream bias+gelu+res": ("stream", (16, 768), (768, 1000), False,
                             dict(ep=E.Epilogue(bias=True, activation="gelu",
                                                residual=True),
                                  out_dtype=torch.bfloat16)),
    "stream f16 silu": ("stream", (7, 512), (512, 300), False,
                        dict(kind=Ger.F16GER2, out_dtype=torch.float16,
                             ep=E.Epilogue(activation="silu"))),
    "wgmma ragged": ("wgmma", (300, 520), (520, 264), False,
                     dict(out_dtype=torch.float32)),
    "wgmma wide tiles": ("wgmma", (2100, 256), (256, 4096), False,
                         dict(out_dtype=torch.bfloat16)),
    "wgmma batched": ("wgmma", (3, 77, 200), (3, 200, 136), False,
                      dict(out_dtype=torch.float32)),
    "wgmma forms": ("wgmma", (130, 96), (96, 72), True,
                    dict(neg_product=True, alpha=-1.5, beta=0.25,
                         out_dtype=torch.float32)),
    "wgmma bias+relu+res": ("wgmma", (257, 384), (384, 200), False,
                            dict(ep=E.Epilogue(bias=True, activation="relu",
                                               residual=True),
                                 out_dtype=torch.bfloat16)),
    "wgmma f16 gelu": ("wgmma", (200, 128), (128, 96), False,
                       dict(kind=Ger.F16GER2, out_dtype=torch.float16,
                            ep=E.Epilogue(activation="gelu"))),
    # deepseek-moe-16b's expert banks, the 64 experts on the batch axis:
    # decode w1 (cap 1), a 256-token prefill's w2 (cap 30) and training's
    # w1 (4 x 512 tokens, cap 240) with the fused silu
    "stream expert bank decode w1": ("stream", (64, 1, 2048),
                                     (64, 2048, 1408), False,
                                     dict(out_dtype=torch.bfloat16,
                                          ep=E.Epilogue(activation="silu"))),
    "stream expert bank prefill w2": ("stream", (64, 30, 1408),
                                      (64, 1408, 2048), False,
                                      dict(out_dtype=torch.bfloat16)),
    "wgmma expert bank train w1": ("wgmma", (64, 240, 2048),
                                   (64, 2048, 1408), False,
                                   dict(out_dtype=torch.bfloat16,
                                        ep=E.Epilogue(activation="silu"))),
}


@pytest.mark.parametrize("name", sorted(_PATH_CASES))
def test_gemm_path_matches_plain(gen, name):
    path, xs, ys, seeded, kw = _PATH_CASES[name]
    kw = dict(kw)
    kind = kw.setdefault("kind", Ger.BF16GER2)
    dt = torch.float16 if kind == Ger.F16GER2 else torch.bfloat16
    x = _randn(gen, *xs, dtype=dt)
    y = _randn(gen, *ys, dtype=dt, scale=ys[-2] ** -0.5)
    out_shape = xs[:-1] + ys[-1:]
    c = _randn(gen, *out_shape, dtype=torch.float32) if seeded else None
    ep = kw.get("ep")
    if ep is not None and ep.bias:
        kw["bias"] = _randn(gen, ys[-1], dtype=torch.float32)
    if ep is not None and ep.residual:
        kw["residual"] = _randn(gen, *out_shape)
    before = dict(G.mma_gemm.launches_by_path)
    launches = G.mma_gemm.launches
    got = G.mma_gemm(x, y, c, **kw)
    assert G.mma_gemm.launches == launches + 1
    assert G.mma_gemm.launches_by_path[path] == before[path] + 1
    _assert_store_close(got, G.mma_gemm_plain(x, y, c, **kw),
                        kw["out_dtype"])
    # the same call again gives the same bits (no float atomics)
    assert torch.equal(G.mma_gemm(x, y, c, **kw), got)


@pytest.mark.parametrize("n,k", [(3352, 768), (768, 1536), (4096, 4096)])
def test_stream_rows_do_not_depend_on_the_batch(gen, n, k):
    """A row of the weight stream's product is the same bits at 1 and 4
    rows, and a product of a batch the same at batch 1 and batch 4 (the
    plan depends on neither): the per-slot decode handoff relies on it."""
    x, y = _randn(gen, 4, k), _randn(gen, k, n, scale=k ** -0.5)
    four = G.mma_gemm(x, y, out_dtype=torch.bfloat16)
    one = G.mma_gemm(x[2:3], y, out_dtype=torch.bfloat16)
    assert torch.equal(four[2:3], one)
    xb, yb = _randn(gen, 4, 1, 128), _randn(gen, 4, 128, n, scale=0.1)
    batch = G.mma_gemm(xb, yb, out_dtype=torch.bfloat16)
    single = G.mma_gemm(xb[1:2], yb[1:2], out_dtype=torch.bfloat16)
    assert torch.equal(batch[1:2], single)


# ----------------------------------------------------------------------
# F32GER's GEMM: the fp32 weight stream (M <= 64) and the fp32 tile
# ----------------------------------------------------------------------

def _tf32(t):
    """t rounded to TF32 (10 mantissa bits, to nearest)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _f32_tol(want):
    return 2e-5 * want.abs() + 2e-5 * want.abs().max()


def _assert_refuses_tf32(x, y, want, plain):
    """The TF32 control: the plain version on TF32-rounded operands lands
    outside the fp32 tolerance (max err/tol above 2) that the kernel met,
    so the check tells fp32 FMAs from a TF32 product."""
    ctrl = plain(_tf32(x), _tf32(y))
    assert ((ctrl - want).abs() / _f32_tol(want)).max().item() > 2


# name: (batch, (M, K, N), seed?, keywords): each row bucket, the M/K/N
# fringes and an unaligned N (the scalar paths: K % 4, N % 4), logits
# width (bn 128, one split), a batched bank, the accumulate forms and the
# epilogues
_F32_STREAM = {
    "bucket-1": (None, (1, 4096, 4096), False, {}),
    "bucket-8": (None, (4, 4096, 11008), False, {}),
    "bucket-16": (None, (16, 768, 3072), False, {}),
    "bucket-32": (None, (32, 1024, 1000), False, {}),
    "bucket-64": (None, (64, 2048, 1024), False, {}),
    "fringe-mkn": (None, (37, 202, 1001), False, {}),
    "k-fringe": (None, (5, 999, 1000), False, {}),
    "unaligned-n": (None, (4, 768, 51865), False, {}),
    "logits": (None, (4, 1024, 40000), False, {}),
    "batched": (3, (7, 200, 136), False, {}),
    "bank": (8, (3, 2048, 1408), False, {}),
    "forms": (None, (40, 768, 520), True,
              dict(neg_product=True, neg_acc=True, alpha=0.5, beta=-2.0)),
    "bias-gelu-res-bf16": (None, (16, 768, 1000), False,
                           dict(ep=E.Epilogue(bias=True, activation="gelu",
                                              residual=True),
                                out_dtype=torch.bfloat16)),
    "silu-seed-fringe": (None, (9, 130, 77), True,
                         dict(ep=E.Epilogue(activation="silu"), beta=0.5)),
}


def _f32_call(gen, b, m, k, n, seeded, kw):
    lead = () if b is None else (b,)
    x = _randn(gen, *lead, m, k, dtype=torch.float32)
    y = _randn(gen, *lead, k, n, dtype=torch.float32, scale=k ** -0.5)
    c = (_randn(gen, *lead, m, n, dtype=torch.float32) if seeded else None)
    kw = dict(kind=Ger.F32GER, **kw)
    kw.setdefault("out_dtype", torch.float32)
    ep = kw.get("ep")
    if ep is not None and ep.bias:
        kw["bias"] = _randn(gen, n, dtype=torch.float32)
    if ep is not None and ep.residual:
        kw["residual"] = _randn(gen, *lead, m, n, dtype=torch.float32)
    return x, y, c, kw


@pytest.mark.parametrize("name", sorted(_F32_STREAM))
def test_f32_stream_matches_splitk_plain(gen, name):
    """The fp32 weight stream (F32GER at M <= 64: true fp32 FMAs, never
    TF32) at every form against its split-K plain version (TF32 off),
    within the fp32 tolerance; the same call again the same bits (no float
    atomics); on a plain product the TF32 control is refused."""
    b, (m, k, n), seeded, kw = _F32_STREAM[name]
    x, y, c, kw = _f32_call(gen, b, m, k, n, seeded, kw)
    path, cfg = tiling.choose_gemm_path(m, n, k, Ger.F32GER, b or 1,
                                        G.natural_aligned(x, y))
    assert path == "stream"
    before = G.mma_gemm.launches_by_path["stream"]
    got = G.mma_gemm(x, y, c, **kw)
    assert G.mma_gemm.launches_by_path["stream"] == before + 1
    plain = G._plain_of(path, cfg, k)
    want = plain(x, y, c, **kw)
    _assert_store_close(got, want, kw["out_dtype"])
    assert torch.equal(G.mma_gemm(x, y, c, **kw), got)
    if c is None and "ep" not in kw:
        _assert_refuses_tf32(x, y, want,
                             lambda a, w: plain(a, w, None, **kw))


@pytest.mark.parametrize("n,k", [(11008, 4096), (4096, 4096), (768, 768),
                                 (51865, 768)])
def test_f32_stream_rows_do_not_depend_on_the_batch(gen, n, k):
    """A decode row of the fp32 stream is the same bits at batch 1 and
    batch 4, and at every M up to 64 (F32GER's plan does not read M), and
    a batched product's element the same at batch 1 and batch 4."""
    x = _randn(gen, 64, k, dtype=torch.float32)
    y = _randn(gen, k, n, dtype=torch.float32, scale=k ** -0.5)
    rows = {m: G.mma_gemm(x[:m], y, kind=Ger.F32GER) for m in (1, 4, 33, 64)}
    assert all(torch.equal(rows[m][:1], rows[1]) for m in rows)
    assert torch.equal(rows[4][2:3], rows[64][2:3])
    xb = _randn(gen, 4, 1, 128, dtype=torch.float32)
    yb = _randn(gen, 4, 128, n, dtype=torch.float32, scale=0.1)
    batch = G.mma_gemm(xb, yb, kind=Ger.F32GER)
    single = G.mma_gemm(xb[1:2], yb[1:2], kind=Ger.F32GER)
    assert torch.equal(batch[1:2], single)


# name: (batch, (M, K, N), seed?, explicit block, keywords): both tiles,
# ragged M/N/K, K % 4 (the element path of X), N % 4 (of Y), batched, the
# forms and the epilogues, a 16-bit store
_F32_TILE = {
    "128": (None, (1024, 512, 2176), False, None, {}),
    "128-explicit-ragged": (None, (300, 203, 1001), False, (128, 128, 16),
                            {}),
    "64": (None, (256, 1024, 1000), False, None, {}),
    "64-ragged": (None, (1000, 330, 1000), False, None, {}),
    "batched": (3, (130, 200, 140), False, (128, 128, 16), {}),
    "forms": (None, (130, 4096, 1100), True, (128, 128, 16),
              dict(neg_product=True, neg_acc=True, alpha=0.75, beta=-1.5)),
    "bias-gelu-res-bf16": (None, (257, 384, 200), False, None,
                           dict(ep=E.Epilogue(bias=True, activation="gelu",
                                              residual=True),
                                out_dtype=torch.bfloat16)),
    "k-below-one-step": (None, (300, 3, 500), False, None, {}),
}


@pytest.mark.parametrize("name", sorted(_F32_TILE))
def test_f32_tile_matches_plain(gen, name):
    """The fp32 tile (F32GER at M > 64, a register-blocked SIMT tile) at
    every form against ``mma_gemm_plain`` (TF32 off) within the fp32
    tolerance; its two tiles the same bits (each output one fmaf chain in
    ascending k from the seed or zero, whatever the tile); on a plain
    product the TF32 control is refused."""
    b, (m, k, n), seeded, block, kw = _F32_TILE[name]
    x, y, c, kw = _f32_call(gen, b, m, k, n, seeded, kw)
    before = G.mma_gemm.launches_by_path["wmma"]
    got = G.mma_gemm(x, y, c, block=block, **kw)
    assert G.mma_gemm.launches_by_path["wmma"] == before + 1
    want = G.mma_gemm_plain(x, y, c, **kw)
    _assert_store_close(got, want, kw["out_dtype"])
    tiles = [G.mma_gemm(x, y, c, block=t, **kw)
             for t in tiling.GEMM_TILES[Ger.F32GER]]
    assert all(torch.equal(t, got) for t in tiles)
    if c is None and "ep" not in kw and k >= 16:
        _assert_refuses_tf32(x, y, want, lambda a, w: G.mma_gemm_plain(
            a, w, None, **kw))


def test_split_k_products_on_two_streams(gen):
    """Split-K products enqueued on two streams at once each get their
    own partials and tickets: both equal the same products run alone."""
    x1, x2 = _randn(gen, 4, 4096), _randn(gen, 4, 11008)
    y1 = _randn(gen, 4096, 4096, scale=4096 ** -0.5)
    y2 = _randn(gen, 11008, 4096, scale=11008 ** -0.5)
    assert tiling.choose_gemm_path(4, 4096, 4096, Ger.BF16GER2)[1].split > 1
    alone = [G.mma_gemm(x1, y1), G.mma_gemm(x2, y2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (x, y) in enumerate(((x1, y1), (x2, y2))):
            with torch.cuda.stream(streams[i]):
                outs[i].append(G.mma_gemm(x, y))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, alone[i]) for o in outs[i])


# (q shape, k/v shape, dtype, flags): GQA, window, q_offset, valid, f16,
# D 32/64/128 on the prefill tile; Sq = 1 over 1500 slots on split-KV
_ATTN_CASES = {
    "gqa causal ragged": ((2, 200, 32, 128), (2, 200, 4, 128),
                          torch.bfloat16, dict(causal=True)),
    "window q tile 128": ((2, 700, 16, 64), (2, 700, 16, 64), torch.bfloat16,
                          dict(causal=True, window=150)),
    "q_offset": ((1, 100, 8, 128), (1, 356, 8, 128), torch.bfloat16,
                 dict(causal=True, q_offset=256)),
    "f16 D=32 full": ((3, 90, 4, 32), (3, 130, 4, 32), torch.float16,
                      dict(causal=False)),
    "cross Sq=1 Sk=1500": ((4, 1, 12, 64), (4, 1500, 12, 64),
                           torch.bfloat16, dict(causal=False)),
    "decode-like Sq=1 causal": ((2, 1, 8, 128), (2, 700, 2, 128),
                                torch.bfloat16,
                                dict(causal=True, q_offset=699)),
}


@pytest.mark.parametrize("name", sorted(_ATTN_CASES))
def test_attention_variants_match_plain(gen, name):
    qs, ks, dt, kw = _ATTN_CASES[name]
    q, k, v = (_randn(gen, *qs, dtype=dt), _randn(gen, *ks, dtype=dt),
               _randn(gen, *ks, dtype=dt))
    n_split, per = A.split_kv_plan(qs[2], qs[1], ks[1])
    assert (n_split > 1) == name.startswith(("cross", "decode"))
    got = A.mma_flash_attention(q, k, v, out_dtype=torch.float32, **kw)
    want = A.flash_attention_plain(q, k, v, out_dtype=torch.float32, **kw)
    assert bool(((got - want).abs() <= 2.0 ** -7 * v.float().abs().max()
                 + 1e-6).all())
    budget = A.rounding_budget(q, k, v, **kw)
    _assert_attn_close(got, want, budget)
    if n_split > 1:
        _assert_attn_close(got, A.flash_attention_splitkv_plain(
            q, k, v, n_split=n_split, per=per, out_dtype=torch.float32, **kw),
            budget)


@pytest.mark.parametrize("sq", [1, 70])
def test_attention_valid_epilogue_and_masked_rows(gen, sq):
    """Split-KV (Sq = 1) and the prefill tile (Sq = 70): batch 0 has no
    valid slot (its rows store exactly the epilogue of 0), batch 1 whole
    invalid KV blocks; bias + silu + residual fused into the store."""
    q = _randn(gen, 2, sq, 8, 64)
    k, v = _randn(gen, 2, 900, 4, 64), _randn(gen, 2, 900, 4, 64)
    valid = torch.ones((2, 900), dtype=torch.bool, device="cuda")
    valid[0] = False
    valid[1, 64:320] = False
    ep = E.Epilogue(bias=True, activation="silu", residual=True)
    bias = _randn(gen, 64, dtype=torch.float32)
    res = _randn(gen, 2, sq, 8, 64)
    kw = dict(causal=False, valid=valid, ep=ep, bias=bias, residual=res,
              out_dtype=torch.float32)
    got = A.mma_flash_attention(q, k, v, **kw)
    want = A.flash_attention_plain(q, k, v, **kw)
    assert bool(((got - want).abs() <= 2.0 ** -7 * v.float().abs().max()
                 + 1e-5).all())
    _assert_attn_close(got, want, A.rounding_budget(
        q, k, v, causal=False, valid=valid, ep=ep))
    zero = A.mma_flash_attention(q, k, v, causal=False, valid=valid,
                                 out_dtype=torch.float32)
    assert bool((zero[0] == 0).all())


@pytest.mark.parametrize("case", [
    # (image NHWC, KH, KW, stride, dtype, epilogue, out dtype)
    ((1, 1, 259, 4224), 1, 4, (1, 1), torch.float32, "bias+silu",
     torch.bfloat16),                                  # zamba2 prefill
    ((4, 1, 4, 1792), 1, 4, (1, 1), torch.float32, "bias+silu",
     torch.bfloat16),                                  # mamba2 decode
    ((2, 9, 37, 130), 3, 5, (2, 3), torch.float32, None, torch.float32),
    ((3, 1, 50, 77), 1, 4, (1, 2), torch.bfloat16, "bias", torch.float32),
    ((2, 5, 20, 33), 2, 3, (1, 1), torch.float16, "bias+gelu",
     torch.float16),
    ((2, 1, 30, 96), 1, 4, (1, 1), torch.float32, "residual",
     torch.float32),
])
def test_depthwise_kernel_matches_plain(gen, case):
    shape, kh, kw, stride, dtype, epi, od = case
    n, h, w, c = shape
    x = _randn(gen, *shape, dtype=dtype)
    taps = _randn(gen, kh, kw, c, dtype=dtype, scale=0.3)
    oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
    ep = bias = res = None
    if epi is not None:
        act = epi.split("+")[1] if "+" in epi else None
        ep = E.Epilogue(bias=epi.startswith("bias"), activation=act,
                        residual=epi == "residual")
        if ep.bias:
            bias = _randn(gen, c, dtype=torch.float32)
        if ep.residual:
            res = _randn(gen, n, oh, ow, c, dtype=torch.float32)
    kw_ = dict(stride=stride, out_dtype=od, ep=ep, bias=bias, residual=res)
    before = K.mma_depthwise_conv2d.launches
    got = K.mma_depthwise_conv2d(x, taps, **kw_)
    torch.cuda.synchronize()
    assert K.mma_depthwise_conv2d.launches == before + 1
    want = K.mma_depthwise_conv2d_plain(x, taps, **kw_)
    assert got.shape == want.shape == (n, oh, ow, c) and got.dtype == od
    scale = want.float().abs().max().item()
    tol = 1e-5 * want.float().abs() + 1e-6 * scale
    if od != torch.float32:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(1e-30))) - (7 if od ==
                                                      torch.bfloat16 else 10))
        tol = tol + ulp
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("case", [
    # (image NHWC, filters HWIO, stride, dtype, epilogue, out dtype, bf)
    ((2, 1, 302, 80), (1, 3, 80, 768), (1, 1), torch.bfloat16, "bias+gelu",
     torch.bfloat16, None),                        # whisper conv1
    ((2, 1, 301, 768), (1, 3, 768, 768), (1, 2), torch.bfloat16,
     "bias+gelu", torch.bfloat16, 128),            # whisper conv2, bf named
    ((1, 112, 84, 3), (14, 14, 3, 3584), (14, 14), torch.bfloat16, "bias",
     torch.bfloat16, None),                        # qwen2-vl patch embed
    ((2, 9, 13, 24), (3, 3, 24, 70), (1, 1), torch.float16, "residual",
     torch.float16, None),                         # ragged F and OW
    ((2, 8, 17, 5), (2, 3, 5, 33), (2, 3), torch.float32, "bias+relu",
     torch.float32, None),                         # F32GER, K fringe
])
def test_conv2d_kernel_matches_plain(gen, case):
    shape, fshape, stride, dtype, epi, od, bf = case
    n, h, w, c = shape
    kh, kw, _, f = fshape
    oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
    x = _randn(gen, *shape, dtype=dtype)
    filt = _randn(gen, *fshape, dtype=dtype, scale=(kh * kw * c) ** -0.5)
    ep = E.Epilogue(bias="bias" in epi, residual=epi == "residual",
                    activation=next((a for a in ("gelu", "relu")
                                     if a in epi), None))
    bias = _randn(gen, f, dtype=torch.float32) if ep.bias else None
    res = _randn(gen, n, oh, ow, f, dtype=od) if ep.residual else None
    kw_ = dict(stride=stride, out_dtype=od, ep=ep, bias=bias, residual=res)
    before = K.mma_conv2d.launches
    got = K.mma_conv2d(x, filt, bf=bf, **kw_)
    torch.cuda.synchronize()
    assert K.mma_conv2d.launches == before + 1
    want = K.mma_conv2d_plain(x, filt, **kw_)
    assert got.shape == want.shape == (n, oh, ow, f) and got.dtype == od
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    if od == torch.float32:
        tol = 1e-4 * scale
    else:
        bits = 7 if od == torch.bfloat16 else 10
        tol = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - bits) + 1e-5 * scale
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all())


def test_conv2d_kernel_refuses_strided_operands(gen):
    x = _randn(gen, 1, 8, 8, 16)
    w = _randn(gen, 3, 3, 16, 64)
    with pytest.raises(ValueError, match="contiguous"):
        K.mma_conv2d(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        K.mma_conv2d(x, w.transpose(0, 1))
    with pytest.raises(ValueError, match="filter tile"):
        K.mma_conv2d(x.float(), w.float(), bf=256)


# (image NHWC, filters HWIO, stride, dtype, epilogue, out dtype, path):
# K3's wgmma path at the main path's three stems (whisper's: the image
# panel by TMA, gathered in 16-byte copies on tiles across a clip boundary,
# the K = 240 fringe and the M = 6000 fringe; qwen2-vl's: 4-byte pairs with
# the K = 588 fringe on 256-wide tiles), a 1-D conv whose tiles all lie in
# one image, a 2-D conv gathered in 16-byte copies and an M fringe of one
# row in an F = 256 bank; and an f16 image with odd (j, c) runs, which
# neither copy gathers, on the WMMA tile
_CONV_PATH_CASES = {
    "whisper conv1": ((4, 1, 3002, 80), (1, 3, 80, 768), (1, 1),
                      torch.bfloat16, "bias+gelu", torch.bfloat16, "wgmma"),
    "whisper conv2": ((4, 1, 3001, 768), (1, 3, 768, 768), (1, 2),
                      torch.bfloat16, "bias+gelu", torch.bfloat16, "wgmma"),
    "qwen2-vl patch embed": ((4, 448, 448, 3), (14, 14, 3, 3584), (14, 14),
                             torch.bfloat16, "bias", torch.bfloat16,
                             "wgmma"),
    "M fringe F=256": ((3, 1, 45, 64), (1, 3, 64, 256), (1, 1),
                       torch.bfloat16, "residual", torch.float32, "wgmma"),
    "1-D tiles in one image": ((2, 1, 258, 64), (1, 3, 64, 128), (1, 1),
                               torch.bfloat16, "bias+gelu", torch.bfloat16,
                               "wgmma"),
    "2-D 16-byte gather": ((2, 12, 17, 32), (3, 3, 32, 96), (1, 1),
                           torch.bfloat16, "bias+gelu", torch.bfloat16,
                           "wgmma"),
    "odd runs f16": ((2, 9, 11, 5), (3, 3, 5, 72), (1, 2), torch.float16,
                     "bias+relu", torch.float16, "wmma"),
}


@pytest.mark.parametrize("name", sorted(_CONV_PATH_CASES))
def test_conv2d_chosen_path_matches_plain(gen, name):
    """Within one ulp of the output dtype (plus 1e-5 * max|ref|; 1e-4 *
    max|ref| for f32), and three launches give the same bits: a gathered
    panel that wgmma read before it landed would show as a difference."""
    shape, fshape, stride, dtype, epi, od, path = _CONV_PATH_CASES[name]
    n, h, w, c = shape
    kh, kw, _, f = fshape
    oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
    x = _randn(gen, *shape, dtype=dtype)
    filt = _randn(gen, *fshape, dtype=dtype, scale=(kh * kw * c) ** -0.5)
    ep = E.Epilogue(bias="bias" in epi, residual=epi == "residual",
                    activation=next((a for a in ("gelu", "relu")
                                     if a in epi), None))
    bias = _randn(gen, f, dtype=torch.float32) if ep.bias else None
    res = _randn(gen, n, oh, ow, f, dtype=od) if ep.residual else None
    kw_ = dict(stride=stride, out_dtype=od, ep=ep, bias=bias, residual=res)
    before = K.mma_conv2d.launches_by_path[path]
    outs = [K.mma_conv2d(x, filt, **kw_) for _ in range(3)]
    torch.cuda.synchronize()
    assert K.mma_conv2d.launches_by_path[path] == before + 3
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    want = K.mma_conv2d_plain(x, filt, **kw_).float()
    got = outs[0].float()
    scale = want.abs().max().item()
    if od == torch.float32:
        tol = 1e-4 * scale
    else:
        bits = 7 if od == torch.bfloat16 else 10
        tol = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - bits) + 1e-5 * scale
    assert got.shape == (n, oh, ow, f) and bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all())


# (image NHWC, KH, KW, stride, dtype, path): K4 at the main path's four
# shapes, the vector path at a ragged OW, with 2-D taps at stride 2 and
# with KW = 6, and the scalar path at channel counts no vector divides
_DW_PATH_CASES = {
    "zamba2 prefill": ((1, 1, 259, 4224), 1, 4, (1, 1), torch.float32,
                       "vector"),
    "zamba2 decode": ((4, 1, 4, 4224), 1, 4, (1, 1), torch.float32,
                      "vector"),
    "mamba2-130m prefill": ((1, 1, 259, 1792), 1, 4, (1, 1), torch.float32,
                            "vector"),
    "mamba2-130m decode": ((4, 1, 4, 1792), 1, 4, (1, 1), torch.float32,
                           "vector"),
    "bf16 ragged OW": ((2, 1, 30, 96), 1, 4, (1, 1), torch.bfloat16,
                       "vector"),
    "f16 2-D stride 2": ((2, 7, 19, 64), 2, 3, (2, 2), torch.float16,
                         "vector"),
    "f32 KW=6": ((1, 1, 40, 128), 1, 6, (1, 1), torch.float32, "vector"),
    "C=4227": ((2, 1, 30, 4227), 1, 4, (1, 1), torch.float32, "scalar"),
    "C=131 2-D bf16": ((2, 3, 11, 131), 2, 2, (1, 1), torch.bfloat16,
                       "scalar"),
    "C=77 stride 2": ((3, 1, 50, 77), 1, 4, (1, 2), torch.bfloat16,
                      "scalar"),
}


@pytest.mark.parametrize("name", sorted(_DW_PATH_CASES))
def test_depthwise_paths_match_plain(gen, name):
    """Bit for bit with no epilogue and an f32 store (the same products
    and sums, each rounded on its own, in the same order); with bias +
    silu and a bf16 store within the existing depthwise tolerance (the
    exp of silu may differ)."""
    shape, kh, kw, stride, dtype, path = _DW_PATH_CASES[name]
    n, h, w, c = shape
    x = _randn(gen, *shape, dtype=dtype)
    taps = _randn(gen, kh, kw, c, dtype=dtype, scale=0.3)
    before = K.mma_depthwise_conv2d.launches_by_path[path]
    got = K.mma_depthwise_conv2d(x, taps, stride=stride)
    torch.cuda.synchronize()
    assert K.mma_depthwise_conv2d.launches_by_path[path] == before + 1
    assert torch.equal(got, K.mma_depthwise_conv2d_plain(x, taps,
                                                         stride=stride))
    ep = E.Epilogue(bias=True, activation="silu")
    bias = _randn(gen, c, dtype=torch.float32)
    kw_ = dict(stride=stride, out_dtype=torch.bfloat16, ep=ep, bias=bias)
    got = K.mma_depthwise_conv2d(x, taps, **kw_).float()
    want = K.mma_depthwise_conv2d_plain(x, taps, **kw_).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    tol = 1e-5 * want.abs() + 1e-6 * want.abs().max() + ulp
    assert bool(((got - want).abs() <= tol).all())
    assert K.mma_depthwise_conv2d.launches_by_path[path] == before + 2


@pytest.mark.parametrize("name", ["whisper-small", "qwen2-vl-7b"])
def test_reduced_multimodal_prefill_and_decode_go_through_k3(gen, name):
    """A reduced whisper or qwen2-vl prefill and decode step on the kernel
    backend: the conv stem launches K3 (2 per whisper prefill, 1 per
    qwen2-vl prefill), and the prefill logits sit within 2e-2 (relative
    L2) of the eager torch backend's."""
    from repro_torch.data import pipeline
    cfg = reduced(get(name))
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    seq = 24 if cfg.is_enc_dec else 12
    batch = pipeline.device_batch(
        pipeline.synthetic_batch(cfg, batch=2, seq=seq, step=0), "cuda")
    if cfg.is_enc_dec:
        batch["tokens"] = batch["tokens"][:, :4]
    p = batch["tokens"].shape[1]
    logits = {}
    for backend in ("kernel", "torch"):
        with facility.configure(facility.FacilityConfig(device="cuda",
                                                        backend=backend)):
            K.mma_conv2d.launches = 0
            logits[backend], pre = M.prefill(model, batch, cfg)
            if backend == "kernel":
                assert K.mma_conv2d.launches == (2 if cfg.is_enc_dec else 1)
            cache = M.init_cache(cfg, 2, seq if cfg.is_enc_dec else seq + 4,
                                 device="cuda")
            cache["k"][:, :, :p] = pre["kv"][0]
            cache["v"][:, :, :p] = pre["kv"][1]
            cache["pos"][:p] = torch.arange(p, device="cuda")
            cache["cur"] = p
            if cfg.is_enc_dec:
                cache["cross_k"].copy_(pre["cross_kv"][0])
                cache["cross_v"].copy_(pre["cross_kv"][1])
            A.mma_flash_attention.launches = 0
            step, _ = M.decode_step(model, cache, batch["tokens"][:, -1:],
                                    cfg)
            if backend == "kernel" and cfg.is_enc_dec:
                # cross-attention over the encoder k/v, one per layer
                assert A.mma_flash_attention.launches == cfg.num_layers
            assert bool(torch.isfinite(step).all())
    rel = ((logits["kernel"] - logits["torch"]).norm()
           / logits["torch"].norm()).item()
    assert rel < 2e-2


def test_reduced_ssm_serve_goes_through_all_three_kernels(gen):
    cfg = reduced(get("zamba2-1.2b"))
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        G.mma_gemm.launches = A.mma_flash_attention.launches = 0
        K.mma_depthwise_conv2d.launches = 0
        out = serve.serve_loop(cfg, model, batch=2, prompt_len=16, gen_len=4,
                               n_requests=3)
        assert G.mma_gemm.launches > 0 and A.mma_flash_attention.launches > 0
        assert K.mma_depthwise_conv2d.launches > 0
    assert out["completed"] == 3


def test_reduced_serve_goes_through_both_kernels(gen):
    cfg = reduced(get("deepseek-7b"))
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        G.mma_gemm.launches = A.mma_flash_attention.launches = 0
        out = serve.serve_loop(cfg, model, batch=2, prompt_len=16, gen_len=4,
                               n_requests=3)
        assert G.mma_gemm.launches > 0 and A.mma_flash_attention.launches > 0
    assert out["completed"] == 3
    prompt = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                           device="cuda", dtype=torch.int32)
    logits = {}
    for backend in ("kernel", "torch"):
        with facility.configure(facility.FacilityConfig(device="cuda",
                                                        backend=backend)):
            logits[backend], _ = M.prefill(model, {"tokens": prompt}, cfg)
    rel = ((logits["kernel"] - logits["torch"]).norm()
           / logits["torch"].norm()).item()
    assert rel < 2e-2


# ----------------------------------------------------------------------
# Gradients: each wrapper's autograd.Function on the card
# ----------------------------------------------------------------------

# (path, x shape, y shape, kwargs): the forward's path; the backward's
# products take the paths their own shapes choose
_GRAD_CASES = {
    "stream seed alpha": ("stream", (8, 512), (512, 768),
                          dict(alpha=0.5, beta=-1.0, neg_acc=True,
                               seeded=True)),
    "wgmma bias silu residual": ("wgmma", (256, 384), (384, 512),
                                 dict(ep=E.Epilogue(bias=True,
                                                    activation="silu",
                                                    residual=True))),
    "wgmma batched gelu": ("wgmma", (2, 128, 256), (2, 256, 192),
                           dict(ep=E.Epilogue(activation="gelu"))),
    "wmma f32ger bias": ("wmma", (96, 160), (160, 80),
                         dict(kind=Ger.F32GER, ep=E.Epilogue(bias=True))),
}


def _flip_budget(dz):
    """Per element of an fp32 dZ, one bf16 ulp where dZ lies within
    2^-8 ulp of a bf16 rounding midpoint, else 0: where the card's and the
    CPU's Z, summed in other orders, may round dZ to bf16 apart."""
    r = dz.to(torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(dz.abs().clamp_min(1e-30))) - 7)
    return ulp * ((dz - r).abs() >= ulp / 2 * (1 - 2.0 ** -8))


@pytest.mark.parametrize("name", sorted(_GRAD_CASES))
def test_gemm_function_grads_match_cpu(gen, name):
    """dX, dY, dbias and the seed's gradient through the K1 Function on
    the card against the same Function on CPU copies (the plain versions),
    at the forward store's tolerance (_assert_store_close).  Under a fused
    activation dZ = dOut act'(Z) is cast to bf16 for the products, and Z
    comes from each device's own product: where dZ lies at a bf16
    midpoint the two may round it apart, so dX and dY also get that
    budget carried through the product (|flips| Y^T and X^T |flips|)."""
    path, xs, ys, kw = _GRAD_CASES[name]
    kw = dict(kw)
    kind = kw.setdefault("kind", Ger.BF16GER2)
    dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
    out_shape = xs[:-1] + ys[-1:]
    ops = {"x": _randn(gen, *xs, dtype=dt),
           "y": _randn(gen, *ys, dtype=dt, scale=ys[-2] ** -0.5)}
    if kw.pop("seeded", False):
        ops["c"] = _randn(gen, *out_shape, dtype=torch.float32)
    ep = kw.get("ep")
    if ep is not None and ep.bias:
        ops["bias"] = _randn(gen, ys[-1], dtype=torch.float32)
    if ep is not None and ep.residual:
        ops["residual"] = _randn(gen, *out_shape, dtype=dt)
    dout = _randn(gen, *out_shape, dtype=torch.float32)
    grads = []
    for device in ("cuda", "cpu"):
        leaves = {k: v.detach().to(device).requires_grad_(True)
                  for k, v in ops.items()}
        before = dict(G.mma_gemm.launches_by_path)
        out = G.mma_gemm(leaves["x"], leaves["y"], leaves.get("c"),
                         bias=leaves.get("bias"),
                         residual=leaves.get("residual"),
                         out_dtype=torch.float32, **kw)
        if device == "cuda":
            assert G.mma_gemm.launches_by_path[path] == before[path] + 1
        out.backward(dout.to(device))
        grads.append({k: v.grad for k, v in leaves.items()})
    budget = {}
    if ep is not None and ep.activation is not None and dt != torch.float32:
        x, y = (ops[k].cpu().float() for k in ("x", "y"))
        b = ops.get("bias")
        z = torch.matmul(x, y) + (b.cpu() if b is not None else 0)
        z.requires_grad_(True)
        dz, = torch.autograd.grad(E.ACTIVATIONS[ep.activation](z), z,
                                  dout.cpu())
        flips = _flip_budget(dz)
        budget = {"x": torch.matmul(flips, y.abs().transpose(-1, -2)),
                  "y": torch.matmul(x.abs().transpose(-1, -2), flips)}
    bad = []
    for k, g in grads[0].items():
        assert g.dtype == ops[k].dtype
        want = grads[1][k].float()
        err = (g.cpu().float() - want).abs()
        if g.dtype == torch.float32:
            tol = 2e-5 * want.abs() + 2e-5 * want.abs().max()
        else:
            tol = (torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(1e-30))) - 7)
                + 1e-4 * want.abs().max())
        tol = tol + budget.get(k, 0)
        if not bool((err <= tol).all()):
            bad.append((k, float(err.max()), float((err / tol).max())))
    assert not bad, bad


def test_attention_and_depthwise_backward_match_torch_lowering(gen):
    """K2's and K4's Functions: the kernel forward, the backward through
    the torch lowering's recomputation, against autograd through the
    torch lowering itself on the card."""
    from repro_torch.core import lowering
    q = _randn(gen, 2, 80, 8, 64).requires_grad_(True)
    k = _randn(gen, 2, 80, 2, 64).requires_grad_(True)
    v = _randn(gen, 2, 80, 2, 64).requires_grad_(True)
    launches = A.mma_flash_attention.launches
    out = A.mma_flash_attention(q, k, v, causal=True, window=50,
                                out_dtype=torch.float32)
    assert A.mma_flash_attention.launches == launches + 1
    dout = _randn(gen, *out.shape, dtype=torch.float32)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(lowering.torch_attention(
        q, k, v, causal=True, window=50, q_offset=0, valid=None,
        out_dtype=torch.float32), (q, k, v), dout)
    assert A.mma_flash_attention.launches == launches + 1   # backward: none
    for g, w in zip(got, want):
        _assert_f32_close(g, w)

    image = _randn(gen, 2, 1, 259, 4224, dtype=torch.float32)
    taps = _randn(gen, 1, 4, 4224, dtype=torch.float32, scale=0.1)
    bias = _randn(gen, 4224, dtype=torch.float32)
    ep = E.Epilogue(bias=True, activation="silu")
    leaves = [t.requires_grad_(True) for t in (image, taps, bias)]
    launches = K.mma_depthwise_conv2d.launches
    out = K.mma_depthwise_conv2d(*leaves[:2], ep=ep, bias=leaves[2])
    assert K.mma_depthwise_conv2d.launches == launches + 1
    dout = _randn(gen, *out.shape, dtype=torch.float32)
    got = torch.autograd.grad(out, leaves, dout)
    want = torch.autograd.grad(E.apply(lowering.torch_conv(
        leaves[0], leaves[1], (1, 1), True, torch.float32), ep,
        bias=leaves[2]), leaves, dout)
    for g, w in zip(got, want):
        _assert_f32_close(g, w)


def test_attention_row_does_not_depend_on_the_batch(gen):
    """One query row of split-KV attention (whisper's cross-attention
    shape) at batch 1 against the same row inside batches of 4 and 8:
    within its rounding budget (the plan reads no batch, so the row is
    summed in the same order; the kernel may differ from the plain
    version only by its rounding)."""
    q = _randn(gen, 8, 1, 12, 64)
    k, v = _randn(gen, 8, 1500, 12, 64), _randn(gen, 8, 1500, 12, 64)
    assert A.split_kv_plan(12, 1, 1500)[0] > 1
    one = A.mma_flash_attention(q[:1], k[:1], v[:1], causal=False,
                                out_dtype=torch.float32)
    budget = A.rounding_budget(q[:1], k[:1], v[:1], causal=False)
    for b in (4, 8):
        many = A.mma_flash_attention(q[:b], k[:b], v[:b], causal=False,
                                     out_dtype=torch.float32)
        _assert_attn_close(many[:1], one, budget)


# ----------------------------------------------------------------------
# Mixture of experts
# ----------------------------------------------------------------------

def _moe_layer(gen):
    """Reduced deepseek-moe-16b's MoE layer (bf16 weights drawn on the
    CPU) and an input (4, 64, d): T = 256 tokens, cap 80, one choice
    drops."""
    from repro_torch.models import moe as MOE
    cfg = reduced(get("deepseek-moe-16b"))
    layer = MOE.init_moe(torch.Generator().manual_seed(0), cfg,
                         device="cpu", dtype=torch.bfloat16)
    x = _randn(gen, 4, 64, cfg.d_model)
    return cfg, layer, x


def test_moe_layer_on_the_card_is_deterministic_and_matches_cpu(gen):
    """apply_moe on the card: the same bits twice, forward and backward
    (no gradient sums in the order of atomics), and within 2e-2 relative
    L2 of the same layer's CPU run (the kernels' plain versions)."""
    import copy

    from repro_torch.models import moe as MOE
    cfg, layer, x = _moe_layer(gen)
    card = copy.deepcopy(layer).to("cuda")
    with facility.configure(facility.FacilityConfig(device="cuda")):
        G.mma_gemm.launches = 0
        a, aux_a = MOE.apply_moe(card, x, cfg)
        b, aux_b = MOE.apply_moe(card, x, cfg)
        # router, the three banks and the shared MLP's three, per call
        assert G.mma_gemm.launches == 2 * 7
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    for p in card.parameters():
        p.requires_grad_(True)
    xg = x.detach().requires_grad_(True)
    leaves = [xg] + list(card.parameters())
    grads = []
    for _ in range(2):
        with facility.configure(facility.FacilityConfig(device="cuda")):
            out, aux = MOE.apply_moe(card, xg, cfg)
            loss = out.float().square().mean() + aux
            grads.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(g, h) for g, h in zip(*grads))
    with facility.configure(facility.FacilityConfig(device="cpu")):
        want, aux_w = MOE.apply_moe(layer, x.cpu(), cfg)
    rel = ((a.cpu().float() - want.float()).norm()
           / want.float().norm()).item()
    assert rel < 2e-2
    assert abs(aux_a.item() - aux_w.item()) <= 1e-5


def test_moe_layer_forward_makes_no_host_sync(gen):
    """One forward apply_moe under CUDA's sync debug mode "error": no
    step of the routing, dispatch, banks or combine reads a value back to
    the host."""
    from repro_torch.models import moe as MOE
    cfg, layer, x = _moe_layer(gen)
    layer = layer.to("cuda")
    with facility.configure(facility.FacilityConfig(device="cuda")):
        MOE.apply_moe(layer, x, cfg)          # builds and loads the kernels
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, aux = MOE.apply_moe(layer, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out).all()) and aux.item() > 0


# ---- the rest of K1's family table: the IMMA and DMMA kernels -----------

def _ints(gen, lo, hi, *shape, dtype):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda").to(
        dtype)


_INT_RANGES = {Ger.I8GER4: ((-128, 128, torch.int8), (0, 256, torch.uint8)),
               Ger.I4GER8: ((-128, 128, torch.int8), (-128, 128, torch.int8)),
               Ger.I16GER2: ((-32768, 32768, torch.int16),
                             (-32768, 32768, torch.int16))}


def _int_operands(gen, kind, lead, m, k, n):
    (xl, xh, xd), (yl, yh, yd) = _INT_RANGES[kind]
    kp = k // 2 if kind == Ger.I4GER8 else k
    return (_ints(gen, xl, xh, *lead, m, kp, dtype=xd),
            _ints(gen, yl, yh, *lead, kp, n, dtype=yd))


_INT_CASES = {
    "ragged": ((), (37, 100, 45), {}),
    "aligned": ((), (256, 1024, 384), {}),
    "batched": ((3,), (77, 200, 130), {}),
    "forms": ((), (70, 256, 90), dict(neg_product=True, neg_acc=True,
                                      alpha=3.7, beta=-2.5, seed=True)),
    "epilogue": ((2,), (33, 96, 40), dict(relu=True, seed=True)),
}


@pytest.mark.parametrize("case", sorted(_INT_CASES))
@pytest.mark.parametrize("kind", sorted(_INT_RANGES, key=str))
def test_imma_kernel_bit_exact(gen, kind, case):
    """The IMMA kernel against its plain version (exact products, wrapped
    to int32) bit for bit, full-range operands included (I16GER2 wraps),
    on the imma path, and the same bits on a second launch."""
    lead, (m, k, n), opts = _INT_CASES[case]
    opts = dict(opts)
    x, y = _int_operands(gen, kind, lead, m, k, n)
    c = (_ints(gen, -2 ** 31, 2 ** 31 - 1, *lead, m, n, dtype=torch.int32)
         if opts.pop("seed", False) else None)
    kw = dict(kind=kind, **opts)
    if kw.pop("relu", False):
        kw.update(ep=E.Epilogue(bias=True, activation="relu", residual=True),
                  bias=_ints(gen, -1000, 1000, n, dtype=torch.int32),
                  residual=_ints(gen, -1000, 1000, *lead, m, n,
                                 dtype=torch.int32))
    before = G.mma_gemm.launches_by_path["imma"]
    got = G.mma_gemm(x, y, c, **kw)
    assert G.mma_gemm.launches_by_path["imma"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, G.mma_gemm_plain(x, y, c, **kw))
    assert torch.equal(G.mma_gemm(x, y, c, **kw), got)


def test_i16ger2_kernel_wraps(gen):
    x = torch.full((16, 64), -32768, dtype=torch.int16, device="cuda")
    y = torch.full((64, 16), -32768, dtype=torch.int16, device="cuda")
    got = G.mma_gemm(x, y, kind=Ger.I16GER2)
    # 64 * 2**30 = 2**36 wraps to 0 modulo 2**32
    assert torch.equal(got, torch.zeros_like(got))
    y[0] = 1
    assert torch.equal(G.mma_gemm(x, y, kind=Ger.I16GER2),
                       G.mma_gemm_plain(x, y, kind=Ger.I16GER2))


def test_i4ger8_matches_i8ger4_on_unpacked_operands(gen):
    """I4GER8 on packed nibbles against I8GER4 on the same values
    unpacked (Y's nibbles kept in 0..7 so that they are uint8 too)."""
    from repro_torch.kernels import ref as R
    x = _ints(gen, -128, 128, 130, 96, dtype=torch.int8)
    lo = _ints(gen, 0, 8, 96, 150, dtype=torch.int8)
    hi = _ints(gen, 0, 8, 96, 150, dtype=torch.int8)
    y = lo | (hi << 4)
    yu = R.unpack_int4(y.transpose(0, 1)).transpose(0, 1)
    got = G.mma_gemm(x, y, kind=Ger.I4GER8)
    want = G.mma_gemm(R.unpack_int4(x), yu.to(torch.uint8).contiguous(),
                      kind=Ger.I8GER4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["ragged", "batched", "forms", "epilogue"])
def test_dmma_kernel_matches_plain(gen, case):
    """F64GER on the DMMA kernel against the float64 plain version within
    1e-15 * K * max|x| max|y| (fp64 sums in another order)."""
    lead, (m, k, n) = {"ragged": ((), (37, 301, 45)),
                       "batched": ((3,), (77, 200, 130)),
                       "forms": ((), (70, 256, 90)),
                       "epilogue": ((2,), (65, 128, 66))}[case]
    x = torch.randn(*lead, m, k, generator=gen, device="cuda",
                    dtype=torch.float64)
    y = torch.randn(*lead, k, n, generator=gen, device="cuda",
                    dtype=torch.float64)
    kw, c = dict(kind=Ger.F64GER), None
    if case == "forms":
        c = torch.randn(m, n, generator=gen, device="cuda",
                        dtype=torch.float64)
        kw.update(neg_product=True, neg_acc=True, alpha=0.5, beta=-2.0)
    if case == "epilogue":
        kw.update(ep=E.Epilogue(bias=True, activation="gelu", residual=True),
                  bias=torch.randn(n, generator=gen, device="cuda",
                                   dtype=torch.float64),
                  residual=torch.randn(*lead, m, n, generator=gen,
                                       device="cuda", dtype=torch.float64))
    before = G.mma_gemm.launches_by_path["dmma"]
    got = G.mma_gemm(x, y, c, **kw)
    assert G.mma_gemm.launches_by_path["dmma"] == before + 1
    want = G.mma_gemm_plain(x, y, c, **kw)
    bound = 1e-15 * k * x.abs().max().item() * y.abs().max().item()
    assert (got - want).abs().max().item() <= bound
    assert torch.equal(G.mma_gemm(x, y, c, **kw), got)


def test_new_kernels_raise_on_build_or_launch_failure(gen, monkeypatch,
                                                      tmp_path):
    """A kernel that does not build, or a launch the kernel refuses,
    raises; nothing falls back to the plain version or counts a launch."""
    from repro_torch.kernels import _build
    x = _ints(gen, -128, 128, 8, 64, dtype=torch.int8)
    y = _ints(gen, 0, 256, 64, 8, dtype=torch.uint8)
    G.mma_gemm(x, y, kind=Ger.I8GER4)                    # builds, loads
    lib, fn = G._FNS["gemm_imma"]
    out = torch.empty((8, 8), dtype=torch.int32, device="cuda")
    rc = fn(x.data_ptr(), y.data_ptr(), None, None, None,   # no masks
            None, None, None, out.data_ptr(),
            7, 3, 1, 8, 8, 64, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0,
            torch.cuda.current_stream().cuda_stream, 0)  # family 7: refused
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, rc, "gemm_imma")
    monkeypatch.setattr(G, "_FNS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    launches = G.mma_gemm.launches
    for kind, xx, yy in ((Ger.I8GER4, x, y),
                         (Ger.F64GER, x.double(), y.double())):
        with pytest.raises(RuntimeError, match="build failed"):
            G.mma_gemm(xx, yy, kind=kind)
    assert G.mma_gemm.launches == launches


def test_family_paths_through_contract(gen):
    """contract with the new families, qdot, dft and complex_gemm on the
    card launch the IMMA / DMMA kernels (dft and complex_gemm: four
    launches a call) and agree with the torch backend."""
    from repro_torch.core import quant
    from repro_torch.kernels import blas3
    G.mma_gemm.launches_by_path = dict.fromkeys(G.PATHS, 0)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        x = torch.randn(6, 256, generator=gen, device="cuda")
        w = torch.randn(256, 96, generator=gen, device="cuda") * 0.05
        wq, ws = quant.quantize_weight(w)
        got = quant.qdot(x, wq, ws)
        want = quant.qdot(x, wq, ws, backend="torch")
        assert torch.equal(got, want)
        assert G.mma_gemm.launches_by_path["imma"] == 1
        xs = torch.randn(2, 64, 5, generator=gen, device="cuda",
                         dtype=torch.float64)
        before = G.mma_gemm.launches
        re, im = blas3.dft(xs)
        assert G.mma_gemm.launches == before + 4
        assert G.mma_gemm.launches_by_path["dmma"] == 4
        fft = torch.fft.fft(xs, dim=-2)
        assert (re - fft.real).abs().max().item() < 1e-9
        assert (im - fft.imag).abs().max().item() < 1e-9
        ar, ai, br, bi = (torch.randn(40, 48, generator=gen, device="cuda")
                          for _ in range(4))
        before = G.mma_gemm.launches
        blas3.complex_gemm(ar, ai, br.T.contiguous(), bi.T.contiguous())
        assert G.mma_gemm.launches == before + 4


# ----------------------------------------------------------------------
# Prepacked operands (K1d, K3's packed filter stream): each packed mode
# bit for bit against the natural launch on the same path
# ----------------------------------------------------------------------

def _packed_y(w, batched=False):
    from repro_torch.core import packing
    k, n = w.shape[-2:]
    lay = packing.gemm_layout(Ger.BF16GER2, k, n, batched=batched)
    return packing.pack_gemm(w, lay)


def _same_path_bits(natural, packed, path):
    before = dict(G.mma_gemm.launches_by_path)
    want = natural()
    got = packed()
    torch.cuda.synchronize()
    assert G.mma_gemm.launches_by_path[path] == before[path] + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (4, 4096, 11008),
                                   (4, 200, 1000), (30, 1408, 2048),
                                   (4, 2048, 102400), (16, 768, 51865)])
def test_packed_stream_bitwise(gen, m, k, n):
    """The weight stream on packed Y panels: split and unsplit K, BN = 64
    and 128, K and N fringes (200 x 1000; whisper's N = 51865, which the
    natural launch reads on its scalar path)."""
    x = _randn(gen, m, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    po = _packed_y(w)
    bias = _randn(gen, n, dtype=torch.float32)
    ep = E.Epilogue(bias=True, activation="silu")
    _same_path_bits(
        lambda: G.mma_gemm(x, w, ep=ep, bias=bias,
                           out_dtype=torch.bfloat16),
        lambda: G.mma_gemm(x, po.data, ep=ep, bias=bias,
                           out_dtype=torch.bfloat16, y_layout=po.layout),
        "stream")


@pytest.mark.parametrize("m,k,n", [(1, 2048, 1408), (1, 1408, 2048),
                                   (3, 200, 136)])
def test_packed_stream_batched_bitwise(gen, m, k, n):
    """deepseek-moe's expert banks at decode: b = 64 batched products on
    packed (B, gn, gk, 64, 64) panels."""
    x = _randn(gen, 64, m, k)
    w = _randn(gen, 64, k, n, scale=k ** -0.5)
    po = _packed_y(w, batched=True)
    _same_path_bits(lambda: G.mma_gemm(x, w),
                    lambda: G.mma_gemm(x, po.data, y_layout=po.layout),
                    "stream")


@pytest.mark.parametrize("b,m,k,n", [(None, 256, 4096, 4096),
                                     (None, 1024, 4096, 11008),
                                     (None, 300, 200, 1000),
                                     (64, 120, 2048, 1408)])
def test_packed_wgmma_bitwise(gen, b, m, k, n):
    """The wgmma tile on a 4-D (5-D batched) map of packed panels: BN =
    128 and 256, K and N fringes, the MoE banks at prefill."""
    lead = () if b is None else (b,)
    x = _randn(gen, *lead, m, k)
    w = _randn(gen, *lead, k, n, scale=k ** -0.5)
    po = _packed_y(w, batched=b is not None)
    c = _randn(gen, *lead, m, n, dtype=torch.float32)
    _same_path_bits(
        lambda: G.mma_gemm(x, w, c, alpha=0.5, beta=2.0),
        lambda: G.mma_gemm(x, po.data, c, alpha=0.5, beta=2.0,
                           y_layout=po.layout),
        "wgmma")


@pytest.mark.parametrize("m", [4, 1024])
def test_packed_imma_x_bitwise(gen, m):
    """The IMMA kernel on packed X panels (I8GER4, qdot's orientation:
    W^T (N, K) int8 from (gm, gk, 128, 64) panels) against the natural
    W^T, the int32 accumulator bit for bit; and qdot through contract."""
    from repro_torch.core import packing, quant
    k, n = 4096, 11008
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.05
    wq, ws = quant.quantize_weight(w)
    lay = packing.gemm_layout(Ger.I8GER4, n, k, side="x", transposed=True)
    po = packing.pack_gemm(wq, lay, scale=ws,
                           col_sum=wq.to(torch.int32).sum(0).float())
    xq = torch.randint(0, 256, (k, m), generator=gen, device="cuda",
                       dtype=torch.int32).to(torch.uint8)
    kw = dict(kind=Ger.I8GER4)
    _same_path_bits(lambda: G.mma_gemm(wq.T.contiguous(), xq, **kw),
                    lambda: G.mma_gemm(po.data, xq, x_layout=po.layout, **kw),
                    "imma")
    x = torch.randn(m, k, generator=gen, device="cuda")
    with facility.configure(facility.FacilityConfig(device="cuda")):
        packing.clear_state()
        assert torch.equal(quant.qdot(x, wq, ws), quant.qdot(x, po))
        assert packing.COUNTERS["demote"] == 0


def test_packed_panels_demote_where_the_path_reads_none(gen):
    """No path demotes: an explicit block's WMMA tile, F64GER's DMMA
    kernel (Y panels, and X and Y panels at once) and F32GER's conv on
    the fp32 tile read their panels (K1d, K3), each a packed launch bit
    for bit the natural one, and the wrapper demotes nothing."""
    from repro_torch.core import packing
    x = _randn(gen, 100, 256)
    w = _randn(gen, 256, 136, scale=256 ** -0.5)
    po = _packed_y(w)
    packing.clear_state()
    _same_path_bits(lambda: G.mma_gemm(x, w, block=(64, 64, 64)),
                    lambda: G.mma_gemm(x, po.data, block=(64, 64, 64),
                                       y_layout=po.layout), "wmma")
    p64 = _packed_like(w.double(), Ger.F64GER)
    px64 = packing.pack_gemm(x.double(), packing.gemm_layout(
        Ger.F64GER, 100, 256, side="x"))
    packed = G.mma_gemm.packed_launches_by_path["dmma"]
    _same_path_bits(lambda: G.mma_gemm(x.double(), w.double(),
                                       kind=Ger.F64GER),
                    lambda: G.mma_gemm(x.double(), p64.data, kind=Ger.F64GER,
                                       y_layout=p64.layout), "dmma")
    _same_path_bits(lambda: G.mma_gemm(x.double(), w.double(),
                                       kind=Ger.F64GER),
                    lambda: G.mma_gemm(px64.data, p64.data, kind=Ger.F64GER,
                                       x_layout=px64.layout,
                                       y_layout=p64.layout), "dmma")
    assert G.mma_gemm.packed_launches_by_path["dmma"] == packed + 2
    img = torch.randn(1, 8, 8, 4, generator=gen, device="cuda")
    wc = torch.randn(3, 3, 4, 72, generator=gen, device="cuda")
    pc = packing.pack_conv(wc, packing.conv_layout(Ger.F32GER, 3, 3, 4, 72))
    before = K.mma_conv2d.launches_by_path["f32"]
    want = K.mma_conv2d(img, wc)
    got = K.mma_conv2d(img, pc.data, w_layout=pc.layout)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.mma_conv2d.launches_by_path["f32"] == before + 2
    assert [e for e in packing.EVENTS if e["event"] == "demote"] == []
    assert packing.COUNTERS["demote"] == 0


@pytest.mark.parametrize("name", ["whisper-conv2", "qwen2-vl-patch"])
def test_packed_conv_bitwise(gen, name):
    """K3's wgmma kernel on the packed (gf, KH, KW, C, 64) stream at the
    stems' shapes: whisper's conv2 (k3 s2 over 3000 frames, TMA-read patch
    rows) and qwen2-vl's 14 x 14 patch embed (gathered), bias + gelu."""
    from repro_torch.core import packing
    if name == "whisper-conv2":
        x = _randn(gen, 4, 1, 3002, 768)
        w = _randn(gen, 1, 3, 768, 768, scale=(3 * 768) ** -0.5)
        stride, nd = (1, 2), 1
    else:
        x = _randn(gen, 4, 448, 448, 3)
        w = _randn(gen, 14, 14, 3, 3584, scale=588 ** -0.5)
        stride, nd = (14, 14), 2
    kh, kw, c, f = w.shape
    lay = packing.conv_layout(Ger.BF16GER2, kh, kw, c, f, nd=nd)
    po = packing.pack_conv(w[0] if nd == 1 else w, lay)
    bias = _randn(gen, f, dtype=torch.float32)
    ep = E.Epilogue(bias=True, activation="gelu")
    before = K.mma_conv2d.launches_by_path["wgmma"]
    want = K.mma_conv2d(x, w, stride=stride, ep=ep, bias=bias,
                        out_dtype=torch.bfloat16)
    got = K.mma_conv2d(x, po.data, stride=stride, ep=ep, bias=bias,
                       out_dtype=torch.bfloat16, w_layout=po.layout)
    torch.cuda.synchronize()
    assert K.mma_conv2d.launches_by_path["wgmma"] == before + 2
    assert torch.equal(got, want)


def test_reduced_prepacked_serve_matches_natural(gen):
    """A reduced deepseek-7b served prepacked on the card: no demote, no
    repack, and the natural run's launches by path."""
    from repro_torch.core import packing
    cfg = reduced(get("deepseek-7b"))
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    settings = dict(batch=2, prompt_len=16, gen_len=4, n_requests=3)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        G.mma_gemm.launches_by_path = dict.fromkeys(G.PATHS, 0)
        nat = serve.serve_loop(cfg, model, **settings)
        by_path = dict(G.mma_gemm.launches_by_path)
        packing.prepack_params_for_serving(model, min_size=1024)
        base = dict(packing.COUNTERS)
        G.mma_gemm.launches_by_path = dict.fromkeys(G.PATHS, 0)
        pk = serve.serve_loop(cfg, model, **settings)
    assert dict(packing.COUNTERS) == base
    assert G.mma_gemm.launches_by_path == by_path
    assert nat["completed"] == pk["completed"] == 3


# ----------------------------------------------------------------------
# K1b: the pm* masked forms on the WMMA, IMMA and DMMA kernels
# ----------------------------------------------------------------------

_MASKED_CASES = {
    "fringe": ((), (37, 100, 45), False),
    "aligned": ((), (256, 1024, 384), False),
    "decode": ((), (4, 512, 1000), False),
    "batched_seed": ((3,), (77, 200, 130), True),
}
_MASKED_KINDS = {Ger.BF16GER2: "wmma", Ger.F16GER2: "wmma",
                 Ger.F32GER: "wmma", Ger.I8GER4: "imma",
                 Ger.I16GER2: "imma", Ger.F64GER: "dmma"}


def _lane_masks(gen, m, n, k):
    """Row, column and rank predicates with about 30% of the lanes off."""
    return tuple(torch.rand(s, generator=gen, device="cuda") > 0.3
                 for s in (m, n, k))


@pytest.mark.parametrize("case", sorted(_MASKED_CASES))
@pytest.mark.parametrize("kind", sorted(_MASKED_KINDS, key=str))
def test_masked_kernel_matches_plain(gen, kind, case):
    """Each masked kernel against its plain version (which selects the same
    lanes), integers bit for bit; a float family's disabled rows, columns
    and ranks hold NaN and Inf, which must leave no trace: the output is
    finite, exactly 0 on disabled rows and columns (no seed), and the
    caller's operands come back untouched."""
    lead, (m, k, n), seeded = _MASKED_CASES[case]
    pol = precision.policy(kind)
    if pol.is_integer:
        x, y = _int_operands(gen, kind, lead, m, k, n)
        c = (_ints(gen, -2 ** 31, 2 ** 31 - 1, *lead, m, n, dtype=torch.int32)
             if seeded else None)
    else:
        x = torch.randn(*lead, m, k, generator=gen, device="cuda").to(
            pol.x_dtype)
        y = (torch.randn(*lead, k, n, generator=gen, device="cuda")
             * 0.05).to(pol.y_dtype)
        c = (torch.randn(*lead, m, n, generator=gen, device="cuda").to(
            pol.acc_dtype) if seeded else None)
    xm, ym, pm = _lane_masks(gen, m, n, k)
    if not pol.is_integer:
        x[..., ~xm, :] = float("nan")
        x[..., ~pm] = float("inf")
        y[..., ~pm, :] = float("nan")
        y[..., ~ym] = float("-inf")
    x0, y0 = x.clone(), y.clone()
    path = _MASKED_KINDS[kind]
    before = (G.mma_gemm.launches_by_path[path],
              G.mma_gemm.masked_launches_by_path[path])
    got = G.mma_gemm(x, y, c, kind=kind, masks=(xm, ym, pm))
    assert (G.mma_gemm.launches_by_path[path],
            G.mma_gemm.masked_launches_by_path[path]) == (before[0] + 1,
                                                         before[1] + 1)
    want = G.mma_gemm_plain(x, y, c, kind=kind, masks=(xm, ym, pm))
    assert torch.equal(x.nan_to_num(), x0.nan_to_num())
    assert torch.equal(y.nan_to_num(), y0.nan_to_num())
    if pol.is_integer:
        assert torch.equal(got, want)
    elif kind == Ger.F64GER:
        assert bool(torch.isfinite(got).all())
        xs, ys = G.select_masks(x, y, (xm, ym, pm))
        bound = 1e-15 * k * xs.abs().max().item() * ys.abs().max().item()
        assert (got - want).abs().max().item() <= bound
    else:
        assert bool(torch.isfinite(got).all())
        _assert_f32_close(got, want)
    if not seeded:
        assert bool((got[..., ~xm, :] == 0).all())
        assert bool((got[..., ~ym] == 0).all())
    assert torch.equal(G.mma_gemm(x, y, c, kind=kind, masks=(xm, ym, pm)),
                       got)


def test_masked_i4ger8_column_predicate(gen):
    """I4GER8 takes a column predicate in the IMMA kernel: bit for bit its
    plain version, and I8GER4 on the unpacked operands with the same
    predicate."""
    from repro_torch.kernels import ref as R
    x = _ints(gen, -128, 128, 130, 48, dtype=torch.int8)
    lo = _ints(gen, 0, 8, 48, 150, dtype=torch.int8)
    hi = _ints(gen, 0, 8, 48, 150, dtype=torch.int8)
    y = lo | (hi << 4)
    ym = torch.rand(150, generator=gen, device="cuda") > 0.3
    got = G.mma_gemm(x, y, kind=Ger.I4GER8, masks=(None, ym, None))
    assert torch.equal(got, G.mma_gemm_plain(x, y, kind=Ger.I4GER8,
                                             masks=(None, ym, None)))
    yu = R.unpack_int4(y.transpose(0, 1)).transpose(0, 1)
    want = G.mma_gemm(R.unpack_int4(x), yu.to(torch.uint8).contiguous(),
                      kind=Ger.I8GER4, masks=(None, ym, None))
    assert torch.equal(got, want)


def test_masked_contract_on_every_backend(gen):
    """contract(masks=) on the kernel, torch and ref backends agree on the
    card: F32GER within the f32 tolerance, I8GER4 bit for bit."""
    m, k, n = 100, 300, 70
    xm, ym, pm = _lane_masks(gen, m, n, k)
    cfg = facility.FacilityConfig(ger=Ger.F32GER, out_dtype=torch.float32)
    x = torch.randn(m, k, generator=gen, device="cuda")
    y = torch.randn(k, n, generator=gen, device="cuda")
    xi, yi = _int_operands(gen, Ger.I8GER4, (), m, k, n)
    with facility.configure(cfg):
        outs = {b: facility.contract("mk,kn->mn", x, y, masks=(xm, ym, pm),
                                     plan=facility.Plan(backend=b))
                for b in ("kernel", "torch", "ref")}
        ints = {b: facility.contract(
            "mk,kn->mn", xi, yi, masks=(xm, ym, pm),
            plan=facility.Plan(ger=Ger.I8GER4, backend=b,
                               out_dtype=facility.ACC))
            for b in ("kernel", "torch", "ref")}
    _assert_f32_close(outs["kernel"], outs["ref"])
    _assert_f32_close(outs["torch"], outs["ref"])
    assert torch.equal(ints["kernel"], ints["ref"])
    assert torch.equal(ints["torch"], ints["ref"])


# ----------------------------------------------------------------------
# K2e: f32 attention on the fp32 tile, both modes
# ----------------------------------------------------------------------

_F32_ATTN_CASES = {
    "tile causal gqa": ((2, 200, 8, 2), 200, dict(causal=True)),
    "tile window": ((1, 300, 4, 4), 300, dict(causal=True, window=90)),
    "tile q_offset valid": ((2, 100, 4, 2), 356,
                            dict(causal=True, q_offset=256, valid=True)),
    "split cross": ((4, 1, 12, 12), 1500, dict(causal=False)),
    "split decode valid": ((2, 1, 8, 2), 700,
                           dict(causal=True, q_offset=699, valid=True)),
    "split window": ((2, 8, 4, 4), 900,
                     dict(causal=True, q_offset=892, window=300)),
}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(_F32_ATTN_CASES))
def test_f32_attention_matches_plain(gen, name, d):
    """f32 q, k and v on the fp32 tile, in the mode the plan gives, within
    each output's rounding budget (no P rounding: (D + 8) * 2^-24 of the
    oracle on |v|) of the plain version; batch 1's first 64 slots invalid where
    `valid` is set, and a fully masked row exactly 0."""
    (b, sq, h, kvh), sk, kw = _F32_ATTN_CASES[name]
    kw = dict(kw)
    q = _randn(gen, b, sq, h, d, dtype=torch.float32)
    k = _randn(gen, b, sk, kvh, d, dtype=torch.float32)
    v = _randn(gen, b, sk, kvh, d, dtype=torch.float32)
    if kw.pop("valid", False):
        valid = torch.ones((b, sk), dtype=torch.bool, device="cuda")
        valid[-1, :64] = False
        valid[0] = False
        kw["valid"] = valid
    n_split, per = A.split_kv_plan(h, sq, sk)
    mode = "f32_split" if n_split > 1 else "f32_tile"
    assert mode.endswith(name.split()[0])
    before = A.mma_flash_attention.launches_by_mode[mode]
    got = A.mma_flash_attention(q, k, v, out_dtype=torch.float32, **kw)
    assert A.mma_flash_attention.launches_by_mode[mode] == before + 1
    want = A.flash_attention_plain(q, k, v, out_dtype=torch.float32, **kw)
    _assert_attn_close(got, want, A.rounding_budget(q, k, v, **kw))
    if n_split > 1:
        _assert_attn_close(got, A.flash_attention_splitkv_plain(
            q, k, v, n_split=n_split, per=per, out_dtype=torch.float32,
            **kw), A.rounding_budget(q, k, v, **kw))
    if "valid" in kw:
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("d", [32, 64, 128])
def test_f32_budget_refuses_tf32_scores(gen, d):
    """The control of the f32 budget: the plain version on q and k rounded
    to TF32 (what a TF32 tensor-core product reads) lands outside the
    budget that the fp32 tile meets, in both modes."""
    for (b, sq, h, kvh), sk, kw in (((2, 200, 8, 2), 200, dict(causal=True)),
                                    ((4, 1, 12, 12), 1500,
                                     dict(causal=False))):
        q = _randn(gen, b, sq, h, d, dtype=torch.float32)
        k = _randn(gen, b, sk, kvh, d, dtype=torch.float32)
        v = _randn(gen, b, sk, kvh, d, dtype=torch.float32)
        want = A.flash_attention_plain(q, k, v, out_dtype=torch.float32,
                                       **kw)
        tol = (A.rounding_budget(q, k, v, **kw)
               + 2.0 ** -20 * want.abs().max())
        got = A.mma_flash_attention(q, k, v, out_dtype=torch.float32, **kw)
        assert bool(((got - want).abs() <= tol).all())
        q32, k32 = (((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(
            torch.float32) for t in (q, k))
        tf32 = A.flash_attention_plain(q32, k32, v, out_dtype=torch.float32,
                                       **kw)
        assert ((tf32 - want).abs() / tol).max().item() > 2


@pytest.mark.parametrize("sq", [1, 70])
def test_f32_attention_epilogue_and_stores(gen, sq):
    """The fused epilogue (bias + gelu + residual) on the fp32 tile, in
    both modes, stored in f32 and bf16."""
    q = _randn(gen, 2, sq, 8, 64, dtype=torch.float32)
    k = _randn(gen, 2, 900, 4, 64, dtype=torch.float32)
    v = _randn(gen, 2, 900, 4, 64, dtype=torch.float32)
    ep = E.Epilogue(bias=True, activation="gelu", residual=True)
    bias = _randn(gen, 64, dtype=torch.float32)
    res = _randn(gen, 2, sq, 8, 64, dtype=torch.float32)
    for out in (torch.float32, torch.bfloat16):
        kw = dict(causal=False, ep=ep, bias=bias, residual=res,
                  out_dtype=out)
        got = A.mma_flash_attention(q, k, v, **kw)
        want = A.flash_attention_plain(q, k, v, **kw)
        assert got.dtype == out
        if out == torch.float32:
            _assert_attn_close(got, want, A.rounding_budget(
                q, k, v, causal=False, ep=ep))
        else:
            _assert_store_close(got, want, out)


def test_f32_attention_row_does_not_depend_on_the_batch(gen):
    """One query row over 2560 positions (split-KV), f32: row 0 at batch 1
    equals the same row inside a batch of 8, bit for bit."""
    q = _randn(gen, 8, 1, 2, 64, dtype=torch.float32)
    k = _randn(gen, 8, 2560, 2, 64, dtype=torch.float32)
    v = _randn(gen, 8, 2560, 2, 64, dtype=torch.float32)
    one = A.mma_flash_attention(q[:1], k[:1], v[:1], causal=False,
                                out_dtype=torch.float32)
    many = A.mma_flash_attention(q, k, v, causal=False,
                                 out_dtype=torch.float32)
    assert torch.equal(one[0], many[0])


# ----------------------------------------------------------------------
# K1e: the ABFT checksum sidecar on the four kernels ABFT reaches
# ----------------------------------------------------------------------

# (family, x shape, y shape, the path, extra call arguments); "stream
# split" splits K (4 x 4096 x 11008 is deepseek-7b's decode MLP up
# projection), "stream 1" does not (a 102400-column logits row).
_SIDECAR_CASES = {
    "stream split": ("BF16GER2", (4, 4096), (4096, 11008), "stream", {}),
    "stream 1": ("BF16GER2", (4, 512), (512, 102400), "stream", {}),
    "stream bank": ("BF16GER2", (8, 3, 2048), (8, 2048, 1408), "stream",
                    {}),
    "stream packed": ("BF16GER2", (4, 4096), (4096, 11008), "stream",
                      {"packed": True}),
    "wgmma": ("BF16GER2", (1024, 4096), (4096, 11008), "wgmma", {}),
    "wgmma ragged forms": ("BF16GER2", (300, 512), (512, 520), "wgmma",
                           {"forms": True}),
    "wgmma packed": ("BF16GER2", (256, 4096), (4096, 4096), "wgmma",
                     {"packed": True}),
    "wmma unaligned": ("BF16GER2", (300, 768), (768, 51865), "wmma", {}),
    "wmma f32": ("F32GER", (130, 4096), (4096, 1100), "wmma",
                 {"forms": True}),
    "wmma f32 128": ("F32GER", (1024, 512), (512, 2176), "wmma",
                     {"forms": True}),
    "stream f32 split": ("F32GER", (4, 4096), (4096, 11008), "stream", {}),
    "stream f32 1": ("F32GER", (4, 512), (512, 102400), "stream", {}),
    "stream f32 forms": ("F32GER", (40, 768), (768, 520), "stream",
                         {"forms": True}),
    "stream f32 bank": ("F32GER", (8, 3, 2048), (8, 2048, 1408), "stream",
                        {}),
    "stream f32 packed": ("F32GER", (4, 4096), (4096, 4096), "stream",
                          {"packed": True}),
    "wmma batched": ("F32GER", (3, 70, 200), (3, 200, 90), "wmma", {}),
    "dmma": ("F64GER", (200, 300), (300, 130), "dmma", {"forms": True}),
}


@pytest.mark.parametrize("case", sorted(_SIDECAR_CASES))
def test_sidecar_bit_for_bit_and_sums_match_plain(gen, case):
    """``checksum=True``: ``out`` bit for bit the ``checksum=False``
    launch's, and the per-tile sums within ABFT's tolerance (``ATOL +
    FACTOR * eps(acc) * |X||Y|`` summed alike, plus the seed's, bias's and
    residual's magnitudes) of the plain version's sums of its own finished
    result, on the path the case names; the sidecar launch is counted."""
    from repro_torch.core import abft, packing
    fam, sx, sy, path, opts = _SIDECAR_CASES[case]
    kind = Ger[fam]
    dt = {"BF16GER2": torch.bfloat16, "F32GER": torch.float32,
          "F64GER": torch.float64}[fam]
    k = sx[-1]
    x = _randn(gen, *sx, dtype=dt)
    y = _randn(gen, *sy, dtype=dt, scale=k ** -0.5)
    kw = dict(kind=kind)
    c = None
    if opts.get("forms"):
        acc = precision.policy(kind).acc_dtype
        n = sy[-1]
        c = _randn(gen, *sx[:-1], n, dtype=acc)
        kw.update(alpha=0.75, beta=-1.5, neg_acc=True,
                  ep=E.Epilogue(bias=True, residual=True),
                  bias=_randn(gen, n, dtype=acc),
                  residual=_randn(gen, *sx[:-1], n, dtype=acc))
    yk = y
    if opts.get("packed"):
        lay = packing.gemm_layout(kind, k, sy[-1], side="y")
        po = packing.pack_gemm(y, lay)
        yk, kw["y_layout"] = po.data, po.layout
    before = dict(G.mma_gemm.checksum_launches_by_path)
    out, ck_col, ck_row = G.mma_gemm(x, yk, c, checksum=True, **kw)
    assert G.mma_gemm.checksum_launches_by_path[path] == before[path] + 1
    plain_out = G.mma_gemm(x, yk, c, **kw)
    assert torch.equal(out, plain_out)
    kw.pop("y_layout", None)
    fin, want_col, want_row = G.mma_gemm_sidecar_plain(x, y, c, **kw)
    eps = torch.finfo(precision.policy(kind).acc_dtype).eps
    mag = (x.double().abs() @ y.double().abs()) * abs(kw.get("alpha", 1.0))
    for t, s in ((c, abs(kw.get("alpha", 1.0) * kw.get("beta", 1.0))),
                 (kw.get("residual"), 1.0)):
        if t is not None:
            mag = mag + s * t.double().abs()
    if kw.get("bias") is not None:
        mag = mag + kw["bias"].double().abs()
    m, n = sx[-2], sy[-1]
    took, cfg = tiling.choose_gemm_path(m, n, k, kind,
                                        sx[0] if len(sx) == 3 else 1,
                                        G.natural_aligned(x, y))
    assert took == path
    mag_col, mag_row = G.checksum_tiles(mag, *G.sidecar_tile(path, cfg, m))
    for got, want, mg in ((ck_col, want_col, mag_col),
                          (ck_row, want_row, mag_row)):
        assert got.shape == want.shape and got.dtype == want.dtype
        err = (got.double() - want.double()).abs()
        assert bool((err <= abft.ATOL + abft.FACTOR * eps * mg).all()), \
            err.max()


# ----------------------------------------------------------------------
# K2 at ABFT's depth D + 1: padded to a compiled depth, every mode
# ----------------------------------------------------------------------

# (dtype, (b, sq, h, kvh), sk, causal, the mode the plan gives)
_PADDED_CASES = {
    "tile": (torch.bfloat16, (2, 256, 32, 32), 256, True, "tile"),
    "split": (torch.bfloat16, (4, 1, 12, 12), 1500, False, "split"),
    "f32 tile": (torch.float32, (2, 200, 8, 2), 200, True, "f32_tile"),
    "f32 split": (torch.float32, (2, 1, 8, 2), 700, True, "f32_split"),
}


@pytest.mark.parametrize("d", [65, 129])
@pytest.mark.parametrize("name", sorted(_PADDED_CASES))
def test_attention_at_padded_depth_matches_plain(gen, name, d):
    """D = 65 and 129 (whisper's and deepseek's head depths plus ABFT's
    checksum column) run the kernel at 128 and 192 (fp32: 160), in every
    mode, within each output's rounding budget of the plain version at
    the logical depth (the softmax scale is D^-1/2 of the logical D)."""
    dt, (b, sq, h, kvh), sk, causal, mode = _PADDED_CASES[name]
    q = _randn(gen, b, sq, h, d, dtype=dt)
    k = _randn(gen, b, sk, kvh, d, dtype=dt)
    v = _randn(gen, b, sk, kvh, d, dtype=dt)
    kw = dict(causal=causal, q_offset=sk - sq if causal else 0)
    before = (A.mma_flash_attention.launches_by_mode[mode],
              A.mma_flash_attention.padded_launches_by_mode[mode])
    got = A.mma_flash_attention(q, k, v, out_dtype=torch.float32, **kw)
    assert (A.mma_flash_attention.launches_by_mode[mode],
            A.mma_flash_attention.padded_launches_by_mode[mode]) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (b, sq, h, d) and got.is_contiguous()
    n_split, per = A.split_kv_plan(h, sq, sk)
    want = (A.flash_attention_splitkv_plain(q, k, v, n_split=n_split,
                                            per=per,
                                            out_dtype=torch.float32, **kw)
            if n_split > 1 else
            A.flash_attention_plain(q, k, v, out_dtype=torch.float32, **kw))
    _assert_attn_close(got, want, A.rounding_budget(q, k, v, **kw))


# ----------------------------------------------------------------------
# K1d on the WMMA and fp32 tiles, K3's packed filters on its WMMA and fp32
# tiles, and autotuned dispatch
# ----------------------------------------------------------------------

def _packed_like(w, kind):
    from repro_torch.core import packing
    k, n = w.shape[-2:]
    return packing.pack_gemm(w, packing.gemm_layout(
        kind, k, n, batched=w.ndim == 3))


# name: (family, batch, (M, K, N), explicit block)
_WMMA_PACKED = {
    "bf16-128": (Ger.BF16GER2, None, (256, 512, 1000), (128, 128, 32)),
    "bf16-64-decode": (Ger.BF16GER2, None, (4, 4096, 11008), (64, 64, 64)),
    "bf16-fringe": (Ger.BF16GER2, None, (37, 45, 100), (128, 128, 32)),
    "bf16-batched": (Ger.BF16GER2, 3, (77, 200, 130), (64, 64, 64)),
    "unaligned": (Ger.BF16GER2, None, (1024, 768, 51865), None),
    "f32": (Ger.F32GER, None, (130, 96, 200), None),
    "f32-decode": (Ger.F32GER, None, (4, 4096, 11008), None),
    "f32-batched": (Ger.F32GER, 3, (77, 200, 130), None),
}


@pytest.mark.parametrize("name", sorted(_WMMA_PACKED))
def test_packed_wmma_bitwise(gen, name):
    """The WMMA and fp32 tiles on packed Y panels (K1d, PackedB): each
    stage cut from the fixed 64 x 64 panels, with the seed, alpha/beta
    and a fused bias + silu, bit for bit the natural launch, at aligned,
    fringe, batched and unaligned (N = 51865) shapes; F32GER decode on
    the fp32 weight stream's panels."""
    kind, b, (m, k, n), block = _WMMA_PACKED[name]
    dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
    lead = () if b is None else (b,)
    x = _randn(gen, *lead, m, k, dtype=dt)
    w = _randn(gen, *lead, k, n, dtype=dt, scale=k ** -0.5)
    c = _randn(gen, *lead, m, n, dtype=torch.float32)
    po = _packed_like(w, kind)
    bias = _randn(gen, n, dtype=torch.float32)
    kw = dict(kind=kind, block=block, alpha=0.5, beta=2.0,
              ep=E.Epilogue(bias=True, activation="silu"), bias=bias)
    # F32GER decode ("f32-decode") takes the fp32 weight stream
    path = tiling.choose_gemm_path(m, n, k, kind, b or 1,
                                   G.natural_aligned(x, w), block)[0]
    assert path == ("stream" if name == "f32-decode" else "wmma")
    _same_path_bits(lambda: G.mma_gemm(x, w, c, **kw),
                    lambda: G.mma_gemm(x, po.data, c, y_layout=po.layout,
                                       **kw), path)


@pytest.mark.parametrize("kind", [Ger.BF16GER2, Ger.F32GER])
@pytest.mark.parametrize("m", [4, 256])
def test_packed_masked_wmma_bitwise_nan_in_disabled_lanes(gen, kind, m):
    """MaskedPackedB: disabled columns hold NaN, disabled ranks Inf, in the
    panels; the masked packed launch is the natural masked one bit for
    bit and finite."""
    from repro_torch.core import packing
    k, n = 512, 1000
    dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
    x = _randn(gen, m, k, dtype=dt)
    w = _randn(gen, k, n, dtype=dt, scale=k ** -0.5)
    masks = _lane_masks(gen, m, n, k)
    w[:, ~masks[1]] = float("nan")
    w[~masks[2], :] = float("inf")
    po = _packed_like(w, kind)
    packing.clear_state()
    before = dict(G.mma_gemm.masked_launches_by_path)
    want = G.mma_gemm(x, w, kind=kind, masks=masks)
    got = G.mma_gemm(x, po.data, kind=kind, masks=masks, y_layout=po.layout)
    torch.cuda.synchronize()
    assert G.mma_gemm.masked_launches_by_path["wmma"] == before["wmma"] + 2
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert packing.COUNTERS["demote"] == 0


@pytest.mark.parametrize("kind", [Ger.BF16GER2, Ger.F32GER])
def test_packed_wmma_sidecar_bitwise(gen, kind):
    """checksum=True on a packed WMMA / fp32 launch: out and both sums are
    the natural launch's bit for bit."""
    m, k, n = 300, 256, 1000
    dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
    x = _randn(gen, m, k, dtype=dt)
    w = _randn(gen, k, n, dtype=dt, scale=k ** -0.5)
    po = _packed_like(w, kind)
    block = (64, 64, 64) if kind == Ger.BF16GER2 else None
    want = G.mma_gemm(x, w, kind=kind, block=block, checksum=True)
    got = G.mma_gemm(x, po.data, kind=kind, block=block, checksum=True,
                     y_layout=po.layout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.parametrize("kind", [Ger.BF16GER2, Ger.F32GER])
@pytest.mark.parametrize("name", ["whisper-conv2", "qwen2-vl-patch"])
def test_packed_conv_wmma_f32_bitwise(gen, kind, name):
    """K3's WMMA tile (an explicit filter tile of 128: two 64-filter slabs
    a stage) and fp32 tile on the packed stream at the stems' shapes, bias
    + gelu: bit for bit the natural launch."""
    from repro_torch.core import packing
    dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
    if name == "whisper-conv2":
        x = _randn(gen, 4, 1, 3001, 768, dtype=dt)
        w = _randn(gen, 1, 3, 768, 768, dtype=dt, scale=(3 * 768) ** -0.5)
        stride, nd = (1, 2), 1
    else:
        x = _randn(gen, 4, 448, 448, 3, dtype=dt)
        w = _randn(gen, 14, 14, 3, 3584, dtype=dt, scale=588 ** -0.5)
        stride, nd = (14, 14), 2
    kh, kw, c, f = w.shape
    po = packing.pack_conv(w[0] if nd == 1 else w, packing.conv_layout(
        kind, kh, kw, c, f, nd=nd))
    bias = _randn(gen, f, dtype=torch.float32)
    path = "f32" if kind == Ger.F32GER else "wmma"
    opts = dict(stride=stride, ep=E.Epilogue(bias=True, activation="gelu"),
                bias=bias, out_dtype=torch.float32,
                bf=None if kind == Ger.F32GER else 128)
    before = (K.mma_conv2d.launches_by_path[path],
              K.mma_conv2d.packed_launches_by_path[path])
    want = K.mma_conv2d(x, w, **opts)
    got = K.mma_conv2d(x, po.data, w_layout=po.layout, **opts)
    torch.cuda.synchronize()
    assert (K.mma_conv2d.launches_by_path[path],
            K.mma_conv2d.packed_launches_by_path[path]) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(got, want)


def test_packed_launch_raises_on_bad_build_or_launch(gen, monkeypatch,
                                                     tmp_path):
    """mma_gemm_launch with Y panels refuses a tile it is not built for and a
    misaligned panel pointer (the wrapper raises through _build.check);
    a source that does not build raises; nothing counts a launch."""
    from repro_torch.kernels import _build
    x = _randn(gen, 64, 128)
    w = _randn(gen, 128, 64)
    po = _packed_like(w, Ger.BF16GER2)
    G.mma_gemm(x, po.data, block=(64, 64, 64), y_layout=po.layout)
    lib, fn = G._FNS["mma_gemm"]
    out = torch.empty((64, 64), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for bm, shift in ((32, 0), (64, 2)):       # no such tile; misaligned
        rc = fn(x.data_ptr(), po.data.data_ptr() + shift, None, None, None,
                None, None, None, out.data_ptr(), 1, 0, 0, 0, 0, 1, 64, 64,
                128, 0, 0, 0, 0, 0, 1.0, 1.0, 0, 0, 0, bm, 64, 64, None,
                None, stream, 2)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(lib, rc, "mma_gemm (packed)")
    monkeypatch.setattr(G, "_FNS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    launches = G.mma_gemm.launches
    with pytest.raises(RuntimeError, match="build failed"):
        G.mma_gemm(x, po.data, block=(64, 64, 64), y_layout=po.layout)
    assert G.mma_gemm.launches == launches


def test_autotune_measures_on_the_card_and_dispatch_follows(gen,
                                                             monkeypatch,
                                                             tmp_path):
    """autotune on the card times its candidates with CUDA events and
    writes a "measured" entry; contract then launches the winner's path;
    an attention search does the same for its q tile and split."""
    import json

    from repro_torch.core import autotune
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", cache)
    scores = {}
    won = autotune.autotune(Ger.BF16GER2, 4, 4096, 4096, scores=scores)
    ent = json.loads((tmp_path / "at.json").read_text())["entries"][
        "xvbf16ger2|8x4096x4096|none|cuda"]
    assert ent["source"] == "measured" and ent["path"] == won[0]
    assert scores[won] == min(scores.values()) == ent["score"]
    assert tiling.choose_gemm_path(4, 4096, 4096, Ger.BF16GER2) in scores
    x = _randn(gen, 4, 4096)
    w = _randn(gen, 4096, 4096, scale=4096 ** -0.5)
    before = dict(G.mma_gemm.launches_by_path)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        facility.contract("mk,kn->mn", x, w)
    assert G.mma_gemm.launches_by_path[won[0]] == before[won[0]] + 1
    got = autotune.autotune_attn(Ger.BF16GER2, 32, 256, 256, 128)
    assert autotune.lookup_attn(Ger.BF16GER2, 32, 256, 256, 128) == got
    assert cache.get_raw("xvbf16ger2|attn32x256x256x128|none|cuda")[
        "source"] == "measured"


def test_tuned_stream_split_row_does_not_depend_on_the_batch(gen,
                                                              monkeypatch,
                                                              tmp_path):
    """A planted stream winner (split 16) is keyed by the row bucket: a
    decode row at batch 1 is the same bits inside a batch of 4."""
    from repro_torch.core import autotune
    cache = autotune.AutotuneCache(tmp_path / "at.json")
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", cache)
    k, n = 4096, 4096
    cache.put(autotune.cache_key(Ger.BF16GER2, 8, n, k, backend="cuda"),
              ("stream", tiling.StreamConfig(64, 16)), source="measured",
              score=0.0)
    x = _randn(gen, 4, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        one = facility.contract("mk,kn->mn", x[:1], w)
        four = facility.contract("mk,kn->mn", x, w)
    torch.cuda.synchronize()
    assert torch.equal(one[0], four[0])


# ----------------------------------------------------------------------
# K1d on every path: X and Y panels on DMMA, IMMA, the weight stream, the
# wgmma tile and the WMMA/fp32 tiles, masked, batched and shared; and
# K2d, the attention kernel's full grid
# ----------------------------------------------------------------------

# name: (family, path, (M, K, N), explicit block)
_K1D = {
    "dmma": (Ger.F64GER, "dmma", (100, 136, 72), None),
    "dmma-512": (Ger.F64GER, "dmma", (512, 512, 512), None),
    "imma-i8": (Ger.I8GER4, "imma", (300, 200, 260), None),
    "imma-i16": (Ger.I16GER2, "imma", (300, 200, 260), None),
    "stream": (Ger.BF16GER2, "stream", (4, 4096, 11008), None),
    "stream-fringe": (Ger.BF16GER2, "stream", (30, 200, 1000), None),
    "wgmma": (Ger.BF16GER2, "wgmma", (1024, 4096, 11008), None),
    "wgmma-fringe": (Ger.BF16GER2, "wgmma", (300, 200, 1000), None),
    "wmma-128": (Ger.BF16GER2, "wmma", (256, 200, 1000), (128, 128, 32)),
    "wmma-64": (Ger.BF16GER2, "wmma", (100, 136, 72), (64, 64, 64)),
    "f32": (Ger.F32GER, "wmma", (130, 100, 200), None),
    "f32-128": (Ger.F32GER, "wmma", (300, 200, 1000), (128, 128, 16)),
    "stream-f32": (Ger.F32GER, "stream", (30, 200, 1000), None),
    "stream-f16": (Ger.F16GER2, "stream", (30, 200, 1000), None),
    "wgmma-f16": (Ger.F16GER2, "wgmma", (300, 200, 1000), None),
    "wmma-f16": (Ger.F16GER2, "wmma", (100, 136, 72), (64, 64, 64)),
}
_K1D_CASES = [(name, side, form)
              for name, (_, path, _, _) in _K1D.items()
              for side in ("x", "y", "both")
              for form in ("plain", "batched", "shared")
              + (("masked",) if path in G.MASKED_PATHS else ())]


def _family_operand(gen, kind, shape, which):
    """A random operand in ``kind``'s input dtype: full-range integers for
    the integer families, unit normals scaled by K^-1/2 on y otherwise."""
    pol = precision.policy(kind)
    dt = pol.x_dtype if which == "x" else pol.y_dtype
    if pol.is_integer:
        info = torch.iinfo(dt)
        return torch.randint(info.min, info.max + 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32).to(dt)
    scale = 1.0 if which == "x" else shape[-2] ** -0.5
    return (torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float64) * scale).to(dt)


@pytest.mark.parametrize("name,side,form", _K1D_CASES)
def test_k1d_panels_on_every_path(gen, name, side, form):
    """Each path on packed X panels, Y panels or both: ``plain`` (with the
    ABFT sidecar where the path has one, the sums bit for bit too),
    ``batched`` (B = 3, batched panels), ``shared`` (the packed operand
    without a batch axis beside a batched one: batch stride 0) and
    ``masked`` (NaN and Inf in every disabled lane of a float family):
    the packed launch on the path the natural call takes, bit for bit the
    natural launch, counted as packed, with no demote."""
    from repro_torch.core import packing
    kind, path, (m, k, n), block = _K1D[name]
    pol = precision.policy(kind)
    lead = (3,) if form in ("batched", "shared") else ()
    shared = ("x" if side == "x" else "y") if form == "shared" else None
    x = _family_operand(gen, kind, (() if shared == "x" else lead)
                        + (m, k), "x")
    y = _family_operand(gen, kind, (() if shared == "y" else lead)
                        + (k, n), "y")
    masks = None
    if form == "masked":
        masks = _lane_masks(gen, m, n, k)
        if not pol.is_integer:
            x[~masks[0], :] = float("nan")
            y[:, ~masks[1]] = float("inf")
            y[~masks[2], :] = float("nan")
    packs = {}
    for s, t in (("x", x), ("y", y)):
        if side in (s, "both"):
            rows, cols = t.shape[-2:]
            packs[s] = packing.pack_gemm(t, packing.gemm_layout(
                kind, rows, cols, side=s, batched=t.ndim == 3))
    nx, ny = (t.expand(lead + tuple(t.shape)).contiguous() if t.ndim == 2
              and lead else t for t in (x, y))
    checksum = path in G.SIDECAR_PATHS and masks is None
    kw = dict(kind=kind, block=block, masks=masks, checksum=checksum)
    packing.clear_state()
    packed_before = G.mma_gemm.packed_launches_by_path[path]
    before = dict(G.mma_gemm.launches_by_path)
    want = G.mma_gemm(nx, ny, **kw)
    got = G.mma_gemm(
        packs["x"].data if "x" in packs else x,
        packs["y"].data if "y" in packs else y,
        x_layout=packs["x"].layout if "x" in packs else None,
        y_layout=packs["y"].layout if "y" in packs else None, **kw)
    torch.cuda.synchronize()
    assert G.mma_gemm.launches_by_path[path] == before[path] + 2
    assert G.mma_gemm.packed_launches_by_path[path] == packed_before + 1
    assert packing.COUNTERS["demote"] == 0
    if checksum:
        assert all(torch.equal(a, c) for a, c in zip(got, want))
        got = got[0]
    else:
        assert torch.equal(got, want)
    if not pol.is_integer:
        assert bool(torch.isfinite(got).all())


# name: (dtype, (B, S, H, D), Sq, kwargs): Sq = S but for the split-KV
# cases (one short query over a long cache)
_K2D = {
    "tile-causal": (torch.bfloat16, (1, 256, 32, 128), None,
                    dict(causal=True)),
    "tile-causal-512": (torch.bfloat16, (2, 512, 4, 64), None,
                        dict(causal=True)),
    "tile-window": (torch.bfloat16, (1, 512, 8, 64), None,
                    dict(causal=True, window=128)),
    "f32-tile-causal": (torch.float32, (1, 256, 4, 64), None,
                        dict(causal=True)),
    "f32-tile-window": (torch.float32, (1, 512, 4, 64), None,
                        dict(causal=True, window=128)),
    "split-causal": (torch.bfloat16, (1, 4096, 32, 128), 4,
                     dict(causal=True, q_offset=1000)),
    "split-window": (torch.bfloat16, (1, 4096, 32, 128), 4,
                     dict(causal=True, q_offset=4092, window=1500)),
    "f32-split-causal": (torch.float32, (1, 2048, 8, 64), 4,
                         dict(causal=True, q_offset=500)),
}


@pytest.mark.parametrize("name", sorted(_K2D))
def test_full_grid_attention(gen, name):
    """K2d: bound_grid=False walks every KV block (counted in
    full_grid_launches).  On the tile modes, and in split-KV mode where
    the live range starts at block 0, it is the bounded launch bit for
    bit (a dead block leaves the state untouched, a dead split weighs 0);
    under a window the split-KV partials group otherwise, within twice
    the rounding budget of the bounded launch.  Both within the budget of
    the plain version."""
    dt, (b, s, h, d), sq, kw = _K2D[name]
    sq = sq or s
    q = _randn(gen, b, sq, h, d, dtype=dt)
    k = _randn(gen, b, s, h, d, dtype=dt)
    v = _randn(gen, b, s, h, d, dtype=dt)
    full_before = A.mma_flash_attention.full_grid_launches
    bounded = A.mma_flash_attention(q, k, v, out_dtype=torch.float32, **kw)
    full = A.mma_flash_attention(q, k, v, out_dtype=torch.float32,
                                 bound_grid=False, **kw)
    torch.cuda.synchronize()
    assert A.mma_flash_attention.full_grid_launches == full_before + 1
    budget = A.rounding_budget(q, k, v, **kw)
    _, n_split, per = A.attn_plan(b, h, sq, s, d, dt == torch.float32)
    if n_split > 1 and "window" in kw:
        assert bool(((full - bounded).abs()
                     <= 2 * budget + 2.0 ** -20).all())
    else:
        assert torch.equal(full, bounded)
    plain = (A.flash_attention_splitkv_plain(
        q, k, v, n_split=n_split, per=per, bound_grid=False,
        out_dtype=torch.float32, **kw) if n_split > 1
        else A.flash_attention_plain(q, k, v, out_dtype=torch.float32, **kw))
    _assert_attn_close(full, plain, budget)


# ----------------------------------------------------------------------
# The 16-bit attention tile (mma_attention.cu flash_tile_kernel: persistent
# blocks, ping-ponged consumers, 128-key steps at D <= 128): every form the
# wrapper sends it, at every compiled depth, in bf16 and f16
# ----------------------------------------------------------------------

# form: ((B, Sq, H), (Sk, KVH), flags); D comes from the parameter
_TILE_FORMS = {
    "causal gqa 7, Sk 300": ((2, 300, 28), (300, 4), dict(causal=True)),
    "window 150 gqa 16": ((1, 700, 16), (700, 1),
                          dict(causal=True, window=150)),
    "q_offset 256": ((2, 100, 8), (356, 8), dict(causal=True, q_offset=256)),
    "valid, masked rows": ((2, 200, 8), (200, 2), dict(causal=True)),
    "epilogue bias silu residual": ((2, 130, 8), (250, 8),
                                    dict(causal=False)),
    "persistence wraps": ((4, 1024, 16), (1024, 16), dict(causal=True)),
    "full grid, window": ((1, 900, 4), (900, 4),
                          dict(causal=True, window=200)),
    "batch 1 row in batch 4": ((4, 256, 32), (256, 32), dict(causal=True)),
}


def _attn_store_ok(got, want, budget, out_dtype):
    """Within the rounding budget plus 2^-20 * max|ref|, and one ulp of a
    16-bit store at |ref|."""
    got, want = got.float(), want.float()
    tol = budget + 2.0 ** -20 * want.abs().max()
    if out_dtype != torch.float32:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - (
                7 if out_dtype == torch.bfloat16 else 10))
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol).all()), (err / tol).max()


@pytest.mark.parametrize("d", A.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("form", sorted(_TILE_FORMS))
def test_attention_tile_redesign_forms(gen, form, dt, d):
    """Each form on each compiled tile (64 and, below 192, 128 rows) held
    to the plain version within its rounding budget, the two tiles bit for
    bit alike (a row's arithmetic does not depend on the tile or the
    block that runs it); fully masked rows exact zeros; the full grid bit
    for bit the bounded launch; row 0 of batch 1 bit for bit the same row
    inside a batch of 4 (64-row tiles at batch 1, 128 at batch 4)."""
    (b, sq, h), (sk, kvh), kw = _TILE_FORMS[form]
    q = _randn(gen, b, sq, h, d, dtype=dt)
    k, v = _randn(gen, b, sk, kvh, d, dtype=dt), _randn(gen, b, sk, kvh, d,
                                                        dtype=dt)
    kw = dict(kw)
    out_dtype = dt
    if form.startswith("valid"):
        valid = torch.ones((b, sk), dtype=torch.bool, device="cuda")
        valid[1, :150] = False
        valid[0, 77:93] = False
        kw["valid"] = valid
    if form.startswith("epilogue"):
        kw.update(ep=E.Epilogue(bias=True, activation="silu",
                                residual=True),
                  bias=_randn(gen, d, dtype=torch.float32),
                  residual=_randn(gen, b, sq, h, d, dtype=dt))
        out_dtype = torch.float32
    assert A.split_kv_plan(h, sq, sk)[0] == 1
    tiles = (64,) if d == 192 else (64, 128)
    before = dict(A.mma_flash_attention.launches_by_mode)
    outs = [A.mma_flash_attention(q, k, v, out_dtype=out_dtype,
                                  tuned=(bq, 1), **kw) for bq in tiles]
    torch.cuda.synchronize()
    assert A.mma_flash_attention.launches_by_mode["tile"] == \
        before["tile"] + len(tiles)
    flags = {f: kw[f] for f in ("causal", "q_offset", "window", "valid",
                                "ep") if f in kw}
    want = A.flash_attention_plain(q, k, v, out_dtype=torch.float32, **kw)
    budget = A.rounding_budget(q, k, v, **flags)
    for got in outs:
        _attn_store_ok(got, want, budget, out_dtype)
        assert torch.equal(got, outs[0])
    if form.startswith("valid"):
        assert bool((outs[0][1, :150] == 0).all())
    if form.startswith("full grid"):
        assert torch.equal(A.mma_flash_attention(
            q, k, v, out_dtype=out_dtype, bound_grid=False, **kw), outs[0])
    if form.startswith("batch"):
        one = A.mma_flash_attention(q[:1], k[:1], v[:1], out_dtype=out_dtype,
                                    **kw)
        many = A.mma_flash_attention(q, k, v, out_dtype=out_dtype, **kw)
        if d < 192:
            assert A.attn_plan(1, h, sq, sk, d, False)[0] == 64
            assert A.attn_plan(4, h, sq, sk, d, False)[0] == 128
        assert torch.equal(one[0], many[0])


# ----------------------------------------------------------------------
# The 16-bit WMMA tile (tile_gemm.cuh: a cp.async ring into ldmatrix and
# mma.sync): every form in bf16 and f16 on both compiled blocks, and K3's
# WMMA conv at each of its gathers
# ----------------------------------------------------------------------

# name: (batch, (M, K, N), forms): "x" / "y" packed panels, "mask" (NaN and
# Inf in the disabled lanes), "seed" (a C seed with alpha and beta),
# "shared" (Y panels without the batch axis), "sidecar" (checksum=True).
# Odd N and K put rows off a 16-byte boundary: the tile copies such rows
# as whole words it realigns.
_WMMA_FORMS = {
    "aligned": ((), (256, 512, 384), ()),
    "odd N": ((), (200, 96, 1001), ()),
    "odd K": ((), (130, 333, 136), ()),
    "K below 16": ((), (150, 5, 200), ()),
    "fringes": ((), (1000, 330, 1000), ()),
    "X panels": ((), (300, 330, 264), ("x",)),
    "Y panels": ((), (300, 330, 1001), ("y",)),
    "X and Y panels": ((), (300, 330, 1001), ("x", "y")),
    "masked": ((), (300, 330, 1001), ("mask",)),
    "masked panels": ((), (300, 330, 1001), ("mask", "x", "y")),
    "seeded": ((), (300, 512, 264), ("seed",)),
    "batched": ((3,), (130, 200, 264), ()),
    "shared": ((3,), (130, 200, 264), ("y", "shared")),
    "sidecar": ((), (300, 768, 1001), ("sidecar",)),
}
# the forms with a natural row off a 16-byte boundary (core/tiling.py's
# tile16_row_shift): their launches take the realigning copies
_WMMA_REALIGNED = {"odd N", "odd K", "K below 16", "fringes", "X panels",
                   "Y panels", "X and Y panels", "masked", "masked panels",
                   "sidecar"}


@pytest.mark.parametrize("block", [(128, 128, 32), (64, 64, 64)])
@pytest.mark.parametrize("kind", [Ger.BF16GER2, Ger.F16GER2])
@pytest.mark.parametrize("form", sorted(_WMMA_FORMS))
def test_wmma_tile_forms_match_plain(gen, form, kind, block):
    """The 16-bit tile at an explicit block: one launch on the wmma path,
    finite, within the f32 tolerance of the plain version (masked: NaN and
    Inf in the disabled lanes leave no trace); on packed panels (X, Y,
    both, masked, or Y shared across the batch) bit for bit the natural
    launch; with the sidecar, ``out`` bit for bit and the sums within
    ABFT's tolerance of the plain result's."""
    from repro_torch.core import abft, packing
    lead, (m, k, n), forms = _WMMA_FORMS[form]
    dt = precision.policy(kind).x_dtype
    x = _randn(gen, *lead, m, k, dtype=dt)
    y = _randn(gen, *(() if "shared" in forms else lead), k, n, dtype=dt,
               scale=k ** -0.5)
    kw = dict(kind=kind, block=block, out_dtype=torch.float32)
    c = None
    if "seed" in forms:
        c = _randn(gen, *lead, m, n, dtype=torch.float32)
        kw.update(alpha=0.75, beta=-0.5)
    if "mask" in forms:
        masks = _lane_masks(gen, m, n, k)
        x[..., ~masks[0], :] = float("nan")
        x[..., ~masks[2]] = float("inf")
        y[..., ~masks[2], :] = float("nan")
        y[..., ~masks[1]] = float("-inf")
        kw["masks"] = masks
    # the natural operand of a shared Y: the same rows for every batch
    yn = y.expand(*lead, k, n).contiguous() if "shared" in forms else y
    realigned = any(tiling.tile16_row_shift(
        t.data_ptr(), t.stride(-2) * t.element_size(), r)
        for t in (x, yn) for r in range(8))
    assert realigned == (form in _WMMA_REALIGNED)
    before = G.mma_gemm.launches_by_path["wmma"]
    got = G.mma_gemm(x, yn, c, **kw)
    torch.cuda.synchronize()
    assert G.mma_gemm.launches_by_path["wmma"] == before + 1
    want = G.mma_gemm_plain(x, yn, c, **{key: v for key, v in kw.items()
                                         if key != "block"})
    assert bool(torch.isfinite(got).all())
    _assert_f32_close(got, want)
    if "x" in forms or "y" in forms:
        xp, yp, lay = x, y, {}
        if "x" in forms:
            po = packing.pack_gemm(x, packing.gemm_layout(
                kind, m, k, side="x", batched=bool(lead)))
            xp, lay["x_layout"] = po.data, po.layout
        if "y" in forms:
            po = packing.pack_gemm(y, packing.gemm_layout(
                kind, k, n, batched=y.ndim == 3))
            yp, lay["y_layout"] = po.data, po.layout
        assert torch.equal(G.mma_gemm(xp, yp, c, **kw, **lay), got)
    if "sidecar" in forms:
        out, ck_col, ck_row = G.mma_gemm(x, y, c, checksum=True, **kw)
        assert torch.equal(out, got)
        eps = torch.finfo(torch.float32).eps
        mag = torch.matmul(x.double().abs(), y.double().abs())
        for ck, want_ck, mag_ck in zip(
                (ck_col, ck_row), G.checksum_tiles(want, *block[:2]),
                G.checksum_tiles(mag, *block[:2])):
            err = (ck.double() - want_ck.double()).abs()
            assert bool((err <= abft.ATOL + abft.FACTOR * eps * mag_ck
                         ).all()), err.max()


# name: (image NHWC, filters HWIO, stride, the copy core/tiling.py's
# conv_gather_bytes picks): whisper's conv2 cut to 301 frames, a qwen2-vl
# patch embed on a 56 x 56 image, 5 channels whose (j, c) runs are odd
_WMMA_CONV_GATHERS = {
    "16-byte": ((2, 1, 301, 768), (1, 3, 768, 768), (1, 2), 16),
    "4-byte": ((2, 56, 56, 3), (14, 14, 3, 200), (14, 14), 4),
    "elements": ((2, 9, 11, 5), (3, 3, 5, 136), (1, 2), 0),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("gather", sorted(_WMMA_CONV_GATHERS))
def test_wmma_conv_gathers_match_plain(gen, gather, dtype):
    """K3 on the WMMA tile (the explicit filter tile 128), bias + gelu:
    within one ulp of the 16-bit store plus 1e-5 * max|ref| of its plain
    version, three launches the same bits, and on the packed filter
    stream bit for bit the natural launch."""
    from repro_torch.core import packing
    shape, fshape, stride, copy = _WMMA_CONV_GATHERS[gather]
    n, h, w, c = shape
    kh, kw, _, f = fshape
    x = _randn(gen, *shape, dtype=dtype)
    filt = _randn(gen, *fshape, dtype=dtype, scale=(kh * kw * c) ** -0.5)
    assert tiling.conv_gather_bytes(c, kw, w, stride[1],
                                    x.data_ptr()) == copy
    opts = dict(stride=stride, ep=E.Epilogue(bias=True, activation="gelu"),
                bias=_randn(gen, f, dtype=torch.float32), out_dtype=dtype,
                bf=128)
    before = K.mma_conv2d.launches_by_path["wmma"]
    outs = [K.mma_conv2d(x, filt, **opts) for _ in range(3)]
    po = packing.pack_conv(filt, packing.conv_layout(
        precision.Ger.BF16GER2 if dtype == torch.bfloat16
        else precision.Ger.F16GER2, kh, kw, c, f, nd=2))
    packed = K.mma_conv2d(x, po.data, w_layout=po.layout, **opts)
    torch.cuda.synchronize()
    assert K.mma_conv2d.launches_by_path["wmma"] == before + 4
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(packed, outs[0])
    want = K.mma_conv2d_plain(x, filt, **{key: v for key, v in opts.items()
                                          if key != "bf"}).float()
    got = outs[0].float()
    bits = 7 if dtype == torch.bfloat16 else 10
    tol = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(1e-30))) - bits) + 1e-5 * want.abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all())


# ----------------------------------------------------------------------
# F64GER's DMMA kernel (gemm_dmma.cu: a cp.async ring on mbarriers into
# mma.sync m16n8k8 f64 on a 128 x 128 or a 64 x 64 tile): every form on
# both tiles
# ----------------------------------------------------------------------

# name: (batch, (M, K, N), forms): "x" / "y" packed panels, "mask" (NaN
# and Inf in the disabled lanes), "seed" (a C seed with alpha, beta and
# both negations), "ep" (bias + gelu + residual), "shared" (Y panels
# without the batch axis), "sidecar" (checksum=True), an out dtype.  M =
# 129, N = 130 and K = 17 put a fringe past each tile; odd K and N take
# the 8-byte copies.
_DMMA_FORMS = {
    "natural": ((), (300, 512, 264), ()),
    "fringes": ((), (129, 17, 130), ()),
    "batched": ((3,), (129, 200, 130), ()),
    "shared": ((3,), (129, 200, 130), ("y", "shared")),
    "forms": ((), (200, 256, 136), ("seed",)),
    "epilogue": ((2,), (130, 128, 200), ("ep",)),
    "out f32": ((), (200, 300, 264), (torch.float32,)),
    "out bf16": ((), (200, 300, 264), (torch.bfloat16,)),
    "out f16": ((), (200, 300, 264), (torch.float16,)),
    "odd K": ((), (200, 301, 136), ()),
    "odd N": ((), (200, 256, 259), ()),
    "X panels": ((), (300, 330, 264), ("x",)),
    "Y panels": ((), (300, 330, 259), ("y",)),
    "X and Y panels": ((), (300, 331, 259), ("x", "y")),
    "masked": ((), (300, 330, 259), ("mask",)),
    "masked panels": ((), (300, 330, 259), ("mask", "x", "y")),
    "sidecar": ((), (300, 512, 259), ("sidecar",)),
    "sidecar packed": ((2,), (129, 200, 130), ("sidecar", "x", "y")),
}


@pytest.mark.parametrize("block", [(128, 128, 32), (64, 64, 16)])
@pytest.mark.parametrize("form", sorted(_DMMA_FORMS))
def test_dmma_redesign_forms(gen, form, block):
    """The DMMA kernel at an explicit tile: one launch on the dmma path,
    within 1e-15 K max|x| max|y| of the float64 plain version (plus one
    rounding of a narrower store); the other tile, a batched call's
    slices and packed operands bit for bit the same; NaN and Inf in
    disabled lanes leave no trace (the same bits as zeros there); with the
    sidecar, ``out`` bit for bit ``checksum=False``'s and the sums within
    ABFT's tolerance of the plain result's."""
    from repro_torch.core import abft, packing
    lead, (m, k, n), forms = _DMMA_FORMS[form]
    f64 = dict(device="cuda", dtype=torch.float64)
    x = torch.randn(*lead, m, k, generator=gen, **f64)
    y = torch.randn(*(() if "shared" in forms else lead), k, n,
                    generator=gen, **f64)
    out_dtype = next((f for f in forms if isinstance(f, torch.dtype)),
                     torch.float64)
    kw = dict(kind=Ger.F64GER, block=block, out_dtype=out_dtype)
    c = None
    if "seed" in forms:
        c = torch.randn(*lead, m, n, generator=gen, **f64)
        kw.update(alpha=0.75, beta=-0.5, neg_product=True, neg_acc=True)
    if "ep" in forms:
        kw.update(ep=E.Epilogue(bias=True, activation="gelu", residual=True),
                  bias=torch.randn(n, generator=gen, **f64),
                  residual=torch.randn(*lead, m, n, generator=gen, **f64))
    bound = 1e-15 * k * x.abs().max().item() * y.abs().max().item()
    if "mask" in forms:
        masks = _lane_masks(gen, m, n, k)
        x[..., ~masks[0], :] = float("nan")
        x[..., ~masks[2]] = float("-inf")
        y[..., ~masks[2], :] = float("inf")
        y[..., ~masks[1]] = float("nan")
        zx, zy = G.select_masks(x, y, masks)
        kw["masks"] = masks
    yn = y.expand(*lead, k, n).contiguous() if "shared" in forms else y
    before = G.mma_gemm.launches_by_path["dmma"]
    got = G.mma_gemm(x, yn, c, **kw)
    torch.cuda.synchronize()
    assert G.mma_gemm.launches_by_path["dmma"] == before + 1
    want = G.mma_gemm_plain(x, yn, c, **{key: v for key, v in kw.items()
                                         if key != "block"})
    assert bool(torch.isfinite(got).all())
    err = (got.double() - want.double()).abs()
    tol = bound + torch.finfo(out_dtype).eps * want.double().abs()
    assert bool((err <= tol).all()), err.max().item()
    other = (64, 64, 16) if block[0] == 128 else (128, 128, 32)
    assert torch.equal(G.mma_gemm(x, yn, c, **{**kw, "block": other}), got)
    assert torch.equal(G.mma_gemm(x, yn, c, **kw), got)
    if "mask" in forms:
        zyn = zy.expand(*lead, k, n).contiguous() if "shared" in forms else zy
        assert torch.equal(G.mma_gemm(zx, zyn, c, **kw), got)
    if lead:
        for i in range(lead[0]):
            one = {**kw}
            if "residual" in one:
                one["residual"] = one["residual"][i]
            assert torch.equal(G.mma_gemm(
                x[i], yn[i], None if c is None else c[i], **one), got[i])
    lay, xp, yp = {}, x, y
    if "x" in forms:
        po = packing.pack_gemm(x, packing.gemm_layout(
            Ger.F64GER, m, k, side="x", batched=bool(lead)))
        xp, lay["x_layout"] = po.data, po.layout
    if "y" in forms:
        po = packing.pack_gemm(y, packing.gemm_layout(
            Ger.F64GER, k, n, batched=y.ndim == 3))
        yp, lay["y_layout"] = po.data, po.layout
    if lay:
        assert torch.equal(G.mma_gemm(xp, yp, c, **kw, **lay), got)
    if "sidecar" in forms:
        out, ck_col, ck_row = G.mma_gemm(xp, yp, c, checksum=True, **kw,
                                         **lay)
        assert torch.equal(out, got)
        eps = torch.finfo(torch.float64).eps
        mag = torch.matmul(x.abs(), yn.abs())
        for ck, want_ck, mag_ck in zip(
                (ck_col, ck_row), G.checksum_tiles(want, *block[:2]),
                G.checksum_tiles(mag, *block[:2])):
            assert ck.dtype == torch.float64
            err = (ck - want_ck).abs()
            assert bool((err <= abft.ATOL + abft.FACTOR * eps * mag_ck
                         ).all()), err.max().item()


# ----------------------------------------------------------------------
# The split-KV decode kernel (mma_attention.cu flash_decode_kernel: four
# warps a (b, h, split), 16-row mma.sync slices or fp32 FMAs on the same
# fragments, the splits merged as one cluster) and the fp32 tile
# (flash_f32_tile_kernel: eight warps of 16 or 8 rows, 64-key steps, 32
# at depth 160):
# every form the wrapper sends them, at every compiled depth
# ----------------------------------------------------------------------

# form: ((B, Sq, H, KVH), Sk, flags); D and the dtype come from the
# parameters.  "valid": batch 0 has no valid slot, batch 1 loses its
# second and third KV blocks.
_DECODE_FORMS = {
    "cross Sq=1 Sk=1500": ((4, 1, 12, 12), 1500, dict(causal=False)),
    "gqa 4 Sq=4 causal q_offset": ((2, 4, 8, 2), 700,
                                   dict(causal=True, q_offset=696)),
    "Sq=20 window q_offset": ((2, 20, 4, 4), 900,
                              dict(causal=True, q_offset=880, window=300)),
    "Sq=64 Sk=333": ((1, 64, 4, 1), 333, dict(causal=False)),
    "valid, masked rows": ((2, 1, 8, 2), 700, dict(causal=False)),
    "epilogue bias silu residual": ((2, 2, 8, 4), 900, dict(causal=False)),
    "full grid causal": ((2, 4, 4, 4), 1024,
                         dict(causal=True, q_offset=200)),
    "8 splits, the cluster's most": ((2, 1, 2, 2), 4096,
                                     dict(causal=False)),
}
_DECODE_TYPES = ([(torch.bfloat16, d) for d in A.KERNEL_HEAD_DIMS]
                 + [(torch.float16, d) for d in A.KERNEL_HEAD_DIMS]
                 + [(torch.float32, d) for d in A.F32_HEAD_DIMS])


@pytest.mark.parametrize("dt,d", _DECODE_TYPES,
                         ids=[f"{str(t)[6:]}-{d}" for t, d in _DECODE_TYPES])
@pytest.mark.parametrize("form", sorted(_DECODE_FORMS))
def test_decode_kernel_forms(gen, form, dt, d):
    """Each split-KV form on the decode kernel (the splits merged as one
    cluster, at most 8 of them), counted in its mode,
    within its rounding budget of the plain version and of the split-KV
    plain version (P rounded per warp against its running max, the splits
    merged in order); fully masked rows exact zeros; the full grid bit for
    bit the bounded launch; row 0 of batch 1 bit for bit the same row in
    the batch; two launches the same bits (the merge's order is
    fixed)."""
    (b, sq, h, kvh), sk, kw = _DECODE_FORMS[form]
    q = _randn(gen, b, sq, h, d, dtype=dt)
    k, v = _randn(gen, b, sk, kvh, d, dtype=dt), _randn(gen, b, sk, kvh, d,
                                                        dtype=dt)
    kw = dict(kw)
    out_dtype = torch.float32
    if form.startswith("valid"):
        valid = torch.ones((b, sk), dtype=torch.bool, device="cuda")
        valid[0] = False
        valid[1, 64:192] = False
        kw["valid"] = valid
    if form.startswith("epilogue"):
        kw.update(ep=E.Epilogue(bias=True, activation="silu",
                                residual=True),
                  bias=_randn(gen, d, dtype=torch.float32),
                  residual=_randn(gen, b, sq, h, d, dtype=dt))
        out_dtype = dt
    n_split, per = A.split_kv_plan(h, sq, sk)
    assert n_split > 1
    # at most 8 splits, one cluster; a long cache takes longer splits
    assert n_split <= A.DECODE_CLUSTER_MAX
    if form.startswith("8 splits"):
        assert n_split == A.DECODE_CLUSTER_MAX
        assert per > A.SPLIT_MIN_BLOCKS
    mode = ("f32_" if dt == torch.float32 else "") + "split"
    before = A.mma_flash_attention.launches_by_mode[mode]
    got = A.mma_flash_attention(q, k, v, out_dtype=out_dtype, **kw)
    again = A.mma_flash_attention(q, k, v, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert A.mma_flash_attention.launches_by_mode[mode] == before + 2
    assert torch.equal(got, again)
    flags = {f: kw[f] for f in ("causal", "q_offset", "window", "valid",
                                "ep") if f in kw}
    budget = A.rounding_budget(q, k, v, **flags)
    _attn_store_ok(got, A.flash_attention_plain(
        q, k, v, out_dtype=torch.float32, **kw), budget, out_dtype)
    _attn_store_ok(got, A.flash_attention_splitkv_plain(
        q, k, v, n_split=n_split, per=per, out_dtype=torch.float32, **kw),
        budget, out_dtype)
    if form.startswith("valid"):
        assert bool((got[0] == 0).all())
    if form.startswith("full grid"):
        assert torch.equal(A.mma_flash_attention(
            q, k, v, out_dtype=out_dtype, bound_grid=False, **kw), got)
    one = A.mma_flash_attention(
        q[:1], k[:1], v[:1], out_dtype=out_dtype,
        **{f: (x[:1] if torch.is_tensor(x) and x.dim() > 1 else x)
           for f, x in kw.items()})
    assert torch.equal(one[0], got[0])


# form: ((B, Sq, H), (Sk, KVH), flags) on the fp32 tile
_F32_TILE_FORMS = {
    "causal gqa 4, Sk 300": ((2, 300, 8), (300, 2), dict(causal=True)),
    "window 90": ((1, 300, 4), (300, 4), dict(causal=True, window=90)),
    "q_offset 256": ((2, 100, 8), (356, 8), dict(causal=True, q_offset=256)),
    "valid, masked rows": ((2, 200, 8), (200, 2), dict(causal=True)),
    "epilogue bias gelu residual": ((2, 130, 8), (250, 8),
                                    dict(causal=False)),
    "full grid, window": ((1, 500, 4), (500, 4),
                          dict(causal=True, window=200)),
    "batch 1 row in batch 4": ((4, 256, 32), (256, 32), dict(causal=True)),
}


@pytest.mark.parametrize("d", A.F32_HEAD_DIMS)
@pytest.mark.parametrize("form", sorted(_F32_TILE_FORMS))
def test_f32_tile_redesign_forms(gen, form, d):
    """Each form on both fp32 tiles (128 rows: eight warps of 16; 64 rows:
    eight of 8) within the f32 budget of the plain version (no P
    rounding), the two tiles bit for bit alike (a row's sums do not depend
    on the tile); fully masked rows exact zeros; the full grid bit for bit
    the bounded launch; row 0 of batch 1 bit for bit the same row in a
    batch of 4 (the 64-row tile at batch 1, the 128-row one at batch 4
    at depths 128 and 160)."""
    (b, sq, h), (sk, kvh), kw = _F32_TILE_FORMS[form]
    f32 = torch.float32
    q = _randn(gen, b, sq, h, d, dtype=f32)
    k, v = _randn(gen, b, sk, kvh, d, dtype=f32), _randn(gen, b, sk, kvh, d,
                                                         dtype=f32)
    kw = dict(kw)
    out_dtype = f32
    if form.startswith("valid"):
        valid = torch.ones((b, sk), dtype=torch.bool, device="cuda")
        valid[1, :150] = False
        valid[0, 77:93] = False
        kw["valid"] = valid
    if form.startswith("epilogue"):
        kw.update(ep=E.Epilogue(bias=True, activation="gelu",
                                residual=True),
                  bias=_randn(gen, d, dtype=f32),
                  residual=_randn(gen, b, sq, h, d, dtype=f32))
    assert A.split_kv_plan(h, sq, sk)[0] == 1
    before = A.mma_flash_attention.launches_by_mode["f32_tile"]
    outs = [A.mma_flash_attention(q, k, v, out_dtype=out_dtype,
                                  tuned=(bq, 1), **kw) for bq in (64, 128)]
    torch.cuda.synchronize()
    assert A.mma_flash_attention.launches_by_mode["f32_tile"] == before + 2
    flags = {f: kw[f] for f in ("causal", "q_offset", "window", "valid",
                                "ep") if f in kw}
    want = A.flash_attention_plain(q, k, v, out_dtype=f32, **kw)
    budget = A.rounding_budget(q, k, v, **flags)
    for got in outs:
        _attn_store_ok(got, want, budget, out_dtype)
    assert torch.equal(outs[0], outs[1])
    if form.startswith("valid"):
        assert bool((outs[0][1, :150] == 0).all())
    if form.startswith("full grid"):
        assert torch.equal(A.mma_flash_attention(
            q, k, v, out_dtype=out_dtype, bound_grid=False, **kw), outs[0])
    if form.startswith("batch"):
        assert A.attn_plan(1, h, sq, sk, d, True)[0] == 64
        assert A.attn_plan(4, h, sq, sk, d, True)[0] == (
            128 if d >= 128 else 64)
        one = A.mma_flash_attention(q[:1], k[:1], v[:1], out_dtype=f32, **kw)
        many = A.mma_flash_attention(q, k, v, out_dtype=f32, **kw)
        assert torch.equal(one[0], many[0])


@pytest.mark.parametrize("d", A.F32_HEAD_DIMS)
def test_f32_redesign_refuses_tf32(gen, d):
    """The f32 budget's TF32 control on the redesigned kernels, at every
    fp32 depth: the fp32 tile (both tiles) and the decode kernel meet the
    budget, and the plain version on q and k rounded to TF32 lands more
    than twice outside it."""
    f32 = torch.float32
    for (b, sq, h, kvh), sk, kw, tiles in (
            ((2, 256, 8, 2), 256, dict(causal=True), ((64, 1), (128, 1))),
            ((4, 1, 12, 12), 1500, dict(causal=False), (None,))):
        q = _randn(gen, b, sq, h, d, dtype=f32)
        k = _randn(gen, b, sk, kvh, d, dtype=f32)
        v = _randn(gen, b, sk, kvh, d, dtype=f32)
        want = A.flash_attention_plain(q, k, v, out_dtype=f32, **kw)
        tol = A.rounding_budget(q, k, v, **kw) + 2.0 ** -20 * want.abs().max()
        for tuned in tiles:
            got = A.mma_flash_attention(q, k, v, out_dtype=f32, tuned=tuned,
                                        **kw)
            assert bool(((got - want).abs() <= tol).all())
        q32, k32 = (_tf32(t) for t in (q, k))
        tf32 = A.flash_attention_plain(q32, k32, v, out_dtype=f32, **kw)
        assert ((tf32 - want).abs() / tol).max().item() > 2


# ----------------------------------------------------------------------
# K1's wgmma tile (gemm_wgmma.cu: a (128, 64 / 128 / 192 / 256) tile a
# block, the width core/tiling.py's wgmma_plan picks): every form at
# every compiled tile
# ----------------------------------------------------------------------

# name: (batch, (M, K, N), forms): "x" / "y" packed panels, "shared" (Y
# panels without the batch axis), "seed" (a C seed with alpha, beta and
# both negations), "ep" (bias + gelu + residual), "bf16 out", "sidecar"
# (checksum=True).  M = 1100 and N = 2104 put more tiles than SMs on the
# card at every tile width; K and N multiples of 8 (TMA's rule), neither
# of the tile's steps.
_WGMMA_FORMS = {
    "natural": ((), (300, 512, 264), ()),
    "many tiles": ((), (1100, 256, 2104), ()),
    "fringes": ((), (1000, 328, 1000), ()),
    "X panels": ((), (300, 328, 264), ("x",)),
    "Y panels": ((), (300, 328, 1000), ("y",)),
    "X and Y panels": ((), (300, 328, 1000), ("x", "y")),
    "seeded": ((), (300, 512, 264), ("seed",)),
    "epilogue": ((), (300, 512, 264), ("ep",)),
    "bf16 out": ((), (1100, 256, 2104), ("ep", "bf16 out")),
    "batched": ((3,), (130, 200, 264), ()),
    "batched panels": ((3,), (130, 200, 264), ("x", "y")),
    "shared": ((3,), (130, 200, 264), ("y", "shared")),
    "moe banks": ((16,), (96, 512, 1408), ("y",)),
    "ssd chunks": ((8,), (256, 64, 256), ()),
    "sidecar": ((), (300, 768, 1000), ("sidecar",)),
}


_WGMMA_FORM_CFGS = [(form, cfg) for form in sorted(_WGMMA_FORMS)
                    for cfg in tiling.WGMMA_TILES]


@pytest.mark.parametrize("kind", [Ger.BF16GER2, Ger.F16GER2])
@pytest.mark.parametrize("form,cfg", _WGMMA_FORM_CFGS)
def test_wgmma_tile_forms_match_plain(gen, form, cfg, kind):
    """The wgmma tile at each compiled width (a planted winner): one
    launch on the wgmma path, finite, within the f32 tolerance of the
    plain version (a 16-bit store within one ulp of it), bit for bit the
    launch on the heuristic's plan (the k order and the epilogue do not
    depend on the tile); on packed panels bit for bit the natural launch;
    with the sidecar, ``out`` bit for bit and the sums within ABFT's
    tolerance of the plain result's."""
    from repro_torch.core import abft, packing
    lead, (m, k, n), forms = _WGMMA_FORMS[form]
    bn = cfg.bn
    dt = precision.policy(kind).x_dtype
    x = _randn(gen, *lead, m, k, dtype=dt)
    y = _randn(gen, *(() if "shared" in forms else lead), k, n, dtype=dt,
               scale=k ** -0.5)
    yn = y.expand(*lead, k, n).contiguous() if "shared" in forms else y
    out_dtype = torch.bfloat16 if "bf16 out" in forms else torch.float32
    kw = dict(kind=kind, out_dtype=out_dtype)
    c = None
    if "seed" in forms:
        c = _randn(gen, *lead, m, n, dtype=torch.float32)
        kw.update(alpha=0.75, beta=-0.5, neg_product=True, neg_acc=True)
    if "ep" in forms:
        kw.update(ep=E.Epilogue(bias=True, activation="gelu", residual=True),
                  bias=_randn(gen, n, dtype=torch.float32),
                  residual=_randn(gen, *lead, m, n, dtype=out_dtype))
    tuned = ("wgmma", cfg)
    assert tiling.takes(tuned, m, n, k, kind)
    before = G.mma_gemm.launches_by_path["wgmma"]
    got = G.mma_gemm(x, yn, c, tuned=tuned, **kw)
    again = G.mma_gemm(x, yn, c, **kw)
    torch.cuda.synchronize()
    assert G.mma_gemm.launches_by_path["wgmma"] == before + 2
    assert torch.equal(got, again)
    want = G.mma_gemm_plain(x, yn, c, **kw)
    assert bool(torch.isfinite(got).all())
    if out_dtype == torch.float32:
        _assert_f32_close(got, want)
    else:
        _assert_store_close(got, want.float(), out_dtype)
    if "x" in forms or "y" in forms:
        xp, yp, lay = x, y, {}
        if "x" in forms:
            po = packing.pack_gemm(x, packing.gemm_layout(
                kind, m, k, side="x", batched=bool(lead)))
            xp, lay["x_layout"] = po.data, po.layout
        if "y" in forms:
            po = packing.pack_gemm(y, packing.gemm_layout(
                kind, k, n, batched=y.ndim == 3))
            yp, lay["y_layout"] = po.data, po.layout
        assert torch.equal(G.mma_gemm(xp, yp, c, tuned=tuned, **kw, **lay),
                           got)
    if "sidecar" in forms:
        out, ck_col, ck_row = G.mma_gemm(x, y, c, checksum=True,
                                         tuned=tuned, **kw)
        assert torch.equal(out, got)
        eps = torch.finfo(torch.float32).eps
        mag = torch.matmul(x.double().abs(), y.double().abs())
        for ck, want_ck, mag_ck in zip(
                (ck_col, ck_row), G.checksum_tiles(want, 128, bn),
                G.checksum_tiles(mag, 128, bn)):
            err = (ck.double() - want_ck.double()).abs()
            assert bool((err <= abft.ATOL + abft.FACTOR * eps * mag_ck
                         ).all()), err.max()


# ----------------------------------------------------------------------
# K3's fp32 conv on the fp32 SIMT tile (mma_conv.cu's conv_f32_kernel on
# tile_gemm.cuh's f32_simt_tile, ConvGatherA::chunk4)
# ----------------------------------------------------------------------

def _fma_chain(a, b):
    """(M, K) @ (K, N) as one fp32 fmaf chain an output, k ascending from
    +0.0: each step's exact a*b + acc (TwoSum in float64) rounded once to
    fp32, a double rounding that lands on an fp32 midpoint broken by the
    sum's error."""
    f64 = torch.float64
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for kk in range(a.shape[1]):
        p = a[:, kk:kk + 1].to(f64) * b[kk:kk + 1, :].to(f64)   # exact
        c = acc.to(f64)
        s = p + c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        r = s.to(torch.float32)
        d = s - r.to(f64)
        hi = torch.nextafter(r, torch.full_like(r, float("inf")))
        lo = torch.nextafter(r, torch.full_like(r, float("-inf")))
        up = (d == (hi.to(f64) - r.to(f64)) / 2) & (err > 0)
        down = (d == (lo.to(f64) - r.to(f64)) / 2) & (err < 0)
        acc = torch.where(up, hi, torch.where(down, lo, r))
    return acc


# name: (image NHWC, filters HWIO, stride, misaligned image base): C = 3
# (qwen2-vl's patch embed: element loads), C = 80 (whisper's conv1: 16-byte
# loads; off a 16-byte base: element loads) and C = 768 (whisper's conv2);
# M, F and K past each tile's edge
_F32_CONV_FORMS = {
    "C=3 patch": ((2, 42, 56, 3), (14, 14, 3, 200), (14, 14), False),
    "C=80 conv1": ((1, 1, 70, 80), (1, 3, 80, 130), (1, 1), False),
    "C=80 unaligned": ((1, 1, 70, 80), (1, 3, 80, 130), (1, 1), True),
    "C=768 conv2": ((1, 1, 101, 768), (1, 3, 768, 72), (1, 2), False),
    "C=5 2-D": ((2, 9, 11, 5), (3, 3, 5, 136), (1, 2), False),
}


@pytest.mark.parametrize("form", sorted(_F32_CONV_FORMS))
def test_f32_conv_simt_tile_bit_for_bit(gen, form):
    """The fp32 conv on both fp32 tiles and on the packed filter stream:
    bit for bit ref.conv2d's patch product summed as one fmaf chain an
    output in ascending k (the chain the parent kernel took), the three
    launches alike; with bias + gelu + residual within the f32 tolerance
    of the plain version."""
    from repro_torch.core import packing
    from repro_torch.kernels import ref
    shape, fshape, stride, misaligned = _F32_CONV_FORMS[form]
    f32 = torch.float32
    n, h, w, c = shape
    kh, kw, _, f = fshape
    if misaligned:
        buf = _randn(gen, n * h * w * c + 1, dtype=f32)
        x = buf[1:].view(shape)
    else:
        x = _randn(gen, *shape, dtype=f32)
    filt = _randn(gen, *fshape, dtype=f32, scale=(kh * kw * c) ** -0.5)
    assert (tiling.conv_gather_bytes(c, kw, w, stride[1], x.data_ptr())
            == 16) == (c % 8 == 0 and not misaligned)
    before = K.mma_conv2d.launches_by_path["f32"]
    outs = [K.mma_conv2d(x, filt, stride=stride, out_dtype=f32, bf=bf)
            for bf in (128, 64)]
    po = packing.pack_conv(filt, packing.conv_layout(Ger.F32GER, kh, kw, c,
                                                     f, nd=2))
    outs.append(K.mma_conv2d(x, po.data, w_layout=po.layout, stride=stride,
                             out_dtype=f32))
    torch.cuda.synchronize()
    assert K.mma_conv2d.launches_by_path["f32"] == before + 3
    oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
    patches = [x[:, i:i + (oh - 1) * stride[0] + 1:stride[0],
                 j:j + (ow - 1) * stride[1] + 1:stride[1], :]
               for i in range(kh) for j in range(kw)]
    abar = torch.cat(patches, dim=-1).reshape(n * oh * ow, kh * kw * c)
    want = _fma_chain(abar, filt.reshape(kh * kw * c, f)).reshape(
        n, oh, ow, f)
    for got in outs:
        assert torch.equal(got, want)
    _assert_f32_close(want, ref.conv2d(x, filt, stride))
    ep = dict(ep=E.Epilogue(bias=True, activation="gelu", residual=True),
              bias=_randn(gen, f, dtype=f32),
              residual=_randn(gen, n, oh, ow, f, dtype=f32))
    got = K.mma_conv2d(x, filt, stride=stride, out_dtype=f32, **ep)
    _assert_f32_close(got, K.mma_conv2d_plain(x, filt, stride=stride,
                                              out_dtype=f32, **ep))


# ----------------------------------------------------------------------
# The 16-bit weight stream on Hopper: a TMA producer, work units sized to
# the card (csrc/gemm_stream.cu's gemm_stream_tma_kernel)
# ----------------------------------------------------------------------

# form: (batch, (M, K, N), forms): each row bucket; natural, X and Y
# panels, a shared Y; the sidecar; an unaligned N (the cp.async kernel);
# the seed and epilogue; f16; a batch of banks whose units fold every
# slice (no partial) and a batch whose units span slices
_STREAM_FORMS = {
    "bucket 8": (None, (4, 1024, 2048), ()),
    "bucket 16": (None, (13, 1024, 2048), ()),
    "bucket 32": (None, (30, 1024, 1408), ()),
    "bucket 64": (None, (64, 768, 2048), ()),
    "one split, bn 128": (None, (4, 256, 40000), ()),
    "K fringe": (None, (5, 1000, 1032), ()),
    "X panels": (None, (4, 1024, 2048), ("x",)),
    "Y panels": (None, (4, 1024, 2048), ("y",)),
    "X and Y panels": (None, (30, 1000, 1032), ("x", "y")),
    "shared Y panels": (3, (4, 1024, 2048), ("y", "shared")),
    "sidecar": (None, (4, 1024, 2048), ("sidecar",)),
    "unaligned N": (None, (4, 768, 5187), ()),
    "seed and epilogue": (None, (7, 512, 1032), ("seed", "ep")),
    "f16": (None, (4, 1024, 2048), ("f16",)),
    "banks cap 1": (64, (1, 512, 1408), ()),
    "banks cap 30 panels": (64, (30, 1408, 512), ("y",)),
    "batch spanning slices": (4, (2, 2048, 1408), ()),
}


@pytest.mark.parametrize("form", sorted(_STREAM_FORMS))
def test_stream_redesign_forms(gen, form):
    """Each form on the stream path: within the 16-bit store's tolerance
    of the split-K plain version (the plan's K slices), the same bits on a
    second launch, packed and shared forms bit for bit the natural launch,
    the sidecar's ``out`` bit for bit the launch without it; a batch bit
    for bit its products run one at a time (b = 1: the slices on blocks of
    their own, with partials)."""
    from repro_torch.core import packing
    b, (m, k, n), forms = _STREAM_FORMS[form]
    kind = Ger.F16GER2 if "f16" in forms else Ger.BF16GER2
    dt = precision.policy(kind).x_dtype
    lead = () if b is None else (b,)
    x = _randn(gen, *lead, m, k, dtype=dt)
    y = _randn(gen, *(() if "shared" in forms else lead), k, n, dtype=dt,
               scale=k ** -0.5)
    yn = y.expand(*lead, k, n).contiguous() if "shared" in forms else y
    out_dtype = torch.float16 if "f16" in forms else torch.bfloat16
    kw = dict(kind=kind, out_dtype=out_dtype)
    c = None
    if "seed" in forms:
        c = _randn(gen, *lead, m, n, dtype=torch.float32)
        kw.update(alpha=0.75, beta=-0.5, neg_acc=True)
    if "ep" in forms:
        kw.update(ep=E.Epilogue(bias=True, activation="silu", residual=True),
                  bias=_randn(gen, n, dtype=torch.float32),
                  residual=_randn(gen, *lead, m, n, dtype=out_dtype))
    cfg = tiling.choose_gemm_path(m, n, k, kind, b or 1)[1]
    before = G.mma_gemm.launches_by_path["stream"]
    got = G.mma_gemm(x, yn, c, **kw)
    again = G.mma_gemm(x, yn, c, **kw)
    torch.cuda.synchronize()
    assert G.mma_gemm.launches_by_path["stream"] == before + 2
    assert torch.equal(got, again)
    want = G.mma_gemm_splitk_plain(x, yn, c, k_slices=cfg.k_slices(k), **kw)
    assert bool(torch.isfinite(got).all())
    _assert_store_close(got, want.float(), out_dtype)
    if "x" in forms or "y" in forms:
        pkw = dict(kw)
        xk, yk = x, y
        if "x" in forms:
            po = packing.pack_gemm(x, packing.gemm_layout(
                kind, m, k, side="x", batched=b is not None))
            xk, pkw["x_layout"] = po.data, po.layout
        if "y" in forms:
            po = packing.pack_gemm(y, packing.gemm_layout(
                kind, k, n, batched=b is not None and "shared" not in forms))
            yk, pkw["y_layout"] = po.data, po.layout
        assert torch.equal(G.mma_gemm(xk, yk, c, **pkw), got)
    if "sidecar" in forms:
        # the sums within ABFT's tolerance of the plain result's, as in
        # test_sidecar_bit_for_bit_and_sums_match_plain
        from repro_torch.core import abft
        out, ck_col, ck_row = G.mma_gemm(x, yn, c, checksum=True, **kw)
        assert torch.equal(out, got)
        _, col, row = G.mma_gemm_sidecar_plain(
            x, yn, c, **{key: v for key, v in kw.items()
                         if key != "out_dtype"})
        mag = x.double().abs() @ yn.double().abs()
        eps = torch.finfo(torch.float32).eps
        for have, want_s, mg in zip((ck_col, ck_row), (col, row),
                                    G.checksum_tiles(mag, m, cfg.bn)):
            err = (have.double() - want_s.double()).abs()
            assert bool((err <= abft.ATOL + abft.FACTOR * eps * mg).all())
    if b is not None:
        one = torch.stack([G.mma_gemm(x[i], yn[i], None if c is None
                                      else c[i], **kw) for i in range(b)])
        assert torch.equal(one, got)


def test_stream_banks_fold_every_slice_and_one_expert_splits():
    """The plan behind the bank form above: deepseek-moe-16b's banks at b
    = 64 fold all of a tile's slices in one unit (no partials), and a
    single expert at b = 1 spreads the same slices over units of one."""
    for m, k, n in ((1, 2048, 1408), (30, 2048, 1408), (1, 1408, 2048),
                    (30, 1408, 2048)):
        cfg = tiling.choose_gemm_path(m, n, k, Ger.BF16GER2, 64)[1]
        assert cfg.split > 1 and not cfg.partials(n, 64)
        assert cfg.run(n) == 1 and cfg.partials(n)


def _conv_target(gen, name):
    shapes = {"whisper conv1": ((2, 1, 1002, 80), (1, 3, 80, 768), (1, 1)),
              "whisper conv2": ((2, 1, 1001, 768), (1, 3, 768, 768),
                                (1, 2)),
              "qwen2-vl patch": ((1, 224, 224, 3), (14, 14, 3, 1280),
                                 (14, 14))}
    ishape, wshape, stride = shapes[name]
    x = _randn(gen, *ishape)
    kh, kw, c, f = wshape
    w = _randn(gen, *wshape, scale=(kh * kw * c) ** -0.5)
    return x, w, stride


@pytest.mark.parametrize("cfg", tiling.CONV_WGMMA_TILES,
                         ids=lambda c: f"bn{c.bn}")
@pytest.mark.parametrize("name", ["whisper conv1", "whisper conv2",
                                  "qwen2-vl patch"])
def test_conv_wgmma_every_tile_bit_for_bit(gen, name, cfg):
    """K3's wgmma conv at each compiled filter tile (a planted winner):
    one launch on the wgmma path, bit for bit the launch on the plan's
    tile (k order and epilogue do not depend on the tile), within one bf16
    ulp of the plain version, and on packed filters bit for bit natural."""
    from repro_torch.core import packing
    x, w, stride = _conv_target(gen, name)
    kh, kw, c, f = w.shape
    ep = dict(ep=E.Epilogue(bias=True, activation="gelu"),
              bias=_randn(gen, f, dtype=torch.float32),
              out_dtype=torch.bfloat16, stride=stride)
    before = K.mma_conv2d.launches_by_path["wgmma"]
    planned = K.mma_conv2d(x, w, **ep)
    got = K.mma_conv2d(x, w, tuned=("wgmma", cfg), **ep)
    pc = packing.pack_conv(w, packing.conv_layout(Ger.BF16GER2, kh, kw, c,
                                                  f))
    packed = K.mma_conv2d(x, pc.data, w_layout=pc.layout,
                          tuned=("wgmma", cfg), **ep)
    torch.cuda.synchronize()
    assert K.mma_conv2d.launches_by_path["wgmma"] == before + 3
    assert torch.equal(got, planned) and torch.equal(packed, got)
    _assert_store_close(got, K.mma_conv2d_plain(x, w, **ep).float(),
                        torch.bfloat16)


def _thread_calls(gen):
    """(library, call) pairs: each library's launch of an instance above
    48 KB of dynamic shared memory."""
    ints = torch.randint(-300, 300, (256, 512), generator=gen,
                         device="cuda", dtype=torch.int16)
    f64 = torch.randn(512, 512, generator=gen, device="cuda",
                      dtype=torch.float64)
    xs, ys = (_randn(gen, 4, 4096), _randn(gen, 256, 1024)), (
        _randn(gen, 4096, 4096, scale=1 / 64), _randn(gen, 1024, 1024,
                                                      scale=1 / 32))
    q, kv = _randn(gen, 1, 512, 8, 128), _randn(gen, 1, 512, 8, 128)
    img, filt = _randn(gen, 2, 1, 1001, 768), _randn(gen, 1, 3, 768, 768,
                                                     scale=0.02)
    return {
        "gemm_stream": lambda: G.mma_gemm(xs[0], ys[0]),
        "gemm_wgmma": lambda: G.mma_gemm(xs[1], ys[1]),
        "mma_gemm": lambda: G.mma_gemm(xs[1], ys[1], block=(128, 128, 32)),
        "gemm_imma": lambda: G.mma_gemm(ints, ints.t().contiguous(),
                                        kind=Ger.I16GER2),
        "gemm_dmma": lambda: G.mma_gemm(f64, f64, kind=Ger.F64GER),
        "mma_attention": lambda: A.mma_flash_attention(q, kv, kv,
                                                       causal=True),
        "mma_conv": lambda: K.mma_conv2d(img, filt),
    }


@pytest.mark.parametrize("lib", ["gemm_stream", "gemm_wgmma", "mma_gemm",
                                 "gemm_imma", "gemm_dmma", "mma_attention",
                                 "mma_conv"])
def test_first_launch_on_a_fresh_thread(gen, lib):
    """ROADMAP queue 3: each library's instance above 48 KB of shared
    memory, launched on the main thread, then for the first time on a
    fresh host thread (as the autograd engine's): it launches, and gives
    the main thread's bits."""
    import threading
    call = _thread_calls(gen)[lib]
    main = call()
    torch.cuda.synchronize()
    got, errs = [], []

    def run():
        try:
            got.append(call())
            torch.cuda.synchronize()
        except RuntimeError as e:
            errs.append(str(e))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errs, errs
    assert torch.equal(got[0], main)
