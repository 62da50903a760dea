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
        K.mma_conv2d(x.float(), w.float(), bf=128)


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
            torch.cuda.current_stream().cuda_stream)    # family 7: refused
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
    """On the card too, panels whose path reads none (an explicit block
    names the WMMA tile; F32GER's conv takes the fp32 tile) are demoted
    by the wrapper, once each, counted, and launch as the natural call."""
    from repro_torch.core import packing
    x = _randn(gen, 100, 256)
    w = _randn(gen, 256, 136, scale=256 ** -0.5)
    po = _packed_y(w)
    packing.clear_state()
    _same_path_bits(lambda: G.mma_gemm(x, w, block=(64, 64, 64)),
                    lambda: G.mma_gemm(x, po.data, block=(64, 64, 64),
                                       y_layout=po.layout), "wmma")
    img = torch.randn(1, 8, 8, 4, generator=gen, device="cuda")
    wc = torch.randn(3, 3, 4, 72, generator=gen, device="cuda")
    pc = packing.pack_conv(wc, packing.conv_layout(Ger.F32GER, 3, 3, 4, 72))
    before = K.mma_conv2d.launches_by_path["f32"]
    want = K.mma_conv2d(img, wc)
    got = K.mma_conv2d(img, pc.data, w_layout=pc.layout)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.mma_conv2d.launches_by_path["f32"] == before + 2
    assert [e["why"] for e in packing.EVENTS if e["event"] == "demote"] == [
        "wmma-tile-reads-no-panels", "conv-f32-tile-reads-no-panels"]


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
