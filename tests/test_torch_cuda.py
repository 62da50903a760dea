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
normalised P once); the depthwise conv within ``rtol=1e-5, atol=1e-6 *
max|ref|`` for an f32 store (the same products summed in the same order;
only silu/gelu's exp/erf differ) and one ulp plus that for a 16-bit store.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.base import reduced
from repro_torch.core import facility
from repro_torch.core import precision
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
    if kw == dict(causal=True):
        assert bool((got[1] == 0).all())


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
