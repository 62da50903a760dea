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
