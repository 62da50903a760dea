"""Gradients through the port's kernel wrappers, on the CPU.

Each wrapper runs as a ``torch.autograd.Function`` where an operand
requires a gradient; on a CPU tensor its forward is the plain version and
its backward the same code the card runs (more GEMM products through
``mma_gemm``; for attention and the convs a recomputation through the
torch lowering).  Held here against autograd through the plain versions
and the torch lowering, on numpy inputs from a seed:

  * the GEMM in F32GER: within ``rtol=atol=1e-5`` of max|ref| per operand
    gradient (fp32 products summed in another order);
  * the GEMM in BF16GER2: relative L2 within 2^-7 per operand gradient:
    the Function casts dZ to bf16 for its products, autograd through the
    plain version keeps it in fp32, so dZ differs by a bf16 half-ulp;
  * attention and the convs: the recomputation is the torch lowering
    itself, so their gradients agree within 1e-6 of max|ref| (the
    forward's plain version differs from it only by fp32 sum order, which
    the backward never sees).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import lowering, precision
from repro_torch.kernels import epilogue as E
from repro_torch.kernels import mma_attention as A
from repro_torch.kernels import mma_conv as K
from repro_torch.kernels import mma_gemm as G

Ger = precision.Ger


def _leaf(rng, shape, dtype=torch.float32, scale=1.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dtype).requires_grad_(True)


def _grads(out, leaves, dout):
    return torch.autograd.grad(out, [t for t in leaves if t is not None],
                               dout)


def _close(got, want, rtol):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert torch.allclose(g.float(), w.float(), rtol=rtol,
                              atol=rtol * scale), float((g - w).abs().max())


def _rel_l2(got, want, bound):
    for g, w in zip(got, want):
        r = float((g.float() - w.float()).norm() / w.float().norm())
        assert r <= bound, r


_FORMS = {
    "plain": dict(),
    "neg alpha": dict(neg_product=True, alpha=0.5),
    "seed beta neg_acc": dict(seed=True, beta=-1.5, neg_acc=True, alpha=2.0),
    "bias gelu residual": dict(ep=("gelu", True, True)),
    "silu": dict(ep=("silu", False, False)),
    "relu bias seed": dict(ep=("relu", True, False), seed=True, alpha=0.75),
}


def _gemm_case(rng, form, dtype, batched, m=24, k=40, n=16):
    lead = (3,) if batched else ()
    x = _leaf(rng, lead + (m, k), dtype)
    y = _leaf(rng, lead + (k, n), dtype, scale=k ** -0.5)
    c = _leaf(rng, lead + (m, n)) if form.get("seed") else None
    ep = bias = res = None
    if "ep" in form:
        act, has_bias, has_res = form["ep"]
        ep = E.Epilogue(bias=has_bias, activation=act, residual=has_res)
        bias = _leaf(rng, (n,)) if has_bias else None
        res = _leaf(rng, lead + (m, n), dtype) if has_res else None
    kw = {f: form[f] for f in ("neg_product", "neg_acc", "alpha", "beta")
          if f in form}
    return (x, y, c, bias, res), dict(ep=ep, **kw)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_gemm_function_matches_autograd_of_plain(kind, form, batched):
    rng = np.random.default_rng(sum(map(ord, form)) + batched)
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    ger = Ger.F32GER if kind == "f32" else Ger.BF16GER2
    (x, y, c, bias, res), kw = _gemm_case(rng, _FORMS[form], dtype, batched)
    leaves = (x, y, c, bias, res)
    out = G.mma_gemm(x, y, c, kind=ger, bias=bias, residual=res,
                     out_dtype=torch.float32, **kw)
    want_out = G.mma_gemm_plain(x, y, c, kind=ger, bias=bias, residual=res,
                                out_dtype=torch.float32, **kw)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    got = _grads(out, leaves, dout)
    want = _grads(want_out, leaves, dout)
    if kind == "f32":
        _close(got, want, 1e-5)
    else:
        _rel_l2(got, want, 2.0 ** -7)
    for g, t in zip(got, [t for t in leaves if t is not None]):
        assert g.dtype == t.dtype and g.shape == t.shape


def test_gemm_function_counts_launches_per_product():
    """The backward's products go through the wrapper: on the CPU no
    launch is counted, and the GEMM with a fused activation recomputes Z
    once (one product) before dX and dY (two more)."""
    rng = np.random.default_rng(0)
    calls = []
    orig = G._mma_gemm

    def spy(*a, **kw):
        calls.append(kw.get("ep"))
        return orig(*a, **kw)

    x, y = _leaf(rng, (8, 32)), _leaf(rng, (32, 16))
    G._mma_gemm = spy
    try:
        out = G.mma_gemm(x, y, kind=Ger.F32GER,
                         ep=E.Epilogue(activation="silu"))
        out.sum().backward()
    finally:
        G._mma_gemm = orig
    assert len(calls) == 4          # forward, recompute, dX, dY
    assert G.mma_gemm.launches == 0


def test_gemm_function_refuses_integer_families():
    x = torch.ones((4, 8), requires_grad=True)
    with pytest.raises(TypeError, match="integer"):
        G.mma_gemm(x, torch.ones((8, 4)), kind=Ger.I8GER4)


def test_no_function_without_a_gradient():
    """Under no_grad (or inference mode) the wrapper is the plain
    dispatch: the output has no graph."""
    x = torch.ones((4, 8), requires_grad=True)
    with torch.inference_mode():
        assert G.mma_gemm(x.detach(), torch.ones((8, 4)),
                          kind=Ger.F32GER).grad_fn is None
    with torch.no_grad():
        assert G.mma_gemm(x, torch.ones((8, 4)),
                          kind=Ger.F32GER).grad_fn is None


_ATTN = {
    "causal gqa": ((2, 20, 8, 16), (2, 20, 2, 16), dict(causal=True)),
    "window q_offset": ((1, 12, 4, 16), (1, 40, 4, 16),
                        dict(causal=True, q_offset=28, window=10)),
    "full valid": ((2, 9, 4, 16), (2, 30, 4, 16), dict(causal=False)),
    "split-kv decode": ((2, 1, 2, 16), (2, 300, 2, 16), dict(causal=False)),
    "epilogue": ((1, 16, 4, 16), (1, 16, 4, 16), dict(causal=True)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(_ATTN))
def test_attention_function_matches_autograd_of_torch_lowering(name, dtype):
    rng = np.random.default_rng(sum(map(ord, name)))
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    qs, ks, kw = _ATTN[name]
    q, k, v = _leaf(rng, qs, dt), _leaf(rng, ks, dt), _leaf(rng, ks, dt)
    kw = dict(kw, q_offset=kw.get("q_offset", 0), window=kw.get("window"))
    valid = bias = res = ep = None
    if name == "full valid":
        valid = torch.from_numpy(rng.random((ks[0], ks[1])) > 0.3)
        valid[0, :] = False                    # a fully-masked batch row
    if name == "epilogue":
        ep = E.Epilogue(bias=True, activation="gelu", residual=True)
        bias, res = _leaf(rng, (qs[-1],)), _leaf(rng, qs, dt)
    if name == "split-kv decode":
        assert A.split_kv_plan(qs[2], qs[1], ks[1])[0] > 1
    leaves = (q, k, v, bias, res)
    out = A.mma_flash_attention(q, k, v, valid=valid, ep=ep, bias=bias,
                                residual=res, out_dtype=torch.float32, **kw)
    want_out = lowering.torch_attention(q, k, v, valid=valid, ep=ep,
                                        bias=bias, residual=res,
                                        out_dtype=torch.float32, **kw)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    _close(_grads(out, leaves, dout), _grads(want_out, leaves, dout), 1e-6)


@pytest.mark.parametrize("case", ["depthwise causal", "depthwise stride",
                                  "dense 1-D stride", "dense 2-D"])
def test_conv_functions_match_autograd_of_torch_lowering(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("depthwise"):
        stride = (1, 2) if case.endswith("stride") else (1, 1)
        image, w = _leaf(rng, (2, 1, 19, 12)), _leaf(rng, (1, 4, 12))
        fn, c_out = K.mma_depthwise_conv2d, 12
    else:
        stride = (1, 2) if case.startswith("dense 1-D") else (2, 2)
        image = _leaf(rng, (2, 1, 21, 6) if case.startswith("dense 1-D")
                      else (2, 9, 9, 3))
        w = _leaf(rng, (1, 3, 6, 8) if case.startswith("dense 1-D")
                  else (3, 3, 3, 8))
        fn, c_out = K.mma_conv2d, 8
    ep = E.Epilogue(bias=True, activation="silu", residual=True)
    bias = _leaf(rng, (c_out,))
    plain = fn(image.detach(), w.detach(), stride=stride)
    res = _leaf(rng, tuple(plain.shape))
    leaves = (image, w, bias, res)
    out = fn(image, w, stride=stride, ep=ep, bias=bias, residual=res)
    want_out = E.apply(lowering.torch_conv(image, w, stride, w.ndim == 3,
                                           torch.float32),
                       ep, bias=bias, residual=res)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    _close(_grads(out, leaves, dout), _grads(want_out, leaves, dout), 1e-6)
