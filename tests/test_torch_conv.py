"""The port's conv op-class (``contract`` on CONV2D, CONV1D and
CONV1D_DEPTHWISE) and the plain versions of its conv kernels (K3, dense;
K4, depthwise) against the JAX reference, on the CPU.

The same numpy inputs go through the reference (its xla, Pallas and ref
lowerings, its Pallas conv kernels in interpret mode, its oracles) and
through the port, whose kernel wrappers run their plain versions on a CPU
tensor.

Tolerances: every case here accumulates in fp32, and the two sides sum
the same products in another order (XLA's convolution against torch's
and the explicit shift-and-sum), so f32 outputs agree within
``rtol=2e-5, atol=2e-5 * max|ref|``; a bf16 output within one bf16 ulp
plus that (a near-tie may round either way).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.kernels import epilogue as jep
from repro.kernels import mma_conv as jconv
from repro.kernels import ref as jref
from repro_torch.core import facility as tfac
from repro_torch.core import lowering as tlow
from repro_torch.core import precision as tprec
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import mma_conv as tconv
from repro_torch.kernels import ref as tref

CPU_F32 = dict(device="cpu", ger=tprec.Ger.F32GER, out_dtype=torch.float32)

# (spec name, image shape, filter shape, stride, padding)
CONV_CASES = [
    ("CONV2D", (2, 9, 11, 3), (3, 3, 3, 5), 1, "valid"),
    ("CONV2D", (2, 9, 11, 3), (3, 2, 3, 5), (2, 3), "same"),
    ("CONV2D", (1, 8, 8, 4), (4, 4, 4, 6), 4, "valid"),      # patch embed
    ("CONV1D", (2, 13, 6), (3, 6, 8), 1, "same"),             # whisper conv1
    ("CONV1D", (2, 13, 6), (3, 6, 8), 2, "same"),             # whisper conv2
    ("CONV1D", (2, 13, 6), (4, 6, 8), 1, "causal"),
    ("CONV1D", (2, 13, 6), (2, 6, 8), 3, "valid"),
    ("CONV1D_DEPTHWISE", (2, 17, 12), (4, 12), 1, "causal"),  # mamba2 prefill
    ("CONV1D_DEPTHWISE", (3, 4, 12), (4, 12), 1, "valid"),    # mamba2 decode
    ("CONV1D_DEPTHWISE", (2, 17, 12), (3, 12), 2, "same"),
    ("CONV1D_DEPTHWISE", (2, 16, 12), (5, 12), 3, "causal"),
]

EPILOGUES = [None, "bias", "bias+relu", "bias+gelu", "bias+silu+residual"]


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close_f32(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def _close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    tol = ulp + 2e-5 * np.abs(want) + 2e-5 * float(np.abs(want).max())
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


def _epilogue(name):
    """(reference Epilogue, port Epilogue) or (None, None)."""
    if name is None:
        return None, None
    parts = name.split("+")
    act = next((p for p in parts if p in ("relu", "gelu", "silu")), None)
    kw = dict(bias="bias" in parts, activation=act,
              residual="residual" in parts)
    return jep.Epilogue(**kw), tep.Epilogue(**kw)


def _operands(rng, case, epi):
    spec, xs, ws, stride, padding = case
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.3).astype(np.float32)
    c_out = ws[-1]
    bias = (rng.standard_normal(c_out).astype(np.float32)
            if epi and "bias" in epi else None)
    # the output shape, for the residual: run the port's ref lowering once
    with tfac.configure(tfac.FacilityConfig(backend="ref", **CPU_F32)):
        shape = tfac.contract(getattr(tfac, spec), _t(x), _t(w),
                              plan=tfac.Plan(stride=stride,
                                             padding=padding)).shape
    res = (rng.standard_normal(tuple(shape)).astype(np.float32)
           if epi and "residual" in epi else None)
    return x, w, bias, res


@pytest.mark.parametrize("epi", EPILOGUES, ids=lambda e: e or "none")
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: f"{c[0]}-{c[4]}-s{c[3]}")
@pytest.mark.parametrize("backends", [("torch", "xla"), ("ref", "ref")],
                         ids=lambda b: b[0])
def test_conv_contract_matches_reference(case, epi, backends):
    """contract on every conv spec, padding, stride and epilogue: the
    port's torch and ref lowerings against the reference's xla and ref
    lowerings, in f32 (F32GER)."""
    tb, jb = backends
    rng = np.random.default_rng(0)
    x, w, bias, res = _operands(rng, case, epi)
    spec, _, _, stride, padding = case
    jepi, tepi = _epilogue(epi)
    jcfg = jfac.FacilityConfig(ger=jprec.Ger.F32GER, out_dtype=jnp.float32)
    with jfac.configure(jcfg):
        want = jfac.contract(
            getattr(jfac, spec), jnp.asarray(x), jnp.asarray(w),
            bias=None if bias is None else jnp.asarray(bias),
            residual=None if res is None else jnp.asarray(res),
            plan=jfac.Plan(stride=stride, padding=padding, epilogue=jepi,
                           backend=jb))
    with tfac.configure(tfac.FacilityConfig(backend=tb, **CPU_F32)):
        got = tfac.contract(
            getattr(tfac, spec), _t(x), _t(w),
            bias=None if bias is None else _t(bias),
            residual=None if res is None else _t(res),
            plan=tfac.Plan(stride=stride, padding=padding, epilogue=tepi))
    assert got.dtype == torch.float32
    _close_f32(_np(got), want)


@pytest.mark.parametrize("ger", ["F32GER", "BF16GER2", "F32GER_3XBF16"])
@pytest.mark.parametrize("case", [c for c in CONV_CASES
                                  if c[0] == "CONV1D_DEPTHWISE"],
                         ids=lambda c: f"{c[4]}-s{c[3]}")
def test_depthwise_kernel_backend_matches_reference_pallas(case, ger):
    """The kernel backend (the wrapper's plain version on the CPU) against
    the reference's Pallas kernel in interpret mode, with mamba2's fused
    bias + silu and a bf16 store; F32GER_3XBF16 runs the expansion chain
    of three bf16 passes on both sides."""
    rng = np.random.default_rng(1)
    x, w, bias, _ = _operands(rng, case, "bias")
    _, _, _, stride, padding = case
    jcfg = jfac.FacilityConfig(use_pallas=True)
    with jfac.configure(jcfg):
        want = jfac.contract(
            jfac.CONV1D_DEPTHWISE, jnp.asarray(x), jnp.asarray(w),
            bias=jnp.asarray(bias),
            plan=jfac.Plan(ger=getattr(jprec.Ger, ger), stride=stride,
                           padding=padding,
                           epilogue=jep.Epilogue(bias=True,
                                                 activation="silu"),
                           out_dtype=jnp.bfloat16))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tfac.contract(
            tfac.CONV1D_DEPTHWISE, _t(x), _t(w), bias=_t(bias),
            plan=tfac.Plan(ger=getattr(tprec.Ger, ger), stride=stride,
                           padding=padding,
                           epilogue=tep.Epilogue(bias=True,
                                                 activation="silu"),
                           out_dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close_bf16(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("case", [
    # (image NHWC, KH, KW, stride, input dtype, epilogue, out dtype)
    ((1, 1, 19, 40), 1, 4, (1, 1), "f32", "bias+silu", "bf16"),
    ((4, 1, 4, 24), 1, 4, (1, 1), "f32", "bias+silu", "bf16"),
    ((2, 7, 13, 20), 3, 4, (2, 3), "f32", None, "f32"),
    ((2, 5, 9, 33), 2, 3, (1, 2), "bf16", "bias+gelu", "f32"),
    ((2, 6, 8, 16), 3, 3, (3, 1), "f32", "residual", "f32"),
    ((2, 4, 10, 8), 2, 2, (1, 1), "bf16", "bias+relu+residual", "bf16"),
], ids=lambda c: f"{c[0]}-k{c[1]}x{c[2]}-s{c[3]}-{c[4]}-{c[5]}")
def test_depthwise_plain_matches_reference_kernel(case):
    """K4's plain version against the reference's ``mma_depthwise_conv2d``
    in interpret mode and against ``ref.depthwise_conv`` (the port's and
    the reference's, which must agree exactly on these f32 sums)."""
    shape, kh, kw, stride, idt, epi, odt = case
    rng = np.random.default_rng(2)
    n, h, w, c = shape
    x = rng.standard_normal(shape).astype(np.float32)
    taps = (rng.standard_normal((kh, kw, c)) * 0.3).astype(np.float32)
    oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
    jepi, tepi = _epilogue(epi)
    bias = (rng.standard_normal(c).astype(np.float32)
            if tepi is not None and tepi.bias else None)
    res = (rng.standard_normal((n, oh, ow, c)).astype(np.float32)
           if tepi is not None and tepi.residual else None)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16}
    want = jconv.mma_depthwise_conv2d(
        jnp.asarray(x).astype(jd[idt]), jnp.asarray(taps).astype(jd[idt]),
        stride=stride, out_dtype=jd[odt], ep=jepi,
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), interpret=True)
    got = tconv.mma_depthwise_conv2d(
        _t(x, td[idt]), _t(taps, td[idt]), stride=stride,
        out_dtype=td[odt], ep=tepi,
        bias=None if bias is None else _t(bias),
        residual=None if res is None else _t(res))
    assert got.shape == (n, oh, ow, c) and got.dtype == td[odt]
    check = _close_f32 if odt == "f32" else _close_bf16
    check(_np(got), np.asarray(want, np.float32))
    # the oracles: the port's and the reference's shift-and-sum agree
    jo = jref.depthwise_conv(jnp.asarray(x).astype(jd[idt]),
                             jnp.asarray(taps).astype(jd[idt]), stride=stride)
    to = tref.depthwise_conv(_t(x, td[idt]), _t(taps, td[idt]),
                             stride=stride)
    np.testing.assert_array_equal(_np(to), np.asarray(jo, np.float32))


@pytest.mark.parametrize("stride", [(1, 1), (2, 3)])
def test_conv2d_oracle_matches_reference(stride):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3, 2, 3, 4)).astype(np.float32)
    want = jref.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = tref.conv2d(_t(x), _t(w), stride=stride)
    _close_f32(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("spec", ["CONV2D", "CONV1D"])
def test_dense_conv_on_the_kernel_backend_raises_naming_k3(spec):
    """The dense specs on the kernel backend no longer raise naming K3:
    they run K3's wrapper (its plain version on the CPU) and match the
    reference's xla lowering, in f32, with no silent route to torch."""
    rng = np.random.default_rng(5)
    xs, ws = ((1, 6, 6, 2), (2, 2, 2, 3)) if spec == "CONV2D" else (
        (1, 6, 2), (2, 2, 3))
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    jcfg = jfac.FacilityConfig(ger=jprec.Ger.F32GER, out_dtype=jnp.float32)
    with jfac.configure(jcfg):
        want = jfac.contract(getattr(jfac, spec), jnp.asarray(x),
                             jnp.asarray(w))
    before = tconv.mma_conv2d.launches
    with tfac.configure(tfac.FacilityConfig(**CPU_F32)):
        got = tfac.contract(getattr(tfac, spec), _t(x), _t(w))
    assert tconv.mma_conv2d.launches == before   # the plain version ran
    _close_f32(_np(got), want)


_DENSE_CASES = [c for c in CONV_CASES if c[0] != "CONV1D_DEPTHWISE"]


@pytest.mark.parametrize("ger", ["BF16GER2", "F32GER", "F32GER_3XBF16"])
@pytest.mark.parametrize("case", _DENSE_CASES,
                         ids=lambda c: f"{c[0]}-{c[4]}-s{c[3]}")
def test_dense_kernel_backend_matches_reference_pallas(case, ger):
    """CONV1D/CONV2D on the kernel backend (K3's plain version on the CPU)
    against the reference's Pallas backend (its K3 in interpret mode),
    with the stems' fused bias + gelu: a bf16 store for BF16GER2, an f32
    one for F32GER and for F32GER_3XBF16's three chained bf16 passes."""
    rng = np.random.default_rng(6)
    x, w, bias, _ = _operands(rng, case, "bias")
    spec, _, _, stride, padding = case
    f32_out = ger != "BF16GER2"
    with jfac.configure(jfac.FacilityConfig(use_pallas=True)):
        want = jfac.contract(
            getattr(jfac, spec), jnp.asarray(x), jnp.asarray(w),
            bias=jnp.asarray(bias),
            plan=jfac.Plan(ger=getattr(jprec.Ger, ger), stride=stride,
                           padding=padding,
                           epilogue=jep.Epilogue(bias=True,
                                                 activation="gelu"),
                           out_dtype=jnp.float32 if f32_out
                           else jnp.bfloat16))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tfac.contract(
            getattr(tfac, spec), _t(x), _t(w), bias=_t(bias),
            plan=tfac.Plan(ger=getattr(tprec.Ger, ger), stride=stride,
                           padding=padding,
                           epilogue=tep.Epilogue(bias=True,
                                                 activation="gelu"),
                           out_dtype=torch.float32 if f32_out
                           else torch.bfloat16))
    assert got.dtype == (torch.float32 if f32_out else torch.bfloat16)
    check = _close_f32 if f32_out else _close_bf16
    check(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("case", [
    # (image NHWC, filters HWIO, stride, input dtype, epilogue, out dtype)
    ((2, 1, 26, 80), (1, 3, 80, 128), (1, 1), "bf16", "bias+gelu",
     "bf16"),                                     # whisper conv1, reduced
    ((2, 1, 25, 128), (1, 3, 128, 128), (1, 2), "bf16", "bias+gelu",
     "bf16"),                                     # whisper conv2, reduced
    ((2, 8, 16, 3), (4, 4, 3, 128), (4, 4), "bf16", "bias", "bf16"),
    # ^ qwen2-vl's patch embed, reduced: kernel = stride = patch
    ((2, 7, 9, 5), (3, 3, 5, 6), (1, 1), "f32", "residual", "f32"),
    ((2, 6, 11, 4), (2, 3, 4, 7), (2, 3), "f32", "bias+relu+residual",
     "f32"),
    ((1, 5, 9, 8), (2, 2, 8, 10), (1, 1), "f16", "bias+silu", "f32"),
], ids=["whisper-conv1", "whisper-conv2", "patch-embed", "3x3-residual",
        "strided-f32", "f16"])
def test_conv2d_plain_matches_reference_kernel(case):
    """K3's plain version against the reference's ``mma_conv2d`` in
    interpret mode at the reduced stems' geometries (1-D convs as H = 1,
    strides 2 and 4, C = 3), and at 2-D, strided, residual, f32 and f16
    edge cases."""
    shape, fshape, stride, idt, epi, odt = case
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(fshape) * 0.3).astype(np.float32)
    n, h, wd, _ = shape
    kh, kw, _, f = fshape
    oh, ow = (h - kh) // stride[0] + 1, (wd - kw) // stride[1] + 1
    jepi, tepi = _epilogue(epi)
    bias = (rng.standard_normal(f).astype(np.float32)
            if tepi is not None and tepi.bias else None)
    res = (rng.standard_normal((n, oh, ow, f)).astype(np.float32)
           if tepi is not None and tepi.residual else None)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    want = jconv.mma_conv2d(
        jnp.asarray(x).astype(jd[idt]), jnp.asarray(w).astype(jd[idt]),
        stride=stride, out_dtype=jd[odt], ep=jepi,
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), interpret=True)
    got = tconv.mma_conv2d(
        _t(x, td[idt]), _t(w, td[idt]), stride=stride, out_dtype=td[odt],
        ep=tepi, bias=None if bias is None else _t(bias),
        residual=None if res is None else _t(res))
    assert got.shape == (n, oh, ow, f) and got.dtype == td[odt]
    check = _close_f32 if odt == "f32" else _close_bf16
    check(_np(got), np.asarray(want, np.float32))


def test_conv_plan_block_names_the_filter_tile():
    """An explicit Plan.block takes K3's filter (N) tile where the kernel
    is compiled for it, with the same result, and raises otherwise."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 10, 8)))
    w = _t(rng.standard_normal((3, 8, 130)) * 0.3)
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        base = tfac.contract(tfac.CONV1D, x, w)
        assert torch.equal(tfac.contract(
            tfac.CONV1D, x, w, plan=tfac.Plan(block=(64, 128, 32))), base)
        for bf in (64, 96):
            with pytest.raises(ValueError, match="filter tile"):
                tfac.contract(tfac.CONV1D, x, w,
                              plan=tfac.Plan(block=(64, bf, 32)))
        with pytest.raises(ValueError, match="bm, bf, bk"):
            tfac.contract(tfac.CONV1D, x, w, plan=tfac.Plan(block=(64, 64)))
    with tfac.configure(tfac.FacilityConfig(**CPU_F32)):
        # F32GER's two fp32 tiles (filter tiles 64 and 128), no other
        for blk in ((64, 64, 16), (128, 128, 16)):
            assert torch.equal(tfac.contract(
                tfac.CONV1D, x, w, plan=tfac.Plan(block=blk)),
                tfac.contract(tfac.CONV1D, x, w))
        with pytest.raises(ValueError, match="filter tile"):
            tfac.contract(tfac.CONV1D, x, w,
                          plan=tfac.Plan(block=(64, 256, 32)))


def test_conv2d_wrapper_checks_its_operands():
    x, w = torch.zeros((1, 6, 6, 4)), torch.zeros((3, 3, 4, 5))
    with pytest.raises(ValueError, match="bias has shape"):
        tconv.mma_conv2d(x, w, ep=tep.Epilogue(bias=True),
                         bias=torch.zeros(4))
    with pytest.raises(ValueError, match="need an Epilogue"):
        tconv.mma_conv2d(x, w, bias=torch.zeros(5))
    with pytest.raises(ValueError, match="residual has shape"):
        tconv.mma_conv2d(x, w, ep=tep.Epilogue(residual=True),
                         residual=torch.zeros((1, 6, 6, 5)))
    with pytest.raises(ValueError, match="smaller than the filters"):
        tconv.mma_conv2d(torch.zeros((1, 2, 6, 4)), w)
    with pytest.raises(ValueError, match="channel mismatch"):
        tconv.mma_conv2d(x, torch.zeros((3, 3, 3, 5)))
    with pytest.raises(ValueError, match="filters"):
        tconv.mma_conv2d(x, torch.zeros((3, 4, 5)))
    with pytest.raises(ValueError, match="strides"):
        tconv.mma_conv2d(x, w, stride=(0, 1))
    with pytest.raises(TypeError, match="one dtype"):
        tconv.mma_conv2d(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError, match="one dtype"):
        tconv.mma_conv2d(x.double(), w.double())
    with pytest.raises(ValueError, match="w_layout"):
        tconv.mma_conv2d(x, torch.zeros((1, 3, 3, 4, 64)))
    with pytest.raises(ValueError, match="runs on cuda"):
        tconv.mma_conv2d(x.to("meta"), w.to("meta"))
    assert tconv.mma_conv2d(x, w).shape == (1, 4, 4, 5)


def test_non_f32_accumulator_goes_to_torch_by_its_family(monkeypatch):
    """F64GER accumulates in f64, which the conv kernel does not: the
    kernel backend sends it to the torch lowering before any kernel is
    reached (as the reference sends it to xla)."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("the depthwise kernel must not run for F64GER")

    monkeypatch.setattr(tconv, "mma_depthwise_conv2d", no_kernel)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 9, 5)))
    w = torch.from_numpy(rng.standard_normal((4, 5)))
    plan = tfac.Plan(ger=tprec.Ger.F64GER, padding="causal",
                     out_dtype=torch.float64)
    outs = {}
    for backend in ("kernel", "torch", "ref"):
        with tfac.configure(tfac.FacilityConfig(device="cpu",
                                                backend=backend)):
            outs[backend] = tfac.contract(tfac.CONV1D_DEPTHWISE, x, w,
                                          plan=plan)
    assert outs["kernel"].dtype == torch.float64
    assert torch.equal(outs["kernel"], outs["torch"])
    torch.testing.assert_close(outs["kernel"], outs["ref"], rtol=1e-12,
                               atol=1e-12)


def test_conv_plan_validation():
    x, w = torch.zeros((1, 8, 4)), torch.zeros((3, 4))
    with tfac.configure(tfac.FacilityConfig(**CPU_F32)):
        with pytest.raises(ValueError, match="stride"):
            tfac.contract(tfac.CONV1D_DEPTHWISE, x, w,
                          plan=tfac.Plan(stride=(1, 2)))
        with pytest.raises(ValueError, match="stride"):
            tfac.contract(tfac.CONV1D_DEPTHWISE, x, w,
                          plan=tfac.Plan(stride=0))
        with pytest.raises(ValueError, match="accumulator seed"):
            tfac.contract(tfac.CONV1D_DEPTHWISE, x, w,
                          acc=torch.zeros((1, 6, 4)))
        with pytest.raises(ValueError, match="accumulate forms"):
            tfac.contract(tfac.CONV1D_DEPTHWISE, x, w,
                          plan=tfac.Plan(neg_product=True))
        with pytest.raises(ValueError, match="padding"):
            tfac.contract(tfac.CONV1D_DEPTHWISE, x, w,
                          plan=tfac.Plan(padding="full"))
        with pytest.raises(ValueError, match="causal padding"):
            tfac.contract(tfac.CONV2D, torch.zeros((1, 5, 5, 2)),
                          torch.zeros((2, 2, 2, 3)),
                          plan=tfac.Plan(padding="causal", backend="torch"))
        with pytest.raises(ValueError, match="conv specs only"):
            tfac.contract(tfac.DOT, torch.zeros((2, 4)), torch.zeros((4, 3)),
                          plan=tfac.Plan(padding="same"))
        with pytest.raises(ValueError, match="channel mismatch"):
            tfac.contract(tfac.CONV1D_DEPTHWISE, x, torch.zeros((3, 5)))
        with pytest.raises(ValueError, match="no tile"):
            tfac.contract(tfac.CONV1D_DEPTHWISE, x, w,
                          plan=tfac.Plan(block=(1, 128)))


def test_depthwise_wrapper_checks_its_operands():
    x, taps = torch.zeros((1, 1, 8, 4)), torch.zeros((1, 4, 4))
    ep = tep.Epilogue(bias=True)
    with pytest.raises(ValueError, match="bias has shape"):
        tconv.mma_depthwise_conv2d(x, taps, ep=ep, bias=torch.zeros(5))
    with pytest.raises(ValueError, match="need an Epilogue"):
        tconv.mma_depthwise_conv2d(x, taps, bias=torch.zeros(4))
    with pytest.raises(ValueError, match="residual has shape"):
        tconv.mma_depthwise_conv2d(x, taps, ep=tep.Epilogue(residual=True),
                                   residual=torch.zeros((1, 1, 4, 4)))
    with pytest.raises(ValueError, match="smaller than the taps"):
        tconv.mma_depthwise_conv2d(torch.zeros((1, 1, 2, 4)), taps)
    with pytest.raises(ValueError, match="channel mismatch"):
        tconv.mma_depthwise_conv2d(x, torch.zeros((1, 4, 3)))
    assert tlow.lookup("kernel", "conv", tprec.Ger.F32GER, True) is not None
