"""The port's complex op-class, ``kernels.blas3`` (complex_gemm, dft, trsm)
and the ``gemm.saturating`` forms against the JAX reference, on the CPU.

Tolerances: complex64 / F32GER within 1e-4 (the reference's blas3 test
tolerance; fp32 sums in another order); complex128 / F64GER within 1e-12;
the DFT within the reference's tolerances against ``np.fft.fft`` (f32
1e-3, bf16 rtol 0.1 and atol 0.35) and 1e-9 in f64; the bf16 twiddles and
the saturating forms bit for bit.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from repro.core import facility as jfac
from repro.core.precision import Ger as JGer
from repro.kernels import blas3 as jblas3
from repro_torch.core import facility as tfac
from repro_torch.core import packing
from repro_torch.core.precision import Ger as TGer
from repro_torch.kernels import blas3 as tblas3

CPU = dict(device="cpu", ger=TGer.F32GER, out_dtype=torch.float32)
BACKENDS = ("kernel", "torch", "ref")
JBACKEND = {"kernel": "pallas", "torch": "xla", "ref": "ref"}


def x64(on: bool):
    """JAX's x64 mode: ``jax.enable_x64`` where the installed jax has it
    (0.9 removed ``jax.experimental.enable_x64``), else the older one."""
    if not on:
        return contextlib.nullcontext()
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


def _cplx(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["F32GER", "F64GER"])
def test_complex_gemm_matches_reference(kind, backend):
    f64 = kind == "F64GER"
    dt, tol = (np.float64, 1e-12) if f64 else (np.float32, 1e-4)
    rng = np.random.default_rng(0)
    ar, ai = (rng.standard_normal((16, 24)).astype(dt) for _ in range(2))
    br, bi = (rng.standard_normal((24, 8)).astype(dt) for _ in range(2))
    with x64(f64):
        jre, jim = jblas3.complex_gemm(*map(jnp.asarray, (ar, ai, br, bi)),
                                       kind=JGer[kind],
                                       backend=JBACKEND[backend])
        jre, jim = np.asarray(jre), np.asarray(jim)
    with tfac.configure(tfac.FacilityConfig(**CPU)):
        re, im = tblas3.complex_gemm(*map(torch.from_numpy, (ar, ai, br, bi)),
                                     kind=TGer[kind], backend=backend)
    assert re.dtype == (torch.float64 if f64 else torch.float32)
    _close(re.numpy(), jre, tol)
    _close(im.numpy(), jim, tol)
    want = (ar + 1j * ai).astype(np.complex128) @ (br + 1j * bi)
    _close(re.numpy(), want.real, tol)
    _close(im.numpy(), want.imag, tol)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["np_seed", "real_out", "bf16_out",
                                  "batched"])
def test_complex_op_class_matches_reference(case, backend):
    """The complex op-class through contract: the np form with a complex
    seed and alpha/beta, a real out_dtype (re-embedded in complex64),
    bf16 rounding of each component, and a batched spec."""
    rng = np.random.default_rng(1)
    spec, xs, ys = "mk,kn->mn", (12, 20), (20, 9)
    jkw, tkw = {}, {}
    if case == "batched":
        spec, xs, ys = "bmk,bkn->bmn", (3, 12, 20), (3, 20, 9)
    x, y = _cplx(rng, xs, np.complex64), _cplx(rng, ys, np.complex64)
    if case == "np_seed":
        c = _cplx(rng, (12, 9), np.complex64)
        jkw = dict(acc=jnp.asarray(c))
        tkw = dict(acc=torch.from_numpy(c))
        forms = dict(neg_product=True, alpha=0.5, beta=-2.0)
        jout, tout = jfac.ACC, tfac.ACC
    elif case == "real_out":
        forms, jout, tout = {}, jnp.float32, torch.float32
    elif case == "bf16_out":
        forms, jout, tout = {}, jnp.bfloat16, torch.bfloat16
    else:
        forms, jout, tout = dict(neg_acc=True), jfac.ACC, tfac.ACC
    want = jfac.contract(spec, jnp.asarray(x), jnp.asarray(y),
                         plan=jfac.Plan(ger=JGer.F32GER, out_dtype=jout,
                                        backend=JBACKEND[backend], **forms),
                         **jkw)
    with tfac.configure(tfac.FacilityConfig(**CPU)):
        got = tfac.contract(spec, torch.from_numpy(x), torch.from_numpy(y),
                            plan=tfac.Plan(ger=TGer.F32GER, out_dtype=tout,
                                           backend=backend, **forms), **tkw)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    tol = 1e-4 if case != "bf16_out" else 2 ** -7 * 8
    _close(got.numpy(), np.asarray(want), tol)


def test_complex_op_class_refusals():
    x = torch.zeros((4, 8), dtype=torch.complex64)
    y = torch.zeros((8, 4), dtype=torch.complex64)
    with tfac.configure(tfac.FacilityConfig(**CPU)):
        with pytest.raises(ValueError, match="natural output order"):
            tfac.contract("mk,kn->nm", x, y)
        with pytest.raises(ValueError, match="accumulate forms only"):
            tfac.contract("mk,kn->mn", x, y,
                          bias=torch.zeros(4, dtype=torch.complex64))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_dft_matches_reference_and_fft(dtype, batched):
    n = 32 if dtype == "bfloat16" else 64
    rng = np.random.default_rng(2)
    shape = (3, n, 5) if batched else (n, 5)
    x = rng.standard_normal(shape).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with x64(dtype == "float64"):
        jx = jnp.asarray(x, getattr(jnp, dtype))
        jre, jim = jblas3.dft(jx)
        jre, jim = np.asarray(jre, np.float64), np.asarray(jim, np.float64)
    with tfac.configure(tfac.FacilityConfig(**CPU)):
        re, im = tblas3.dft(tx)
    assert tuple(re.shape) == shape
    want = np.fft.fft(tx.to(torch.float64).numpy(), axis=-2)
    if dtype == "bfloat16":
        # the reference's tolerance against the fft, and one bf16 rounding
        # of the operands' products apart from the reference
        for got, ref, exact in ((re, jre, want.real), (im, jim, want.imag)):
            np.testing.assert_allclose(got.double().numpy(), exact,
                                       rtol=0.1, atol=0.35)
            np.testing.assert_allclose(got.double().numpy(), ref,
                                       rtol=1e-3, atol=1e-3)
        return
    tol = 1e-9 if dtype == "float64" else 1e-3
    for got, ref, exact in ((re, jre, want.real), (im, jim, want.imag)):
        _close(got.double().numpy(), exact, tol)
        _close(got.double().numpy(), ref, 1e-12 if dtype == "float64"
               else 1e-4)


def test_twiddles_are_host_side_dtype_keyed_and_bf16_exact():
    packing.STORE.invalidate(("dft.twiddle",))
    n = 64
    wr32, wi32 = tblas3._twiddle(n, torch.float32)
    wrb, wib = tblas3._twiddle(n, torch.bfloat16)
    for t in (wr32, wi32, wrb, wib):
        assert t.device.type == "cpu"
    assert wr32.dtype == torch.float32 and wrb.dtype == torch.bfloat16
    # rounded once from float64, as ml_dtypes rounds it (the reference's
    # rule): bit for bit
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    bf16 = jnp.dtype(jnp.bfloat16)
    np.testing.assert_array_equal(wrb.view(torch.int16).numpy(),
                                  np.cos(ang).astype(bf16).view(np.int16))
    np.testing.assert_array_equal(wib.view(torch.int16).numpy(),
                                  np.sin(ang).astype(bf16).view(np.int16))
    jwr, _ = jblas3._twiddle(n, "bfloat16")
    np.testing.assert_array_equal(wrb.view(torch.int16).numpy(),
                                  np.asarray(jwr).view(np.int16))
    np.testing.assert_array_equal(wr32.numpy(), np.cos(ang).astype(
        np.float32))


def test_store_caches_and_invalidates_twiddles():
    packing.STORE.invalidate(("dft.twiddle",))
    hits = packing.COUNTERS["store_hit"]
    a = tblas3._twiddle(16, torch.float32)
    b = tblas3._twiddle(16, torch.float32)
    assert a is b and packing.COUNTERS["store_hit"] == hits + 1
    tblas3._twiddle(16, torch.float64)
    keys = [k for k in packing.STORE.keys() if k[0] == "dft.twiddle"]
    assert len(keys) == 2
    assert keys[0][3] == packing.plan_gemm_block(TGer.F32GER, 16, 16, 16)
    assert packing.STORE.invalidate(("dft.twiddle", 16, "float32")) == 1
    assert tblas3._twiddle(16, torch.float32) is not a
    assert packing.STORE.invalidate(("dft.twiddle",)) == 2


@pytest.mark.parametrize("n,m,block", [(64, 8, 16), (100, 5, 32)])
def test_trsm_matches_reference_and_scipy(n, m, block):
    rng = np.random.default_rng(n)
    l = (np.tril(rng.standard_normal((n, n))) + np.eye(n) * n).astype(
        np.float32)
    b = rng.standard_normal((n, m)).astype(np.float32)
    want = np.asarray(jblas3.trsm(jnp.asarray(l), jnp.asarray(b),
                                  block=block))
    with tfac.configure(tfac.FacilityConfig(**CPU)):
        got = tblas3.trsm(torch.from_numpy(l), torch.from_numpy(b),
                          block=block).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got, scipy.linalg.solve_triangular(l, b, lower=True), rtol=2e-4,
        atol=2e-4)


# ---- gemm.saturating --------------------------------------------------

SAT = {"I16GER2": (np.int16, np.int16, (-32767, 32768), (-32767, 32768)),
       "I8GER4": (np.int8, np.uint8, (-128, 128), (0, 256))}


def _sat_operands(fam, m, k, n, seed):
    xd, yd, xr, yr = SAT[fam]
    rng = np.random.default_rng(seed)
    x = rng.integers(*xr, (m, k)).astype(xd)
    y = rng.integers(*yr, (k, n)).astype(yd)
    # a seed near INT32_MAX in half the rows, near INT32_MIN in the rest,
    # so that both ends clamp
    c = np.where(np.arange(m)[:, None] % 2 == 0, 2 ** 31 - 1000,
                 -2 ** 31 + 1000).astype(np.int32) * np.ones((m, n),
                                                             np.int32)
    return x, y, c


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fam", list(SAT))
def test_saturating_matches_reference(fam, backend):
    x, y, c = _sat_operands(fam, 10, 32, 12, seed=5)
    plan_kw = dict(ger=TGer[fam], saturating=True, backend=backend,
                   out_dtype=tfac.ACC)
    with tfac.configure(tfac.FacilityConfig(**CPU)):
        got = tfac.contract("mk,kn->mn", torch.from_numpy(x),
                            torch.from_numpy(y), acc=torch.from_numpy(c),
                            plan=tfac.Plan(**plan_kw)).numpy()
    clamped = 0
    for jb in ("xla", "ref"):
        want = np.asarray(jfac.contract(
            "mk,kn->mn", jnp.asarray(x), jnp.asarray(y), acc=jnp.asarray(c),
            plan=jfac.Plan(ger=JGer[fam], saturating=True, backend=jb,
                           out_dtype=jfac.ACC)))
        np.testing.assert_array_equal(got, want)
        clamped = int((np.abs(want.astype(np.int64)) >= 2 ** 31 - 1).sum())
    assert clamped > 0                         # the clamp is exercised
    wrapped = (x.astype(np.int64) @ y.astype(np.int64) + c).astype(np.int32)
    assert (got != wrapped).any()              # and differs from the wrap


def test_saturating_i16_corner_is_exact():
    """Two -32768 * -32768 products make one rank-2 update of 2**31, one
    past INT32_MAX: the port clamps it exactly, as the reference's ref
    oracle does (its xla lowering sums the pair in int32 and wraps first:
    ROADMAP queue 3)."""
    x = np.full((2, 2), -32768, np.int16)
    y = np.full((2, 2), -32768, np.int16)
    want = np.asarray(jfac.contract(
        "mk,kn->mn", jnp.asarray(x), jnp.asarray(y),
        plan=jfac.Plan(ger=JGer.I16GER2, saturating=True, backend="ref",
                       out_dtype=jfac.ACC)))
    np.testing.assert_array_equal(want, np.full((2, 2), 2 ** 31 - 1))
    for backend in BACKENDS:
        with tfac.configure(tfac.FacilityConfig(**CPU)):
            got = tfac.contract(
                "mk,kn->mn", torch.from_numpy(x), torch.from_numpy(y),
                plan=tfac.Plan(ger=TGer.I16GER2, saturating=True,
                               backend=backend, out_dtype=tfac.ACC))
        np.testing.assert_array_equal(got.numpy(), want)


def test_saturating_i4ger8_clamps_nibble_products():
    """I4GER8's saturating form on the unpacked nibbles, rank-8 groups,
    against a numpy oracle (the reference multiplies the packed bytes:
    ROADMAP queue 3)."""
    rng = np.random.default_rng(6)
    x = rng.integers(-128, 128, (6, 8)).astype(np.int8)     # K = 16
    y = rng.integers(-128, 128, (8, 5)).astype(np.int8)
    c = np.full((6, 5), 2 ** 31 - 50, np.int32)

    def unpack(v, axis):
        lo = (v.astype(np.int16) << 12 >> 12).astype(np.int64)
        hi = (v.astype(np.int64) >> 4)
        return np.stack([lo, hi], axis=axis + 1).reshape(
            [s * 2 if i == axis else s for i, s in enumerate(v.shape)])

    xu, yu = unpack(x, 1), unpack(y, 0)
    acc = c.astype(np.int64)
    for g in range(2):
        acc = np.clip(acc + xu[:, 8 * g:8 * g + 8] @ yu[8 * g:8 * g + 8],
                      -2 ** 31, 2 ** 31 - 1)
    for backend in BACKENDS:
        with tfac.configure(tfac.FacilityConfig(**CPU)):
            got = tfac.contract(
                "mk,kn->mn", torch.from_numpy(x), torch.from_numpy(y),
                acc=torch.from_numpy(c),
                plan=tfac.Plan(ger=TGer.I4GER8, saturating=True,
                               backend=backend, out_dtype=tfac.ACC))
        np.testing.assert_array_equal(got.numpy(), acc.astype(np.int32))


def test_saturating_refusals_match_reference():
    xf, yf = np.zeros((4, 8), np.float32), np.zeros((8, 4), np.float32)
    xi, yi = np.zeros((2, 4, 8), np.int16), np.zeros((2, 8, 4), np.int16)
    cases = [
        ("mk,kn->mn", xf, yf, dict(ger="F32GER"), "integer-only"),
        ("bmk,bkn->bmn", xi, yi, dict(ger="I16GER2"), "2-D only"),
        ("mk,kn->mn", xi[0], yi[0], dict(ger="I16GER2", alpha=2.0),
         "accumulator seed only"),
    ]
    for spec, x, y, kw, msg in cases:
        ger = kw.pop("ger")
        with pytest.raises(ValueError, match=msg):
            jfac.contract(spec, jnp.asarray(x), jnp.asarray(y),
                          plan=jfac.Plan(ger=JGer[ger], saturating=True,
                                         backend="xla", **kw))
        with tfac.configure(tfac.FacilityConfig(**CPU)):
            for backend in BACKENDS:
                with pytest.raises(ValueError, match=msg):
                    tfac.contract(spec, torch.from_numpy(x),
                                  torch.from_numpy(y),
                                  plan=tfac.Plan(ger=TGer[ger],
                                                 saturating=True,
                                                 backend=backend, **kw))
