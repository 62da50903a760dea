"""The pm* prefixed masked forms (K1b) in the port against the JAX
reference, on the CPU: ``contract(..., masks=(xmask, ymask, pmask))`` on
the port's kernel (its plain version on a CPU tensor), torch and ref
backends against the reference's pallas (interpret mode), xla and ref
backends and its ``ref.pm_ger`` oracle; the validation errors, message for
message; the kernel wrapper's refusals and route; and ``kernels/ops.py``'s
shims against the reference's.

The same numpy inputs, from a seed, go to both packages.  Tolerances:
F32GER, BF16GER2 and F16GER2 within 1e-5 of max|ref| (fp32 accumulators;
the 16-bit products are exact in fp32, the sums run in another order),
F32GER_3XBF16 within 1e-5 too (three bf16 passes either way), F64GER
within 1e-12, the integer families bit for bit.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import facility as tfac
from repro_torch.core import lowering as tlow
from repro_torch.core import packing
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_families import operands, x64

CPU = tfac.FacilityConfig(device="cpu")
FAMILIES = ("F32GER", "BF16GER2", "F16GER2", "F32GER_3XBF16", "I8GER4",
            "I16GER2", "F64GER")
# reference backend for each of the port's
BACKENDS = {"kernel": "pallas", "torch": "xla", "ref": "ref"}
NP_DTYPES = {"F32GER": np.float32, "BF16GER2": np.float32,
             "F16GER2": np.float16, "F32GER_3XBF16": np.float32}


def _operands(fam, shape_x, shape_y, seed):
    """Seeded numpy operands in a dtype both packages take as the family's
    input (bf16 operands go over as f32 and are cast by the policy)."""
    if fam in NP_DTYPES:
        rng = np.random.default_rng(seed)
        dt = NP_DTYPES[fam]
        x = rng.standard_normal(shape_x).astype(dt)
        y = rng.standard_normal(shape_y).astype(dt)
        if fam == "BF16GER2":       # bf16 values, so the oracle sees them
            x, y = (torch.from_numpy(a).bfloat16().float().numpy()
                    for a in (x, y))
        return x, y
    return operands(fam, shape_x, shape_y, seed)


def _masks(seed, m, n, k, which="xyp"):
    """Bool masks with about 30% of the lanes off, each of rows (x),
    columns (y) and ranks (p) as ``which`` names."""
    rng = np.random.default_rng(100 + seed)
    out = []
    for tag, size in zip("xyp", (m, n, k)):
        out.append(rng.random(size) > 0.3 if tag in which else None)
    return tuple(out)


def _close(fam, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if fam in ("I8GER4", "I16GER2"):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    tol = 1e-12 if fam == "F64GER" else 1e-5
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(np.abs(want).max(initial=0.0), 1.0), err


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return (t.double() if t.dtype == torch.bfloat16 else t).numpy()


def _ref_contract(spec, fam, backend, x, y, masks, acc=None):
    return jfac.contract(
        spec, _j(x), _j(y), acc=_j(acc), masks=tuple(_j(m) for m in masks),
        plan=jfac.Plan(ger=jprec.Ger[fam], backend=backend, interpret=True,
                       out_dtype=jfac.ACC))


def _port_contract(spec, fam, backend, x, y, masks, acc=None):
    with tfac.configure(CPU):
        return tfac.contract(
            spec, _t(x), _t(y), acc=_t(acc),
            masks=tuple(_t(m) for m in masks),
            plan=tfac.Plan(ger=tprec.Ger[fam], backend=backend,
                           out_dtype=tfac.ACC))


CASES = {
    "ragged": dict(shape=(37, 45, 29), which="xyp"),
    "rows_ranks": dict(shape=(20, 64, 24), which="xp"),
    "columns": dict(shape=(33, 32, 40), which="y"),
    "batch_seed": dict(shape=(9, 32, 17), batch=3, which="xyp", seed=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("fam", FAMILIES)
def test_contract_masked_matches_reference(fam, backend, case):
    spec_case = CASES[case]
    m, k, n = spec_case["shape"]
    lead = (spec_case["batch"],) if "batch" in spec_case else ()
    spec = "bmk,bkn->bmn" if lead else "mk,kn->mn"
    seed = list(CASES).index(case)
    x, y = _operands(fam, lead + (m, k), lead + (k, n), seed)
    masks = _masks(seed, m, n, k, spec_case["which"])
    acc = None
    if spec_case.get("seed"):
        acc = _operands(fam, lead + (m, n), (1, 1), seed + 7)[0]
        if fam in ("I8GER4", "I16GER2"):
            acc = acc.astype(np.int32)
        elif fam != "F64GER":
            acc = acc.astype(np.float32)
    with x64(fam == "F64GER"):
        want = _ref_contract(spec, fam, BACKENDS[backend], x, y, masks, acc)
        got = _port_contract(spec, fam, backend, x, y, masks, acc)
        _close(fam, _np(got), want)
        if not lead and acc is None and fam != "F32GER_3XBF16":
            # and the oracle: pm_ger multiplies the (finite) operands out
            ones = [np.ones(s, bool) for s in (m, n)]
            xm, ym = (mk if mk is not None else o
                      for mk, o in zip(masks[:2], ones))
            oracle = jref.pm_ger(_j(x), _j(y), jprec.Ger[fam], _j(xm),
                                 _j(ym), _j(masks[2]))
            _close(fam, _np(got), oracle)


@pytest.mark.parametrize("fam", ["F32GER", "BF16GER2", "F16GER2", "I8GER4",
                                 "I4GER8", "I16GER2", "F64GER"])
def test_pm_ger_matches_reference(fam):
    m, k, n = 21, 64, 19
    with x64(fam == "F64GER"):
        if fam == "I4GER8":
            x, y = operands(fam, (m, k), (k, n), 3)
        else:
            x, y = _operands(fam, (m, k), (k, n), 3)
        xm, ym, pm = _masks(3, m, n, k)
        acc = np.arange(m * n).reshape(m, n) % 7
        acc = acc.astype(np.float64 if fam == "F64GER" else (
            np.float32 if fam in NP_DTYPES else np.int32))
        want = jref.pm_ger(_j(x), _j(y), jprec.Ger[fam], _j(xm), _j(ym),
                           _j(pm), _j(acc))
        got = tref.pm_ger(_t(x), _t(y), tprec.Ger[fam], _t(xm), _t(ym),
                          _t(pm), _t(acc))
        _close("I8GER4" if fam == "I4GER8" else fam, _np(got), want)


def test_pm_ger_multiplies_nan_in_a_disabled_lane():
    """The oracle multiplies: a NaN in a disabled row stays NaN there, as
    the reference's oracle keeps it."""
    x = np.ones((4, 8), np.float32)
    x[1, 3] = np.nan
    y = np.ones((8, 5), np.float32)
    xm = np.array([True, False, True, True])
    ym = np.ones(5, bool)
    got = tref.pm_ger(_t(x), _t(y), tprec.Ger.F32GER, _t(xm), _t(ym))
    want = np.asarray(jref.pm_ger(_j(x), _j(y), jprec.Ger.F32GER, _j(xm),
                                  _j(ym)))
    assert np.isnan(got.numpy()[1]).all() and np.isnan(want[1]).all()
    np.testing.assert_array_equal(got.numpy()[[0, 2, 3]], want[[0, 2, 3]])


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("fam", ["F32GER", "BF16GER2", "F64GER"])
def test_nan_in_disabled_lanes_gives_exact_zeros(fam, backend, monkeypatch):
    """NaN in a disabled row and rank of X and a disabled column and rank
    of Y: every backend selects them away (exact zeros where a whole row
    or column is off, the clean product elsewhere), and the kernel
    wrapper is handed the caller's unmasked tensors."""
    m, k, n = 24, 48, 20
    rng = np.random.default_rng(5)
    dt = np.float64 if fam == "F64GER" else np.float32
    x = rng.standard_normal((m, k)).astype(dt)
    y = rng.standard_normal((k, n)).astype(dt)
    xm, ym, pm = _masks(5, m, n, k)
    x[~xm, :] = np.nan
    x[:, ~pm] = np.nan
    y[~pm, :] = np.nan
    y[:, ~ym] = np.inf
    clean_x = np.where(xm[:, None] & pm[None, :], x, 0).astype(dt)
    clean_y = np.where(pm[:, None] & ym[None, :], y, 0).astype(dt)
    seen = []
    wrapped = tgemm.mma_gemm

    def spy(xi, yi, *a, **kw):
        seen.append((xi, kw.get("masks")))
        return wrapped(xi, yi, *a, **kw)

    monkeypatch.setattr(tlow._gemm, "mma_gemm", spy)
    tx, ty = _t(x), _t(y)
    with x64(fam == "F64GER"), tfac.configure(CPU):
        got = tfac.contract(
            "mk,kn->mn", tx, ty, masks=(_t(xm), _t(ym), _t(pm)),
            plan=tfac.Plan(ger=tprec.Ger[fam], backend=backend,
                           out_dtype=tfac.ACC))
        want = tfac.contract(
            "mk,kn->mn", _t(clean_x), _t(clean_y),
            plan=tfac.Plan(ger=tprec.Ger[fam], backend="ref",
                           out_dtype=tfac.ACC))
    got = _np(got)
    assert np.isfinite(got).all()
    assert (got[~xm] == 0).all() and (got[:, ~ym] == 0).all()
    _close(fam, got, _np(want))
    if backend == "kernel":
        assert len(seen) == 1
        xi, mk = seen[0]
        assert mk is not None and len(mk) == 3
        if fam != "BF16GER2":       # the policy's cast copies bf16 operands
            assert xi.data_ptr() == tx.data_ptr()
        assert torch.isnan(xi).any()
    else:
        assert not seen


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_masks_with_no_entry_are_the_plain_product(backend):
    x, y = _operands("F32GER", (12, 16), (16, 10), 9)
    got = _port_contract("mk,kn->mn", "F32GER", backend, x, y,
                         (None, None, None))
    with tfac.configure(CPU):
        want = tfac.contract("mk,kn->mn", _t(x), _t(y),
                             plan=tfac.Plan(ger=tprec.Ger.F32GER,
                                            backend=backend,
                                            out_dtype=tfac.ACC))
    assert torch.equal(got, want)


ERRORS = {
    "two_entries": ("mk,kn->mn", (8, 16), (16, 4), "masks2", "F32GER"),
    "einsum": ("mk,mk->m", (8, 16), (8, 16), "masks3", "F32GER"),
    "not_natural": ("km,kn->mn", (16, 8), (16, 4), "masks3", "F32GER"),
    "dequant": ("mk,kn->mn", (8, 16), (16, 4), "dequant", "I8GER4"),
    "int4": ("mk,kn->mn", (8, 8), (8, 4), "masks3", "I4GER8"),
    "shape": ("mk,kn->mn", (8, 16), (16, 4), "bad_shape", "F32GER"),
    "conv": ("nhwc,hwio->nhwo", (1, 4, 4, 2), (2, 2, 2, 3), "masks3",
             "F32GER"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_validation_errors_match_reference(case):
    spec, sx, sy, how, fam = ERRORS[case]
    dt = np.int8 if fam.startswith("I") else np.float32
    x, y = np.zeros(sx, dt), np.zeros(sy, np.uint8 if fam == "I8GER4"
                                      else dt)
    m3 = (None, None, np.ones(sx[-1], bool))
    masks = {"masks2": (None, None), "masks3": m3, "dequant": m3,
             "bad_shape": (np.ones(sx[0] + 1, bool), None, None)}[how]
    jkw, tkw = {}, {}
    if how == "dequant":
        from repro.core import lowering as jlow
        jkw["dequant"] = jlow.Dequant(jnp.ones((8, 1)), jnp.zeros((8, 1)),
                                      jnp.zeros(4), jnp.ones(4))
        tkw["dequant"] = tlow.Dequant(torch.ones(8, 1), torch.zeros(8, 1),
                                      torch.zeros(4), torch.ones(4))
    with pytest.raises(ValueError) as jerr:
        jfac.contract(spec, _j(x), _j(y), masks=tuple(_j(m) for m in masks),
                      plan=jfac.Plan(ger=jprec.Ger[fam]), **jkw)
    with tfac.configure(CPU), pytest.raises(ValueError) as terr:
        tfac.contract(spec, _t(x), _t(y), masks=tuple(_t(m) for m in masks),
                      plan=tfac.Plan(ger=tprec.Ger[fam]), **tkw)
    assert str(terr.value) == str(jerr.value)


def test_later_list_is_gone():
    assert not hasattr(tlow, "_LATER") and not hasattr(tlow, "_later")
    for b in ("kernel", "torch", "ref"):
        assert tlow.lookup(b, "gemm.masked", tprec.Ger.BF16GER2, False)


# ----------------------------------------------------------------------
# The kernel wrapper: route, refusals, packed operands
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fam,m,path", [
    ("BF16GER2", 4, "wmma"), ("BF16GER2", 1024, "wmma"),
    ("F16GER2", 4, "wmma"), ("F32GER", 1024, "wmma"),
    ("I8GER4", 4, "imma"), ("I16GER2", 512, "imma"),
    ("F64GER", 2048, "dmma")])
def test_masked_route_is_static(fam, m, path):
    """A masked 16-bit or fp32 product takes the WMMA tile at every M
    (the unmasked one takes the stream or the wgmma tile), the integers
    IMMA, F64GER DMMA."""
    ger = tprec.Ger[fam]
    got, cfg = tiling.choose_gemm_path(m, 11008, 4096, ger, 1, True, None,
                                       True)
    assert got == path
    if path == "wmma":
        assert cfg in tiling.tiles_for(ger)
        assert tiling.choose_gemm_path(m, 11008, 4096, ger)[0] != "wmma" \
            or fam == "F32GER"


def test_wrapper_refusals():
    x = torch.ones((8, 16), dtype=torch.int8)
    y = torch.ones((16, 4), dtype=torch.int8)
    rows = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="ref.pm_ger"):
        tgemm.mma_gemm(x, y, kind=tprec.Ger.I4GER8,
                       masks=(rows, None, None))
    with pytest.raises(ValueError, match="ref.pm_ger"):
        tgemm.mma_gemm(x, y, kind=tprec.Ger.I4GER8,
                       masks=(None, None, torch.ones(32, dtype=torch.bool)))
    a = torch.randn(8, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tgemm.mma_gemm(a, torch.randn(16, 4), kind=tprec.Ger.F32GER,
                       masks=(rows, None, None))
    with pytest.raises(ValueError, match="mask 1 has shape"):
        tgemm.mma_gemm(torch.randn(8, 16), torch.randn(16, 4),
                       kind=tprec.Ger.F32GER,
                       masks=(None, torch.ones(5, dtype=torch.bool), None))


def test_i4ger8_column_mask_on_the_wrapper():
    """I4GER8 takes a column predicate in the kernel (a zero byte unpacks
    to two zero nibbles): the plain version equals pm_ger with every row
    and rank on."""
    x, y = operands("I4GER8", (16, 64), (64, 24), 4)
    ym = _masks(4, 16, 24, 64, "y")[1]
    got = tgemm.mma_gemm(_t(x), _t(y), kind=tprec.Ger.I4GER8,
                         masks=(None, _t(ym), None))
    want = jref.pm_ger(_j(x), _j(y), jprec.Ger.I4GER8,
                       jnp.ones(16, bool), _j(ym))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_packed_operand_demotes_when_masked(backend):
    """A prepacked weight under masks: the kernel backend's WMMA tile reads
    its panels through the masked packed loader (K1d), with no demote; the
    torch and ref lowerings demote it, counted, with their reason, as they
    demote any packed operand; the result is the natural masked one bit
    for bit."""
    packing.clear_state()
    k, n = 96, 200
    x, w = _operands("BF16GER2", (4, k), (k, n), 8)
    masks = tuple(_t(mk) for mk in _masks(8, 4, n, k))
    tw = _t(w).to(torch.bfloat16)
    po = packing.pack_gemm(tw, packing.gemm_layout(tprec.Ger.BF16GER2, k, n))
    plan = tfac.Plan(backend=backend, out_dtype=tfac.ACC)
    with tfac.configure(CPU):
        nat = tfac.contract("mk,kn->mn", _t(x), tw, masks=masks, plan=plan)
        before = packing.COUNTERS["demote"]
        pk = tfac.contract("mk,kn->mn", _t(x), po, masks=masks, plan=plan)
    assert torch.equal(nat, pk)
    if backend == "kernel":
        assert packing.COUNTERS["demote"] == before
    else:
        assert packing.COUNTERS["demote"] == before + 1
        why = {"torch": "torch-masked", "ref": "ref-gemm"}[backend]
        assert packing.EVENTS[-1]["why"] == why
    packing.clear_state()


# ----------------------------------------------------------------------
# kernels/ops.py against the reference's shims
# ----------------------------------------------------------------------

def _warns(fn, *a, **kw):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        out = fn(*a, **kw)
    return out, [w.category for w in got]


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_ops_mma_dot_and_fused(backend):
    x, y = _operands("F32GER", (20, 48), (48, 12), 11)
    c = _operands("F32GER", (20, 12), (1, 1), 12)[0]
    bias = _operands("F32GER", (12,), (1, 1), 13)[0]
    jb = BACKENDS[backend]
    pallas = dict(use_pallas=jb == "pallas", interpret=True)
    want, jw = _warns(jops.mma_dot, _j(x), _j(y), _j(c),
                      kind=jprec.Ger.F32GER, **pallas)
    with tfac.configure(CPU):
        got, tw = _warns(tops.mma_dot, _t(x), _t(y), _t(c),
                         kind=tprec.Ger.F32GER, backend=backend)
    assert DeprecationWarning in tw and DeprecationWarning in jw
    _close("F32GER", got.numpy(), want)
    jep = jfac.Epilogue(bias=True, activation="gelu")
    tep_ = tfac.Epilogue(bias=True, activation="gelu")
    want, _ = _warns(jops.mma_dot_fused, _j(x), _j(y), _j(c),
                     kind=jprec.Ger.F32GER, epilogue=jep, bias=_j(bias),
                     alpha=2.0, beta=-0.5, neg_acc=True, **pallas)
    with tfac.configure(CPU):
        got, tw = _warns(tops.mma_dot_fused, _t(x), _t(y), _t(c),
                         kind=tprec.Ger.F32GER, epilogue=tep_,
                         bias=_t(bias), alpha=2.0, beta=-0.5, neg_acc=True,
                         backend=backend)
    assert DeprecationWarning in tw
    _close("F32GER", got.numpy(), want)


@pytest.mark.parametrize("fam", ["F32GER", "BF16GER2", "I8GER4", "I4GER8",
                                 "I16GER2"])
def test_ops_mma_pm_dot(fam):
    m, k, n = 17, 64, 22
    x, y = (operands if fam == "I4GER8" else _operands)(
        fam, (m, k), (k, n), 14)
    xm, ym, pm = _masks(14, m, n, k)
    want, jw = _warns(jops.mma_pm_dot, _j(x), _j(y),
                      kind=jprec.Ger[fam], xmask=_j(xm), ymask=_j(ym),
                      pmask=_j(pm))
    with tfac.configure(CPU):
        got, tw = _warns(tops.mma_pm_dot, _t(x), _t(y), kind=tprec.Ger[fam],
                         xmask=_t(xm), ymask=_t(ym), pmask=_t(pm))
    # I4GER8 keeps the oracle, without the warning, in both packages
    assert (DeprecationWarning in tw) == (fam != "I4GER8")
    assert (DeprecationWarning in jw) == (fam != "I4GER8")
    _close("I8GER4" if fam == "I4GER8" else fam, _np(got), want)


@pytest.mark.parametrize("seeded", [False, True])
def test_ops_mma_pm_dot_i4ger8_column_mask_takes_the_kernel(monkeypatch,
                                                           seeded):
    """I4GER8 with a column mask alone goes to the kernel wrapper's column
    predicate (a spy on ``mma_gemm``), bit for bit the reference's
    ``pm_ger`` with every row and rank on; with a row mask it keeps the
    oracle and never reaches the wrapper."""
    m, k, n = 17, 64, 22
    x, y = operands("I4GER8", (m, k), (k, n), 21)
    ym = _masks(21, m, n, k, "y")[1]
    acc = (np.random.default_rng(21).integers(-2 ** 20, 2 ** 20, (m, n))
           .astype(np.int32) if seeded else None)
    calls = []
    real = tgemm.mma_gemm

    def spy(*args, **kw):
        calls.append(kw.get("masks"))
        return real(*args, **kw)

    monkeypatch.setattr(tgemm, "mma_gemm", spy)
    want = jref.pm_ger(_j(x), _j(y), jprec.Ger.I4GER8, jnp.ones(m, bool),
                       _j(ym), acc=_j(acc))
    with tfac.configure(CPU):
        got = tops.mma_pm_dot(_t(x), _t(y), kind=tprec.Ger.I4GER8,
                              xmask=None, ymask=_t(ym), acc=_t(acc))
    assert len(calls) == 1 and calls[0][0] is None and calls[0][2] is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with tfac.configure(CPU):
        tops.mma_pm_dot(_t(x), _t(y), kind=tprec.Ger.I4GER8,
                        xmask=_t(np.ones(m, bool)), ymask=_t(ym))
    assert len(calls) == 1


@pytest.mark.parametrize("fam", ["I8GER4", "I16GER2"])
def test_ops_mma_ger_saturating(fam):
    x, y = operands(fam, (12, 64), (64, 10), 15)
    acc = np.full((12, 10), 2 ** 31 - 1000, np.int32)
    want = jops.mma_ger_saturating(_j(x), _j(y), jprec.Ger[fam], _j(acc))
    with tfac.configure(CPU):
        got = tops.mma_ger_saturating(_t(x), _t(y), tprec.Ger[fam], _t(acc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_ops_mma_conv2d(backend):
    rng = np.random.default_rng(16)
    img = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    ker = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    jb = BACKENDS[backend]
    want, _ = _warns(jops.mma_conv2d, _j(img), _j(ker),
                     use_pallas=jb == "pallas", interpret=True)
    with tfac.configure(CPU):
        got, tw = _warns(tops.mma_conv2d, _t(img), _t(ker), backend=backend)
    assert DeprecationWarning in tw
    _close("F32GER", got.numpy(), want)


@pytest.mark.parametrize("fam", ["BF16GER2", "F32GER"])
def test_packed_masked_wmma_reads_panels_nan_in_disabled_lanes(fam):
    """K1d under the pm* masks: a packed weight whose disabled columns and
    ranks hold NaN and Inf rides the WMMA (fp32) tile's masked packed
    loader: no demote, the natural masked result bit for bit, finite, and
    the reference's pallas (interpret) result within the family's
    tolerance on the same panels' natural values."""
    packing.clear_state()
    m, k, n = 70, 96, 200
    x, w = _operands(fam, (m, k), (k, n), 9)
    masks = _masks(9, m, n, k)
    _, ym, pm = masks
    w = w.copy()
    w[:, ~ym] = np.nan
    w[~pm, :] = np.inf
    dt = torch.bfloat16 if fam == "BF16GER2" else torch.float32
    tw = _t(w).to(dt)
    po = packing.pack_gemm(tw, packing.gemm_layout(tprec.Ger[fam], k, n))
    plan = tfac.Plan(ger=tprec.Ger[fam], out_dtype=tfac.ACC)
    tmasks = tuple(_t(mk) for mk in masks)
    with tfac.configure(CPU):
        nat = tfac.contract("mk,kn->mn", _t(x), tw, masks=tmasks, plan=plan)
        before = dict(packing.COUNTERS)
        pk = tfac.contract("mk,kn->mn", _t(x), po, masks=tmasks, plan=plan)
    assert torch.equal(nat, pk)
    assert bool(torch.isfinite(pk).all())
    assert dict(packing.COUNTERS) == before
    assert tiling.choose_gemm_path(m, n, k, tprec.Ger[fam], 1, True, None,
                                   True)[0] == "wmma"
    want = _ref_contract("mk,kn->mn", fam, "pallas", x, w, masks)
    _close(fam, _np(pk), want)
