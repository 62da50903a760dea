"""ABFT checksummed contract execution in the port (``core/abft.py``, the
guarded ladder's verification, the GEMM kernels' checksum sidecar K1e)
against the JAX reference's, on the CPU.

The reference's cases (``tests/test_abft.py``) on the port: an injected
``flip`` is detected by checksum verification and recovered to the result
of the clean call bit for bit (same-rung retry, then demotion with
quarantine); with ABFT off the same flip sails through; no false positive
over a clean sweep of shapes and backends, the accumulate forms and the
bias epilogue; the attn and conv augmentations detect a flip and stay
within 2e-2 of the unaugmented call (the reference's bound: the extra
column moves rounding only), depthwise skips; a packed Y verifies with no
demote (``packing.COUNTERS``).  Where both packages run the same call
under the same plan, their verdict sequences are equal after mapping the
reference's rung names (pallas -> kernel, xla -> torch).  The sidecar: the
port's per-tile sums, reduced (``abft.deposit``), equal the reference
kernel's reduced sidecar (interpret mode) within ABFT's own tolerance,
``ATOL + FACTOR * eps(acc) * |X||Y|`` summed alike, on each path's plain
version (the weight stream split and batched, in bf16 and at F32GER
decode, the wgmma tile, the WMMA tile at an unaligned pitch and the fp32
tile, DMMA in F64GER), fringes included.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import facility as jfac
from repro.core import lowering as jlow
from repro.core import packing as jpacking
from repro.core.precision import Ger as JGer
from repro.kernels import mma_gemm as jgemm
from repro.runtime import faults as jfaults
from repro_torch.core import abft
from repro_torch.core import facility as tfac
from repro_torch.core import lowering as tlow
from repro_torch.core import packing, tiling
from repro_torch.core.precision import Ger
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.runtime import faults
from test_torch_families import x64

CPU = tfac.FacilityConfig(device="cpu")
RUNGS = {"pallas": "kernel", "xla": "torch", "ref": "ref"}
KERNEL = tfac.Plan(backend="kernel")
PALLAS = jfac.Plan(backend="pallas")


@pytest.fixture(autouse=True)
def _clean_guard_state():
    tlow.clear_guard_state()
    jlow.clear_guard_state()
    yield
    tlow.clear_guard_state()
    jlow.clear_guard_state()


def _xy(m=16, k=32, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(**over):
    return tfac.configure(dataclasses.replace(CPU, **over))


def _jcfg(**over):
    return jfac.configure(dataclasses.replace(jfac.current(), **over))


def _flip_specs(**kw):
    return [dict(point="contract.dispatch", kind="flip", **kw)]


def _plans(specs, seed=0):
    return (faults.FaultPlan([faults.FaultSpec(**s) for s in specs], seed),
            jfaults.FaultPlan([jfaults.FaultSpec(**s) for s in specs], seed))


def _verdicts(vs, mapped=False):
    name = (lambda r: RUNGS[r]) if mapped else (lambda r: r)
    return [(v["op_class"], name(v["rung"]), v["recovered"], v["how"])
            for v in vs]


def _bytes(t):
    return t.float().numpy().tobytes()


# ---------------------------------------------------------------------
# the regression ABFT exists for
# ---------------------------------------------------------------------

def test_flip_on_kernel_gemm_detected_and_recovered_bitwise():
    x, y = _xy()
    with _cfg():
        base = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
    tp, jp = _plans(_flip_specs())
    with _cfg(guards=True, abft=True), faults.install(tp):
        out = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
        got = abft.drain_verdicts()
    with _jcfg(guards=True, abft=True), jfaults.install(jp):
        jfac.contract("mk,kn->mn", x, y, plan=PALLAS)
        want = jabft.drain_verdicts()
    assert _bytes(out) == _bytes(base)
    assert _verdicts(got) == _verdicts(want, True) == [
        ("gemm", "kernel", True, "retry")]
    # the kernel rung's check read the sidecar the kernel summed
    assert got[0]["detail"]["sidecar"] is True


def test_flip_without_abft_sails_through_undetected():
    x, y = _xy()
    with _cfg():
        base = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
    tp, _ = _plans(_flip_specs())
    with _cfg(guards=True), faults.install(tp):
        out = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
        verdicts = abft.drain_verdicts()
    assert bool(torch.isfinite(out).all())
    assert _bytes(out) != _bytes(base)
    assert verdicts == [] and tlow.GUARD_EVENTS == []


def test_abft_flag_without_guards_is_inert_and_bitwise():
    x, y = _xy()
    with _cfg():
        base = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
    with _cfg(abft=True):
        out = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
    assert _bytes(out) == _bytes(base)
    assert abft.drain_verdicts() == []


def test_persistent_flip_demotes_with_quarantine_exactly_once():
    x, y = _xy()
    with _cfg():
        base = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
    tp, jp = _plans(_flip_specs(every=1, max_fires=4))
    with _cfg(guards=True, abft=True), faults.install(tp):
        out = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
        got = abft.drain_verdicts()
        q1 = dict(tlow.quarantine_state())
        out2 = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=KERNEL)
        q2 = dict(tlow.quarantine_state())
    with _jcfg(guards=True, abft=True), jfaults.install(jp):
        jfac.contract("mk,kn->mn", x, y, plan=PALLAS)
        want = jabft.drain_verdicts()
    # ref's result is the ground truth: within fp32 rounding of the kernel
    # rung's, the same store dtype
    torch.testing.assert_close(out.float(), base.float(), rtol=2 ** -7,
                               atol=0)
    assert _bytes(out2) == _bytes(out)
    assert len(tp.fired(faults.CONTRACT_DISPATCH)) == 4
    assert _verdicts(got) == _verdicts(want, True) == [
        ("gemm", "ref", True, "demote")]
    assert list(q1.values()) == ["ref"] and q1 == q2
    assert [(e["from"], e["to"], e["reason"]) for e in tlow.GUARD_EVENTS] \
        == [(RUNGS[e["from"]], RUNGS[e["to"]], e["reason"])
            for e in jlow.GUARD_EVENTS]


# ---------------------------------------------------------------------
# no false positives: clean dispatches stay bitwise and verdict-free
# ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("m,k,n,batched", [(16, 32, 16, False),
                                           (13, 17, 11, False),
                                           (8, 24, 12, True),
                                           (130, 64, 72, False)])
def test_clean_gemm_sweep_no_false_positive(backend, m, k, n, batched):
    x, y = (_t(a) for a in _xy(m, k, n))
    spec = "mk,kn->mn"
    if batched:
        x, y, spec = (torch.stack([x, x + 1]), torch.stack([y, y - 1]),
                      "bmk,bkn->bmn")
    plan = tfac.Plan(backend=backend)
    with _cfg():
        base = tfac.contract(spec, x, y, plan=plan)
    with _cfg(guards=True, abft=True):
        out = tfac.contract(spec, x, y, plan=plan)
        verdicts = abft.drain_verdicts()
    assert _bytes(out) == _bytes(base)
    assert verdicts == [] and tlow.GUARD_EVENTS == []


def test_clean_forms_and_bias_epilogue_no_false_positive():
    x, y = (_t(a) for a in _xy(16, 32, 16))
    rng = np.random.default_rng(3)
    c = _t(rng.standard_normal((16, 16)).astype(np.float32))
    bias = _t(rng.standard_normal((16,)).astype(np.float32))
    calls = [
        dict(plan=tfac.Plan(backend="kernel", alpha=1.5, beta=-0.5,
                            neg_product=True), acc=c),
        dict(plan=tfac.Plan(backend="kernel", neg_acc=True), acc=c),
        dict(plan=KERNEL, bias=bias),
        dict(plan=KERNEL, residual=c),
    ]
    for kw in calls:
        with _cfg():
            base = tfac.contract("mk,kn->mn", x, y, **kw)
        with _cfg(guards=True, abft=True):
            out = tfac.contract("mk,kn->mn", x, y, **kw)
            verdicts = abft.drain_verdicts()
        assert _bytes(out) == _bytes(base), kw
        assert verdicts == [], kw


# ---------------------------------------------------------------------
# attn / conv: operand augmentation
# ---------------------------------------------------------------------

def _qkv(seed=0, B=2, Sq=8, Sk=8, H=2, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D)))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_attn_augmentation_is_tolerance_clean_and_detects_flip(backend):
    q, k, v = _qkv()
    plan = tfac.Plan(backend=backend)
    with _cfg():
        base = tfac.contract(tfac.ATTN, _t(q), _t(k), _t(v), plan=plan)
    with _cfg(guards=True, abft=True):
        clean = tfac.contract(tfac.ATTN, _t(q), _t(k), _t(v), plan=plan)
        assert abft.drain_verdicts() == []
    torch.testing.assert_close(clean.float(), base.float(), atol=2e-2,
                               rtol=2e-2)
    tp, jp = _plans(_flip_specs())
    with _cfg(guards=True, abft=True), faults.install(tp):
        out = tfac.contract(tfac.ATTN, _t(q), _t(k), _t(v), plan=plan)
        got = abft.drain_verdicts()
    with _jcfg(guards=True, abft=True), jfaults.install(jp):
        jfac.contract(jfac.ATTN, q, k, v,
                      plan=jfac.Plan(backend={"kernel": "pallas",
                                              "torch": "xla"}[backend]))
        want = jabft.drain_verdicts()
    assert _verdicts(got) == _verdicts(want, True) == [
        ("attn", backend, True, "retry")]
    torch.testing.assert_close(out.float(), base.float(), atol=2e-2,
                               rtol=2e-2)


def test_conv_augmentation_detects_flip_and_depthwise_skips():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 8)).astype(np.float32)
    w = rng.standard_normal((3, 8, 12)).astype(np.float32)
    with _cfg():
        base = tfac.contract(tfac.CONV1D, _t(x), _t(w))
    tp, jp = _plans(_flip_specs())
    with _cfg(guards=True, abft=True), faults.install(tp):
        out = tfac.contract(tfac.CONV1D, _t(x), _t(w))
        got = abft.drain_verdicts()
    with _jcfg(guards=True, abft=True, use_pallas=True), \
            jfaults.install(jp):
        jfac.contract(jfac.CONV1D, x, w)
        want = jabft.drain_verdicts()
    assert _verdicts(got) == _verdicts(want, True) == [
        ("conv", "kernel", True, "retry")]
    torch.testing.assert_close(out.float(), base.float(), atol=2e-2,
                               rtol=2e-2)
    wd = rng.standard_normal((3, 8)).astype(np.float32)
    with _cfg():
        based = tfac.contract(tfac.CONV1D_DEPTHWISE, _t(x), _t(wd))
    with _cfg(guards=True, abft=True):
        outd = tfac.contract(tfac.CONV1D_DEPTHWISE, _t(x), _t(wd))
        assert abft.drain_verdicts() == []
    assert _bytes(outd) == _bytes(based)


# ---------------------------------------------------------------------
# prepacked operands: panel checksums, verified without demotion
# ---------------------------------------------------------------------

def test_packed_y_verifies_bitwise_and_detects_flip():
    """A packed Y on the weight stream (which reads its panels): verified
    straight over the panels, bit for bit the natural call, no demote."""
    m, k, n = 16, 96, 80
    x, y = (_t(a) for a in _xy(m, k, n))
    po = packing.pack_gemm(y.bfloat16(), packing.gemm_layout(
        Ger.BF16GER2, k, n, side="y"))
    assert tiling.choose_gemm_path(m, n, k, Ger.BF16GER2)[0] == "stream"
    with _cfg():
        natural = tfac.contract("mk,kn->mn", x, y, plan=KERNEL)
        base = tfac.contract("mk,kn->mn", x, po, plan=KERNEL)
    assert _bytes(base) == _bytes(natural)
    demotes = packing.COUNTERS["demote"]
    with _cfg(guards=True, abft=True):
        clean = tfac.contract("mk,kn->mn", x, po, plan=KERNEL)
        assert abft.drain_verdicts() == []
    assert _bytes(clean) == _bytes(base)
    tp, jp = _plans(_flip_specs())
    with _cfg(guards=True, abft=True), faults.install(tp):
        out = tfac.contract("mk,kn->mn", x, po, plan=KERNEL)
        got = abft.drain_verdicts()
    assert packing.COUNTERS["demote"] == demotes
    assert _bytes(out) == _bytes(base)
    # the reference's packed case, F32GER on its pallas kernel
    jx, jy = x.numpy(), y.numpy()
    jpo = jpacking.pack_gemm(jy, jpacking.gemm_layout(
        JGer.F32GER, m, n, k, side="y", backend="pallas"))
    with _jcfg(guards=True, abft=True), jfaults.install(jp):
        jfac.contract("mk,kn->mn", jx, jpo,
                      plan=jfac.Plan(ger=JGer.F32GER, backend="pallas"))
        want = jabft.drain_verdicts()
    assert _verdicts(got) == _verdicts(want, True) == [
        ("gemm", "kernel", True, "retry")]


# ---------------------------------------------------------------------
# the kernel sidecar (K1e): per-tile sums against the reference's
# ---------------------------------------------------------------------

# (family, x shape, y shape, the path the card takes)
SIDECAR_CASES = {
    "stream split": ("BF16GER2", (5, 512), (512, 300), "stream"),
    "stream batched": ("BF16GER2", (3, 7, 96), (3, 96, 130), "stream"),
    "wgmma": ("BF16GER2", (130, 64), (64, 72), "wgmma"),
    "wmma unaligned": ("BF16GER2", (100, 40), (40, 77), "wmma"),
    "wmma f32": ("F32GER", (70, 40), (40, 11), "wmma"),
    "stream f32 decode": ("F32GER", (4, 512), (512, 300), "stream"),
    "dmma": ("F64GER", (70, 20), (20, 130), "dmma"),
}


@pytest.mark.parametrize("case", sorted(SIDECAR_CASES))
def test_sidecar_matches_reference_within_abft_tolerance(case):
    fam, sx, sy, path = SIDECAR_CASES[case]
    rng = np.random.default_rng(len(case))
    f64 = fam == "F64GER"
    dt = np.float64 if f64 else np.float32
    x = rng.standard_normal(sx).astype(dt)
    y = (rng.standard_normal(sy) * sy[-2] ** -0.5).astype(dt)
    if fam == "BF16GER2":             # bf16 values on both sides
        x, y = (torch.from_numpy(a).bfloat16().float().numpy()
                for a in (x, y))
    tdt = {"BF16GER2": torch.bfloat16, "F32GER": torch.float32,
           "F64GER": torch.float64}[fam]
    tx, ty = _t(x).to(tdt), _t(y).to(tdt)
    b, m, n, k = (x.shape[0] if x.ndim == 3 else None, x.shape[-2],
                  y.shape[-1], x.shape[-1])
    took, cfg = tiling.choose_gemm_path(m, n, k, Ger[fam], b or 1,
                                        tgemm.natural_aligned(tx, ty))
    assert took == path and (not case.startswith("stream")
                             or "batched" in case or cfg.split > 1)
    out, ck_col, ck_row = tgemm.mma_gemm(tx, ty, kind=Ger[fam],
                                         checksum=True)
    assert _bytes(out) == _bytes(tgemm.mma_gemm(tx, ty, kind=Ger[fam]))
    rows, cols = tgemm.sidecar_tile(path, cfg, m)
    lead = (b,) if b else ()
    assert tuple(ck_col.shape) == lead + (-(-m // rows), n)
    assert tuple(ck_row.shape) == lead + (m, -(-n // cols))
    slot = {}
    abft.deposit(slot, ck_col, ck_row)
    jdt = {"BF16GER2": jnp.bfloat16, "F32GER": jnp.float32,
           "F64GER": jnp.float64}[fam]
    with x64(f64):
        _, jc, jr = jgemm.mma_gemm(jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                                   kind=JGer[fam], interpret=True,
                                   checksum=True)
        jslot = {}
        jabft.deposit(jslot, jc, jr)
        want_col = np.asarray(jslot["col"], np.float64)
        want_row = np.asarray(jslot["row"], np.float64)
    eps = torch.finfo(torch.float64 if f64 else torch.float32).eps
    ax, ay = np.abs(x.astype(np.float64)), np.abs(y.astype(np.float64))
    mag_col = np.einsum("...k,...kn->...n", ax.sum(-2), ay)
    mag_row = np.einsum("...mk,...k->...m", ax, ay.sum(-1))
    for got, want, mag in ((slot["col"], want_col, mag_col),
                           (slot["row"], want_row, mag_row)):
        err = np.abs(got.double().numpy() - want)
        assert np.all(err <= abft.ATOL + abft.FACTOR * eps * mag), err.max()


def test_f64ger_verifies_clean_where_the_reference_flags_it():
    """F64GER's checksums are taken in float64: a clean DGEMM verifies.
    The reference takes them in float32 against a float64 eps and flags
    the same clean product (ROADMAP queue 3, a reference caveat)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((512, 512))
    y = rng.standard_normal((512, 512)) / 512 ** 0.5
    plan = tfac.Plan(ger=Ger.F64GER, out_dtype=torch.float64)
    with _cfg():
        base = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=plan)
    with _cfg(guards=True, abft=True):
        out = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=plan)
        assert abft.drain_verdicts() == []
    assert torch.equal(out, base) and tlow.GUARD_EVENTS == []
    with x64(True), _jcfg(guards=True, abft=True):
        jfac.contract("mk,kn->mn", x, y, plan=jfac.Plan(
            ger=JGer.F64GER, out_dtype=jnp.float64, backend="xla"))
        want = jabft.drain_verdicts()
    assert [v["recovered"] for v in want] == [False]
