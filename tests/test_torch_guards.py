"""Guarded contract dispatch in the port (``core/lowering._guarded_dispatch``:
the kernel -> torch -> ref ladder, quarantine, ``GUARD_EVENTS``) against the
JAX reference's (pallas -> xla -> ref), on the CPU.

The reference's cases (``tests/test_guards.py``) run on one contract call
in both packages (F32GER with an f32 store, so the two agree to fp32
rounding), the same numpy operands and the same fault plan; their
``GUARD_EVENTS`` must be equal after mapping the reference's rung names
(pallas -> kernel, xla -> torch), and the outputs equal within 1e-5 of
max|ref| (fp32 products summed in another order).  The reference's two jit
cases have no counterpart: the port traces nothing.  With guards off (and
no plan) the output is the guarded one bit for bit.  A ``RuntimeError``
from a kernel wrapper — how a CUDA kernel that fails to build or launch
reports — propagates under guards and is not demoted: the ladder is no
hidden fallback from the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import lowering as jlow
from repro.runtime import faults as jfaults
from repro_torch.core import facility as tfac
from repro_torch.core import lowering as tlow
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.runtime import faults

CPU = tfac.FacilityConfig(device="cpu", ger=tfac.Ger.F32GER,
                          out_dtype=torch.float32)
GUARDED = dataclasses.replace(CPU, guards=True)
RUNGS = {"pallas": "kernel", "xla": "torch", "ref": "ref"}
SPEC = "mk,kn->mn"


@pytest.fixture(autouse=True)
def _clean_guard_state():
    tlow.clear_guard_state()
    jlow.clear_guard_state()
    yield
    tlow.clear_guard_state()
    jlow.clear_guard_state()


def _xy(m=8, k=16, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _port(x, y, cfg=GUARDED, backend="kernel"):
    with tfac.configure(cfg):
        return tfac.contract(SPEC, torch.from_numpy(x), torch.from_numpy(y),
                             plan=tfac.Plan(backend=backend)).numpy()


def _ref(x, y, guards=True, backend="pallas"):
    cfg = dataclasses.replace(jfac.current(), guards=guards,
                              ger=jfac.Ger.F32GER, out_dtype=np.float32)
    with jfac.configure(cfg):
        return np.asarray(jfac.contract(SPEC, x, y,
                                        plan=jfac.Plan(backend=backend)))


def _events(log, mapped=False):
    name = (lambda r: RUNGS[r]) if mapped else (lambda r: r)
    return [(e["op_class"], e["spec"], name(e["from"]), name(e["to"]),
             e["reason"]) for e in log]


def _both(x, y, plan_specs, backend="pallas", seed=0):
    """One guarded contract call in each package under the same plan:
    (port output, reference output, port plan, reference plan)."""
    tp = faults.FaultPlan([faults.FaultSpec(**s) for s in plan_specs],
                          seed=seed)
    jp = jfaults.FaultPlan([jfaults.FaultSpec(**s) for s in plan_specs],
                           seed=seed)
    with faults.install(tp):
        got = _port(x, y, backend=RUNGS[backend])
    with jfaults.install(jp):
        want = _ref(x, y, backend=backend)
    return got, want, tp, jp


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _count(rung, op_class="gemm"):
    return sum(v for (b, oc, _), v in tlow.DISPATCH_COUNTS.items()
               if b == rung and oc == op_class)


def test_guards_off_bitwise_unchanged():
    x, y = _xy()
    assert faults.active() is None
    base = _port(x, y, cfg=CPU)
    guarded = _port(x, y)
    assert base.dtype == guarded.dtype and base.tobytes() == guarded.tobytes()
    assert tlow.GUARD_EVENTS == [] and tlow.quarantine_state() == {}
    _close(guarded, _ref(x, y))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_injected_raise_demotes_within_one_call(backend):
    x, y = _xy()
    got, want, tp, jp = _both(x, y, [dict(point="contract.dispatch",
                                          kind="raise")], backend)
    assert len(tp.events) == len(jp.events) == 1
    assert _events(tlow.GUARD_EVENTS) == _events(jlow.GUARD_EVENTS, True)
    assert tlow.GUARD_EVENTS[0]["to"] == RUNGS[
        jlow.GUARD_EVENTS[0]["to"]]
    assert "InjectedFault" in tlow.GUARD_EVENTS[0]["reason"]
    assert sorted(tlow.quarantine_state().values()) == sorted(
        RUNGS[r] for r in jlow.quarantine_state().values())
    _close(got, want)
    _close(got, _port(x, y, cfg=CPU))


def test_quarantine_not_retried_per_call():
    x, y = _xy()
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.CONTRACT_DISPATCH, kind=faults.RAISE)])
    with faults.install(plan):
        _port(x, y)
        n_events = len(tlow.GUARD_EVENTS)
        before = _count("torch")
        _port(x, y)                            # plan exhausted: no fault
    assert len(tlow.GUARD_EVENTS) == n_events  # no new demotion
    assert _count("torch") == before + 1       # served from the torch rung


def test_nan_poison_demotes_and_recovers():
    x, y = _xy()
    got, want, _, _ = _both(x, y, [dict(point="contract.dispatch",
                                        kind="nan")])
    assert np.isfinite(got).all()
    _close(got, want)
    assert _events(tlow.GUARD_EVENTS) == _events(jlow.GUARD_EVENTS, True)
    assert any(e["reason"] == "non-finite output"
               for e in tlow.GUARD_EVENTS)
    assert list(tlow.quarantine_state().values()) == ["torch"]


def test_input_borne_nan_is_not_quarantined():
    x, y = _xy()
    x[0, 0] = np.nan
    got = _port(x, y)
    want = _ref(x, y)
    assert not np.isfinite(got).all()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert tlow.quarantine_state() == {} == jlow.quarantine_state()
    assert _events(tlow.GUARD_EVENTS) == _events(jlow.GUARD_EVENTS, True)


def test_unguarded_dispatch_propagates_injected_raise():
    x, y = _xy()
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.CONTRACT_DISPATCH, kind=faults.RAISE)])
    with faults.install(plan):
        with pytest.raises(faults.InjectedFault):
            _port(x, y, cfg=CPU)


def test_persistent_raise_walks_the_whole_ladder_as_reference():
    """Three raises in a row: every rung fails, the last one's raise
    surfaces, and the demotions on the way are the reference's."""
    x, y = _xy()
    specs = [dict(point="contract.dispatch", kind="raise", every=1,
                  max_fires=None)]
    tp = faults.FaultPlan([faults.FaultSpec(**s) for s in specs])
    jp = jfaults.FaultPlan([jfaults.FaultSpec(**s) for s in specs])
    with faults.install(tp), pytest.raises(faults.InjectedFault):
        _port(x, y)
    with jfaults.install(jp), pytest.raises(jfaults.InjectedFault):
        _ref(x, y)
    assert _events(tlow.GUARD_EVENTS) == _events(jlow.GUARD_EVENTS, True)
    assert len(tp.events) == len(jp.events) == 3


@pytest.mark.parametrize("err", [RuntimeError, torch.AcceleratorError])
def test_kernel_runtime_error_raises_under_guards(monkeypatch, err):
    """A kernel that fails to build or launch raises RuntimeError (or
    torch.AcceleratorError): not a LOWERING_ERROR, so guarded dispatch
    lets it through — no demotion, no quarantine, no torch-rung result."""
    x, y = _xy()

    def broken(*args, **kwargs):
        raise err("mma_gemm (stream): CUDA error 209 (no kernel image)")

    monkeypatch.setattr(tgemm, "mma_gemm", broken)
    assert not issubclass(err, tlow.LOWERING_ERRORS)
    before = _count("torch")
    with pytest.raises(err, match="CUDA error"):
        _port(x, y)
    assert tlow.GUARD_EVENTS == [] and tlow.quarantine_state() == {}
    assert _count("torch") == before
