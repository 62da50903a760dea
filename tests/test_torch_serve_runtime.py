"""The port's serving runtime (``launch/serve.py``'s ``serve_loop`` and
``run_fault_matrix``, ``runtime/kv_pages.py``) against the JAX reference's,
on a reduced deepseek-7b on the CPU (``device="cpu"``: the kernels' plain
versions).

The reference's cases (``tests/test_serve_runtime.py``, which serves
mamba2-130m): the page pool's ledger, admission on page pressure,
rejection, deadline preemption and requeue, the retry budget, the NaN
guard, the fault matrix and an unrecovered SDC burst.  Where the reference
runs the same settings here (its reduced deepseek-7b, random weights: the
outcomes do not depend on them), the outcomes match: completed, rejected
and failed counts, each matrix scenario ``ok`` (three of the seven run
in the reference here: ``REF_SCENARIOS``), and the page pool quiescent.
The fault timing is not compared visit for visit: the port runs prefill
under an empty fault plan and verifies it, the reference jits it and
visits no hook in it once traced (ROADMAP queue 3).
"""

from __future__ import annotations

import jax
import pytest
import torch

from repro.configs import get as jget
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.configs.base import reduced
from repro_torch.core import facility
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.runtime import faults
from repro_torch.runtime.kv_pages import (PageAccountingError, PagePool,
                                          PagesExhausted)

ARCH = "deepseek-7b"


# ---------------------------------------------------------------------
# PagePool unit tests (no model)
# ---------------------------------------------------------------------

def test_pool_footprint_math():
    pool = PagePool(total_pages=8, page_size=4)
    assert pool.pages_for(1) == 1 and pool.pages_for(4) == 1
    assert pool.pages_for(5) == 2 and pool.pages_for(0) == 1
    assert pool.fits(32) and not pool.fits(33)


def test_pool_alloc_free_exactly_once():
    pool = PagePool(total_pages=4, page_size=4)
    a = pool.alloc(0, 7)
    assert len(a.pages) == 2 and pool.used_pages == 2
    pool.alloc(1, 8)
    assert pool.free_pages == 0 and pool.high_water == 4
    with pytest.raises(PagesExhausted):
        pool.alloc(2, 1)
    assert pool.free(0) == 2
    with pytest.raises(PageAccountingError):
        pool.free(0)
    with pytest.raises(PageAccountingError):
        pool.alloc(1, 1)
    pool.free(1)
    pool.assert_quiescent()
    assert pool.allocs == 2 and pool.frees == 2


def test_pool_exhaustion_allocates_nothing_partially():
    pool = PagePool(total_pages=3, page_size=4)
    pool.alloc(0, 8)
    with pytest.raises(PagesExhausted):
        pool.alloc(1, 8)
    assert pool.free_pages == 1
    pool.free(0)
    pool.assert_quiescent()


def test_pool_quiescence_detects_leak():
    pool = PagePool(total_pages=2, page_size=4)
    pool.alloc(7, 4)
    with pytest.raises(PageAccountingError):
        pool.assert_quiescent()


def test_pool_alloc_fault_point():
    pool = PagePool(total_pages=2, page_size=4)
    plan = faults.FaultPlan([faults.FaultSpec(point=faults.KV_ALLOC,
                                              kind=faults.RAISE)])
    with faults.install(plan):
        with pytest.raises(faults.InjectedFault):
            pool.alloc(0, 4)
        assert pool.free_pages == 2      # the failed alloc took nothing
        pool.alloc(0, 4)                 # transient: the next try succeeds
    pool.free(0)
    pool.assert_quiescent()


# ---------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """(port cfg, port model, reference cfg, reference params)."""
    cfg = reduced(get(ARCH))
    model = M.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    jcfg = jreduced(jget(ARCH))
    return cfg, model, jcfg, JM.init_params(jcfg, jax.random.key(0))


def _serve(served, **kw):
    cfg, model, _, _ = served
    with facility.configure(facility.FacilityConfig(device="cpu")):
        return serve.serve_loop(cfg, model, **kw)


def _ref(served, **kw):
    _, _, jcfg, params = served
    return jserve.serve_loop(jcfg, params, **kw)


def _outcome(out):
    pages = out["pages"]
    return (out["completed"], out["rejected"], out["failed"],
            pages["allocs"] == pages["frees"],
            pages["free_pages"] == pages["total_pages"])


def test_serve_counts_live_tokens_only(served):
    out = _serve(served, batch=4, prompt_len=8, gen_len=6, n_requests=1)
    assert out["completed"] == 1
    assert out["decode_tokens"] <= 6
    assert out["decode_tokens"] < out["steps"] * 4
    assert out["prefill_tokens"] == 8
    assert out["pages"]["allocs"] == out["pages"]["frees"] == 1


def test_serve_admission_queues_on_page_pressure(served):
    kw = dict(batch=4, prompt_len=8, gen_len=6, n_requests=6, page_size=4,
              total_pages=PagePool(1, 4).pages_for(14))
    out = _serve(served, **kw)
    assert out["completed"] == 6 and out["failed"] == 0
    assert out["pages"]["high_water_pages"] == out["pages"]["total_pages"]
    assert _outcome(out) == _outcome(_ref(served, **kw))


def test_serve_rejects_oversized_requests(served):
    kw = dict(batch=2, prompt_len=8, gen_len=6, n_requests=3, page_size=4,
              total_pages=2)
    out = _serve(served, **kw)
    assert out["rejected"] == 3 and out["completed"] == 0
    assert out["pages"]["allocs"] == 0
    assert _outcome(out) == _outcome(_ref(served, **kw))


def test_serve_preempts_and_requeues_on_deadline(served):
    kw = dict(batch=1, prompt_len=4, gen_len=4, n_requests=1,
              deadline_steps=3, backoff_steps=2, max_retries=5)
    specs = [dict(point="serve.step", kind="raise", every=1, max_fires=8)]
    with faults.install(faults.FaultPlan(
            [faults.FaultSpec(**s) for s in specs])):
        out = _serve(served, **kw)
    assert out["step_faults"] >= 1
    assert out["preemptions"] >= 1 and out["requeues"] >= 1
    assert out["completed"] == 1 and out["failed"] == 0
    with jserve._faults.install(jserve._faults.FaultPlan(
            [jserve._faults.FaultSpec(**s) for s in specs])):
        want = _ref(served, **kw)
    assert _outcome(out) == _outcome(want)
    assert (out["preemptions"], out["requeues"], out["step_faults"]) == (
        want["preemptions"], want["requeues"], want["step_faults"])


def test_serve_fails_request_after_retry_budget(served):
    kw = dict(batch=1, prompt_len=4, gen_len=4, n_requests=1,
              deadline_steps=2, backoff_steps=1, max_retries=2)
    specs = [dict(point="serve.step", kind="raise", every=1,
                  max_fires=None)]
    with faults.install(faults.FaultPlan(
            [faults.FaultSpec(**s) for s in specs])):
        out = _serve(served, **kw)
    assert out["failed"] == 1 and out["completed"] == 0
    assert out["preemptions"] == 3          # initial try + 2 retries
    assert out["pages"]["allocs"] == out["pages"]["frees"] == 3
    with jserve._faults.install(jserve._faults.FaultPlan(
            [jserve._faults.FaultSpec(**s) for s in specs])):
        assert _outcome(out) == _outcome(_ref(served, **kw))


def test_serve_nan_guard_discards_poisoned_tick(served):
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.SERVE_STEP, kind=faults.NAN, every=3, max_fires=2)])
    with faults.install(plan):
        out = _serve(served, batch=2, prompt_len=4, gen_len=6, n_requests=2,
                     guards=True)
    assert out["nan_steps"] >= 1
    assert out["completed"] == 2


def test_discarded_tick_leaves_the_tokens_of_a_clean_run(served):
    """A discarded tick (the NaN guard's) emits nothing and changes no
    state the next tick reads: the tokens of the run match a clean run's,
    tick for tick, one tick later."""
    cfg, model, _, _ = served
    runs = {}
    for name, specs in (("clean", []), ("nan", [faults.FaultSpec(
            point=faults.SERVE_STEP, kind=faults.NAN, at_steps=(2,))])):
        got = []
        real = serve.S.make_serve_step

        def factory(cfg, real=real, got=got):
            step = real(cfg)

            def run(model, cache, tokens):
                nxt, logits, cache = step(model, cache, tokens)
                got.append(nxt.clone())
                return nxt, logits, cache
            return run

        serve.S.make_serve_step = factory
        try:
            with faults.install(faults.FaultPlan(specs)):
                runs[name] = (_serve(served, batch=2, prompt_len=4,
                                     gen_len=6, n_requests=2, guards=True),
                              got)
        finally:
            serve.S.make_serve_step = real
    (clean, ct), (nan, nt) = runs["clean"], runs["nan"]
    assert nan["nan_steps"] == 1 and nan["steps"] == clean["steps"] + 1
    assert len(nt) == len(ct) + 1
    assert all(torch.equal(a, b) for a, b in zip(nt[:2] + nt[3:], ct))


# The matrix scenarios the reference also runs here (its matrix compiles
# its serving steps anew for each, ~3 s a scenario): one admission, one
# allocator and one checksum scenario; its own test runs all seven.
REF_SCENARIOS = ("page-exhaustion", "alloc-fault", "sdc")


def test_fault_matrix_every_request_served_exactly_once(served, monkeypatch):
    cfg, model, jcfg, params = served
    kw = dict(batch=2, prompt_len=6, gen_len=5, n_requests=3)
    with facility.configure(facility.FacilityConfig(device="cpu")):
        results = serve.run_fault_matrix(cfg, model, **kw)
    assert len(results) == 7
    for r in results:
        assert r["ok"], (r["scenario"], r)
        assert r["completed"] == 3
    by_name = {r["scenario"]: r for r in results}
    for name in ("kernel-raise", "nan-poison", "latency-spike",
                 "step-crash", "alloc-fault"):
        assert by_name[name]["fired"] >= 1, name
    assert by_name["kernel-raise"]["demotions"] >= 1
    assert by_name["nan-poison"]["nan_steps"] >= 1
    assert by_name["step-crash"]["step_faults"] >= 1
    assert by_name["alloc-fault"]["requeues"] >= 1
    assert (by_name["page-exhaustion"]["pages"]["high_water_pages"]
            <= by_name["page-exhaustion"]["pages"]["total_pages"])
    sdc = by_name["sdc"]
    assert sdc["fired"] >= 1 and sdc["abft_detections"] >= 1
    assert sdc["completed"] == 3
    (v,) = [v for v in sdc["abft_verdicts"] if v["op_class"] == "gemm"]
    assert v["recovered"] and v["detail"]["sidecar"] is True
    real = jserve._matrix_scenarios
    monkeypatch.setattr(jserve, "_matrix_scenarios", lambda: tuple(
        sc for sc in real() if sc[0] in REF_SCENARIOS))
    want = jserve.run_fault_matrix(jcfg, params, **kw)
    assert [(r["scenario"], r["ok"]) + _outcome(r) for r in results
            if r["scenario"] in REF_SCENARIOS] == [
        (r["scenario"], r["ok"]) + _outcome(r) for r in want]


def test_serve_unrecovered_sdc_discards_tick_and_requeues(served):
    """A flip burst long enough to outlive retry and demotion inside one
    dispatch: the tick is discarded, its slots preempted with their pages
    reclaimed exactly once, and the requests finish on readmission."""
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.CONTRACT_DISPATCH, kind=faults.FLIP, every=1,
        max_fires=8)])
    with faults.install(plan):
        out = _serve(served, batch=2, prompt_len=4, gen_len=5, n_requests=2,
                     guards=True, abft=True, max_retries=4)
    assert out["abft_detections"] >= 1 and out["abft_discards"] >= 1
    assert out["requeues"] >= 1 or out["preemptions"] >= 1
    assert out["completed"] + out["failed"] == 2
    assert out["pages"]["allocs"] == out["pages"]["frees"]
    assert out["pages"]["free_pages"] == out["pages"]["total_pages"]
