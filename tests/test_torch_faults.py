"""The port's fault-injection registry (``repro_torch.runtime.faults``)
against the JAX reference's (``repro.runtime.faults``): the reference's
trigger, hook and applier cases on the port, and the parity that makes one
plan mean the same run in both packages — for the same specs and seed the
same ``FaultPlan.events`` (the seeded ``p=`` draws and the per-fire
``flip`` seeds included), and ``flip`` moves the same element by the same
delta, bit for bit (float32 and bfloat16; numpy inputs to both)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import faults as jfaults
from repro_torch.runtime import faults


def _plan(*specs, seed=0):
    return faults.FaultPlan(specs, seed=seed)


# ---------------------------------------------------------------------
# triggers (the reference's cases)
# ---------------------------------------------------------------------

def test_at_steps_fires_each_listed_step_once():
    p = _plan(faults.FaultSpec(point=faults.TRAIN_STEP, at_steps=(2, 5),
                               max_fires=None))
    fired = [s for s in range(8) if p.fire(faults.TRAIN_STEP, step=s)]
    assert fired == [2, 5]
    assert p.fire(faults.TRAIN_STEP, step=2) is None
    assert p.fire(faults.TRAIN_STEP, step=5) is None


def test_every_n_fires_on_nth_visits():
    p = _plan(faults.FaultSpec(point=faults.SERVE_STEP, every=3,
                               max_fires=None))
    assert [i for i in range(9) if p.fire(faults.SERVE_STEP)] == [2, 5, 8]


def test_probability_is_seeded_and_reproducible():
    def run(seed):
        p = _plan(faults.FaultSpec(point=faults.KV_ALLOC, p=0.5,
                                   max_fires=None), seed=seed)
        return [bool(p.fire(faults.KV_ALLOC)) for _ in range(32)]

    a, b = run(7), run(7)
    assert a == b
    assert any(a) and not all(a)


def test_max_fires_bounds_total():
    p = _plan(faults.FaultSpec(point=faults.SERVE_STEP, every=1,
                               max_fires=2))
    assert [bool(p.fire(faults.SERVE_STEP)) for _ in range(5)] == [
        True, True, False, False, False]
    assert len(p.events) == 2


def test_default_trigger_is_first_visit_only():
    p = _plan(faults.FaultSpec(point=faults.AUTOTUNE_LOAD))
    assert p.fire(faults.AUTOTUNE_LOAD) is not None
    assert p.fire(faults.AUTOTUNE_LOAD) is None


def test_specs_trigger_independently_and_first_match_wins():
    p = _plan(faults.FaultSpec(point=faults.SERVE_STEP, kind=faults.NAN,
                               every=2, max_fires=None),
              faults.FaultSpec(point=faults.SERVE_STEP, kind=faults.LATENCY,
                               every=3, max_fires=None))
    kinds = [f.kind if (f := p.fire(faults.SERVE_STEP)) else None
             for _ in range(6)]
    assert kinds == [None, faults.NAN, faults.LATENCY, faults.NAN,
                     None, faults.NAN]


def test_spec_validation():
    with pytest.raises(ValueError):
        faults.FaultSpec(point="not.a.point")
    with pytest.raises(ValueError):
        faults.FaultSpec(point=faults.SERVE_STEP, kind="explode")
    with pytest.raises(ValueError):
        faults.FaultSpec(point=faults.SERVE_STEP, p=1.5)


def test_points_and_kinds_are_the_reference_s():
    assert faults.POINTS == jfaults.POINTS
    assert faults.KINDS == jfaults.KINDS


# ---------------------------------------------------------------------
# ambient plan + hooks
# ---------------------------------------------------------------------

def test_no_plan_hooks_are_noops():
    assert faults.active() is None
    assert faults.fire(faults.SERVE_STEP) is None
    assert faults.maybe_inject(faults.SERVE_STEP) is None


def test_install_scopes_and_restores():
    p = _plan(faults.FaultSpec(point=faults.SERVE_STEP))
    with faults.install(p):
        assert faults.active() is p
        assert faults.fire(faults.SERVE_STEP) is not None
    assert faults.active() is None
    assert p.fired(faults.SERVE_STEP)


def test_maybe_inject_raises_for_raise_kind():
    p = _plan(faults.FaultSpec(point=faults.KV_ALLOC, kind=faults.RAISE))
    with faults.install(p):
        with pytest.raises(faults.InjectedFault):
            faults.maybe_inject(faults.KV_ALLOC)


def test_maybe_inject_returns_data_kinds_for_caller():
    p = _plan(faults.FaultSpec(point=faults.SERVE_STEP, kind=faults.NAN))
    with faults.install(p):
        f = faults.maybe_inject(faults.SERVE_STEP)
    assert f is not None and f.kind == faults.NAN


# ---------------------------------------------------------------------
# appliers
# ---------------------------------------------------------------------

def test_poison_floats_passes_ints():
    x = torch.ones((2, 3))
    assert bool(torch.isnan(faults.poison(x)).all())
    i = torch.ones((2,), dtype=torch.int32)
    assert faults.poison(i) is i


def test_tear_truncates_file(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(b"x" * 100)
    assert faults.tear(f)
    assert f.stat().st_size == 50
    assert not faults.tear(tmp_path / "missing.bin")


def test_events_record_point_kind_step():
    p = _plan(faults.FaultSpec(point=faults.TRAIN_STEP, at_steps=(3,)))
    p.fire(faults.TRAIN_STEP, step=3)
    (ev,) = p.events
    assert (ev.point, ev.kind, ev.step) == (faults.TRAIN_STEP,
                                            faults.RAISE, 3)
    assert np.isfinite(ev.latency_s)


def test_flip_fires_once_with_seed_and_stays_finite():
    p = _plan(faults.FaultSpec(point=faults.CONTRACT_DISPATCH,
                               kind=faults.FLIP))
    f = p.fire(faults.CONTRACT_DISPATCH)
    assert f is not None and f.kind == faults.FLIP and f.seed is not None
    assert p.fire(faults.CONTRACT_DISPATCH) is None
    x = torch.linspace(-1.0, 1.0, 24).reshape(4, 6)
    y = faults.flip(x, f.seed)
    assert bool(torch.isfinite(y).all())
    assert int(((y - x).abs() > 0).sum()) == 1
    assert torch.equal(x, torch.linspace(-1.0, 1.0, 24).reshape(4, 6))


def test_flip_is_seeded_reproducible():
    x = torch.ones((3, 5), dtype=torch.bfloat16)
    a, b = faults.flip(x, 1234), faults.flip(x, 1234)
    assert torch.equal(a, b)
    assert not torch.equal(a, faults.flip(x, 1235))
    mk = lambda: _plan(faults.FaultSpec(point=faults.CONTRACT_DISPATCH,  # noqa: E731
                                        kind=faults.FLIP), seed=7)
    assert mk().fire(faults.CONTRACT_DISPATCH).seed == \
        mk().fire(faults.CONTRACT_DISPATCH).seed


def test_flip_passes_non_inexact_and_empty():
    i = torch.ones((4,), dtype=torch.int32)
    assert faults.flip(i, 0) is i
    e = torch.zeros((0, 3))
    assert faults.flip(e, 0) is e


# ---------------------------------------------------------------------
# parity with the reference: the same plan, the same run
# ---------------------------------------------------------------------

def _spec_sets():
    """Plans over every trigger: (specs as FaultSpec keyword dicts, seed,
    the visits as (point, step) pairs)."""
    visits = ([(jfaults.SERVE_STEP, s) for s in range(12)]
              + [(jfaults.CONTRACT_DISPATCH, None)] * 10
              + [(jfaults.KV_ALLOC, None)] * 16
              + [(jfaults.TRAIN_STEP, s) for s in (0, 3, 3, 5, 7)])
    return [
        ([dict(point="serve.step", kind="nan", every=2, max_fires=3),
          dict(point="serve.step", kind="latency", every=3, max_fires=None,
               latency_s=0.0)], 0, visits),
        ([dict(point="kv.alloc", kind="raise", p=0.4, max_fires=None),
          dict(point="contract.dispatch", kind="flip", every=1,
               max_fires=4)], 3, visits),
        ([dict(point="contract.dispatch", kind="flip", p=0.5,
               max_fires=None),
          dict(point="kv.alloc", kind="flip", p=0.3, max_fires=5),
          dict(point="train.step", kind="raise", at_steps=(3, 7))], 11,
         visits),
        ([dict(point="contract.dispatch", kind="raise", max_fires=2),
          dict(point="serve.step", kind="torn", at_steps=(1, 4, 9))], 5,
         visits),
    ]


@pytest.mark.parametrize("case", range(4))
def test_events_equal_the_reference_s(case):
    """For the same specs and seed, the port's plan fires the same events,
    in the same order, with the same per-fire flip seeds."""
    specs, seed, visits = _spec_sets()[case]
    tp = faults.FaultPlan([faults.FaultSpec(**s) for s in specs], seed=seed)
    jp = jfaults.FaultPlan([jfaults.FaultSpec(**s) for s in specs],
                           seed=seed)
    for point, step in visits:
        tf, jf = tp.fire(point, step), jp.fire(point, step)
        assert (tf is None) == (jf is None)
    assert len(tp.events) == len(jp.events) > 0
    for t, j in zip(tp.events, jp.events):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 - 1])
def test_flip_moves_the_reference_s_element_by_its_delta(dtype, seed):
    """The same seed flips the same element by the same delta, bit for bit
    (the delta ``(1 + max|x|) * 8`` rounds in x's dtype in both)."""
    x = np.random.default_rng(seed % 97).standard_normal((7, 13)).astype(
        np.float32)
    x[2, 3] = np.inf          # a non-finite max counts as 0 in both
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = faults.flip(tx, seed).float().numpy()
    want = np.asarray(jfaults.flip(jx, seed).astype(jnp.float32))
    assert np.array_equal(got, want, equal_nan=True)
    moved = np.argwhere(got != tx.float().numpy())
    assert moved.shape[0] == 1
