"""The port's elastic trainer (``runtime/elastic.py``) on the CPU.

  * The reference's eight ``test_substrate.py`` elastic cases, mirrored on
    the port with mamba2-130m ``reduced()``, batch 2, seq 32, AdamW at a
    constant 1e-3 (the reference's ``_mini_trainer``).
  * Trainer parity: the reference's ``ElasticTrainer`` and the port's over
    the same float32 toy step (a jnp step and a torch step; the reference's
    model step needs a bf16 dot that jax's CPU backend lacks) under the same
    fault plan give the same metrics log, restarts, stragglers, fault
    events, ``latest_step()`` and number of ``wait()`` calls.  The toy
    step's values are multiples of 2^-13 below 8, so both frameworks
    compute them exactly and the logs are compared bit for bit.
  * Model parity: mamba2-130m reduced in the F32 config of
    ``tests/test_torch_train.py`` (``ger=F32GER, out_dtype=float32``, the
    reference under ``eager_layers()``) through both trainers with a failure
    at step 3: each step's loss within 1e-4 relative of the reference's
    (``test_train_step_matches_reference``'s bound).
  * The port's own rules: only ``InjectedFault`` restarts; the failed
    attempt's state is garbage before ``make_state()`` runs again; the
    ``batches`` iterator is closed on restart; ``state_shardings`` raises.
"""

from __future__ import annotations

import contextlib
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get as jget
from repro.configs.base import reduced as jreduced
from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro.runtime import elastic as JE
from repro.runtime import faults as jfaults
from repro.train import steps as JST
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.data import pipeline as tpipe
from repro_torch.models import convert
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedule as TSch
from repro_torch.runtime import faults
from repro_torch.runtime.elastic import (ElasticConfig, ElasticTrainer,
                                         SimulatedFailure, StragglerDetected)
from repro_torch.train import steps as TST

CPU = tfac.FacilityConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The watchdog reads wall-clock step times: one intra-op thread keeps
    a reduced step at ~30 ms beside other test workers, where a pool of
    threads a worker oversubscribes the cores and stretches it by 10x or
    more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini_trainer(tmp_path, fail_at=(), raise_on_straggler=False, *,
                  make_state=None, batches=None, plan=None):
    """The reference's ``_mini_trainer`` on the port: the batches come from
    a ``Prefetcher`` on the CPU."""
    cfg = treduced(tget("mamba2-130m"))
    opt_cfg = TA.AdamWConfig(lr=1e-3)
    step = TST.make_train_step(cfg, opt_cfg)

    def run_step(state, batch):
        with tfac.configure(CPU):
            return step(state, batch)

    def init():
        return TST.init_train_state(cfg, 0, opt_cfg, device="cpu")

    def prefetch(start):
        return tpipe.Prefetcher(cfg, batch=2, seq=32, device="cpu",
                                start_step=start)

    return ElasticTrainer(
        make_step=lambda: run_step,
        make_state=init if make_state is None else make_state(init),
        batches=prefetch if batches is None else batches(prefetch),
        checkpointer=Checkpointer(str(tmp_path)),
        cfg=ElasticConfig(ckpt_every=4, fail_at_steps=tuple(fail_at),
                          raise_on_straggler=raise_on_straggler),
        faults=plan)


def _equal_states(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), p


# ----------------------------------------------------------------------
# The reference's cases (tests/test_substrate.py), mirrored
# ----------------------------------------------------------------------

def test_elastic_completes_without_failures(tmp_path):
    out = _mini_trainer(tmp_path).run(6)
    assert len(out["metrics"]) == 6
    assert out["restarts"] == 0


def test_elastic_survives_injected_failure(tmp_path):
    tr = _mini_trainer(tmp_path, fail_at=(5,))
    out = tr.run(10)
    assert out["restarts"] == 1
    # steps 4..9 ran; restart resumed from ckpt at 4, not from 0
    steps_seen = [m["step"] for m in out["metrics"]]
    assert steps_seen.count(4) == 2
    assert steps_seen.count(0) == 1
    assert max(steps_seen) == 9
    assert [f.step for f in tr.faults.fired(faults.TRAIN_STEP)] == [5]


def test_elastic_gives_up_after_max_restarts(tmp_path):
    tr = _mini_trainer(tmp_path, fail_at=(1, 2, 3, 4, 5, 6, 7, 8, 9))
    tr.cfg = ElasticConfig(ckpt_every=100, max_restarts=2,
                           fail_at_steps=(1, 2, 3, 4, 5, 6, 7, 8, 9))
    with pytest.raises(SimulatedFailure):
        tr.run(10)
    assert tr.restarts == 3


def test_elastic_restart_is_deterministic(tmp_path):
    """Loss sequence with a mid-run failure == loss sequence without: on
    the port bit for bit, the final state too (the reference's bound is
    1e-4)."""
    out_fail = _mini_trainer(tmp_path / "a", fail_at=(5,)).run(8)
    out_clean = _mini_trainer(tmp_path / "b").run(8)
    by_step_fail = {m["step"]: m["loss"] for m in out_fail["metrics"]}
    by_step_clean = {m["step"]: m["loss"] for m in out_clean["metrics"]}
    assert sorted(by_step_fail) == list(range(8))
    for s in range(8):
        assert by_step_fail[s] == by_step_clean[s], s
    _equal_states(out_fail["state"], out_clean["state"])


def test_elastic_waits_for_async_ckpt_on_failure_path(tmp_path):
    """The restart path joins the in-flight async save before restoring,
    or restore could read a half-written step."""
    tr = _mini_trainer(tmp_path, fail_at=(5,))
    waits = []
    orig_wait = tr.ckpt.wait
    tr.ckpt.wait = lambda: (waits.append(True), orig_wait())[1]
    out = tr.run(10)
    assert out["restarts"] == 1
    # one wait on the failure path (before restore), one at clean finish
    assert len(waits) >= 2


def test_elastic_faultplan_latency_triggers_watchdog(tmp_path):
    """A latency-kind train.step fault is an injected straggler: the
    wall-clock watchdog flags it (no restart: the step is slow, not
    dead)."""
    tr = _mini_trainer(tmp_path)
    tr.cfg = ElasticConfig(ckpt_every=100, straggler_factor=3.0,
                           straggler_patience=1)
    tr.faults.add(faults.FaultSpec(
        point=faults.TRAIN_STEP, kind=faults.LATENCY, at_steps=(6,),
        latency_s=2.0))
    out = tr.run(8)
    assert out["restarts"] == 0
    assert 6 in out["stragglers"]


def test_elastic_survives_checkpoint_save_fault(tmp_path):
    """A crash during checkpoint save is another InjectedFault: the restart
    loop absorbs it, and the atomic rename hides the torn save, so
    training resumes from the last complete step."""
    tr = _mini_trainer(tmp_path)
    tr.faults.add(faults.FaultSpec(
        point=faults.CHECKPOINT_SAVE, kind=faults.RAISE, at_steps=(10,)))
    out = tr.run(10)         # final sync save at step 10 crashes once
    assert out["restarts"] == 1
    assert tr.ckpt.latest_step() == 10
    steps_seen = [m["step"] for m in out["metrics"]]
    assert steps_seen.count(8) == 2          # resumed from 8, not 0


def test_elastic_trainers_do_not_share_config():
    """The old `cfg: ElasticConfig = ElasticConfig()` default was
    evaluated once and aliased across every trainer."""
    mk = dict(make_step=lambda: None, make_state=lambda: None,
              batches=lambda start: iter(()),
              checkpointer=Checkpointer.__new__(Checkpointer))
    a, b = ElasticTrainer(**mk), ElasticTrainer(**mk)
    assert a.cfg is not b.cfg
    assert a.faults is not b.faults
    a.cfg.max_restarts = 99
    assert b.cfg.max_restarts != 99


# ----------------------------------------------------------------------
# Trainer parity with the reference's ElasticTrainer
# ----------------------------------------------------------------------

TOY_SLEEP = 0.1          # each toy step's time: 4 x 0.1 s to flag


def _toy_batch(step):
    # multiples of 1/8 in [-2, 2): every value the step makes is exact
    x = np.random.default_rng(step).integers(-16, 16, 4) / 8
    return x.astype(np.float32)


def _plan_specs(mod):
    return [mod.FaultSpec(point=mod.TRAIN_STEP, kind=mod.RAISE,
                          at_steps=(5,)),
            mod.FaultSpec(point=mod.TRAIN_STEP, kind=mod.LATENCY,
                          at_steps=(9,), latency_s=1.0),
            mod.FaultSpec(point=mod.CHECKPOINT_SAVE, kind=mod.RAISE,
                          at_steps=(10,))]


def _ref_toy(path):
    def step(state, x):
        time.sleep(TOY_SLEEP)
        d = state["w"] - x
        return ({"w": state["w"] - 0.5 * d, "n": state["n"] + 1},
                {"loss": jnp.mean(jnp.abs(d))})

    return JE.ElasticTrainer(
        make_step=lambda: step,
        make_state=lambda: {"w": jnp.zeros(4, jnp.float32),
                            "n": jnp.asarray(0, jnp.int32)},
        batches=lambda start: ((s, jnp.asarray(_toy_batch(s)))
                               for s in range(start, 10 ** 6)),
        checkpointer=JCheckpointer(str(path)),
        cfg=JE.ElasticConfig(ckpt_every=4, straggler_factor=4.0,
                             straggler_patience=1),
        faults=jfaults.FaultPlan(_plan_specs(jfaults)))


def _port_toy(path):
    def step(state, x):
        time.sleep(TOY_SLEEP)
        d = state["w"] - x
        state["w"] = state["w"] - 0.5 * d
        state["n"] = state["n"] + 1
        return state, {"loss": torch.mean(torch.abs(d))}

    return ElasticTrainer(
        make_step=lambda: step,
        make_state=lambda: {"w": torch.zeros(4),
                            "n": torch.tensor(0, dtype=torch.int32)},
        batches=lambda start: ((s, torch.from_numpy(_toy_batch(s)))
                               for s in range(start, 10 ** 6)),
        checkpointer=Checkpointer(str(path)),
        cfg=ElasticConfig(ckpt_every=4, straggler_factor=4.0,
                          straggler_patience=1),
        faults=faults.FaultPlan(_plan_specs(faults)))


class _CountWaits:
    """A checkpointer seen through the trainer: counts the trainer's own
    ``wait()`` calls (the port's ``save`` also joins its writer, the
    reference's does not)."""

    def __init__(self, ckpt):
        self.ckpt, self.waits = ckpt, 0

    def wait(self):
        self.waits += 1
        return self.ckpt.wait()

    def __getattr__(self, name):
        return getattr(self.ckpt, name)


def test_port_trainer_matches_reference_trainer(tmp_path):
    outs = []
    for name, make in (("ref", _ref_toy), ("port", _port_toy)):
        tr = make(tmp_path / name)
        tr.ckpt = _CountWaits(tr.ckpt)
        out = tr.run(10)
        outs.append(dict(
            metrics=out["metrics"], restarts=out["restarts"],
            stragglers=out["stragglers"], latest=tr.ckpt.latest_step(),
            waits=tr.ckpt.waits, w=np.asarray(out["state"]["w"]),
            n=int(out["state"]["n"]),
            events=[(f.point, f.kind, f.step) for f in tr.faults.events]))
    ref, port = outs
    assert [m["step"] for m in port["metrics"]] == (
        [0, 1, 2, 3, 4] + [4, 5, 6, 7, 8, 9] + [8, 9])
    assert port["restarts"] == 2 and port["stragglers"] == [9]
    assert port["latest"] == 10 and port["n"] == 10 and port["waits"] == 4
    for key in ref:
        if key == "w":
            assert np.array_equal(ref["w"], port["w"])
        else:
            assert ref[key] == port[key], key


# ----------------------------------------------------------------------
# Model parity: mamba2-130m reduced, F32 config, both trainers
# ----------------------------------------------------------------------

def test_mamba2_losses_match_reference_through_a_restart(tmp_path):
    steps, fail_at = 6, 3
    jcfg, tcfg = jreduced(jget("mamba2-130m")), treduced(tget("mamba2-130m"))
    jopt = JA.AdamWConfig(lr=JS.warmup_cosine(3e-4, 1, steps),
                          weight_decay=0.1)
    topt = TA.AdamWConfig(lr=TSch.warmup_cosine(3e-4, 1, steps),
                          weight_decay=0.1)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(0)))
    ecfg = dict(ckpt_every=2, fail_at_steps=(fail_at,))

    def host(cfg, s):
        return jpipe.synthetic_batch(cfg, batch=2, seq=32, step=s)

    jstep = jax.jit(JST.make_train_step(jcfg, jopt))
    jtr = JE.ElasticTrainer(
        make_step=lambda: jstep,
        make_state=lambda: JST.init_train_state(jcfg, jax.random.key(0),
                                                jopt),
        batches=lambda start: (
            (s, {k: jnp.asarray(v) for k, v in host(jcfg, s).items()})
            for s in range(start, 10 ** 6)),
        checkpointer=JCheckpointer(str(tmp_path / "ref")),
        cfg=JE.ElasticConfig(**ecfg))
    with contextlib.ExitStack() as stack:
        stack.enter_context(jfac.configure(jfac.FacilityConfig(
            ger=jprec.Ger.F32GER, out_dtype=jnp.float32)))
        stack.enter_context(JM.eager_layers())
        jout = jtr.run(steps)

    tstep = TST.make_train_step(tcfg, topt)
    f32 = tfac.FacilityConfig(device="cpu", ger=tprec.Ger.F32GER,
                              out_dtype=torch.float32)

    def run_step(state, batch):
        with tfac.configure(f32):
            return tstep(state, batch)

    ttr = ElasticTrainer(
        make_step=lambda: run_step,
        make_state=lambda: TST.train_state_from(
            convert.params_from_numpy(params, tcfg, device="cpu"), topt),
        batches=lambda start: tpipe.Prefetcher(
            tcfg, batch=2, seq=32, device="cpu", start_step=start),
        checkpointer=Checkpointer(str(tmp_path / "port")),
        cfg=ElasticConfig(**ecfg))
    tout = ttr.run(steps)

    want = [0, 1, 2, 2, 3, 4, 5]
    assert [m["step"] for m in jout["metrics"]] == want
    assert [m["step"] for m in tout["metrics"]] == want
    assert jout["restarts"] == tout["restarts"] == 1
    for got, ref in zip(tout["metrics"], jout["metrics"]):
        assert abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"]), (
            tout["metrics"], jout["metrics"])
    # the restored step counter brings back the schedule's position
    assert int(tout["state"]["opt"]["step"]) == steps


# ----------------------------------------------------------------------
# The port's own rules
# ----------------------------------------------------------------------

def test_a_kernel_error_propagates_without_a_restart(tmp_path):
    """Only InjectedFault restarts the run: a RuntimeError from the step
    (a kernel's failed launch) propagates on its first raise, and the
    attempt's batch iterator is closed."""
    made = []

    def batches(prefetch):
        def make(start):
            made.append(prefetch(start))
            return made[-1]
        return make

    tr = _mini_trainer(tmp_path, batches=batches)
    real = tr.make_step()

    def step(state, batch):
        if int(state["opt"]["step"]) == 2:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(state, batch)

    tr.make_step = lambda: step
    with pytest.raises(RuntimeError, match="illegal") as err:
        tr.run(6)
    assert not isinstance(err.value, faults.InjectedFault)
    assert tr.restarts == 0
    assert len(made) == 1 and not made[0]._t.is_alive()


@pytest.mark.parametrize("point,step", [(faults.TRAIN_STEP, 5),
                                        (faults.CHECKPOINT_SAVE, 10)])
def test_failed_attempts_state_is_garbage_before_make_state(tmp_path, point,
                                                            step):
    """The optimizer updates the state in place, so a restart builds a
    fresh ``make_state()``; the failed attempt's state (its module and
    its tensors) must be gone before that, or the card holds two."""
    refs, dead = [], []

    def make_state(init):
        def make():
            dead.append([r() is None for r in refs])
            state = init()
            refs.extend([weakref.ref(state["params"]),
                         weakref.ref(next(state["params"].parameters())),
                         weakref.ref(state["opt"]["m"][
                             next(iter(state["opt"]["m"]))])])
            return state
        return make

    plan = faults.FaultPlan([faults.FaultSpec(point=point, at_steps=(step,))])
    out = _mini_trainer(tmp_path, make_state=make_state, plan=plan).run(10)
    assert out["restarts"] == 1
    assert dead == [[], [True, True, True]]


def test_batches_iterator_is_closed_on_restart(tmp_path):
    """Each ``batches(start)`` is a Prefetcher with a thread: the failed
    attempt's is closed (its thread joined) before the next is made, and
    the last is closed when the run ends."""
    made, open_at_make = [], []

    def batches(prefetch):
        def make(start):
            open_at_make.append([pf._t.is_alive() for pf in made])
            made.append(prefetch(start))
            return made[-1]
        return make

    tr = _mini_trainer(tmp_path, fail_at=(5,), batches=batches)
    tr.faults.add(faults.FaultSpec(point=faults.CHECKPOINT_SAVE,
                                   at_steps=(10,)))
    out = tr.run(10)
    assert out["restarts"] == 2
    assert open_at_make == [[], [False], [False, False]]
    assert not any(pf._t.is_alive() for pf in made)


def test_state_shardings_are_refused_until_the_mesh():
    mk = dict(make_step=lambda: None, make_state=lambda: None,
              batches=lambda start: iter(()),
              checkpointer=Checkpointer.__new__(Checkpointer))
    assert ElasticTrainer(**mk, state_shardings=None).state_shardings is None
    with pytest.raises(NotImplementedError, match="mesh"):
        ElasticTrainer(**mk, state_shardings={"params": "replicated"})


def test_straggler_raises_when_asked(tmp_path):
    tr = _mini_trainer(tmp_path, raise_on_straggler=True)
    # patience 1 at a factor far above a loaded worker's jitter: only the
    # injected 2 s step trips it
    tr.cfg.straggler_patience, tr.cfg.straggler_factor = 1, 10.0
    tr.faults.add(faults.FaultSpec(
        point=faults.TRAIN_STEP, kind=faults.LATENCY, at_steps=(5,),
        latency_s=2.0))
    with pytest.raises(StragglerDetected) as err:
        tr.run(8)
    assert err.value.step == 5 and tr.straggler_events == [5]
