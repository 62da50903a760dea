"""Facility-wide fault-injection registry (port of ``repro.runtime.faults``).

ONE registry every layer shares: a :class:`FaultPlan` holds
:class:`FaultSpec` entries — *named injection points* with configurable
*triggers* and *fault kinds* — and call sites consult the ambient plan
through :func:`fire` / :func:`maybe_inject`.  With no plan installed every
hook is a single contextvar read returning ``None``, so production paths
pay nothing and stay bit for bit what they were
(``tests/test_torch_guards.py``).

Injection points (the facility's fault surface)::

    contract.dispatch   core/lowering.execute — kernel build/launch/poison
    kv.alloc            runtime/kv_pages.PagePool.alloc — transient alloc
    serve.step          launch/serve — one decode step of the serving loop
    autotune.load       core/autotune.AutotuneCache._load — cache reads
    autotune.save       core/autotune.AutotuneCache.put_raw — torn writes
    checkpoint.save     checkpoint.Checkpointer._write — crash mid-save
    train.step          runtime/elastic.ElasticTrainer — node death
    collective          the mesh's comm edges (not ported yet)

All eight points are defined, so a plan written for the reference is a
valid plan here; the port consults the seven that have a call site in it
(``contract.dispatch``, ``kv.alloc``, ``serve.step``, ``autotune.load``,
``autotune.save``, ``checkpoint.save``, ``train.step``); ``collective``
waits for the mesh (ROADMAP queue 1, E1).

Triggers (first matching rule of a spec wins):

  * ``at_steps=(s, ...)`` — fire when the call site's ``step`` is listed;
    each listed step fires at most once ("a node dies once").
  * ``every=N`` — fire on every Nth *visit* to the point (the visit counter
    is per spec, so two specs on one point trigger independently).
  * ``p=q`` — fire with probability ``q`` per visit, from the plan's
    seeded ``np.random.default_rng(seed)``, as the reference draws it: one
    plan fires the same events in both packages.
  * none of the above — fire on the first visit.

``max_fires`` bounds the total (default 1: a fault is an *event*, not a
permanent property; ``max_fires=None`` for a persistently broken
component).

Fault kinds and who applies them:

  * ``raise`` — :func:`maybe_inject` raises :class:`InjectedFault` at the
    call site (a crashed kernel / dead node / failed syscall).
  * ``nan`` — the call site poisons its float output with :func:`poison`.
  * ``latency`` — :func:`maybe_inject` sleeps ``latency_s``.
  * ``torn`` — the call site truncates its in-flight write with
    :func:`tear`.
  * ``flip`` — the call site perturbs ONE seeded element of its float
    output with :func:`flip` (silent data corruption that stays finite, so
    only checksum verification, core/abft.py, can see it).  The index and
    delta come from the per-fire seed the plan draws (``Fault.seed``) by
    the reference's rule, so the same plan flips the same element by the
    same delta in both packages.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import time

import numpy as np
import torch

# ---- injection points -------------------------------------------------

CONTRACT_DISPATCH = "contract.dispatch"
KV_ALLOC = "kv.alloc"
SERVE_STEP = "serve.step"
AUTOTUNE_LOAD = "autotune.load"
AUTOTUNE_SAVE = "autotune.save"
CHECKPOINT_SAVE = "checkpoint.save"
TRAIN_STEP = "train.step"
COLLECTIVE = "collective"

POINTS = (CONTRACT_DISPATCH, KV_ALLOC, SERVE_STEP, AUTOTUNE_LOAD,
          AUTOTUNE_SAVE, CHECKPOINT_SAVE, TRAIN_STEP, COLLECTIVE)

# ---- fault kinds ------------------------------------------------------

RAISE = "raise"
NAN = "nan"
LATENCY = "latency"
TORN = "torn"
FLIP = "flip"

KINDS = (RAISE, NAN, LATENCY, TORN, FLIP)


class InjectedFault(RuntimeError):
    """Raised at a call site for ``raise``-kind faults.  Layers treat it
    exactly like the real failure it stands in for (demote, requeue); it
    must never escape a fault-tolerant loop."""


@dataclasses.dataclass
class FaultSpec:
    """One injection rule: where, what, and when."""

    point: str
    kind: str = RAISE
    at_steps: tuple[int, ...] = ()
    every: int = 0
    p: float = 0.0
    max_fires: int | None = 1
    latency_s: float = 0.05

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; have {POINTS}")
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {KINDS}")
        if self.every < 0 or not (0.0 <= self.p <= 1.0):
            raise ValueError(f"bad trigger: every={self.every} p={self.p}")


@dataclasses.dataclass(frozen=True)
class Fault:
    """What :func:`fire` hands back to the call site when a spec triggers."""

    point: str
    kind: str
    step: int | None
    latency_s: float
    # ``flip`` kinds only: the per-fire seed for :func:`flip`.
    seed: int | None = None


class FaultPlan:
    """A seeded schedule of FaultSpecs plus the record of what fired:
    build one, ``install`` it (context manager), then assert on
    :attr:`events` afterwards."""

    def __init__(self, specs=(), seed: int = 0):
        self.specs: list[FaultSpec] = []
        self._rng = np.random.default_rng(seed)
        self._visits: list[int] = []
        self._fires: list[int] = []
        self._fired_steps: list[set] = []
        self.events: list[Fault] = []
        for s in specs:
            self.add(s)

    def add(self, spec: FaultSpec) -> "FaultPlan":
        self.specs.append(spec)
        self._visits.append(0)
        self._fires.append(0)
        self._fired_steps.append(set())
        return self

    def _triggers(self, i: int, spec: FaultSpec, step: int | None) -> bool:
        if spec.max_fires is not None and self._fires[i] >= spec.max_fires:
            return False
        if spec.at_steps:
            if step is None or step not in spec.at_steps \
                    or step in self._fired_steps[i]:
                return False
            self._fired_steps[i].add(step)
            return True
        if spec.every:
            return self._visits[i] % spec.every == 0
        if spec.p:
            return bool(self._rng.random() < spec.p)
        return self._fires[i] == 0       # no trigger: first visit

    def fire(self, point: str, step: int | None = None) -> Fault | None:
        """Consult the plan at one injection point.  Returns the first
        triggering spec's :class:`Fault` (recording it), else None.  Every
        spec on the point sees the visit."""
        idxs = [i for i, s in enumerate(self.specs) if s.point == point]
        for i in idxs:
            self._visits[i] += 1
        for i in idxs:
            if self._triggers(i, self.specs[i], step):
                self._fires[i] += 1
                seed = (int(self._rng.integers(2 ** 31))
                        if self.specs[i].kind == FLIP else None)
                fault = Fault(point=point, kind=self.specs[i].kind,
                              step=step, latency_s=self.specs[i].latency_s,
                              seed=seed)
                self.events.append(fault)
                return fault
        return None

    def fired(self, point: str | None = None) -> list[Fault]:
        if point is None:
            return list(self.events)
        return [f for f in self.events if f.point == point]


# ---- the ambient plan -------------------------------------------------

_ACTIVE: contextvars.ContextVar[FaultPlan | None] = contextvars.ContextVar(
    "repro_torch_fault_plan", default=None)


def active() -> FaultPlan | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def install(plan: FaultPlan):
    """Make ``plan`` the ambient plan for every hook inside the block."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def fire(point: str, step: int | None = None) -> Fault | None:
    """The raw hook: consult the ambient plan; None when none installed."""
    plan = _ACTIVE.get()
    if plan is None:
        return None
    return plan.fire(point, step)


def maybe_inject(point: str, step: int | None = None) -> Fault | None:
    """The common hook: raises for ``raise`` kinds, sleeps for ``latency``
    kinds, and returns the fault (or None) so the caller can apply the
    data-shaped kinds (``nan``/``torn``/``flip``) itself."""
    fault = fire(point, step)
    if fault is None:
        return None
    if fault.kind == RAISE:
        raise InjectedFault(f"injected fault at {point}"
                            + (f" (step {step})" if step is not None else ""))
    if fault.kind == LATENCY:
        time.sleep(fault.latency_s)
    return fault


# ---- fault appliers ---------------------------------------------------

def poison(x: torch.Tensor) -> torch.Tensor:
    """NaN-poison a float tensor.  Non-float tensors pass through
    unchanged — there is no NaN to plant."""
    if not (x.is_floating_point() or x.is_complex()):
        return x
    return torch.full_like(x, float("nan"))


def flip(x: torch.Tensor, seed: int) -> torch.Tensor:
    """A copy of ``x`` with ONE seeded element moved by a finite delta that
    dominates every magnitude in it, ``(1 + max|x|) * 8`` in x's dtype (a
    non-finite max counts as 0): silent data corruption that stays finite.
    The index is ``np.random.default_rng(seed).integers(x.numel())``, the
    reference's draw, so the same seed corrupts the same element by the
    same delta in both packages.  Non-float and empty tensors pass through
    unchanged."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    idx = int(np.random.default_rng(seed).integers(x.numel()))
    flat = x.reshape(-1).clone()
    mag = flat.abs().max()
    mag = torch.where(torch.isfinite(mag), mag, torch.zeros_like(mag))
    delta = ((1.0 + mag) * 8.0).to(x.dtype)
    flat[idx] += delta
    return flat.reshape(x.shape)


def tear(path) -> bool:
    """Truncate ``path`` to half its bytes — a torn (crash-interrupted)
    write.  Returns True when the file existed and was torn."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    return True
