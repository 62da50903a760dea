"""Elastic / fault-tolerant training loop (port of
``repro.runtime.elastic``).

The contract, as the reference's:

  * **Checkpoint/restart**: async checkpoints every ``ckpt_every`` steps;
    on an injected failure the trainer restores the latest complete step
    into a fresh ``make_state()``.  The batches are step-addressable
    (``data.pipeline.Prefetcher(start_step=...)``), so a restart resumes
    the exact batch sequence.
  * **Straggler mitigation**: a per-step wall-clock watchdog.  Once 4
    steps are timed, a step slower than ``straggler_factor`` x the median
    of the trailing ``straggler_window`` counts as slow; after
    ``straggler_patience`` slow steps in a row the step is recorded as a
    straggler, and ``raise_on_straggler`` raises :class:`StragglerDetected`.
  * **Failure injection**: the facility-wide registry
    (``runtime/faults.py``).  Pass a :class:`~repro_torch.runtime.faults.
    FaultPlan` as ``faults=``, or use the legacy ``cfg.fail_at_steps``
    shorthand, which becomes ``train.step`` at-step specs on the same plan.
    The plan is ambient for the whole run, so ``checkpoint.save`` fires
    against it too; the async writer runs on a fresh thread with no
    ambient plan, so save faults hit the sync save.  ``raise`` kinds at
    ``train.step`` become :class:`SimulatedFailure`, ``latency`` kinds
    sleep inside the timed window.

Where the port differs:

  * The train step reads nothing back to the host (the AdamW step counter
    is a device tensor), so the timed window ends on the loss read to the
    host, as the reference's ends on ``jax.block_until_ready``.
  * Only :class:`~repro_torch.runtime.faults.InjectedFault` restarts the
    run.  A kernel's ``RuntimeError`` (or ``torch.AcceleratorError``)
    propagates on its first raise.
  * A restart drops the failed attempt's state and step function before
    ``make_state()`` runs again (the optimizer updates the state in place,
    and two states at once would double the card's peak memory), and the
    iterator from ``batches(start)`` is closed on every way out of an
    attempt (a ``Prefetcher`` runs a thread).
  * ``state_shardings`` (``launch.train.build(mesh=...)``'s third value,
    a tree of ``parallel.api.Sharding``): a restart restores the latest
    step onto them, into the fresh ``make_state()`` built on the mesh (the
    port's restore writes in place).  Every rank runs the trainer; the
    ``collective`` fault point fires on every rank at the same dispatch,
    so all restart together, and the checkpointer's ``wait()`` barrier
    gives them the same latest step.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Iterable

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.runtime import faults as _faults


class SimulatedFailure(_faults.InjectedFault):
    """A mid-step node death.  Subclasses the registry's InjectedFault so
    one ``except`` in the restart loop covers both the trainer's own
    injections and faults raised by deeper layers (checkpoint.save)."""


class StragglerDetected(RuntimeError):
    def __init__(self, step, step_time, median):
        super().__init__(
            f"step {step} took {step_time:.3f}s > "
            f"{median:.3f}s median x factor")
        self.step = step


@dataclasses.dataclass
class ElasticConfig:
    ckpt_every: int = 10
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    straggler_window: int = 16
    fail_at_steps: tuple = ()      # legacy test hook -> train.step specs
    raise_on_straggler: bool = False


def _close(it) -> None:
    close = getattr(it, "close", None)
    if close is not None:
        close()


class ElasticTrainer:
    def __init__(self, *, make_step: Callable[[], Callable],
                 make_state: Callable[[], Any],
                 batches: Callable[[int], Iterable],
                 checkpointer: Checkpointer,
                 cfg: ElasticConfig | None = None,
                 state_shardings: Any = None,
                 faults: _faults.FaultPlan | None = None,
                 on_step: Callable | None = None):
        # on_step(step, loss, dt_s): host-side live-progress hook, fired
        # after each step's loss is read (it must not mutate training
        # state).
        self.on_step = on_step
        self.make_step = make_step
        self.make_state = make_state
        self.batches = batches
        self.ckpt = checkpointer
        # Never a `cfg: ElasticConfig = ElasticConfig()` default: it would
        # be evaluated once and shared by every trainer in the process.
        self.cfg = cfg if cfg is not None else ElasticConfig()
        self.state_shardings = state_shardings
        self.faults = faults if faults is not None else _faults.FaultPlan()
        self.restarts = 0
        self.straggler_events: list[int] = []
        self._failspecs_synced = False

    # ------------------------------------------------------------------
    def _sync_failspecs(self):
        """Translate the legacy cfg.fail_at_steps shorthand onto the
        registry plan (once; re-reads cfg at run() so a cfg swapped after
        construction still counts)."""
        if self._failspecs_synced:
            return
        self._failspecs_synced = True
        if self.cfg.fail_at_steps:
            self.faults.add(_faults.FaultSpec(
                point=_faults.TRAIN_STEP, kind=_faults.RAISE,
                at_steps=tuple(self.cfg.fail_at_steps), max_fires=None))

    def _restore_or_init(self):
        latest = self.ckpt.latest_step()
        state = self.make_state()
        if latest is not None:
            return self.ckpt.restore(latest, state,
                                     self.state_shardings), latest
        return state, 0

    # ------------------------------------------------------------------
    def run(self, total_steps: int) -> dict:
        """Train until total_steps, surviving injected failures."""
        self._sync_failspecs()
        metrics_log = []
        with _faults.install(self.faults):
            return self._run(total_steps, metrics_log)

    def _run(self, total_steps: int, metrics_log: list) -> dict:
        while True:
            it = None
            try:
                state, start = self._restore_or_init()
                step_fn = self.make_step()
                it = iter(self.batches(start))
                times: list[float] = []
                slow = 0
                for step, batch in it:
                    if step >= total_steps:
                        break
                    t0 = time.perf_counter()
                    fault = self.faults.fire(_faults.TRAIN_STEP, step=step)
                    if fault is not None:
                        if fault.kind == _faults.RAISE:
                            raise SimulatedFailure(
                                f"injected at step {step}")
                        if fault.kind == _faults.LATENCY:
                            # inside the timed window: an injected
                            # straggler the watchdog must catch
                            time.sleep(fault.latency_s)
                    state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])    # the step's sync
                    dt = time.perf_counter() - t0
                    # ---- straggler watchdog ----
                    if len(times) >= 4:
                        med = statistics.median(
                            times[-self.cfg.straggler_window:])
                        if dt > self.cfg.straggler_factor * med:
                            slow += 1
                            if slow >= self.cfg.straggler_patience:
                                self.straggler_events.append(step)
                                slow = 0
                                if self.cfg.raise_on_straggler:
                                    raise StragglerDetected(step, dt, med)
                        else:
                            slow = 0
                    times.append(dt)
                    metrics_log.append({"step": step, "loss": loss})
                    if self.on_step is not None:
                        self.on_step(step, loss, dt)
                    if (step + 1) % self.cfg.ckpt_every == 0:
                        self.ckpt.save_async(step + 1, state)
                self.ckpt.wait()
                self.ckpt.save(total_steps, state)
                return {"state": state, "metrics": metrics_log,
                        "restarts": self.restarts,
                        "stragglers": self.straggler_events}
            except _faults.InjectedFault:
                # Drop the failed attempt before the next make_state():
                # the frames of the raise go with the exception at the end
                # of this block.
                state = step_fn = batch = metrics = None
                self.restarts += 1
                self.ckpt.wait()
                if self.restarts > self.cfg.max_restarts:
                    raise
            finally:
                _close(it)
