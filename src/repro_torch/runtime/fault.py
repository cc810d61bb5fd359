"""Fault-tolerant *step* loop: checkpoint/restart, failure handling,
straggler detection (the port of the reference's ``repro.runtime.fault``).

This is the step-granular prototype of the recovery policy, plain Python
around caller-supplied step, save and restore functions; the epidemic
engine's chunk-granular version — with checkpoint integrity, invariant
guards and a deterministic chaos harness — is
:mod:`repro_torch.runtime.resilience`.

  * **checkpoint cadence** — a snapshot every ``checkpoint_interval``
    steps; deterministic counter-based RNG (core/rng.py) makes replay from
    the last snapshot bitwise-exact, so a restart costs at most
    ``interval`` steps of recompute.
  * **failure → restore → replay** — on exception the loop restores the
    newest checkpoint and replays; repeated failures back off and are
    capped by ``max_restarts``.
  * **straggler detection** — per-step wall times against the median of a
    window; a step slower than ``straggler_factor`` × median triggers a
    callback (detection here, policy at the caller).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class FaultConfig:
    checkpoint_interval: int = 50
    max_restarts: int = 10
    straggler_window: int = 20
    straggler_factor: float = 2.0
    backoff_s: float = 0.0  # kept 0 in tests


@dataclasses.dataclass
class LoopStats:
    steps_run: int = 0
    restarts: int = 0
    checkpoints: int = 0
    straggler_events: int = 0
    step_times: list = dataclasses.field(default_factory=list)


class FaultTolerantLoop:
    """Drives ``step_fn(state) -> state`` for ``num_steps`` with recovery.

    ``save_fn(step, state)`` / ``restore_fn() -> (step, state)`` wrap the
    checkpoint manager. ``fault_injector(step)`` (tests only) may raise to
    simulate a node failure at a step boundary.
    """

    def __init__(
        self,
        step_fn: Callable,
        save_fn: Callable,
        restore_fn: Callable,
        cfg: FaultConfig = FaultConfig(),
        on_straggler: Optional[Callable] = None,
        fault_injector: Optional[Callable] = None,
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.fault_injector = fault_injector
        self.stats = LoopStats()

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        restarts = 0
        while step < start_step + num_steps:
            try:
                t0 = time.perf_counter()
                if self.fault_injector is not None:
                    self.fault_injector(step)
                state = self.step_fn(state)
                dt = time.perf_counter() - t0
                self._track_straggler(dt, step)
                step += 1
                self.stats.steps_run += 1
                if step % self.cfg.checkpoint_interval == 0:
                    self.save_fn(step, state)
                    self.stats.checkpoints += 1
            except Exception:  # noqa: BLE001 — the recovery boundary
                restarts += 1
                self.stats.restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                if self.cfg.backoff_s:
                    time.sleep(min(self.cfg.backoff_s * restarts, 30.0))
                step, state = self.restore_fn()
        return step, state

    def _track_straggler(self, dt: float, step: int):
        times = self.stats.step_times
        times.append(dt)
        w = self.cfg.straggler_window
        if len(times) >= w:
            window = np.asarray(times[-w:])
            med = np.median(window)
            if med > 0 and dt > self.cfg.straggler_factor * med:
                self.stats.straggler_events += 1
                if self.on_straggler is not None:
                    self.on_straggler(step, dt, med)
