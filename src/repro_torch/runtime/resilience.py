"""Resilient chunked runs: the recovery policy around the engine's chunk
loop (the port of the reference's ``repro.runtime.resilience``, with its
logic as written).

``repro_torch.engine.core.run_chunked`` gives day-chunked checkpoints and a
bitwise resume; this module wraps it with the recovery policy a multi-hour
study needs:

  * **failure → restore → replay** — any fault at a chunk boundary (a
    raised error, an injected chaos fault, an invariant violation from
    runtime/guards.py) restores the newest *valid* snapshot — corrupt ones
    are digest-detected and quarantined by the checkpoint layer — and
    replays. Counter-based RNG makes the replay bitwise, so a recovered
    run equals an uninterrupted one exactly. Restarts are capped and
    backed off.
  * **invariant guards** — after every chunk (and before its snapshot is
    written) the state passes the :mod:`repro_torch.runtime.guards` pack; a
    violation is treated as a fault, so a poisoned state is replayed away
    instead of checkpointed.
  * **straggler detection** — per-chunk wall times (which end in the
    chunk's history copy, so they time the device's work) feed a robust
    median/MAD outlier test; an outlier may trigger a rebuild of the
    driver at the next safe chunk boundary.
  * **elastic degradation** — on device loss the driver is rebuilt on
    fewer workers and the run continues from the newest snapshot. The port
    runs one worker, so a device loss re-raises, as the reference does on
    one worker; shrinking a mesh is ROADMAP queue 1 item 4.

Everything is driven deterministically by :mod:`repro_torch.runtime.chaos`
in tests; :class:`ResilienceReport` records what recovery did, for
``RunResult.provenance["resilience"]``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointCorruptionError  # noqa: F401 (re-export)
from repro_torch.runtime.chaos import ChaosSchedule, DeviceLossError
from repro_torch.runtime.guards import GuardContext, InvariantViolation


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """The recovery policy for a resilient chunked run."""

    max_restarts: int = 3  # restore+replay attempts before giving up
    backoff_s: float = 0.0  # restart backoff (linear in attempt; 0 in tests)
    guards: bool = True  # run the post-chunk invariant pack
    elastic: bool = True  # shrink workers on device loss (vs. re-raise)
    straggler_window: int = 5  # chunk-time window for the median/MAD test
    straggler_factor: float = 4.0  # flag dt > factor * median ...
    straggler_z: float = 8.0  # ... and dt > median + z * 1.4826 * MAD
    repartition_on_straggler: bool = False  # rebuild driver on detection
    max_repartitions: int = 2


@dataclasses.dataclass
class ResilienceReport:
    """What recovery actually did, for ``RunResult.provenance``."""

    restarts: int = 0
    chunks_replayed: int = 0
    snapshots_quarantined: int = 0
    straggler_events: list = dataclasses.field(default_factory=list)
    guard_violations: list = dataclasses.field(default_factory=list)
    device_losses: list = dataclasses.field(default_factory=list)
    repartitions: int = 0
    faults: list = dataclasses.field(default_factory=list)
    final_workers: int = 1
    final_layout: str = "local"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _RepartitionSignal(Exception):
    """Control flow: the straggler policy asked for a driver rebuild at
    the next safe boundary (internal to run_resilient)."""

    def __init__(self, day: int):
        super().__init__(f"repartition requested at day {day}")
        self.day = day


class _ChunkHooks:
    """The hook object handed to ``run_chunked``: chaos injection, the
    invariant guards, straggler timing, and replay accounting."""

    def __init__(self, policy: ResiliencePolicy, report: ResilienceReport,
                 manager, guard: Optional[GuardContext],
                 chaos: Optional[ChaosSchedule],
                 on_straggler: Optional[Callable]):
        self.policy = policy
        self.report = report
        self.manager = manager
        self.guard = guard
        self.chaos = chaos
        self.on_straggler = on_straggler
        self.chunk_times: list = []
        self.max_end = 0  # furthest chunk boundary completed (any attempt)
        self.saved_any = False

    # -- run_chunked hook surface ---------------------------------------
    def on_start(self, state, day: int) -> None:
        if self.guard is not None:
            self.guard.reset(state)

    def before_chunk(self, day: int, n: int) -> None:
        if self.chaos is not None:
            self.chaos.before_chunk(day, self.manager)

    def after_chunk(self, end_day: int, state, dt: float):
        if end_day <= self.max_end:
            self.report.chunks_replayed += 1
        else:
            self.max_end = end_day
        if self.chaos is not None:
            state = self.chaos.poison_state(end_day, state)
        if self.guard is not None:
            self.guard.check(state)  # raises InvariantViolation on poison
        self._track_straggler(end_day, dt)
        return state

    def after_save(self, day: int) -> None:
        self.saved_any = True

    # -- straggler detection (median/MAD over per-chunk wall time) ------
    def _track_straggler(self, end_day: int, dt: float) -> None:
        times = self.chunk_times
        times.append(dt)
        w = self.policy.straggler_window
        if len(times) < w:
            return
        window = np.asarray(times[-w:])
        med = float(np.median(window))
        mad = float(np.median(np.abs(window - med)))
        slow = dt > max(self.policy.straggler_factor * med,
                        med + self.policy.straggler_z * 1.4826 * mad)
        if med > 0 and slow:
            self.report.straggler_events.append(
                {"day": int(end_day), "chunk_s": round(dt, 4),
                 "median_s": round(med, 4)})
            if self.on_straggler is not None:
                self.on_straggler(end_day, dt, med)
            if (self.policy.repartition_on_straggler
                    and self.report.repartitions < self.policy.max_repartitions):
                raise _RepartitionSignal(end_day)


def run_resilient(
    make_driver: Callable,
    days: int,
    observables: tuple,
    ctx,
    *,
    manager,
    every: int = 50,
    resume: bool = True,
    resume_key: Optional[dict] = None,
    policy: Optional[ResiliencePolicy] = None,
    chaos: Optional[ChaosSchedule] = None,
    on_straggler: Optional[Callable] = None,
):
    """Run ``run_chunked`` under the recovery policy.

    ``make_driver(workers=None)`` builds (or rebuilds) the chunk driver —
    a :class:`~repro_torch.engine.core.CoreDriver` or ``SequentialDriver``
    whose ``.core`` exposes ``workers``/``layout``/``params``. Passing a
    worker count rebuilds the engine on that many workers (the elastic
    degradation path); ``None`` means the spec's own mesh.

    Returns ``run_chunked``'s tuple plus a :class:`ResilienceReport`:
    ``(state, hist, carries, dailies, resumed_from, num_chunks, report)``.
    """
    from repro_torch.engine.core import ResumeKeyError, run_chunked

    if manager is None:
        raise ValueError(
            "resilient runs need checkpointing: recovery restores from "
            "snapshots (set checkpoint.directory)")
    policy = policy if policy is not None else ResiliencePolicy()
    report = ResilienceReport()
    driver = make_driver(None)
    guard = None
    if policy.guards:
        guard = GuardContext(
            num_states=int(driver.core.params.sus_table.shape[-1]))
    hooks = _ChunkHooks(policy, report, manager, guard, chaos, on_straggler)

    restarts = 0
    while True:
        try:
            out = run_chunked(
                driver, days, observables, ctx, manager=manager,
                every=every, resume=resume or hooks.saved_any,
                resume_key=resume_key, hooks=hooks,
            )
            break
        except ResumeKeyError:
            raise  # a config error, not a fault — never retried
        except _RepartitionSignal as sig:
            # Straggler policy: rebuild the driver on the same worker
            # count; the next attempt resumes from the newest snapshot — a
            # safe repartition point.
            report.repartitions += 1
            report.faults.append(
                {"kind": "repartition", "day": sig.day})
            driver = make_driver(int(getattr(driver.core, "workers", 1)))
            hooks.chunk_times.clear()  # fresh program => fresh timing baseline
        except DeviceLossError as e:
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            old_w = int(getattr(driver.core, "workers", 1))
            new_w = old_w - e.workers_lost
            if not policy.elastic or new_w < 1 or old_w <= 1:
                raise
            report.device_losses.append(
                {"workers_before": old_w, "workers_after": new_w})
            report.faults.append({"kind": "device_loss", "error": str(e)})
            driver = make_driver(new_w)
            hooks.chunk_times.clear()  # fresh program => fresh timing baseline
            _backoff(policy, restarts)
        except Exception as e:  # noqa: BLE001 — the recovery boundary
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            if isinstance(e, InvariantViolation):
                report.guard_violations.extend(e.violations)
            report.faults.append(
                {"kind": type(e).__name__, "error": str(e)})
            _backoff(policy, restarts)
        if guard is not None:
            guard.reset()  # rebased on the restored state at on_start

    report.restarts = restarts
    report.snapshots_quarantined = len(manager.quarantined_steps)
    report.final_workers = int(getattr(driver.core, "workers", 1))
    report.final_layout = str(getattr(driver.core, "layout", "local"))
    return out + (report,)


def _backoff(policy: ResiliencePolicy, attempt: int) -> None:
    if policy.backoff_s:
        time.sleep(min(policy.backoff_s * attempt, 30.0))
