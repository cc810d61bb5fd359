"""Deterministic chaos harness: seeded fault schedules for resilient runs
(the port of the reference's ``repro.runtime.chaos``; ``ChaosSchedule.random``
draws the reference's events for the same seed).

Production failure modes — a peer raising out of a collective, a snapshot
half-written when a node died, NaNs escaping a broken kernel, a device
dropping out, one worker suddenly 10x slower — are simulated here as
*scheduled events at chunk boundaries*, so the whole recovery matrix of
runtime/resilience.py runs deterministically and every recovered run can be
asserted bitwise-equal to a fault-free one.

Event kinds (all fire exactly once, at the boundary *entering* the chunk
that starts at ``day``):

  ==============  =====================================================
  ``raise``       raise :class:`ChaosError` — a node failure at a chunk
                  boundary; recovery = restore newest snapshot + replay.
  ``corrupt``     flip bytes inside the newest on-disk snapshot, then
                  raise — recovery must quarantine it and fall back to
                  the next-older valid step.
  ``truncate``    truncate a leaf file of the newest snapshot, then
                  raise — same fallback path, different failure shape.
  ``nan``         poison the in-memory state with NaNs *after* the chunk
                  runs — the invariant guards must catch it before it is
                  checkpointed.
  ``device_loss`` raise :class:`DeviceLossError` — the elastic path
                  rebuilds the engine on fewer workers and continues (on
                  one worker there is none to drop, and the loss is
                  re-raised).
  ``slow``        sleep inside the chunk's timed section — the straggler
                  detector must flag it (and may trigger repartition).
  ==============  =====================================================

Schedules are plain data: build them explicitly for targeted tests, or
:meth:`ChaosSchedule.random` draws a reproducible mix from a seed.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

KINDS = ("raise", "corrupt", "truncate", "nan", "device_loss", "slow")


class ChaosError(RuntimeError):
    """An injected, recoverable fault (simulated node failure)."""


class DeviceLossError(RuntimeError):
    """A worker device dropped out of the mesh; carries how many."""

    def __init__(self, workers_lost: int = 1,
                 message: str = "simulated device loss"):
        super().__init__(f"{message} ({workers_lost} worker(s))")
        self.workers_lost = int(workers_lost)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    kind: str  # one of KINDS
    day: int  # chunk boundary the event fires at
    workers_lost: int = 1  # device_loss only
    sleep_s: float = 0.25  # slow only
    leaf: Optional[str] = None  # corrupt/truncate target (None = the largest)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"chaos kind must be one of {KINDS}, "
                             f"got '{self.kind}'")


@dataclasses.dataclass
class ChaosSchedule:
    """An ordered set of one-shot fault events, consumed by the resilient
    chunk loop's hooks. ``fired`` tracks which events already went off —
    replayed chunks do not re-fire them, which is what makes recovery
    terminate and stay bitwise-comparable."""

    events: tuple = ()

    def __post_init__(self):
        self.events = tuple(self.events)
        self.fired: set = set()
        self.log: list = []

    @classmethod
    def random(cls, seed: int, days: int, every: int,
               kinds: tuple = KINDS, n_events: int = 3) -> "ChaosSchedule":
        """A reproducible schedule: ``n_events`` faults drawn (without
        replacement over boundaries) from ``kinds`` at interior chunk
        boundaries of a ``days``-day run chunked ``every`` days."""
        # detlint: ignore[DET001] — fault-schedule generator: seeded PCG64
        # on the host, the reference's draw; schedules replay identically.
        rng = np.random.Generator(np.random.PCG64(seed))
        boundaries = list(range(every, days, every)) or [0]
        picks = rng.choice(len(boundaries),
                           size=min(n_events, len(boundaries)), replace=False)
        events = tuple(
            ChaosEvent(kind=str(rng.choice(list(kinds))),
                       day=int(boundaries[int(i)]))
            for i in sorted(picks)
        )
        return cls(events=events)

    # ------------------------------------------------------------------
    def _take(self, day: int, kinds: tuple) -> list:
        out = []
        for i, ev in enumerate(self.events):
            if i not in self.fired and ev.day == day and ev.kind in kinds:
                self.fired.add(i)
                self.log.append((ev.kind, int(day)))
                out.append(ev)
        return out

    # -- hook surface consumed by runtime/resilience.py -----------------
    def before_chunk(self, day: int, manager=None) -> None:
        """Fire boundary events for the chunk starting at ``day``. Disk
        events need ``manager`` (the run's CheckpointManager)."""
        for ev in self._take(day, ("slow",)):
            time.sleep(ev.sleep_s)
        for ev in self._take(day, ("corrupt", "truncate")):
            if manager is not None:
                _damage_newest(manager, ev)
            raise ChaosError(
                f"injected {ev.kind}-snapshot fault at day {day}")
        for ev in self._take(day, ("device_loss",)):
            raise DeviceLossError(ev.workers_lost)
        for ev in self._take(day, ("raise",)):
            raise ChaosError(f"injected node failure at day {day}")

    def poison_state(self, day: int, state):
        """Apply any ``nan`` event scheduled for the boundary *ending* at
        ``day``: a copy of the state whose first dwell entry is NaN (a
        float leaf the guards sweep). The live tensors are never written."""
        for _ in self._take(day, ("nan",)):
            dwell = state.dwell.clone(memory_format=torch.contiguous_format)
            dwell.view(-1)[0] = float("nan")
            state = dataclasses.replace(state, dwell=dwell)
        return state


def _damage_newest(manager, ev: ChaosEvent) -> None:
    """Corrupt or truncate one leaf file of the newest on-disk snapshot."""
    manager.wait()
    steps = manager.all_steps()
    if not steps:
        return
    d = os.path.join(manager.directory, f"step-{steps[-1]:010d}")
    names = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    if not names:
        return
    if ev.leaf is not None:
        target = ev.leaf.replace("/", "__") + ".npy"
    else:  # the largest leaf: damage is guaranteed to land in array bytes
        target = max(names, key=lambda f: os.path.getsize(os.path.join(d, f)))
    path = os.path.join(d, target)
    size = os.path.getsize(path)
    if ev.kind == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    else:  # corrupt: invert trailing payload bytes (guaranteed to change)
        pos = max(size - 8, 0)
        with open(path, "r+b") as f:
            f.seek(pos)
            chunk = f.read(4)
            f.seek(pos)
            f.write(bytes(b ^ 0xFF for b in chunk))
