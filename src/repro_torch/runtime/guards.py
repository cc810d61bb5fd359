"""Post-chunk invariant guards: catch a poisoned state *before* it is
checkpointed (the port of the reference's ``repro.runtime.guards``, with
its violation strings word for word).

A silent corruption (NaN creeping out of a bad kernel, a health code
outside the disease table, an isolation window travelling backwards in
time) is worse than a crash: the chunk loop would snapshot the poisoned
state and every later restart would faithfully replay garbage. The
resilient driver (runtime/resilience.py) runs :class:`GuardContext` after
every chunk and treats a violation exactly like an injected node failure —
restore the newest *valid* snapshot and replay — so the poisoned state
never reaches disk.

The sweep runs where the state lives: torch reductions on its device give
a handful of counts (minima, maxima, the number of bad entries), which come
to the host in one copy; the ``(B, P)`` person leaves never do, and the
monotonicity baselines stay on the device. The checks:

  * ``health`` codes lie in ``[0, num_states)`` — the disease-table range;
  * counters are non-negative (``cumulative``, ``day``) and ``cumulative``
    never decreases across chunks;
  * ``isolated_until`` is per-agent monotone non-decreasing (isolation
    windows only ever extend);
  * every float leaf is NaN/Inf-free (``dwell`` uses the finite
    ``ABSORBING_DWELL`` sentinel, so a true Inf is always a bug).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


class InvariantViolation(RuntimeError):
    """A state invariant failed; carries the full list of violations."""

    def __init__(self, violations: list):
        super().__init__(
            "state invariant violation: " + "; ".join(violations))
        self.violations = list(violations)


def _min(t: torch.Tensor) -> torch.Tensor:
    return t.min().long() if t.numel() else torch.zeros((), dtype=torch.long,
                                                         device=t.device)


def check_state(state, *, num_states: int,
                prev: Optional[dict] = None) -> list:
    """Sweep a (stacked or unstacked) SimState for invariant violations.

    ``state``'s leaves are tensors (numpy arrays are taken as CPU tensors).
    ``prev`` carries the previous boundary's monotonicity baselines
    (``{"cumulative": ..., "isolated_until": ...}``, tensors on the state's
    device); pass None on the first call or after any event that
    legitimately changes shapes.

    Returns a list of human-readable violations (empty = healthy).
    """
    s = {f.name: torch.as_tensor(getattr(state, f.name))
         for f in dataclasses.fields(state)}
    health = s["health"]
    dev = health.device
    # Every count the checks read, as int64 scalars on the state's device,
    # in one tensor and so one host copy.
    named = {
        "health_bad": ((health < 0) | (health >= num_states)).sum(),
        "cumulative_min": _min(s["cumulative"]),
        "day_min": _min(s["day"]),
        "iso_min": _min(s["isolated_until"]),
    }
    floats = [k for k, v in s.items() if v.is_floating_point()]
    for k in floats:
        named[f"nonfinite_{k}"] = (~torch.isfinite(s[k])).sum()
    checks = {}
    if prev is not None:
        for k in ("cumulative", "isolated_until"):
            p = prev.get(k)
            if p is not None and tuple(p.shape) == tuple(s[k].shape):
                checks[k] = True
                named[f"back_{k}"] = (s[k] < torch.as_tensor(p, device=dev)).sum()
    c = dict(zip(named, torch.stack(
        [v.long().reshape(()) for v in named.values()]).tolist()))

    out = []
    if health.numel() and c["health_bad"]:
        out.append(
            f"health: {c['health_bad']} code(s) outside the disease-table range "
            f"[0, {num_states})")
    for k in ("cumulative", "day"):
        if c[f"{k}_min"] < 0:
            out.append(f"{k}: negative counter (min {c[f'{k}_min']})")
    if c["iso_min"] < 0:
        out.append(f"isolated_until: negative day (min {c['iso_min']})")
    for k in floats:
        if c[f"nonfinite_{k}"]:
            out.append(f"{k}: {c[f'nonfinite_{k}']} non-finite value(s) (NaN/Inf sweep)")
    if checks.get("cumulative") and c["back_cumulative"]:
        out.append("cumulative: decreased across a chunk boundary")
    if checks.get("isolated_until") and c["back_isolated_until"]:
        out.append(
            f"isolated_until: {c['back_isolated_until']} isolation window(s) moved "
            "backwards (windows may only extend)")
    return out


@dataclasses.dataclass
class GuardContext:
    """Stateful wrapper around :func:`check_state` that threads the
    monotonicity baselines between chunk boundaries.

    ``num_states`` is the disease table's state count (e.g.
    ``core.params.sus_table.shape[-1]``)."""

    num_states: int
    prev: Optional[dict] = None

    def reset(self, state=None) -> None:
        """Drop the baselines (fresh run) or rebase them on ``state``
        (after a restore or an elastic repartition)."""
        self.prev = None if state is None else self._baseline(state)

    @staticmethod
    def _baseline(state) -> dict:
        return {k: torch.as_tensor(getattr(state, k)).clone()
                for k in ("cumulative", "isolated_until")}

    def check(self, state) -> None:
        """Raise :class:`InvariantViolation` if ``state`` is poisoned;
        otherwise advance the baselines to it."""
        violations = check_state(state, num_states=self.num_states,
                                 prev=self.prev)
        if violations:
            raise InvariantViolation(violations)
        self.prev = self._baseline(state)
