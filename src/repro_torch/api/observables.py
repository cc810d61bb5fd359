"""Observables: streaming reductions over the day loop, on the run's device.

An :class:`Observable` is an ``init / update / finalize`` triple over the
per-day stats every day step emits (keys
``repro_torch.core.simulator.STAT_KEYS``, each a ``(B,)`` tensor over the
batch's real scenarios). ``update`` runs *inside* the day loop
(``engine/day.py:run_days``): running reductions (attack rate, peak-day
argmax, cross-scenario mean/CI bands) live in the carry, per-day outputs
are stacked day-major after the loop, and nothing goes to the host per day.
The port of the reference's ``repro.api.observables``, with the same nine
observables, names and outputs.

Two drivers consume the same observables:

  * in the loop — :func:`repro_torch.api.runner.run` threads the carries
    through the batched day loop for engines whose whole batch runs in one
    loop (``single`` at B = 1, ``ensemble``);
  * :func:`observe_history` — the same updates replayed over a day-major
    history after the run, for a pinned ``single`` engine with B > 1, whose
    scenarios run one at a time.

Both paths run the same torch ops on the same values on one device, so
inside the port they give bitwise-equal results. (Against the reference's
JAX observables they agree only to float32 rounding: its own replay differs
from its in-scan values by 1-2 ulp, ROADMAP queue 3.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ObsContext:
    """Static study geometry the reductions need.

    ``sweep_axes`` describes the factorial design the batch expands:
    ``((axis_name, (level_of_scenario_0, level_of_scenario_1, ...)), ...)``
    — one entry per sweep axis with more than one level. ``device`` is
    where the carries live: the run's device."""

    num_people: int
    num_scenarios: int
    sweep_axes: tuple = ()
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class Observable:
    """Base streaming reduction. Subclasses override the three hooks."""

    name = "observable"

    def init(self, ctx: ObsContext):
        """Initial carry (tensors on ``ctx.device``, or an empty tuple)."""
        return ()

    def update(self, carry, stats):
        """One day's update: ``(carry, stats) -> (carry, daily_output)``.
        ``stats`` entries are ``(B,)`` tensors; runs inside the day loop, so
        it must not synchronise with the host. ``daily_output`` is stacked
        day-major; ``()`` for reductions with no per-day series."""
        return carry, ()

    def finalize(self, carry, ctx: ObsContext) -> dict:
        """Named end-of-run results from the final carry."""
        return {}


@dataclasses.dataclass(frozen=True)
class DailyNewInfections(Observable):
    """The day-major incidence series (one column per scenario)."""

    name = "daily_new_infections"

    def update(self, carry, stats):
        return carry, {"daily": stats["new_infections"]}


@dataclasses.dataclass(frozen=True)
class AttackRate(Observable):
    """Final cumulative infections / population, per scenario."""

    name = "attack_rate"

    def init(self, ctx):
        return torch.zeros((ctx.num_scenarios,), dtype=torch.int64, device=ctx.device)

    def update(self, carry, stats):
        return stats["cumulative"], ()

    def finalize(self, carry, ctx):
        return {
            "cumulative": carry,
            "attack_rate": carry.to(torch.float32) / ctx.num_people,
        }


@dataclasses.dataclass(frozen=True)
class PeakDay(Observable):
    """Running argmax of the infectious curve (first-peak semantics,
    matching ``np.argmax``), per scenario."""

    name = "peak_day"

    def init(self, ctx):
        B = ctx.num_scenarios
        return (torch.full((B,), -1, dtype=torch.int32, device=ctx.device),
                torch.zeros((B,), dtype=torch.int32, device=ctx.device))

    def update(self, carry, stats):
        best, best_day = carry
        inf = stats["infectious"].to(torch.int32)
        better = inf > best  # strict: ties keep the earlier day
        return (
            torch.where(better, inf, best),
            torch.where(better, stats["day"].to(torch.int32), best_day),
        ), ()

    def finalize(self, carry, ctx):
        best, best_day = carry
        return {"peak_infectious": best, "peak_day": best_day}


@dataclasses.dataclass(frozen=True)
class EnsembleMeanCI(Observable):
    """Cross-scenario mean and normal-approximation 95% CI band of the daily
    incidence and infectious curves, computed where the batch lives. A
    zero-width band at B = 1."""

    name = "ensemble_mean_ci"
    Z = 1.96

    def update(self, carry, stats):
        out = {}
        for key in ("new_infections", "infectious"):
            x = stats[key].to(torch.float32)
            B = x.shape[0]
            m = torch.mean(x)
            sem = (torch.std(x, correction=1) / np.sqrt(B)) if B > 1 else torch.zeros_like(m)
            out[key] = {"mean": m, "lo": m - self.Z * sem, "hi": m + self.Z * sem}
        return carry, out


@dataclasses.dataclass(frozen=True)
class SobolFirstOrder(Observable):
    """First-order Sobol sensitivity indices of the final cumulative
    infection count over the study's sweep axes.

    For a full-factorial design the first-order index of axis ``a`` is the
    between-level variance fraction

        S1_a = Var_l( E[Y | X_a = l] ) / Var(Y),

    with ``E[Y | X_a = l]`` the mean outcome over the scenarios at level
    ``l`` and both variances population variances over the batch. The carry
    is the running cumulative count per scenario; grouping happens once, in
    ``finalize``, from ``ctx.sweep_axes``: each level's sum is a one-hot mask
    summed along the batch, a fixed-order sum (no float atomics)."""

    name = "sobol_first_order"

    def init(self, ctx):
        return torch.zeros((ctx.num_scenarios,), dtype=torch.int64, device=ctx.device)

    def update(self, carry, stats):
        return stats["cumulative"], ()

    def finalize(self, carry, ctx):
        y = carry.to(torch.float32)
        mu = torch.mean(y)
        var = torch.mean((y - mu) ** 2)
        s1 = {}
        for axis_name, levels in ctx.sweep_axes:
            g = torch.as_tensor(levels, dtype=torch.int64, device=y.device)
            L = int(max(levels)) + 1
            onehot = (g[None, :] == torch.arange(L, device=y.device)[:, None]).to(torch.float32)
            sums = (onehot * y[None, :]).sum(dim=1)
            cnts = onehot.sum(dim=1)
            gmean = sums / torch.clamp(cnts, min=1.0)
            var_between = torch.sum(cnts * (gmean - mu) ** 2) / y.shape[0]
            s1[axis_name] = torch.where(var > 0.0, var_between / var,
                                        torch.full_like(var, float("nan")))
        return {"variance": var, "S1": s1}


@dataclasses.dataclass(frozen=True)
class TEPS(Observable):
    """Traversed-edge telemetry: the day-major edge series per scenario plus
    a running total across days and scenarios — the numerator of the
    paper's headline metric (traversed edges per second). On the
    ``pallas-compact`` route the per-day counts come from the kernel's own
    counter, elsewhere from ``cnt.sum()``; both equal ``stats["contacts"]``.
    The denominator (wall clock) is the runner's."""

    name = "teps"

    def init(self, ctx):
        return torch.zeros((), dtype=torch.int64, device=ctx.device)

    def update(self, carry, stats):
        e = stats["edges"]
        return carry + e.sum(), {"daily": e}

    def finalize(self, carry, ctx):
        return {"edges_total": carry}


@dataclasses.dataclass(frozen=True)
class TestsUsed(Observable):
    """Day-major tests-administered series plus the running total per
    scenario — the utilization of the capacity-limited test budget."""

    name = "tests_used"

    def init(self, ctx):
        return torch.zeros((ctx.num_scenarios,), dtype=torch.int32, device=ctx.device)

    def update(self, carry, stats):
        t = stats["tests_used"].to(torch.int32)
        return carry + t, {"daily": t}

    def finalize(self, carry, ctx):
        return {"tests_total": carry}


@dataclasses.dataclass(frozen=True)
class IsolatedCount(Observable):
    """Day-major count of people in isolation, with the per-scenario peak."""

    name = "isolated_count"

    def init(self, ctx):
        return torch.zeros((ctx.num_scenarios,), dtype=torch.int32, device=ctx.device)

    def update(self, carry, stats):
        iso = stats["isolated"].to(torch.int32)
        return torch.maximum(carry, iso), {"daily": iso}

    def finalize(self, carry, ctx):
        return {"peak_isolated": carry}


@dataclasses.dataclass(frozen=True)
class AvertedByTTI(Observable):
    """Infections averted relative to scenario 0, per scenario:
    ``averted[b] = cumulative[0] - cumulative[b]``."""

    name = "averted_by_tti"

    def init(self, ctx):
        return torch.zeros((ctx.num_scenarios,), dtype=torch.int32, device=ctx.device)

    def update(self, carry, stats):
        return stats["cumulative"].to(torch.int32), ()

    def finalize(self, carry, ctx):
        return {"cumulative": carry, "averted": carry[0] - carry}


OBSERVABLES = {
    o.name: type(o)
    for o in (DailyNewInfections(), AttackRate(), PeakDay(), EnsembleMeanCI(),
              SobolFirstOrder(), TEPS(), TestsUsed(), IsolatedCount(),
              AvertedByTTI())
}


def make_observables(names) -> tuple:
    return tuple(OBSERVABLES[n]() for n in names)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _has_leaves(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_leaves(v) for v in tree.values())
    if isinstance(tree, tuple):
        return any(_has_leaves(v) for v in tree)
    return True


def init_carries(observables, ctx: ObsContext) -> tuple:
    return tuple(o.init(ctx) for o in observables)


def update_all(observables, carries, stats):
    """One day across every observable; returns (carries, {name: daily})."""
    new_carries, daily = [], {}
    for o, c in zip(observables, carries):
        c, d = o.update(c, stats)
        new_carries.append(c)
        daily[o.name] = d
    return tuple(new_carries), daily


def stack_days(days: list):
    """The per-day outputs of :func:`update_all` stacked day-major: each
    leaf gains a leading days axis."""
    first = days[0]
    if isinstance(first, dict):
        return {k: stack_days([d[k] for d in days]) for k in first}
    if isinstance(first, tuple):
        return tuple(stack_days([d[i] for d in days]) for i in range(len(first)))
    return torch.stack(days)


def finalize_all(observables, carries, dailies, ctx: ObsContext) -> dict:
    """Merge each observable's finalized reductions with its stacked
    day-major series (under the ``"daily"``-rooted keys its update
    emitted)."""
    out = {}
    for o, c in zip(observables, carries):
        res = dict(o.finalize(c, ctx))
        d = dailies.get(o.name, ()) if dailies is not None else ()
        if _has_leaves(d):
            res.update(d if isinstance(d, dict) else {"daily": d})
        out[o.name] = res
    return out


def scan_history(observables, hist, ctx: ObsContext):
    """The updates replayed over a day-major history, on ``ctx.device``.

    ``hist`` maps STAT_KEYS to ``(days, B)`` arrays. Returns ``(carries,
    dailies)``; ``dailies`` are host numpy arrays, as the in-loop path's
    come back from the run."""
    hist_dev = {k: torch.as_tensor(np.asarray(v), device=ctx.device)
                for k, v in hist.items()}
    days = next(iter(hist_dev.values())).shape[0]
    carries, daily = init_carries(observables, ctx), []
    for d in range(days):
        carries, out = update_all(observables, carries,
                                  {k: v[d] for k, v in hist_dev.items()})
        daily.append(out)
    return carries, observables_to_numpy(stack_days(daily)) if daily else None


def observe_history(observables, hist, ctx: ObsContext) -> dict:
    """Run the observables over an existing day-major history: the
    post-run driver for scenarios that ran one at a time; bitwise equal to
    the in-loop path inside the port."""
    carries, dailies = scan_history(observables, hist, ctx)
    return finalize_all(observables, carries, dailies, ctx)


def observables_to_numpy(obs):
    """Tensors (nested in dicts/tuples) -> host numpy arrays."""
    if isinstance(obs, dict):
        return {k: observables_to_numpy(v) for k, v in obs.items()}
    if isinstance(obs, tuple):
        return tuple(observables_to_numpy(v) for v in obs)
    return obs.cpu().numpy() if isinstance(obs, torch.Tensor) else obs
