"""How ``correct`` is decided: the program's outputs against the plain
reference.

Three numbers, each held to a limit from the traffic file:

* ``history_mismatches``: entries (day, statistic, scenario) of the
  sampled scenarios' histories where the program and the reference
  (``reference/sim.py``, from the same twin, presets and seeds) differ.
  The model fixes every rounding, so the comparison is exact;
* ``observable_mismatches``: entries of the integer observables (series,
  totals, peaks) that differ from what the observable's definition gives
  from the history they came with;
* ``float_gap``: the widest gap between the program's float observables
  (the attack rate; in a study the ensemble mean and 95% band and the
  Sobol indices) and the same values in float64 from the history, over
  that value's largest magnitude (at least 1).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import sim

Z = 1.96


def sweep_axes(n_iv: int, n_tau: int, n_rep: int) -> list:
    """Each factorial axis with more than one level: (name, level of each
    scenario), scenarios ordered interventions x tau x replicates."""
    idx = np.arange(n_iv * n_tau * n_rep)
    axes = []
    if n_iv > 1:
        axes.append(("interventions", idx // (n_tau * n_rep)))
    if n_tau > 1:
        axes.append(("tau_scales", (idx // n_rep) % n_tau))
    if n_rep > 1:
        axes.append(("replicates", idx % n_rep))
    return axes


def exact_observables(hist: dict, names) -> dict:
    """The observables whose values are integers, from a ``(days, B)``
    history."""
    out = {}
    if "daily_new_infections" in names:
        out["daily_new_infections"] = {"daily": hist["new_infections"]}
    if "attack_rate" in names:
        out["attack_rate"] = {"cumulative": hist["cumulative"][-1]}
    if "peak_day" in names:
        inf = hist["infectious"]
        at = np.argmax(inf, axis=0)
        out["peak_day"] = {"peak_infectious": inf.max(axis=0),
                           "peak_day": hist["day"][at, np.arange(inf.shape[1])]}
    if "teps" in names:
        out["teps"] = {"edges_total": hist["edges"].sum(), "daily": hist["edges"]}
    return out


def float_observables(hist: dict, names, num_people: int, axes=(),
                      dtype=torch.float64) -> dict:
    """The attack rate, the mean and 95% band across scenarios per day, and
    the first-order Sobol indices of the final cumulative count over the
    sweep ``axes``, computed in ``dtype``."""
    out = {}
    t = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)
    num = lambda x: x.to(torch.float64).numpy()
    if "attack_rate" in names:
        out["attack_rate"] = {"attack_rate": num(t(hist["cumulative"][-1]) / num_people)}
    if "ensemble_mean_ci" in names:
        d = {}
        for key in ("new_infections", "infectious"):
            x = t(hist[key])
            B = x.shape[1]
            m = x.mean(dim=1)
            sem = x.std(dim=1, correction=1) / np.sqrt(B) if B > 1 else torch.zeros_like(m)
            d[key] = {"mean": num(m), "lo": num(m - Z * sem), "hi": num(m + Z * sem)}
        out["ensemble_mean_ci"] = d
    if "sobol_first_order" in names:
        y = t(hist["cumulative"][-1])
        mu = y.mean()
        var = ((y - mu) ** 2).mean()
        s1 = {}
        for name, levels in axes:
            between = torch.zeros((), dtype=dtype)
            for lv in np.unique(levels):
                sel = torch.as_tensor(levels == lv)
                between = between + int(sel.sum()) * (y[sel].mean() - mu) ** 2
            between = between / len(y)
            s1[name] = num(between / var) if float(var) > 0 else np.float64(np.nan)
        out["sobol_first_order"] = {"variance": num(var), "S1": s1}
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def count_mismatches(program: dict, reference: dict, where: set = None) -> int:
    """Entries of ``reference``'s leaves that ``program`` lacks or holds
    otherwise (exact); the paths of the leaves that differ go into
    ``where``."""
    bad = 0
    prog = dict(_leaves(program))
    for path, ref in _leaves(reference):
        ref = np.asarray(ref)
        got = prog.get(path)
        n = (max(ref.size, 1) if got is None or np.shape(got) != ref.shape
             else int(np.sum(np.asarray(got) != ref)))
        if n and where is not None:
            where.add(path)
        bad += n
    return bad


def widest_gap(program: dict, reference: dict) -> float:
    """Over ``reference``'s leaves: max |program - reference| over the
    leaf's largest magnitude (at least 1); a missing leaf or a NaN where
    the reference has a number reads as infinity."""
    gap = 0.0
    prog = dict(_leaves(program))
    for path, ref in _leaves(reference):
        ref = np.asarray(ref, np.float64)
        got = prog.get(path)
        if got is None or np.shape(got) != ref.shape:
            return float("inf")
        got = np.asarray(got, np.float64)
        both_nan = np.isnan(ref) & np.isnan(got)
        if np.any(np.isnan(got) != np.isnan(ref)):
            return float("inf")
        scale = max(float(np.max(np.abs(np.where(both_nan, 0.0, ref)), initial=0.0)), 1.0)
        diff = np.abs(np.where(both_nan, 0.0, got - ref))
        gap = max(gap, float(np.max(diff, initial=0.0)) / scale)
    return gap


def history_mismatches(program: dict, reference: dict) -> int:
    """Differing entries over the ten statistics of ``(days, B)`` histories."""
    bad = 0
    for key in sim.STAT_KEYS:
        a, b = np.asarray(program[key]), np.asarray(reference[key])
        if a.shape != b.shape:
            bad += b.size
        else:
            bad += int(np.sum(a != b))
    return bad
