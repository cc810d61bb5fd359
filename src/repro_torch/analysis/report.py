"""Scenario-sweep summary tables (the reference's ``repro.analysis.report``,
its sweep part): per-scenario summary rows from a history or a RunResult's
observables, and their markdown tables, used by ``launch/sweep.py``.

    python -m repro_torch.analysis.report --result run.json

renders a saved RunResult (``RunResult.save``, or the sweep CLI's
``--out``): its sweep table and its mean/CI band table. The reference's
``--section dryrun|roofline`` tables belong to the LM tooling, which the
port does not have yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def summarize_sweep(hist, names, num_people):
    """Per-scenario epidemic summaries from ensemble history.

    ``hist`` is the dict of (days, B) arrays returned by
    ``EngineCore.run``; returns one row per
    scenario with the headline intervention-study metrics.
    """
    cum = np.asarray(hist["cumulative"])  # (days, B)
    infectious = np.asarray(hist["infectious"])
    rows = []
    for i, name in enumerate(names):
        rows.append({
            "scenario": name,
            "cumulative": int(cum[-1, i]),
            "attack_rate_pct": round(100.0 * cum[-1, i] / num_people, 2),
            "peak_infectious": int(infectious[:, i].max()),
            "peak_day": int(np.argmax(infectious[:, i])),
            "interactions": int(
                np.asarray(hist["contacts"], np.int64)[:, i].sum()
            ),
        })
    return rows


def summarize_result(result):
    """Per-scenario rows straight from a RunResult's *observables* — the
    on-device reductions, no second pass over the history. Accepts a live
    ``repro_torch.api.RunResult`` or one loaded back from JSON. Falls back to the
    legacy history-based :func:`summarize_sweep` when the result was run
    without the attack-rate/peak-day observables."""
    obs = result.observables
    if "attack_rate" in obs and "peak_day" in obs:
        cum = np.asarray(obs["attack_rate"]["cumulative"])
        peak = np.asarray(obs["peak_day"]["peak_infectious"])
        peak_day = np.asarray(obs["peak_day"]["peak_day"])
        contacts = np.asarray(result.history["contacts"], np.int64)
        num_people = result.provenance["num_people"]
        return [{
            "scenario": name,
            "cumulative": int(cum[i]),
            # float64 from the exact counts, matching summarize_sweep's
            # rounding (the f32 on-device attack_rate can round differently
            # at the 2nd decimal)
            "attack_rate_pct": round(100.0 * cum[i] / num_people, 2),
            "peak_infectious": int(peak[i]),
            "peak_day": int(peak_day[i]),
            "interactions": int(contacts[:, i].sum()),
        } for i, name in enumerate(result.scenario_names)]
    return summarize_sweep(result.history, result.scenario_names,
                           result.provenance["num_people"])


def mean_ci_table(result, key="new_infections", every=1, file=None):
    """Render the on-device cross-scenario mean/CI band series of a
    RunResult (requires the ``ensemble_mean_ci`` observable)."""
    band = result.observables.get("ensemble_mean_ci", {}).get(key)
    if band is None:
        print(f"(no ensemble_mean_ci[{key}] observable in this result)",
              file=file)
        return
    mean = np.asarray(band["mean"])
    lo, hi = np.asarray(band["lo"]), np.asarray(band["hi"])
    print(f"| day | mean {key} | 95% CI |", file=file)
    print("|---|---|---|", file=file)
    for d in range(0, len(mean), every):
        print(f"| {d} | {mean[d]:.1f} | [{lo[d]:.1f}, {hi[d]:.1f}] |",
              file=file)


def sweep_table(rows, file=None):
    """Render summarize_sweep rows as a markdown table."""
    print("| scenario | attack % | peak infectious | peak day | interactions |",
          file=file)
    print("|---|---|---|---|---|", file=file)
    for r in rows:
        print(
            f"| {r['scenario']} | {r['attack_rate_pct']:.1f} | "
            f"{r['peak_infectious']} | {r['peak_day']} | "
            f"{r['interactions']} |",
            file=file,
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.report")
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--section", default="all")
    ap.add_argument("--result", default=None,
                    help="render the sweep + mean/CI tables of a RunResult JSON "
                         "(repro_torch.api.run output)")
    args = ap.parse_args(argv)
    if args.result:
        from repro_torch.api import RunResult  # cycle-free at call time

        result = RunResult.load(args.result)
        print(f"\n### {result.spec.name} (engine={result.provenance['engine']})\n")
        sweep_table(summarize_result(result))
        print()
        mean_ci_table(result, every=max(1, result.days // 20))
        return 0
    print(f"report: --section {args.section} renders the LM tooling's dry-run and "
          "roofline tables, which the port does not have yet (ROADMAP queue 1 item 9); "
          "pass --result run.json to render a RunResult", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
