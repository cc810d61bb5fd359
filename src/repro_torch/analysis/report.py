"""Dry-run and roofline tables from ``artifacts/dryrun/*.json``, plus the
scenario-sweep summary tables used by ``launch/sweep.py`` (the reference's
``repro.analysis.report``; its tables print the same text from the same
records, so either package's dry-run artifacts render here).

    python -m repro_torch.analysis.report [--dir artifacts/dryrun] \
        [--section all|dryrun|roofline]
    python -m repro_torch.analysis.report --result run.json

The first renders ``launch/dryrun.py``'s records; the second a saved
RunResult (``RunResult.save``, or the sweep CLI's ``--out``): its sweep
table and its mean/CI band table.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def load(dir_, pattern):
    out = []
    for p in sorted(glob.glob(os.path.join(dir_, pattern))):
        with open(p) as f:
            out.append((os.path.basename(p)[:-5], json.load(f)))
    return out


def fmt_bytes(b):
    return f"{b/2**30:.1f}G" if b > 2**28 else f"{b/2**20:.0f}M"


def dryrun_table(dir_):
    print("\n### Dry-run status (compile proof per cell)\n")
    print("| arch | shape | 16x16 | 2x16x16 | compile s (1-pod) |")
    print("|---|---|---|---|---|")
    single = {k.replace("_16x16", ""): v for k, v in load(dir_, "*_16x16.json")}
    multi = {k.replace("_2x16x16", ""): v for k, v in load(dir_, "*_2x16x16.json")}
    for key in sorted(single):
        if key.endswith(("_chunked", "_opt", "_capdata", "_capdata2", "_flash",
                         "_smdisp", "_opt1", "_opt2", "_final")):
            continue
        s, m = single[key], multi.get(key)
        stat = lambda r: ("skip" if r and "skipped" in r
                          else "FAIL" if r is None or "error" in r else "ok")
        cs = s.get("compile_s", "-")
        print(f"| {s.get('arch')} | {s.get('shape')} | {stat(s)} | {stat(m)} | {cs} |")


def roofline_table(dir_, suffix="_16x16"):
    print("\n### Roofline baseline (single pod, 256 chips; seconds per step)\n")
    print("| arch | shape | t_compute | t_memory | t_collective | bottleneck | useful | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    for key, r in load(dir_, f"*{suffix}.json"):
        if "roofline" not in r:
            continue
        rf = r["roofline"]
        print(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute_s']:.4f} | "
            f"{rf['t_memory_s']:.4f} | {rf['t_collective_s']:.4f} | "
            f"{rf['bottleneck']} | {rf['useful_flops_fraction']:.3f} | "
            f"{rf['roofline_fraction']:.4f} |"
        )


def compare(dir_, base, opts):
    print(f"\n#### {base}")
    print("| variant | t_compute | t_memory | t_collective | temp mem | roofline frac |")
    print("|---|---|---|---|---|---|")
    for name, path in [("baseline", base)] + opts:
        try:
            with open(os.path.join(dir_, path + ".json")) as f:
                r = json.load(f)
        except FileNotFoundError:
            continue
        if "roofline" not in r:
            print(f"| {name} | - | - | - | - | ERROR |")
            continue
        rf = r["roofline"]
        tb = r["scanned"]["memory"].get("temp_bytes", 0)
        print(
            f"| {name} | {rf['t_compute_s']:.3f} | {rf['t_memory_s']:.3f} | "
            f"{rf['t_collective_s']:.3f} | {fmt_bytes(tb)} | "
            f"{rf['roofline_fraction']:.4f} |"
        )


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
    if args.section in ("all", "dryrun"):
        dryrun_table(args.dir)
    if args.section in ("all", "roofline"):
        roofline_table(args.dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
