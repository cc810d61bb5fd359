"""The study loop: whole ``repro_torch.api.run`` calls back to back, as a
modeller runs a sensitivity study.

Traffic (``kind: "study"``): every preset of the configuration crossed with
``tau_scales`` and ``replicates`` scenarios, ``days`` days, the named
``observables``. Study i of a run takes its Monte Carlo seed from
(``--seed``, i); every study has the same shape. Set-up builds the twin,
hands it to the program as its ``Population`` and runs one short study of
the same shapes (the kernels' build, the week's first upload). The window
starts studies while ``--seconds`` have not passed and finishes the one in
flight; the rate is all their scenario-days over the time from the first
call's start to the last call's end.

``correct``: after the window, a sample of scenarios drawn from the seed
(one of each preset, plus ``sample_extra`` more) is run by the reference
and compared entry by entry; every study's observables are held to their
definitions over its history. A traced run profiles the window's first
study and runs the reference over all of its scenarios, which also counts
that study's susceptible-infectious pairs for the roofline reader.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import check
from portbench import twin as twin_lib
from portbench.reference import sim
from portbench.reference import week as week_lib
from portbench.trace import Slice


WARMUP = 2 ** 32  # the index of the set-up study's seed


def study_seed(seed: int, index: int) -> int:
    return int(np.random.default_rng([int(seed) % 2 ** 64, index]).integers(0, 2 ** 31))


def make_spec(config: dict, traffic: dict, seed: int, days: int):
    from repro_torch import api

    return api.ExperimentSpec(
        name=f"{config['name']}-study", dataset=config["dataset"],
        disease=config["disease"]["name"], days=days,
        interventions=tuple(config["presets"]), tau=float(config["tau"]),
        tau_scales=tuple(traffic["tau_scales"]), replicates=int(traffic["replicates"]),
        seed=seed, seed_per_day=int(config["seed_per_day"]),
        seed_days=int(config["seed_days"]), backend=config["backend"],
        block_size=int(config["block_size"]), observables=tuple(traffic["observables"]))


def scenario(config: dict, traffic: dict, spec_seed: int, col: int) -> tuple:
    """(preset name, seed, tau) of column ``col`` of a study."""
    n_tau, n_rep = len(traffic["tau_scales"]), int(traffic["replicates"])
    preset = list(config["presets"])[col // (n_tau * n_rep)]
    tau = float(config["tau"]) * float(traffic["tau_scales"][(col // n_rep) % n_tau])
    return preset, spec_seed + col % n_rep, tau


def run(config, traffic, *, seed, seconds, trace, started, device="cuda",
        control_dtype=None):
    from repro_torch import api

    presets = list(config["presets"])
    B = len(presets) * len(traffic["tau_scales"]) * int(traffic["replicates"])
    days = int(traffic["days"])
    phases = [time.time()]
    twin = twin_lib.generate(config["twin"], name=config["dataset"])
    phases.append(time.time())
    pop = twin_lib.to_program_population(twin, config["contact_model"],
                                         int(config["twin"]["pad_multiple"]))
    phases.append(time.time())
    api.run(make_spec(config, traffic, study_seed(seed, WARMUP), int(traffic["warmup_days"])),
            population=pop, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases.append(time.time())
    setup_s = time.time() - started
    print("portbench: set-up s: start to the loop {:.3f}, twin {:.3f}, population {:.3f}, "
          "warm-up study {:.3f}".format(phases[0] - started, *(b - a for a, b in zip(
              phases, phases[1:]))), file=sys.stderr)

    studies, traced = [], None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        s = study_seed(seed, len(studies))
        spec = make_spec(config, traffic, s, days)
        if trace and traced is None:
            with Slice("study") as traced, torch.profiler.record_function("api.run"):
                res = api.run(spec, population=pop, device=device)
        else:
            res = api.run(spec, population=pop, device=device)
        studies.append({"seed": s, "history": res.history, "observables": res.observables,
                        "provenance": res.provenance, "end": time.perf_counter()})
        print(f"portbench: study {len(studies)}: wall_s {res.provenance['wall_s']}, "
              f"run_wall_s {res.provenance['run_wall_s']}", file=sys.stderr, flush=True)
    elapsed = studies[-1]["end"] - t0
    if all("edges_total" in st["provenance"] for st in studies):
        edges = sum(st["provenance"]["edges_total"] for st in studies)
        print(f"portbench: edges_per_scenario_day {edges / (len(studies) * B * days)}",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del res
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- correct ---------------------------------------------------------
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    picks = []  # (study, column)
    per_preset = B // len(presets)
    for p in range(len(presets)):
        picks.append((int(rng.integers(len(studies))), p * per_preset
                      + int(rng.integers(per_preset))))
    for _ in range(int(traffic["sample_extra"])):
        picks.append((int(rng.integers(len(studies))), int(rng.integers(B))))
    if traced is not None:  # the profiled study, whole
        picks += [(0, c) for c in range(B)]
    picks = sorted(set(picks))
    week = week_lib.Week(twin, config["contact_model"], int(config["block_size"]), device)

    def reference(fdt):
        out = {}
        for preset in presets:
            cols = [(i, c) for i, c in picks
                    if scenario(config, traffic, studies[i]["seed"], c)[0] == preset]
            for lo in range(0, len(cols), int(traffic["reference_batch"])):
                chunk = cols[lo:lo + int(traffic["reference_batch"])]
                sc = [scenario(config, traffic, studies[i]["seed"], c) for i, c in chunk]
                h = sim.simulate(week, twin, config, config["presets"][preset],
                                 [x[1] for x in sc], [x[2] for x in sc], days, device=device,
                                 fdt=fdt, pair_counts=traced is not None)
                for n, key in enumerate(chunk):
                    out[key] = {k: v[:, n] for k, v in h.items()}
        return out

    ref_hist = reference(torch.float32)
    program = {(i, c): {k: studies[i]["history"][k][:, c] for k in sim.STAT_KEYS}
               for i, c in picks}
    mismatches = sum(check.history_mismatches(program[p], ref_hist[p]) for p in picks)
    names = traffic["observables"]
    axes = check.sweep_axes(len(presets), len(traffic["tau_scales"]), int(traffic["replicates"]))
    obs_bad, gap, where = 0, 0.0, set()
    for st in studies:
        obs_bad += check.count_mismatches(
            st["observables"], check.exact_observables(st["history"], names), where)
        gap = max(gap, check.widest_gap(st["observables"], check.float_observables(
            st["history"], names, twin.num_people, axes)))
    limits = traffic["limits"]
    checks = [("history_mismatches", mismatches, limits["history_mismatches"]),
              ("observable_mismatches", obs_bad, limits["observable_mismatches"]),
              ("float_gap", gap, limits["float_gap"])]
    control = None
    if control_dtype is not None:  # the reference in the program's place, a precision below
        low = reference(control_dtype)
        control = {
            "history_mismatches": sum(check.history_mismatches(low[p], ref_hist[p])
                                      for p in picks),
            "float_gap": max(check.widest_gap(
                check.float_observables(st["history"], names, twin.num_people, axes,
                                        control_dtype),
                check.float_observables(st["history"], names, twin.num_people, axes))
                for st in studies)}

    record = {
        "kind": "study", "studies": [st["provenance"] for st in studies],
        "scenarios": B, "days": days, "trace": traced,
        "visits": [len(d[0]) for d in twin.days],
    }
    if traced is not None:
        record["traced_pairs"] = np.stack([ref_hist[(0, c)]["sus_inf_pairs"]
                                           for c in range(B)], axis=1)
    return {
        "attempted": len(studies) * B, "failed": 0, "setup_s": setup_s,
        "study_scenario_days_per_s": len(studies) * B * days / elapsed,
        "memory_peak_bytes": peak, "checks": checks, "record": record,
        "picked": len(picks), "control": control, "differing": sorted(where),
    }
