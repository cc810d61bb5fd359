"""Scenario-ensemble driver — a thin wrapper over ``repro_torch.api.run``.

    PYTHONPATH=src python -m repro_torch.launch.sweep --dataset twin-2k --days 60 \
        --interventions none,school-closure,lockdown --replicates 3 \
        --tau-scales 1.0,0.75 --out artifacts/sweep.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --dataset twin-2k \
        --days 12 --interventions none,lockdown --replicates 2 --device cpu

The flags build (or, with ``--spec``, override) a declarative
:class:`~repro_torch.api.ExperimentSpec` whose sweep axes (interventions x
tau x replicate seeds) expand to a ScenarioBatch; the facade runs it as the
ensemble engine, the whole batch in one batched day loop on ``--device``,
and this prints per-scenario attack-rate summaries plus ensemble throughput
(TEPS x batch). ``--scenarios S`` shards the batch over S ranks and
``--workers W`` each scenario's people over W (``launch/cli.py``):

    PYTHONPATH=src python -m repro_torch.launch.sweep --dataset twin-2k \
        --days 12 --replicates 4 --scenarios 2 --device cpu
"""

from __future__ import annotations

import argparse
import json

from repro_torch.analysis.report import sweep_table
from repro_torch.launch import cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_common_args(ap)
    ap.add_argument("--interventions", default=None,
                    help="comma list of preset names "
                         "(see repro_torch/configs/presets.py)")
    ap.add_argument("--tau-scales", default=None,
                    help="comma list of multipliers on the base tau")
    args = ap.parse_args(argv)

    extra = {}
    if args.interventions is not None:
        extra["interventions"] = cli.parse_intervention_axis(args.interventions)
    if args.tau_scales is not None:
        extra["tau_scales"] = cli.parse_float_axis(args.tau_scales, "--tau-scales")
    spec = cli.build_spec(args, dict(
        name="sweep", days=60,
        interventions=("none", "school-closure"), replicates=2,
    ), **extra)

    result = cli.run(spec, args.device, args.backend_dist)
    if not cli.is_rank0():
        return
    prov = result.provenance
    print(f"dataset={result.spec.dataset} engine={prov['engine']} "
          f"scenarios={result.num_scenarios} days={result.days} "
          f"devices={prov['num_devices']} device={prov['jax_backend']}")
    sweep_table(result.summaries)
    edges = float(sum(r["interactions"] for r in result.summaries))
    # Throughput from the day-loop wall clock (excluding the population build).
    wall = prov["run_wall_s"]
    print(json.dumps({
        "dataset": result.spec.dataset,
        "engine": prov["engine"],
        "device": prov["jax_backend"],
        "scenarios": result.num_scenarios,
        "days": result.days,
        "wall_s": wall,
        "s_per_scenario_day": round(wall / (result.days * result.num_scenarios), 5),
        "ensemble_teps": round(edges / wall, 1) if wall else None,
    }))
    if args.out:
        result.save(args.out)  # creates parent dirs


if __name__ == "__main__":
    main()
