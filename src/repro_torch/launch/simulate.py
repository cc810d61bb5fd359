"""Epidemic simulation driver — a thin wrapper over ``repro_torch.api.run``.

    PYTHONPATH=src python -m repro_torch.launch.simulate --dataset md-mini --days 200
    PYTHONPATH=src python -m repro_torch.launch.simulate --dataset twin-2k \
        --days 30 --interventions vax-seniors --device cpu
    PYTHONPATH=src python -m repro_torch.launch.simulate --dataset md-mini \
        --days 200 --interventions tti --backend pallas
    PYTHONPATH=src python -m repro_torch.launch.simulate --spec examples/experiment.toml
    PYTHONPATH=src python -m repro_torch.launch.simulate --dataset twin-2k \
        --days 60 --ckpt-dir build/ckpt --ckpt-every 20 --resilient --device cpu
    PYTHONPATH=src python -m repro_torch.launch.simulate --dataset twin-2k \
        --days 30 --workers 2 --device cpu

The flags build (or, with ``--spec``, override) a declarative
:class:`~repro_torch.api.ExperimentSpec`, as the reference's
``repro.launch.simulate`` does, and run it on ``--device`` (the card unless
``--device cpu``). It prints one summary row per scenario, with the
reference's fields. With ``--ckpt-dir`` the run is checkpointed every
``--ckpt-every`` days and resumes from the newest valid snapshot there
(the last line's ``resumed_from_day``); ``--resilient`` adds the recovery
policy and prints what it did. ``--workers W`` runs the ``dist`` engine on
W ranks (``launch/cli.py``).
"""

from __future__ import annotations

import argparse
import json

from repro_torch import api
from repro_torch.configs.presets import INTERVENTION_PRESETS
from repro_torch.launch import cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_common_args(ap)
    ap.add_argument("--interventions", default=None,
                    choices=sorted(INTERVENTION_PRESETS),
                    help="single intervention preset for this run")
    args = ap.parse_args(argv)

    extra = {}
    if args.interventions is not None:
        extra["interventions"] = (args.interventions,)
    spec = cli.build_spec(args, dict(
        name="simulate", days=100, interventions=("none",), replicates=1,
        backend="pallas-compact",
    ), **extra)
    result = cli.run(spec, args.device, args.backend_dist)
    if not cli.is_rank0():
        return
    prov = result.provenance
    print(f"dataset={result.spec.dataset} engine={prov['engine']} "
          f"device={prov['jax_backend']} backend={result.spec.backend} "
          f"scenarios={result.num_scenarios} days={result.days}")
    for row in result.summaries:
        print(json.dumps(row), flush=True)
    print(json.dumps({k: prov[k] for k in ("engine", "wall_s", "run_wall_s", "chunks",
                                           "resumed_from_day")}))
    if "resilience" in prov:
        print(json.dumps({"resilience": prov["resilience"]}))
    if args.out:
        result.save(args.out)


if __name__ == "__main__":
    main()
