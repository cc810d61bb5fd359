"""Run one epidemic with the PyTorch port and print its summary.

    PYTHONPATH=src python -m repro_torch.launch.simulate --dataset md-mini --days 200
    PYTHONPATH=src python -m repro_torch.launch.simulate --dataset twin-2k \
        --days 30 --interventions vax-seniors --device cpu

A thin front end over ``EngineCore.single(...).run1(days)``: one scenario on
one device (the card unless ``--device cpu``). It prints the same
per-scenario summary fields as the reference's ``repro.launch.simulate``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import DISEASES, INTERVENTION_PRESETS, get_epidemic
from repro_torch.core import transmission as tx_lib
from repro_torch.engine import EngineCore


def summary_row(name: str, hist: dict, num_people: int) -> dict:
    """The headline intervention-study metrics of one scenario's history."""
    cum, infectious = hist["cumulative"], hist["infectious"]
    return {
        "scenario": name,
        "cumulative": int(cum[-1]),
        "attack_rate_pct": round(100.0 * int(cum[-1]) / num_people, 2),
        "peak_infectious": int(infectious.max()),
        "peak_day": int(np.argmax(infectious)),
        "interactions": int(np.asarray(hist["contacts"], np.int64).sum()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="twin-2k",
                    help="epidemic dataset name (configs/epidemics.py)")
    ap.add_argument("--disease", default="covid", choices=sorted(DISEASES))
    ap.add_argument("--days", type=int, default=100)
    ap.add_argument("--tau", type=float, default=None,
                    help="transmissibility (default: the dataset's)")
    ap.add_argument("--seed", type=int, default=0, help="Monte Carlo seed")
    ap.add_argument("--interventions", default="none",
                    choices=sorted(INTERVENTION_PRESETS),
                    help="intervention preset for this run")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU only on request)")
    args = ap.parse_args(argv)

    if args.days < 1:
        raise SystemExit("error: --days must be at least 1")
    t0 = time.time()
    epi = get_epidemic(args.dataset)
    pop = epi.build()
    tau = args.tau if args.tau is not None else epi.tau
    core = EngineCore.single(
        pop, DISEASES[args.disease](), tx_lib.TransmissionModel(tau=tau),
        interventions=INTERVENTION_PRESETS[args.interventions],
        seed=args.seed, name=args.interventions, device=args.device,
    )
    t1 = time.time()
    _, hist = core.run1(args.days)
    t2 = time.time()
    print(f"dataset={args.dataset} engine=single device={core.device} "
          f"scenarios=1 days={args.days}")
    print(json.dumps(summary_row(args.interventions, hist, pop.num_people)), flush=True)
    print(json.dumps({"engine": "single", "wall_s": round(t2 - t0, 3),
                      "build_s": round(t1 - t0, 3), "run_s": round(t2 - t1, 3)}))


if __name__ == "__main__":
    main()
