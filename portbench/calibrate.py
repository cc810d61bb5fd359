"""The readings a cell's limits are set from: the program's numbers against
the reference, and the control's, on several seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``) and then, besides the program's compared numbers, the
control's: the reference computed in bfloat16, a precision below the
configuration's float32, put in the program's place. The benchmark's own
runs never run the control. One JSON line per seed on standard output.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from portbench import harness  # noqa: E402


def main(argv=None, *, device="cuda", hooks=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    cell, config, traffic = harness.resolve(args.workload, hooks)
    if device == "cuda":
        harness.require_devices(int(cell["chips"]))
    harness.use_checkout_caches()
    loop = harness.loop(traffic)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = loop.run(config, traffic, seed=seed, seconds=args.seconds, trace=False,
                       started=time.time(), device=device, control_dtype=torch.bfloat16)
        line = {"workload": args.workload, "seed": seed,
                "program": {n: v for n, v, _ in out["checks"]}, "control": out["control"],
                "picked": out["picked"], "attempted": out["attempted"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
