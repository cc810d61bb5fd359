"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout. Finds the cell in ``BENCHMARK.json``,
its configuration in ``portbench/configs/``, its traffic in
``portbench/traffic/``; the traffic's ``kind`` names the loop, the module
``portbench/<kind>.py`` (``study``). The program under test
is ``repro_torch`` from ``src/``. Prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced, the
``breakdown``; each compared number beside its limit under ``checks``, and
on standard error.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from portbench import harness  # noqa: E402

#: Host threads for torch's CPU work: the card's host has eight cores, and a
#: run leaves room beside its own Python threads.
HOST_THREADS = 4


def main(argv=None, *, device="cuda", hooks=None) -> dict:
    """Run a cell; returns the result line's dict. ``device="cpu"`` (tests
    only) skips the look for a card; ``hooks`` overrides traffic or
    configuration keys (tests run a cell at a size a CPU holds)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if device == "cuda":  # a stuck run dumps every thread's stack and ends
        faulthandler.dump_traceback_later(340, exit=True)

    cell, config, traffic = harness.resolve(args.workload, hooks)
    if device == "cuda":
        harness.require_devices(int(cell["chips"]))
    harness.use_checkout_caches()
    import torch

    torch.set_num_threads(HOST_THREADS)
    loop = harness.loop(traffic)
    out = loop.run(config, traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), started=STARTED, device=device)

    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        raise SystemExit(4)
    record = out["record"]
    if out["differing"]:
        print(f"portbench: observables that differ: {out['differing'][:10]}", file=sys.stderr)
    print(f"portbench: {out['attempted']} attempted, {out['picked']} sampled for the reference",
          file=sys.stderr)
    metrics = {}
    for m in harness.metric_names(args.workload, bool(args.trace)):
        if args.trace:
            value = harness.read_metric(m["name"], record)
        elif m["name"] == "setup_s":
            value = out["setup_s"]
        else:
            value = out.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = out["checks"]
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": (harness.device_record(int(cell["chips"]), out["memory_peak_bytes"])
                   if device == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 0,
                                             "memory_peak_bytes": 0}),
    }
    if args.trace and record["trace"] is not None:
        t = record["trace"]
        result["device"]["busy_s"] = t.busy_s()
        result["device"]["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    if device == "cuda":
        print(f"portbench: {args.workload} on {harness.power_limit()}", file=sys.stderr)
    harness.emit(result, checks)
    return result


if __name__ == "__main__":
    main()
