"""What every cell of the benchmark shares: finding the pieces of a cell by
name, the device record, the check that no JAX module was loaded, and the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``configs/<config>.json`` and ``traffic/<traffic>.json``
beside this file, runs the loop the mix names (its ``kind``), and reads
each per-layer metric with ``metrics/<name>.py``. Nothing here names a
cell: a new cell is new files and a new entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level module names that must never be loaded: JAX, its relatives
#: and the JAX package of this repository (whole names: ``repro_torch`` is
#: the program and passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def resolve(workload: str, hooks: dict = None) -> tuple:
    """``(cell, config, traffic)`` of the cell named ``workload``; ``hooks``
    (tests only) overrides keys, as ``{"config.key" | "traffic.key" |
    "twin.key": value}``, to cut a cell to a size a CPU holds."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    for key, value in (hooks or {}).items():
        where, name = key.split(".", 1)
        ({"config": config, "traffic": traffic, "twin": config["twin"]}[where])[name] = value
    return cell, config, traffic


def loop(traffic: dict):
    """The module that runs a traffic mix: ``portbench/<kind>.py``."""
    return importlib.import_module("portbench." + traffic["kind"])


def metric_names(workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer metrics."""
    bench = benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metric(name: str, run: dict):
    """The reading of per-layer metric ``name`` from ``metrics/<name>.py``
    (its ``read(run)``), or None where it finds nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def require_devices(count: int):
    """Exit without a result unless ``count`` CUDA devices are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        print(f"portbench: needs {count} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        raise SystemExit(3)


def use_checkout_caches() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths (the
    program builds its nvcc libraries under ``src/repro_torch/build``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_record(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def emit(result: dict, checks: list) -> None:
    """Print each compared number beside its limit on standard error, then
    the result line (``checks`` last in it) on standard output."""
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    result["checks"] = {name: {"value": _number(value), "limit": limit}
                        for name, value, limit in checks}
    print(json.dumps(result, allow_nan=False))


def _number(x):
    """A compared number for the JSON line (a non-finite one as text)."""
    x = float(x)
    return (int(x) if x.is_integer() else x) if math.isfinite(x) else str(x)
