"""Multi-pod dry run: build and run every (arch x shape x mesh) cell on
``meta`` tensors in a fake world (the reference's ``repro/launch/dryrun.py``).

For each cell this proves the distribution config is coherent on the
production mesh (16 x 16 single-pod / 2 x 16 x 16 multi-pod) and extracts
the roofline measurements:

  1. run the production step once on ``meta`` DTensors placed by
     ``launch/steps.py``'s shardings -> the proof, and the per-rank
     measurement (``analysis/hlo.py:measure_compiled``);
  2. unless ``--quick``, run the 1- and 2-unit variants and record their
     extrapolation to full depth beside it (see below);
  3. write artifacts/dryrun/<arch>_<shape>_<mesh>.json

The reference compiles on 512 fake host devices; the port runs one process
as rank 0 of a fake world of 256 or 512 ranks (torch's ``"fake"`` backend:
collectives are accepted and move no data) on a ``cpu`` ``DeviceMesh``,
with every tensor on ``meta`` (shapes and dtypes, no storage): nothing is
computed, yet every op dispatches with this rank's local shapes. A DTensor
strategy that is missing, or an op that has no ``meta`` kernel, fails the
cell as ``error``, as a failed XLA compile does. ``lower_s`` is the wall
time of building and placing the abstract arguments, ``compile_s`` that of
running the step once under the meter (there is no compile).

No loop undercount: the port's layers are a Python loop, so the dispatcher
sees every layer and the full-depth count needs no correction. The 1- and
2-unit runs (family-aware: a hybrid's unit is its block pattern) are kept as
a cross-check, ``m1``, ``m2`` and ``corrected = m1 + (L - 1)(m2 - m1)`` as
the reference records them; for a dense arch ``corrected`` equals the
full-depth count. The roofline row is computed in every mode, from
``corrected`` when it exists (the reference's choice) and from the
full-depth count under ``--quick`` (where the reference has none).

The cpu mesh has one difference from a CUDA one: DTensor turns a shard to
shard redistribution into an all-gather and a chunk on cpu meshes, where a
CUDA mesh runs an all-to-all, so the collective bytes of such steps are
the all-gather's.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--quick]
  python -m repro_torch.launch.dryrun --epidemic md-mini [--multi-pod]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import hlo as hlo_lib
from repro_torch.analysis import roofline as rf
from repro_torch.configs import ARCHS, LM_SHAPES, get_config, get_shape, supports_shape
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh, mesh_num_devices
from repro_torch.models import model as M
from repro_torch.models.sharding import MeshRules
from repro_torch.optim import AdamWConfig

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun")


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``size``-rank world on torch's fake
    backend, when no process group exists (destroyed on exit); an existing
    group of that size is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a dry run of {size} ranks inside a world of "
                               f"{dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool, mesh_shape):
    """The production mesh, or (tests) a smaller ``(data, model)`` one."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    from torch.distributed.device_mesh import init_device_mesh

    names = ("pod", "data", "model")[-len(mesh_shape):]
    return init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=names)


def _place(trees, shardings) -> tuple:
    return tuple(steps_lib.place(t, s) for t, s in zip(trees, shardings))


def _cell_programs(cfg, shape, rules, mesh):
    """(fn, placed abstract args)."""
    mtp = shape.seq_len + 8
    params_abs = M.abstract_params(cfg, mtp)
    if shape.kind == "train":
        opt_abs = steps_lib.abstract_opt_state(params_abs)
        batch_abs = M.input_specs(cfg, shape)
        in_s, _ = steps_lib.train_shardings(cfg, shape, rules, mesh, mtp)
        fn = steps_lib.make_train_step(cfg, AdamWConfig(), rules)
        return fn, _place((params_abs, opt_abs, batch_abs), in_s)
    if shape.kind == "prefill":
        batch_abs = M.input_specs(cfg, shape)
        in_s, _ = steps_lib.prefill_shardings(cfg, shape, rules, mesh, None, mtp)
        fn = torch.no_grad()(steps_lib.make_prefill_step(cfg, rules))
        return fn, _place((params_abs, batch_abs), in_s)
    # decode: one step at the cache's last position, then argmax
    spec = M.input_specs(cfg, shape)
    in_s, _ = steps_lib.decode_shardings(cfg, shape, rules, mesh, spec["cache"], mtp)
    placed = _place((params_abs, spec["cache"], spec["token"]), in_s[:3])
    step = torch.no_grad()(steps_lib.make_decode_step(cfg, rules))
    return (lambda p, c, t: step(p, c, t, shape.seq_len - 1)), placed


def _measure(cfg, shape, rules, mesh):
    t0 = time.perf_counter()
    fn, args = _cell_programs(cfg, shape, rules, mesh)
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    meas = hlo_lib.measure_compiled(fn, *args)
    return meas, lower_s, time.perf_counter() - t0


def _reduced_layers_cfg(cfg, units: int):
    """Config with `units` layer-units (family-aware)."""
    if cfg.family == "hybrid":
        pat = len(cfg.block_pattern)
        return dataclasses.replace(cfg, num_layers=units * pat), pat
    if cfg.family == "audio":
        return dataclasses.replace(cfg, num_layers=units, enc_layers=units), 1
    return dataclasses.replace(cfg, num_layers=units), 1


def _dropped(cfg, shape, mesh, overrides) -> list:
    """The sharding guard's events (``MeshRules.dropped``) as the
    reference's scanned program records them: the shardings' specs, then one
    trace of the step's forward, in which a scanned layer body is traced
    once. The port's layer loop asks the rules once per layer (and its
    backward's remat again), so the trace here is a forward without grad
    over one layer unit (a hybrid's pattern cycle; the reference also traces
    the layers past the last whole cycle, which this does not)."""
    cfg1, _ = _reduced_layers_cfg(cfg, 1)
    rules = MeshRules.for_mesh(mesh, overrides)
    fn, args = _cell_programs(cfg1, shape, rules, mesh)
    with torch.no_grad():
        if shape.kind == "train":
            M.forward_train(cfg1, args[0], args[2], rules)
        else:
            fn(*args)
    return [f"{ax}:{dim}%{size} {why}" for (axes, ax, dim, size, why) in rules.dropped]


def compile_cell(arch: str, shape_name: str, multi_pod: bool, *,
                 quick: bool = False, overrides=None, cfg_overrides=None,
                 cfg=None, mesh_shape=None):
    """One cell's record. ``cfg`` (a ``ModelConfig``) replaces the arch's
    preset and ``mesh_shape`` the production mesh (tests: reduced configs
    on a small fake world); the fake world is made here if none exists."""
    cfg = cfg if cfg is not None else get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    ok, why = supports_shape(cfg, shape)
    record = {
        "arch": arch, "shape": shape.name,
        "mesh": ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16"),
        "kind": shape.kind,
    }
    if not ok:
        record["skipped"] = why
        return record

    size = mesh_num_devices(tuple(mesh_shape) if mesh_shape else
                            (2, 16, 16) if multi_pod else (16, 16))
    with fake_world(size):
        mesh = _mesh(multi_pod, mesh_shape)
        chips = mesh_num_devices(mesh)
        rules = MeshRules.for_mesh(mesh, overrides)
        record["chips"] = chips
        record["param_count"] = M.param_count(cfg)
        record["active_param_count"] = M.param_count(cfg, active_only=True)

        # --- 1. the production step on meta DTensors: THE dry-run proof ---
        meas, lower_s, compile_s = _measure(cfg, shape, rules, mesh)
        record["lower_s"], record["compile_s"] = round(lower_s, 2), round(compile_s, 2)
        record["scanned"] = meas
        record["dropped_shardings"] = _dropped(cfg, shape, mesh, overrides)
        # the flash kernel is not seen by the dispatcher (meta: it computes
        # nothing): add its exact analytic attention flops (forward only;
        # training attends through the chunked softmax)
        add = (rf.analytic_attention_flops(cfg, shape) / chips
               if cfg.attn_impl == "flash" and shape.kind != "train" else 0.0)
        totals = {"flops": meas["flops"] + add, "bytes_accessed": meas["bytes_accessed"],
                  "collective_total_bytes": meas["collectives"]["total_bytes"]}

        if not quick:
            # --- 2. the 1-/2-unit runs: the extrapolation, cross-checked ---
            ms = []
            for units in (1, 2):
                cfg_n, pat = _reduced_layers_cfg(cfg, units)
                rules_n = MeshRules.for_mesh(mesh, overrides)
                ms.append(_measure(cfg_n, shape, rules_n, mesh)[0])
            record["m1"], record["m2"] = ms
            totals = rf.extrapolate_layers(ms[0], ms[1], cfg.num_layers,
                                           layers_per_unit=pat)
            totals["flops"] += add
            record["corrected"] = totals
        if add:
            record["flash_analytic_flops_per_chip"] = add
        mf = rf.model_flops(cfg, shape, record["param_count"],
                            record["active_param_count"])
        record["model_flops_global"] = mf
        record["roofline"] = rf.roofline_from_measurements(totals, mf, chips).row()
    return record


def _tree_bytes(obj) -> int:
    """Bytes of the tensors and numpy arrays in a tree of dicts, sequences
    and dataclasses."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_tree_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tree_bytes(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tree_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def run_epidemic_dryrun(dataset: str, multi_pod: bool, *, workers=None):
    """Build the distributed epidemic day on the production world flattened
    to 1-D workers (256 ranks, 512 multi-pod; ``workers`` overrides it for
    tests) and run one day, as rank 0 of a fake world: the ``workers``
    layout's plan for every worker, then rank 0's tables, parameters and
    state, on the CPU (the reference lowers and compiles its one-day
    program).

    The fake backend moves no data: a received buffer stays as it was made
    (uninitialised), so the day's values mean nothing and none is recorded.
    Its indexing and control flow read only the plan's host-built routes,
    so the day runs: ``day_s`` is its wall time, ``measured`` its per-rank
    measurement (``measure_compiled``: collectives by kind and operand
    bytes, bytes moved) and ``topology`` the mesh topology's own counters
    (calls and bytes sent, by kind)."""
    from repro_torch.configs import get_epidemic
    from repro_torch.core import disease as disease_lib
    from repro_torch.core import transmission as tx
    from repro_torch.engine.core import EngineCore
    from repro_torch.launch.mesh import make_worker_mesh

    n = workers or (512 if multi_pod else 256)
    epi = get_epidemic(dataset)
    pop = epi.build()
    with fake_world(n):
        t0 = time.perf_counter()
        core = EngineCore.single(
            pop, disease_lib.covid_model(), tx.TransmissionModel(tau=epi.tau),
            seed=epi.seed, layout="workers", mesh=make_worker_mesh(n), device="cpu",
        )
        state = core.init_state()
        build_s = time.perf_counter() - t0
        core.topo.reset_counts()
        t0 = time.perf_counter()
        meas = hlo_lib.measure_compiled(lambda: core.run_days(1, state=state))
        day_s = time.perf_counter() - t0
        topology = {"counts": dict(core.topo.counts),
                    "bytes_sent": dict(core.topo.bytes_sent)}
    return {
        "epidemic": dataset, "workers": n,
        "pop": pop.stats(),
        "build_s": round(build_s, 2),
        "day_s": round(day_s, 2),
        "compile_s": round(build_s + day_s, 2),
        "day": "run: received buffers unwritten (fake backend), no value recorded",
        "bytes": {"plan_all_workers": _tree_bytes(core.plan), "tables": _tree_bytes(core.week),
                  "params": _tree_bytes(core.params), "state": _tree_bytes(state)},
        "measured": meas,
        "topology": topology,
    }


def _cast(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="skip the 1-/2-unit cross-check runs")
    ap.add_argument("--epidemic", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig overrides, e.g. --set attn_impl=chunked")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding-rule overrides, e.g. --rule expert_cap=data"
                         " (value 'none' clears; comma for tuples)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)

    cfg_overrides = {k: _cast(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    rule_overrides = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        rule_overrides[k] = None if v == "none" else tuple(v.split(",")) if "," in v else v

    out_dir = args.out or os.path.abspath(ART_DIR)
    os.makedirs(out_dir, exist_ok=True)

    if args.epidemic:
        rec = run_epidemic_dryrun(args.epidemic, args.multi_pod)
        path = os.path.join(out_dir, f"epidemic_{args.epidemic}_{rec['workers']}w.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
        print(json.dumps(rec, indent=1, default=float))
        return 0

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    n_ok = n_skip = n_fail = 0
    for a, s, mp in cells:
        tag = f"{a}_{s}_{'2x16x16' if mp else '16x16'}" + (f"_{args.tag}" if args.tag else "")
        path = os.path.join(out_dir, tag + ".json")
        t0 = time.perf_counter()
        try:
            rec = compile_cell(a, s, mp, quick=args.quick,
                               cfg_overrides=cfg_overrides or None,
                               overrides=rule_overrides or None)
            rec["cfg_overrides"] = cfg_overrides
            rec["rule_overrides"] = {k: str(v) for k, v in rule_overrides.items()}
            if "skipped" in rec:
                n_skip += 1
                print(f"[skip] {tag}: {rec['skipped']}", flush=True)
            else:
                n_ok += 1
                r = rec.get("roofline", {})
                print(
                    f"[ok]   {tag}: compile={rec['compile_s']}s "
                    f"flops/chip={rec['scanned']['flops']:.3g} "
                    f"bottleneck={r.get('bottleneck', '?')} "
                    f"roofline_frac={r.get('roofline_fraction', 0):.3f} "
                    f"wall={time.perf_counter() - t0:.2f}s",
                    flush=True,
                )
        except Exception as e:  # noqa: BLE001 — a failed cell is recorded, as a failed compile
            n_fail += 1
            rec = {"arch": a, "shape": s, "mesh": tag, "error": repr(e),
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {tag}: {e!r} wall={time.perf_counter() - t0:.2f}s", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
