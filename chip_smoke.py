#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a traceback and a non-zero exit, no result):

  1. device — the card's name and power limit; no CUDA device is an error;
  2. build  — nvcc builds every kernel of the main path from the checkout's
     sources and prints ptxas's registers / shared memory / spills;
  3. kernels against their plain versions at md-mini day shapes (b=128) in
     three states (early, mid-epidemic, everyone infectious and
     susceptible): bitwise equality, times (CUDA events), the bound;
  4. the main path — EngineCore.single on md-mini, covid, seed 0, 200 days
     under torch.use_deterministic_algorithms(True), the day loop under
     torch.cuda.set_sync_debug_mode("error"): one kernel launch per day,
     edges == contacts every day, a monotone cumulative count above the
     seeds, and a bitwise-identical second run;
  5. reference — twin-2k, 30 days, on the card against the plain path on the
     CPU: the same trajectory up to float ulps in exp/log.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the reference
package ``repro``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATASET = "md-mini"
DAYS = 200
PROFILE_FROM = 21  # a profiled week near the epidemic's peak
BLOCK = 128
# H100 SXM published peaks (NVIDIA H100 datasheet): 3.35 TB/s of HBM and
# 67 TFLOP/s float32 outside the tensor cores. That float32 figure counts a
# fused multiply-add as two operations: it is 128 FP32 lanes per SM, so
# 33.5e12 float instructions per second. An SM has half as many INT32 lanes
# (64), so 16.75e12 integer instructions per second. Its four schedulers
# issue 128 thread-instructions per clock in all, the FP32 rate again. The
# kernel's u32/f32 work has no tensor-core path.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12 / 2
PEAK_INT32_OPS_PER_S = 67e12 / 4
PEAK_ISSUE_PER_S = 67e12 / 2
# The least work the function needs (csrc/interactions_compact.cu), as
# (integer, float) operations. Every pair of a live tile pays the validity
# test: pid >= 0, same loc, different pid (integer) and the overlap's min,
# max, subtract and > 0 (float). Only a valid pair pays the rest: min/max of
# the pids and the pick of their hashed words (4), three pair-dependent
# words of the hash fold (3 x 9: xor, then the murmur3 finalizer), the
# uniform's shift (1) and the count (2) in integers; the uniform's
# convert/multiply/add (3), the compare with p (1), rho's three products
# and sum (4) and inf > 0 (1) in floats. The inner hash of a word that is
# one visit's id (pid twice, loc) is per visit (3 x 9), the day's hash
# prefix is per day.
OPS_PER_PAIR = (3, 4)
OPS_PER_VALID_PAIR = (34, 9)
OPS_PER_VISIT = (27, 0)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def visit_inputs(core, person_sus, person_inf, dow, ops):
    """The interaction pass's inputs for one weekday and person channels,
    as the day step builds them (no interventions)."""
    w = {k: v[dow] for k, v in core.week.items()}
    pid = w["pid"]
    active = pid >= 0
    sus_v = person_sus[pid.clamp(min=0)] * active
    inf_v = person_inf[pid.clamp(min=0)] * active
    eff = torch.where(active, pid, -1)
    nb = pid.shape[0] // BLOCK
    meta = torch.stack([core.params.seed, torch.full_like(core.params.seed, dow)])
    return (eff, w["loc"], w["start"], w["end"], w["p"], sus_v, inf_v,
            w["row"], w["col"], w["pa"],
            ops.col_has_infectious(inf_v, eff, nb, BLOCK),
            ops.row_has_susceptible(sus_v, eff, nb, BLOCK), meta)


def pair_counts(kargs, n_live: int):
    """(pairs, valid pairs) in the live tiles: the data-dependent work."""
    pid, loc, start, end = kargs[:4]
    rows, cols = kargs[7][:n_live].long(), kargs[8][:n_live].long()
    blk = lambda a, idx: a.view(-1, BLOCK)[idx]
    valid = 0
    for s in range(0, n_live, 256):
        r, c = rows[s:s + 256], cols[s:s + 256]
        pr, pc = blk(pid, r)[:, :, None], blk(pid, c)[:, None, :]
        ov = (torch.minimum(blk(end, r)[:, :, None], blk(end, c)[:, None, :])
              - torch.maximum(blk(start, r)[:, :, None], blk(start, c)[:, None, :]))
        v = ((pr >= 0) & (pc >= 0) & (pr != pc) & (ov > 0)
             & (blk(loc, r)[:, :, None] == blk(loc, c)[:, None, :]))
        valid += int(v.sum())
    return n_live * BLOCK * BLOCK, valid


def bound(kargs, outs, n_live: int):
    """Least time the card could take: inputs read once and outputs written
    once at peak bandwidth, against this data's operations at peak rate.
    The INT32 and FP32 lanes run side by side, so the operations take the
    longest of integers at the INT32 rate, floats at the FP32 rate and both
    at the issue rate."""
    nbytes = sum(a.numel() * a.element_size() for a in kargs)
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    pairs, valid = pair_counts(kargs, n_live)
    visits = kargs[0].numel()
    n_int, n_float = (pairs * a + valid * b + visits * c for a, b, c in
                      zip(OPS_PER_PAIR, OPS_PER_VALID_PAIR, OPS_PER_VISIT))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 1e3 * max(n_int / PEAK_INT32_OPS_PER_S, n_float / PEAK_FP32_OPS_PER_S,
                      (n_int + n_float) / PEAK_ISSUE_PER_S)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, pairs, valid, n_int, n_float


def profile_days(core, state, card: str) -> None:
    """torch.profiler over one week of the main path from ``state``: device
    busy time per day, the idle share of the span the kernels cover, and
    device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        core.run_days(7, state=state)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log("[profile] torch.profiler recorded no device events: device time "
            "not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    by_name: dict = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    kern = [v for k, v in by_name.items() if "interactions_compact_kernel" in k]
    k_n, k_ms = kern[0] if kern else (0, 0.0)
    log(f"[profile] days {PROFILE_FROM}-{PROFILE_FROM + 6} (profiler on): "
        f"wall {wall_ms / 7:.3f} ms/day, device busy {busy / 7:.3f} ms/day over a "
        f"kernel span of {span / 7:.3f} ms/day, idle share "
        f"{1.0 - busy / span:.4f}; {len(dev) / 7:.1f} device ops/day; "
        f"interactions_compact_kernel {k_n} launches, {k_ms / 7:.4f} ms/day "
        f"({k_ms / busy:.4f} of device time); {card}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        log(f"[profile]   {ms / 7:9.4f} ms/day  {n / 7:6.1f}/day  {name[:110]}")


def main() -> int:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_epidemic
    from repro_torch.core import disease as disease_lib
    from repro_torch.core import transmission as tx_lib
    from repro_torch.engine import EngineCore, hist_to_numpy
    from repro_torch.kernels.interactions import kernel, ops

    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices={count}")

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    lib, ptxas = kernel.build()
    log(f"[build] {os.path.relpath(kernel.SOURCE, ROOT)} -> "
        f"{os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ---- phase 3: kernel against its plain version -------------------------
    epi = get_epidemic(DATASET)
    t0 = time.perf_counter()
    pop = epi.build()
    covid = disease_lib.covid_model()
    core = EngineCore.single(
        pop, covid, tx_lib.TransmissionModel(tau=epi.tau), seed=0,
        block_size=BLOCK, device="cuda",
    )
    torch.cuda.synchronize()
    log(f"[setup] {DATASET}: {pop.num_people} people, "
        f"{pop.num_locations} locations, V={core.week['pid'].shape[1]}, "
        f"NP={core.week['row'].shape[1]}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    P = pop.num_people
    dev = core.device
    rs = np.random.default_rng(0)
    tables = (torch.as_tensor(covid.susceptibility, device=dev),
              torch.as_tensor(covid.infectivity, device=dev))
    early = np.zeros(P, np.int32)  # everyone S, ten seeds presymptomatic
    early[rs.choice(P, 10, replace=False)] = covid.state_index("Ipre")
    mid = rs.choice(covid.num_states, size=P,
                    p=[0.45, 0.1, 0.1, 0.15, 0.1, 0.1]).astype(np.int32)
    beta_sus, beta_inf = core.params.beta_sus, core.params.beta_inf
    states = {}
    for label, health in (("early", early), ("mid", mid)):
        h = torch.as_tensor(health, device=dev).long()
        states[label] = (tables[0][h] * beta_sus, tables[1][h] * beta_inf)
    states["all"] = (beta_sus, beta_inf)  # everyone infectious and susceptible

    records = {}
    for label, (ps, pi) in states.items():
        args = visit_inputs(core, ps, pi, 0, ops)
        rc = ops.compact_schedule(*args[7:12])
        kargs = args[:7] + rc + args[10:]
        n_live = int(rc[3][0])
        out_k = kernel.interactions_compact_cuda(*kargs, block_size=BLOCK)
        out_p = kernel.interactions_compact_plain(*kargs, block_size=BLOCK)
        torch.cuda.synchronize()
        for what, a, b in zip(("acc", "cnt", "edges"), out_k, out_p):
            if not torch.equal(a, b):
                raise AssertionError(f"[{label}] kernel {what} != plain {what}")
        err = float((out_k[0] - out_p[0]).abs().max())
        ms = cuda_ms(lambda: kernel.interactions_compact_cuda(*kargs, block_size=BLOCK), 50)
        wrap_ms = cuda_ms(lambda: ops.interactions_compact_edges(*args, block_size=BLOCK), 50)
        plain_ms = cuda_ms(lambda: kernel.interactions_compact_plain(*kargs, block_size=BLOCK), 3)
        bound_ms, bound_by, pairs, valid, n_int, n_float = bound(kargs, out_k, n_live)
        records[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, max_abs_err=err)
        log(f"[kernel:{label}] bitwise equal to plain; live_tiles={n_live} "
            f"pairs={pairs} valid_pairs={valid} int_ops={n_int} "
            f"float_ops={n_float} edges={int(out_k[2])} "
            f"kernel_ms={ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) max_abs_err={err}")

    # ---- phase 4: the main path -------------------------------------------
    torch.use_deterministic_algorithms(True)

    def main_run():
        state = core.init_state1()
        torch.cuda.synchronize()
        kernel.interactions_compact_cuda.launches = 0
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            final, hist = core.run_days(DAYS, state=state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return final, hist_to_numpy(hist), kernel.interactions_compact_cuda.launches, dt

    final1, hist1, launches, dt1 = main_run()
    if launches != DAYS:
        raise AssertionError(f"{launches} kernel launches in {DAYS} days")
    if not np.array_equal(hist1["edges"], hist1["contacts"]):
        raise AssertionError("in-kernel edges != contacts on some day")
    cum = hist1["cumulative"]
    seeds = core.scenario.seed_per_day * core.scenario.seed_days
    if np.any(np.diff(cum) < 0) or cum[-1] <= seeds:
        raise AssertionError(f"cumulative not monotone or not above {seeds}: {cum}")
    final2, hist2, launches2, dt2 = main_run()
    for k in hist1:
        if not np.array_equal(hist1[k], hist2[k]):
            raise AssertionError(f"second run's '{k}' history differs")
    for f in ("health", "dwell", "cumulative", "vaccinated"):
        if not torch.equal(getattr(final1, f), getattr(final2, f)):
            raise AssertionError(f"second run's final '{f}' differs")
    edges = int(hist1["edges"].sum())
    log(f"[main] {DATASET} covid seed 0, {DAYS} days: launches={launches}, "
        f"cumulative={int(cum[-1])} ({100.0 * cum[-1] / P:.2f}%), "
        f"peak_infectious={int(hist1['infectious'].max())} on day "
        f"{int(np.argmax(hist1['infectious']))}, edges={edges}")
    log(f"[main] run 1: {1e3 * dt1 / DAYS:.3f} ms/day; run 2: "
        f"{1e3 * dt2 / DAYS:.3f} ms/day, {edges / dt2:.4g} traversed edges/s; "
        f"bitwise identical; {card}")

    # ---- phase 4b: where a day's time goes --------------------------------
    mid_state, _ = core.run_days(PROFILE_FROM)
    profile_days(core, mid_state, card)

    # ---- phase 5: reference on a small input ------------------------------
    torch.use_deterministic_algorithms(False)
    small = get_epidemic("twin-2k")
    spop = small.build()
    hists = {}
    for device in ("cuda", "cpu"):
        c = EngineCore.single(spop, covid, tx_lib.TransmissionModel(tau=small.tau),
                              seed=0, block_size=BLOCK, device=device)
        hists[device] = c.run1(30)[1]
    diff = [d for d in range(30)
            if any(hists["cuda"][k][d] != hists["cpu"][k][d] for k in hists["cpu"])]
    ar = {d: 100.0 * h["cumulative"][-1] / spop.num_people for d, h in hists.items()}
    if abs(ar["cuda"] - ar["cpu"]) > 5.0:
        raise AssertionError(f"twin-2k attack rates differ: {ar}")
    log(f"[reference] twin-2k 30 days, card vs CPU plain path: first differing "
        f"day {diff[0] if diff else None}; attack rate {ar['cuda']:.2f}% vs "
        f"{ar['cpu']:.2f}%")

    rec = records["mid"]
    log(card)
    log(json.dumps({"kernels": [{
        "name": "interactions_compact",
        "route": "cuda",
        "source": "src/repro_torch/csrc/interactions_compact.cu",
        "replaces": "src/repro/kernels/interactions/kernel.py:205",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records.values()),
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
