#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --interactions-only SRC_DIR

The second form runs phases 1 and 3 alone on the interaction kernels of the
checkout whose src/ directory is given (an earlier commit's, unpacked with
git archive, to time its kernels beside this one's in one call).

Phases, each fatal on failure (a traceback and a non-zero exit, no result):

  1. device — the card's name and power limit; no CUDA device is an error;
  2. build  — nvcc builds the interaction kernels (one source, four
     instantiations) and the flash-attention kernels (one source: the bf16
     wgmma/TMA design at Dh 64/128/256 and the float32 FP32-lane design at
     the same three), both at once, from the checkout's sources and prints
     ptxas's registers / shared memory / spills for each;
  3. kernels against their plain versions at md-mini day shapes (b=128) in
     four states (early, mid-epidemic, everyone infectious and susceptible,
     and "shuffled": the mid inputs with the visits permuted inside each
     block, so a location's visits are not contiguous), with a
     tracing-source vector on ~1% of the infectious visits: each of the four
     kernels bitwise equal to its plain version, padded bitwise equal to
     compacted; the pair counts; times by CUDA events around back-to-back
     calls and device alone (the stream asleep first), the wrapper's host
     time per call, and the bound under this model and PR 11-14's;
  3b. the scenario axis — the four kernels at B = 4 (one scenario in each
     state, the batch sharing the week's layout: "shuffled" permutes only the
     per-scenario arrays) in one launch each, bitwise equal to the plain
     version and, per scenario, to its own B = 1 launch; at B = 8 timed on
     both timers beside eight B = 1 launches, the plain version and the
     bound (these B = 8 numbers fill the kernels' JSON record);
  4. one scenario — EngineCore.single on md-mini, covid, seed 0, 200 days
     under torch.use_deterministic_algorithms(True), the day loop under
     torch.cuda.set_sync_debug_mode("error"): one kernel launch per day,
     edges == contacts every day, a monotone cumulative count above the
     seeds, and a bitwise-identical second run; then the same run on the
     "pallas" backend, bitwise equal, through the padded kernel;
  4b. where a day's time goes (torch.profiler over one week);
  4c. the TTI path — the same run with the "tti" preset on each backend:
     one launch per day of that backend's traced kernel, edges == contacts,
     the test budget kept, tests/isolation/tracing all used, the backends'
     histories and final states bitwise equal, a bitwise-identical second
     run of each; ms/day and traversed edges/s; a profiled TTI week;
  4d. the main path: scenario batches — the md-mini B = 8 ensemble (presets
     none, lockdown, school-closure, vax-seniors x 2 replicates) for 200 days
     on each backend, the nine observables updating inside the loop under
     sync-debug "error", one launch a day for the batch, each column bitwise
     equal to its B = 1 card run, the backends bitwise equal; profiled weeks
     at B = 8 and 64; the TTI ensemble (tti x 4 replicates) on both
     backends, bitwise; repro_torch.api.run at B = 1, 8 and 64 (ms per
     scenario-day), twice each; launch/sweep.py once;
  4e. chunked runs and recovery — api.run at B = 8 checkpointed every 50
     days into a fresh directory under build/: every history column and
     observable bitwise equal to phase 4d's unchunked B = 8 study, 200
     launches; a 100-day prefix resumed to 200 days, bitwise, then a second
     resume that launches nothing; under the recovery policy, chaos events
     raise@100, nan@150 and corrupt@150, each bitwise, with 200 launches plus
     the replayed days and the recovery report printed; a TTI B = 1 study on
     "pallas" (the traced padded kernel) resumed bitwise; the checkpointed
     and unchunked studies at B = 8 and 64, twice each in alternating order
     (ms per scenario-day), the host copy and the wait on the writer per
     boundary, the restore, and the bytes per snapshot; at B = 64, the
     extra time broken down (boundaries alone, + host copy, + the writer
     thread, + the writer in the loop's thread);
  4f. the simulation server — md-mini, covid, buckets of SERVE_CHUNK (10)
     days, each a captured CUDA graph of the batched day: the captured
     runner bitwise equal to eager run_days over three chunks (phase 4d's
     B = 8 and TTI ensemble cores on each backend; replays under
     sync-debug "error", one launch per replayed day); eager against graph
     ms/day at B = 8 and 64 (eager, graph, graph, eager) and a profile of
     three replays at each (ops per replayed day, idle share, one
     interaction launch a day); a closed-loop mix of 18 requests over six
     B = 8 buckets (presets none, lockdown, school-closure, vax-seniors and
     tti; both backends; 1-4 scenarios, 60-200 days; all four kernels),
     zero captures after the warm-ups, the first six (one per bucket)
     bitwise equal to their solo api.run, latency p50/p99 and requests/s;
     one served dispatch under the profiler (one interaction launch per
     day); sixteen four-scenario requests in one B = 64 dispatch, the first
     bitwise against its solo run; and
     ``python -m repro_torch.launch.serve_sim --check`` once;
  4g. meshes — ranks started by ``repro_torch.launch.mesh.spawn`` (every
     group's timeout 60 s, each spawn's wall limit 400 s); the ranks share
     one card, so no scaling claim: (a) one rank over nccl, the ``workers``
     layout W = 1 (the exchange runs, all to itself) on each backend, the
     day loop under sync-debug "error", history and final state bitwise
     phase 4's; (b) two ranks sharing cuda:0 over gloo, W = 2, the same
     runs and TTI on each backend, bitwise phases 4 and 4c; (c) the B = 8
     study through ``api.run`` sharded over S = 2 and on a 2 x 2 hybrid mesh
     (four ranks), every column and observable bitwise phase 4d's; (d) the
     B = 1 study on engine ``dist`` (W = 2) checkpointed every 50 days and a
     100-day prefix resumed to 200 (rank 0 writes), bitwise the unchunked
     study, and the W = 2 snapshot of day 100 resumed under ``local``
     (``run_chunked`` with its resume key), bitwise; one launch per rank per
     day throughout; per layout ms/day, each rank's host build, collectives
     per day by kind and bytes sent;
  4h. elastic shrink, the static-network oracle, detlint — (a) and (b) run
     at the end of phase 4g's two- and four-rank spawns: (a) the B = 1
     study on engine dist, W = 2 over gloo on the shared card, checkpointed
     every 50 days under the recovery policy with a device_loss chaos event
     (one worker) at day 100, on each backend: rank 1 retires at day 100
     (an empty history, 100 launches), rank 0 rebuilds on W = 1 and resumes
     from the day-100 snapshot, bitwise phase 4d's study, 200 launches, the
     report reading 2 -> 1; ms/day before and after the loss, the rebuild
     (groups, plan and tables) and the restore; (b) the B = 8 study on a
     hybrid 2 x 2 mesh (four ranks) losing its second worker row at day 100:
     ranks 0-1 finish on 1 x 2 bitwise phase 4d's B = 8 study, ranks 2-3
     retire; (c) the static-network mode against core/baseline.py's oracle:
     the Watts-Strogatz 500 case on both backends equal on every day, then
     md-mini under the oracle's SIR(7) and seeding (2 a day for 5 days) for
     STATIC_DAYS days, equal on every day until a day with an infection
     decision inside the float32 band, or after a dwell draw inside it
     (that day and the first in-band day printed), with the oracle's network
     build and run seconds beside the card's ms/day; (d) no float64
     op dispatched in a card day of either route; (e) the port's detlint over
     src/repro_torch and this file: 0 findings, no baseline;
  5. reference — twin-2k on the card against the plain path on the CPU, 30
     days untraced and 25 days under test-trace-isolate: the same
     trajectory up to float ulps in exp/log;
  6. flash attention — the kernels (built in phase 2 beside the interaction
     kernels) against their plain version at qwen2-1.5b's prefill shape (B=8,
     S=512, 12 query heads over 2 KV heads, Dh=128, bf16, causal) and in
     extra cases (Dh 64 and 256, float32, end-aligned Sq < Sk, a window of
     128, ragged tiles, a long 2048-token causal prefill), each within its
     stated tolerance; times of the kernel, the plain version and
     F.scaled_dot_product_attention (the library yardstick, never used by
     the port), and the bound;
  7. the serving path — repro_torch.launch.serve.serve with qwen2-1.5b at
     full width and depth (28 layers, d_model 1536), bf16, attn_impl
     "flash", seeded random parameters, batch 8, prompt 512, 32 greedy
     tokens: 28 kernel launches per prefill, the prefill's last logits
     against the replay's at position 511 and a "naive" prefill, a second
     session giving identical tokens; prefill ms, decode ms per step and
     tokens/s.

The line before the last is the kernels' JSON record (``launches``: phase
4d's; ``served_launches``: phase 4f's closed-loop mix; ``mesh_launches``:
phase 4g's and ``shrink_launches``: phase 4h (a)-(b)'s, each summed over
its ranks); the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the reference
package ``repro``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# The least work the function needs on this data (csrc/interactions.cu), as
# (integer, float) operations. A candidate is a same-location pair of a row
# visit with pid >= 0 and sus != 0 and a column visit with pid >= 0 and
# inf != 0 (the rest can change no output): it pays the validity test, the
# pid compare (integer) and the overlap's min, max, subtract and > 0
# (float). A contributing pair (a valid candidate) pays the draw: the pick
# of the min pid's hash state and the max pid's word (compare and two
# selects), two xors, two murmur3 finalizers (8 each), the shift and the
# threshold compare, all integer. A contact pays rho's two products and its
# sum (float) and the count (integer); traced, also src > 0 and that count.
# Each candidate visit of a live tile pays its hash words once: the min-pid
# state and the max-pid word (three finalizers, two adds and an xor).
OPS_PER_PAIR = (1, 4)
OPS_PER_VALID_PAIR = (23, 0)
OPS_PER_CONTACT = (1, 3)
OPS_PER_TRACED_CONTACT = (1, 1)
OPS_PER_VISIT = (27, 0)
# The model of PR 11-14, printed beside it: the validity test (3 integer, 4
# float) for every pair of a live tile, the draw and the rest for every
# valid pair (34 integer, 9 float; traced +2 integer), and the three words
# of each visit (27 integer).
OLD_OPS_PER_PAIR = (3, 4)
OLD_OPS_PER_VALID_PAIR = (34, 9)
OLD_OPS_PER_TRACED_VALID_PAIR = (2, 0)
OLD_OPS_PER_VISIT = (27, 0)
# The four instantiations: wrapper name in kernel.py, backend, traced?,
# the Pallas kernel each replaces.
KERNELS = {
    "interactions_compact": ("interactions_compact_cuda", "pallas-compact", False,
                             "src/repro/kernels/interactions/kernel.py:205"),
    "interactions_compact_traced": ("interactions_compact_traced_cuda", "pallas-compact",
                                    True, "src/repro/kernels/interactions/kernel.py:205"),
    "interactions_padded": ("interactions_padded_cuda", "pallas", False,
                            "src/repro/kernels/interactions/kernel.py:66"),
    "interactions_padded_traced": ("interactions_padded_traced_cuda", "pallas", True,
                                   "src/repro/kernels/interactions/kernel.py:66"),
}
TTI_TESTS_PER_DAY = 100  # the "tti" preset's budget
# Flash attention. Dense tensor-core peaks (NVIDIA H100 datasheet): 989e12
# bf16 FLOP/s; float32 inputs get the 67e12 FLOP/s of the FP32 lanes, since
# the function's float32 dots have no tensor-core path of full precision.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel against plain: the same float32 arithmetic in another order, so
# float32 outputs agree to |d| <= 1e-5 + 1e-5|x|; a bf16 output may round
# to the neighbouring bf16 (2^-8 relative at most): |d| <= 2e-2 + 1e-2|x|.
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
# At 2048 keys a typical |o| is ~0.03-0.05, where a key tile lost from a
# row would hide under 2e-2; so bf16 rows are also held as vectors,
# ||d_row|| <= 2^-6 ||o_row||. Rounding P (2^-9 per weight) and the output
# (half a bf16 step) keeps a row within ~2^-8 of the plain version; losing
# one 64-key tile of n moves a row by ~8 / sqrt(n) of its norm (0.18 at 2048).
FLASH_ROW_REL = {torch.bfloat16: 2**-6}
# (label, B, H, M, Sq, Sk, Dh, dtype, causal, window); the first is the
# serving prefill's shape and the kernel's JSON record. bf16 runs the wgmma
# kernel, float32 the FP32-lane one. "long" (~103 GFLOP of live pairs) is
# bound by operations: it shows how near the tensor cores' rate the design
# comes.
FLASH_CASES = (
    ("prefill", 8, 12, 2, 512, 512, 128, torch.bfloat16, True, None),
    ("dh64", 8, 12, 2, 512, 512, 64, torch.bfloat16, True, None),
    ("dh256", 8, 12, 2, 512, 512, 256, torch.bfloat16, True, None),
    ("f32", 8, 12, 2, 512, 512, 128, torch.float32, True, None),
    ("end_aligned", 8, 12, 2, 256, 512, 128, torch.bfloat16, True, None),
    ("window128", 8, 12, 2, 512, 512, 128, torch.bfloat16, True, 128),
    ("ragged", 2, 12, 2, 200, 300, 64, torch.float32, False, None),
    ("long", 8, 12, 2, 2048, 2048, 128, torch.bfloat16, True, None),
)
FLASH_PLAIN_REPS = {"long": 3}  # the plain version's timed calls (default 20)
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:28"
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "qwen2-1.5b", 8, 512, 32
# Prefill logits (bf16 compute) against the replay's at prompt_len - 1 and
# against a "naive" prefill: the paths round differently (flash attends in
# float32, naive takes bf16 logits, the replay reads the bf16 cache), which
# moved logits by ~2% of their largest magnitude over 28 layers at reduced
# width on the CPU; the bound is 8%. A feeding or masking fault moves them by
# the order of the logits themselves.
SERVE_REL_TOL = 0.08


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def stamp(phase: str) -> None:
    """The script's wall time at the start of ``phase``."""
    log(f"[time] {phase} starts at {time.perf_counter() - T_START:.1f} s")


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


# A stream sleep ahead of a timed run (~25 ms), so that the host has queued
# every call before the first one runs.
SLEEP_CYCLES = 50_000_000


def device_host_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn`` over ``reps`` calls, after one
    warm-up call. Unlike :func:`cuda_ms`, the stream sleeps first, so the
    CUDA events time the device alone even where a wrapper's host work per
    call outlasts its kernel; the host clock times the enqueueing."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - h0) * 1e3 / reps
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps, host_ms


def visit_inputs(core, person_sus, person_inf, dow, ops):
    """The interaction pass's inputs for one weekday and person channels,
    as the day step builds them (no interventions), in the wrappers'
    argument order."""
    w = {k: v[dow] for k, v in core.week.items()}
    pid = w["pid"]
    active = pid >= 0
    sus_v = person_sus[pid.clamp(min=0)] * active
    inf_v = person_inf[pid.clamp(min=0)] * active
    eff = torch.where(active, pid, -1)
    nb = pid.shape[0] // BLOCK
    seed = core.params.seed[0]
    meta = torch.stack([seed, torch.full_like(seed, dow)])
    return (eff, w["loc"], w["start"], w["end"], w["p"], sus_v, inf_v,
            w["row"], w["col"], w["rs"], w["pa"],
            ops.col_has_infectious(inf_v, eff, nb, BLOCK),
            ops.row_has_susceptible(sus_v, eff, nb, BLOCK), meta)


def pair_counts(args, rows, cols, contact_uniform) -> dict:
    """The data-dependent work in the live tiles ``rows``/``cols``: their
    pairs, same-location pairs, candidates (same location, row pid >= 0 and
    sus != 0, column pid >= 0 and inf != 0), valid pairs, contributing pairs
    (valid candidates), contacts among them, and the candidate visits whose
    hash words a kernel needs (rows of the live row blocks, columns of the
    live column blocks)."""
    pid, loc, start, end, p_loc, sus, inf = args[:7]
    meta = args[-1]
    rows, cols = rows.long(), cols.long()
    blk = lambda a, idx: a.view(-1, BLOCK)[idx]
    rok = (pid >= 0) & (sus != 0)
    cok = (pid >= 0) & (inf != 0)
    n = dict(pairs=rows.shape[0] * BLOCK * BLOCK, same_loc=0, candidates=0, valid=0,
             contributing=0, contacts=0)
    for s in range(0, rows.shape[0], 256):
        r, c = rows[s:s + 256], cols[s:s + 256]
        pr, pc = blk(pid, r)[:, :, None], blk(pid, c)[:, None, :]
        lr = blk(loc, r)[:, :, None]
        ov = (torch.minimum(blk(end, r)[:, :, None], blk(end, c)[:, None, :])
              - torch.maximum(blk(start, r)[:, :, None], blk(start, c)[:, None, :]))
        same = lr == blk(loc, c)[:, None, :]
        v = same & (pr >= 0) & (pc >= 0) & (pr != pc) & (ov > 0)
        both = blk(rok, r)[:, :, None] & blk(cok, c)[:, None, :]
        contrib = v & both
        u = contact_uniform(meta[0], meta[1], pr, pc, lr)
        n["same_loc"] += int(same.sum())
        n["candidates"] += int((same & both).sum())
        n["valid"] += int(v.sum())
        n["contributing"] += int(contrib.sum())
        n["contacts"] += int((contrib & (u < blk(p_loc, r)[:, :, None])).sum())
    n["word_visits"] = (int(blk(rok, torch.unique(rows)).sum())
                        + int(blk(cok, torch.unique(cols)).sum()))
    return n


def _times(nbytes: float, n_int: float, n_float: float):
    """Bytes at peak bandwidth against operations at peak rate: the INT32 and
    FP32 lanes run side by side, so the operations take the longest of
    integers at the INT32 rate, floats at the FP32 rate and both at the
    issue rate. Returns (bound ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 1e3 * max(n_int / PEAK_INT32_OPS_PER_S, n_float / PEAK_FP32_OPS_PER_S,
                      (n_int + n_float) / PEAK_ISSUE_PER_S)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def io_bytes(inputs, outs) -> int:
    """Inputs read once and outputs written once."""
    return sum(a.numel() * a.element_size() for a in (*inputs, *outs))


def bound(inputs, outs, n: dict, traced: bool):
    """Least time the card could take under the model above. Returns
    (ms, bound_by, integer operations, float operations)."""
    per_contact = [a + (b if traced else 0)
                   for a, b in zip(OPS_PER_CONTACT, OPS_PER_TRACED_CONTACT)]
    n_int, n_float = (n["candidates"] * a + n["contributing"] * b + n["contacts"] * c
                      + n["word_visits"] * d for a, b, c, d in
                      zip(OPS_PER_PAIR, OPS_PER_VALID_PAIR, per_contact, OPS_PER_VISIT))
    return (*_times(io_bytes(inputs, outs), n_int, n_float), n_int, n_float)


def bound_old(inputs, outs, n: dict, traced: bool):
    """The bound under PR 11-14's model: (ms, bound_by)."""
    per_valid = [a + (b if traced else 0)
                 for a, b in zip(OLD_OPS_PER_VALID_PAIR, OLD_OPS_PER_TRACED_VALID_PAIR)]
    visits = inputs[0].numel()
    n_int, n_float = (n["pairs"] * a + n["valid"] * b + visits * c for a, b, c in
                      zip(OLD_OPS_PER_PAIR, per_valid, OLD_OPS_PER_VISIT))
    return _times(io_bytes(inputs, outs), n_int, n_float)


def profile_days(core, state, card: str, label: str) -> None:
    """torch.profiler over one week of ``core``'s run from ``state``: device
    busy time per day, the idle share of the span the kernels cover, device
    operations per day and device time by kernel."""
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
        log(f"[profile:{label}] torch.profiler recorded no device events: device "
            "time not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    by_name: dict = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    kern = [v for k, v in by_name.items() if "interactions_kernel" in k]
    k_n, k_ms = sum(v[0] for v in kern), sum(v[1] for v in kern)
    sorts = [v for k, v in by_name.items() if "sort" in k.lower()]
    s_n, s_ms = sum(v[0] for v in sorts), sum(v[1] for v in sorts)
    day0 = int(state.day[0])
    B = state.day.shape[0]
    log(f"[profile:{label}] B={B}, days {day0}-{day0 + 6} (profiler on): "
        f"wall {wall_ms / 7:.3f} ms/day ({wall_ms / 7 / B:.4f} ms per scenario-day), "
        f"device busy {busy / 7:.3f} ms/day over a "
        f"kernel span of {span / 7:.3f} ms/day, idle share "
        f"{1.0 - busy / span:.4f}; {len(dev) / 7:.1f} device ops/day; "
        f"interactions_kernel {k_n} launches, {k_ms / 7:.4f} ms/day "
        f"({k_ms / busy:.4f} of device time); sort kernels {s_n / 7:.1f}/day, "
        f"{s_ms / 7:.4f} ms/day; {card}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        log(f"[profile:{label}]   {ms / 7:9.4f} ms/day  {n / 7:6.1f}/day  {name[:110]}")


def run_path(core, wrappers, days: int, column=0, observables=()):
    """Drive ``core`` (a batch of B scenarios) for ``days`` days from its
    initial state with every launch count set to 0 just before and read
    just after, the day loop (with the named ``observables`` updating inside
    it) under sync-debug "error". Returns (final, hist, launches, seconds):
    ``hist`` maps each stat to scenario ``column``'s (days,) series, or with
    ``column=None`` to the (days, B) array."""
    from repro_torch.api import observables as obs_lib
    from repro_torch.engine import hist_to_numpy

    state = core.init_state()
    obs = obs_lib.make_observables(observables)
    carries = obs_lib.init_carries(obs, obs_lib.ObsContext(
        num_people=core.pop.num_people, num_scenarios=core.num_real, device=str(core.device)))
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, _, hist, _ = core.run_days(days, state=state, observables=obs,
                                          carries=carries)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    hist = hist_to_numpy(hist)
    if column is not None:
        hist = {k: v[:, column] for k, v in hist.items()}
    return final, hist, launches, dt


def same_run(a, b, what: str) -> None:
    """Two (final, hist) pairs bitwise equal, or raise."""
    (fa, ha), (fb, hb) = a, b
    for k in ha:
        if not np.array_equal(ha[k], hb[k]):
            raise AssertionError(f"{what}: '{k}' history differs")
    for f in ("health", "dwell", "cumulative", "vaccinated", "tested", "traced",
              "isolated_until"):
        if not torch.equal(getattr(fa, f), getattr(fb, f)):
            raise AssertionError(f"{what}: final '{f}' differs")


def expect_launches(launches: dict, kernel: str, days: int, what: str) -> None:
    want = {k: days if k == kernel else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def flash_bound(q, k, v, o, live_pairs: int):
    """Least time for the attention function: Q, K, V read once and O written
    once at peak bandwidth (K/V at their kv-head count: the kernel reads them
    in place), against 4 Dh flops (two multiply-adds) per unmasked
    (query, key) pair and query head at the input type's peak rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
    flops = 4 * q.shape[-1] * live_pairs * q.shape[0]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", flops


def attention_mask(Sq, Sk, causal, window, device):
    """(Sq, Sk) boolean mask of the unmasked pairs, queries end-aligned."""
    qpos = torch.arange(Sk - Sq, Sk, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_phase(fk, card: str) -> dict:
    """The flash kernel against its plain version in each of FLASH_CASES;
    times by CUDA events; returns the first case's JSON fields."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products in
    torch.backends.cudnn.allow_tf32 = False  # the plain version and SDPA
    # detlint: ignore[DET001] — the flash cases' inputs: a seeded generator
    # on the card, not simulation state
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = None
    for label, B, H, M, Sq, Sk, Dh, dt, causal, window in FLASH_CASES:
        G = H // M
        # detlint: ignore[DET001] — the same seeded inputs
        draw = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = draw(B * H, Sq, Dh), draw(B * M, Sk, Dh), draw(B * M, Sk, Dh)
        kw = dict(causal=causal, window=window)
        run_k = lambda: fk.flash_attention_bhsd_cuda(q, k, v, **kw)
        run_p = lambda: fk.flash_attention_bhsd_plain(q, k, v, **kw)
        o_k, o_p = run_k(), run_p()
        torch.cuda.synchronize()
        if not torch.isfinite(o_k.float()).all():
            raise AssertionError(f"[flash:{label}] non-finite kernel output")
        atol, rtol = FLASH_TOL[dt]
        diff = (o_k.float() - o_p.float()).abs()
        err = float(diff.max())
        worst = float((diff - rtol * o_p.float().abs()).max())
        if worst > atol:
            raise AssertionError(f"[flash:{label}] kernel != plain: max |d| {err}, "
                                 f"tolerance {atol} + {rtol}|x|")
        row_rel = float((diff.square().sum(-1).sqrt()
                         / o_p.float().square().sum(-1).sqrt().clamp_min(1e-30)).max())
        if row_rel > FLASH_ROW_REL.get(dt, float("inf")):
            raise AssertionError(f"[flash:{label}] kernel != plain: a row is off by {row_rel} "
                                 f"of its norm, tolerance {FLASH_ROW_REL[dt]}")
        mask = attention_mask(Sq, Sk, causal, window, "cuda")
        qs = q.view(B, H, Sq, Dh)
        ks = k.view(B, M, Sk, Dh).repeat_interleave(G, dim=1)
        vs = v.view(B, M, Sk, Dh).repeat_interleave(G, dim=1)
        if causal and window is None and Sq == Sk:
            run_lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        elif not causal and window is None:
            run_lib = lambda: F.scaled_dot_product_attention(qs, ks, vs)
        else:  # bottom-right aligned masks: is_causal aligns top-left
            run_lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        lib_err = float((run_lib().reshape(B * H, Sq, Dh).float() - o_p.float()).abs().max())
        ms = cuda_ms(run_k, 20)
        plain_ms, lib_ms = cuda_ms(run_p, FLASH_PLAIN_REPS.get(label, 20)), cuda_ms(run_lib, 20)
        device_ms, host_ms = device_host_ms(run_k, 20)
        lib_device_ms = device_host_ms(run_lib, 20)[0]
        live = int(mask.sum())
        bound_ms, bound_by, flops = flash_bound(q, k, v, o_k, live)
        log(f"[flash:{label}] B={B} H={H} M={M} Sq={Sq} Sk={Sk} Dh={Dh} "
            f"{str(dt).split('.')[-1]} causal={causal} window={window}: kernel within "
            f"tolerance of plain (max_abs_err={err}, tolerance {atol} + {rtol}|x|, "
            f"output rms {float(o_p.float().square().mean().sqrt()):.4g}; rows off by "
            f"{row_rel:.3g} of their norm at most"
            f"{f', tolerance {FLASH_ROW_REL[dt]:.4g}' if dt in FLASH_ROW_REL else ''}); "
            f"kernel_ms={ms:.4f} (device alone {device_ms:.4f}, wrapper host "
            f"{host_ms:.4f} per call) "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} (device alone {lib_device_ms:.4f}) "
            f"(sdpa max |d| vs plain {lib_err:.3g}) bound_ms={bound_ms:.5f} ({bound_by}; "
            f"{flops / 1e9:.3f} GFLOP, live fraction {live / (Sq * Sk):.4f}) "
            f"{100.0 * bound_ms / ms:.2f}% of bound; {flops / ms / 1e9:.2f} TFLOP/s (device "
            f"alone {100.0 * bound_ms / device_ms:.2f}%, {flops / device_ms / 1e9:.2f}); {card}")
        if out is None:
            out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms, device_ms=device_ms,
                       library_device_ms=lib_device_ms)
    return out


def device_summary(prof, wall_ms: float, steps: int, label: str, card: str) -> None:
    """Device busy time, idle share of the span, device ops and the top
    kernels per step of a torch.profiler window."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"[profile:{label}] torch.profiler recorded no device events: not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    by_name: dict = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    fl = by_name.get(next((k for k in by_name if "flash_fwd" in k), ""), (0, 0.0))
    log(f"[profile:{label}] per step (profiler on): wall {wall_ms / steps:.3f} ms, device "
        f"busy {busy / steps:.3f} ms over a span of {span / steps:.3f} ms, idle share "
        f"{1.0 - busy / span:.4f}; {len(dev) / steps:.1f} device ops; flash_fwd "
        f"{fl[0] / steps:.1f} launches, {fl[1] / steps:.4f} ms ({fl[1] / busy:.4f} of "
        f"device time); {card}")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        log(f"[profile:{label}]   {ms / steps:9.4f} ms/step  {n / steps:6.1f}/step  {name[:100]}")


def profile_serving(cfg, params, prompts, card: str, decode_steps: int = 16) -> None:
    """torch.profiler over one prefill and over decode steps at positions
    past the prompt (the session's own calls, after its warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    p = M.prepare(cfg, params)
    toks = torch.as_tensor(prompts, device="cuda").long()
    cache = M.init_cache(cfg, toks.shape[0], SERVE_PROMPT + decode_steps, device="cuda")
    tok = toks[:, -1:]
    with torch.no_grad():
        for label, steps, fn in (
                ("prefill", 1, lambda: M.forward_prefill(cfg, p, {"tokens": toks})),
                ("decode", decode_steps, lambda: [M.decode_step(cfg, p, cache, tok, SERVE_PROMPT + i)
                                                  for i in range(decode_steps)])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            device_summary(prof, (time.perf_counter() - t0) * 1e3, steps, label, card)


def serve_phase(fk, card: str) -> int:
    """qwen2-1.5b served at full width through repro_torch.launch.serve:
    returns the flash launches of one session (one prefill)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.serve import serve, summary
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(SERVE_ARCH), compute_dtype="bfloat16",
                              attn_impl="flash")
    t0 = time.perf_counter()
    # detlint: ignore[DET001] — random model weights from a seed (the LM
    # side-stack serves random weights), not simulation state
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = TokenPipeline(cfg.vocab_size, SERVE_PROMPT, SERVE_BATCH, 0).batch(0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, Dh {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {M.param_count(cfg)} parameters, "
        f"compute {cfg.compute_dtype}, attn_impl {cfg.attn_impl}; set up in "
        f"{time.perf_counter() - t0:.1f} s")
    sessions, launches = [], []
    for _ in range(2):
        fk.flash_attention_bhsd_cuda.launches = 0
        res = serve(cfg, params, prompts, SERVE_GEN, device="cuda")
        launches.append(fk.flash_attention_bhsd_cuda.launches)
        sessions.append(res)
    if launches != [cfg.num_layers] * 2:
        raise AssertionError(f"flash launches per session {launches}, expected "
                             f"{cfg.num_layers} (one per layer of one prefill)")
    res = sessions[0]
    if not np.array_equal(res.tokens, sessions[1].tokens):
        raise AssertionError("a second session generated other tokens")
    pre, rep = res.prefill_logits.float(), res.replay_logits.float()
    V = cfg.vocab_size
    if pre.shape != (SERVE_BATCH, 1, V) or not torch.isfinite(pre).all() \
            or not torch.isfinite(rep).all():
        raise AssertionError(f"prefill logits {tuple(pre.shape)} not finite (B, 1, {V})")
    if res.tokens.shape != (SERVE_BATCH, SERVE_GEN) or res.tokens.min() < 0 \
            or res.tokens.max() >= V:
        raise AssertionError(f"generated tokens {res.tokens.shape} out of range")
    with torch.no_grad():
        naive = M.forward_prefill(dataclasses.replace(cfg, attn_impl="naive"),
                                  M.cast_params(cfg, params),
                                  {"tokens": torch.as_tensor(prompts, device="cuda").long()})[0]
    scale = float(pre.abs().max())
    for what, other in (("replay", rep), ("naive", naive.float())):
        d = float((pre - other).abs().max())
        agree = float((pre.argmax(-1) == other.argmax(-1)).float().mean())
        log(f"[serve] prefill logits against {what}: max |d| {d:.5f} of max |logit| "
            f"{scale:.4f} (tolerance {SERVE_REL_TOL} x that), argmax agreement {agree:.3f}")
        if d > SERVE_REL_TOL * scale:
            raise AssertionError(f"prefill logits against {what}: {d} > "
                                 f"{SERVE_REL_TOL} x {scale}")
    for i, r in enumerate(sessions):
        log(f"[serve] session {i + 1}: prefill_ms={1e3 * r.prefill_s:.3f} "
            f"decode_ms_per_step={1e3 * r.decode_s / r.decode_steps:.3f} "
            f"({r.decode_steps} steps of batch {SERVE_BATCH}: {SERVE_PROMPT - 1} replayed, "
            f"{SERVE_GEN} generated) tokens_per_s={r.tokens.size / r.decode_s:.2f} "
            f"prefill_tokens_per_s={SERVE_BATCH * SERVE_PROMPT / r.prefill_s:.1f}; {card}")
        log(f"[serve:{i + 1}] {json.dumps(summary(cfg, r))}")
    profile_serving(cfg, params, prompts, card)
    log(f"[serve:launches] flash_attention {launches[0]} per prefill, both sessions; "
        f"tokens identical across sessions; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches[0]


def interaction_states(core, covid, ops):
    """The phase-3 inputs: label -> (wrapper args, tracing sources). Person
    channels early (ten presymptomatic seeds), mid (states drawn from numpy)
    and all (everyone infectious and susceptible), each with a tracing-source
    vector on about 1% of the infectious visits; and "shuffled", the mid
    inputs with the visits permuted inside each block (numpy seed 1), so a
    location's visits are no longer contiguous, on the same schedule."""
    P = core.pop.num_people
    dev = core.device
    # detlint: ignore[DET001] — the kernel check's synthetic states: a seeded
    # host generator, not simulation state
    rs = np.random.default_rng(0)
    tables = (torch.as_tensor(covid.susceptibility, device=dev),
              torch.as_tensor(covid.infectivity, device=dev))
    early = np.zeros(P, np.int32)  # everyone S, ten seeds presymptomatic
    early[rs.choice(P, 10, replace=False)] = covid.state_index("Ipre")
    mid = rs.choice(covid.num_states, size=P,
                    p=[0.45, 0.1, 0.1, 0.15, 0.1, 0.1]).astype(np.int32)
    beta_sus, beta_inf = core.params.beta_sus[0], core.params.beta_inf[0]
    channels = {}
    for label, health in (("early", early), ("mid", mid)):
        h = torch.as_tensor(health, device=dev).long()
        channels[label] = (tables[0][h] * beta_sus, tables[1][h] * beta_inf)
    channels["all"] = (beta_sus, beta_inf)
    states = {}
    for label, (ps, pi) in channels.items():
        args = visit_inputs(core, ps, pi, 0, ops)
        infectious = (args[6] > 0).cpu().numpy()
        src = torch.as_tensor(
            (infectious & (rs.random(infectious.shape[0]) < 0.01)).astype(np.float32),
            device=dev)
        states[label] = (args, src)
    args, src = states["mid"]
    V = args[0].shape[0]
    # detlint: ignore[DET001] — the "shuffled" kernel state's permutation
    perm = np.random.default_rng(1).permuted(
        np.arange(V).reshape(-1, BLOCK), axis=1).reshape(-1)
    perm = torch.as_tensor(perm, device=dev)
    vis = [a[perm] for a in args[:7]]
    nb = V // BLOCK
    states["shuffled"] = ((*vis, *args[7:11], ops.col_has_infectious(vis[6], vis[0], nb, BLOCK),
                           ops.row_has_susceptible(vis[5], vis[0], nb, BLOCK), args[13]),
                          src[perm])
    return states


def interaction_phase(core, covid, kernel, ops, wrappers, card: str) -> dict:
    """Each of the four interaction kernels against its plain version in
    every state of :func:`interaction_states` (bitwise, and padded against
    compacted), timed on both timers, with the bound under both models.
    Returns kernel -> state -> record."""
    from repro_torch.kernels.interactions.ref import contact_uniform

    records = {k: {} for k in KERNELS}
    plain = {"pallas-compact": kernel.interactions_compact_plain,
             "pallas": kernel.interactions_padded_plain}
    for label, (args, src) in interaction_states(core, covid, ops).items():
        rc = ops.compact_schedule(args[7], args[8], *args[10:13])
        n_live = int(rc[3][0])
        n = pair_counts(args, rc[0][:n_live], rc[1][:n_live], contact_uniform)
        log(f"[kernel:{label}] live_tiles={n_live} pairs={n['pairs']} "
            f"same_location={n['same_loc']} candidates={n['candidates']} "
            f"valid={n['valid']} contributing={n['contributing']} "
            f"contacts={n['contacts']} word_visits={n['word_visits']}")
        kargs = {"pallas-compact": args[:7] + rc + args[11:], "pallas": args}
        outs = {}
        for kname, (wname, backend, traced, _) in KERNELS.items():
            ka = kargs[backend]
            kw = dict(block_size=BLOCK, src_val=src) if traced else dict(block_size=BLOCK)
            run_k = lambda: wrappers[kname](*ka, **kw)
            run_p = lambda: plain[backend](*ka, **kw)
            out_k, out_p = run_k(), run_p()
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(out_k, out_p)):
                if not torch.equal(a, b):
                    raise AssertionError(f"[{label}] {kname} output {i} != plain")
            outs[kname] = out_k
            err = float((out_k[0] - out_p[0]).abs().max())
            ms = cuda_ms(run_k, 50)
            device_ms, host_ms = device_host_ms(run_k, 50)
            plain_ms = cuda_ms(run_p, 3)
            inputs = list(ka) + ([src] if traced else [])
            bound_ms, bound_by, n_int, n_float = bound(inputs, out_k, n, traced)
            old_ms, old_by = bound_old(inputs, out_k, n, traced)
            wrap_ms = cuda_ms(lambda: (ops.interactions_auto_traced(
                *args, backend=backend, **kw) if traced else ops.interactions_auto_edges(
                *args, backend=backend, block_size=BLOCK)), 50)
            records[kname][label] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         max_abs_err=err)
            extra = f" traced={int(out_k[2].sum())}" if traced else ""
            log(f"[kernel:{label}] {kname} bitwise equal to plain; "
                f"int_ops={n_int} float_ops={n_float} contacts={int(out_k[1].sum())}"
                f"{extra} kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
                f"host_ms={host_ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
                f"bound_ms={bound_ms:.5f} ({bound_by}; {100.0 * bound_ms / device_ms:.2f}% "
                f"device alone) old_model_bound_ms={old_ms:.5f} ({old_by}; "
                f"{100.0 * old_ms / device_ms:.2f}%) max_abs_err={err}; {card}")
        # Padded against compacted: the same live tiles in the same order.
        for a, b in (("interactions_padded", "interactions_compact"),
                     ("interactions_padded_traced", "interactions_compact_traced")):
            for i in range(len(outs[a])):
                if not torch.equal(outs[a][i], outs[b][i]):
                    raise AssertionError(f"[{label}] {a} output {i} != {b}")
        log(f"[kernel:{label}] padded bitwise equal to compacted, untraced and traced; "
            f"sources={int(src.sum())}")
    return records


# Scenario batches (this slice's main path): the ensemble's presets, and the
# study shapes timed through api.run: (B, interventions, tau scales,
# replicates), each run twice in the order 1, 8, 64, 64, 8, 1.
ENSEMBLE_PRESETS = ("none", "lockdown", "school-closure", "vax-seniors")
STUDIES = ((1, ("none",), (1.0,), 1), (8, ENSEMBLE_PRESETS, (1.0,), 2),
           (64, ENSEMBLE_PRESETS, (1.0, 0.75), 8))
TTI_REPLICATES = 4
CKPT_EVERY = 50  # phase 4e's chunk: four boundaries in 200 days
CKPT_ROOT = os.path.join(ROOT, "build", "chip_smoke_ckpt")
CHAOS = (("raise", 100), ("nan", 150), ("corrupt", 150))


def study_spec(width: int, **kw):
    """The md-mini study of ``width`` scenarios from STUDIES, through api.run."""
    from repro_torch import api

    _, ivs, taus, reps = next(s for s in STUDIES if s[0] == width)
    base = dict(name=f"md-mini-B{width}", dataset=DATASET, days=DAYS, interventions=ivs,
                tau_scales=taus, replicates=reps, backend="pallas-compact")
    base.update(kw)
    return api.ExperimentSpec(**base)


# Per-scenario arguments of the wrappers (a leading B in a batched call).
PER_SCENARIO = (0, 5, 6, 11, 12, 13)


def stack_scenarios(scen):
    """[(args, src), ...] of scenarios on one layout -> (batched args,
    batched src): per-scenario arguments stacked, the rest the first's."""
    args = tuple(torch.stack([a[j] for a, _ in scen]) if j in PER_SCENARIO else scen[0][0][j]
                 for j in range(len(scen[0][0])))
    return args, torch.stack([src for _, src in scen])


def batch_states(core, covid, ops):
    """Phase 3b's scenarios on md-mini's day-0 layout: early, mid, all and
    "shuffled", each with its own meta (seed, day). The batch shares the
    week's loc, start, end, p and schedule, so "shuffled" here permutes only
    the mid state's per-scenario arrays (pid, sus, inf, sources) inside each
    block, the permutation phase 3 applies to every array."""
    states = interaction_states(core, covid, ops)
    base = states["mid"][0]
    scen = []
    for i, label in enumerate(("early", "mid", "all", "shuffled")):
        args, src = states[label]
        args = list(args)
        if label == "shuffled":
            args[1:5], args[7:11] = base[1:5], base[7:11]
        args[13] = torch.tensor([1 + 7919 * i, i], dtype=torch.int64, device=base[0].device)
        scen.append((tuple(args), src))
    return scen


def batched_kernel_phase(core, covid, kernel, ops, wrappers, card) -> dict:
    """The four interaction kernels with the scenario axis: at B = 4 (one
    scenario per state) each is bitwise equal to its plain version and, per
    scenario, to its own B = 1 launch, in one launch; at B = 8 (the four
    states twice, other seeds) it is timed on both timers beside the plain
    version, eight B = 1 launches and the bound. Returns kernel -> the B = 8
    record (the JSON line's numbers: the main path's batch width)."""
    from repro_torch.kernels.interactions.ref import contact_uniform

    scen4 = batch_states(core, covid, ops)
    scen8 = scen4 + [((*a[:13], a[13] + torch.tensor([100, 0], device=a[13].device)), s)
                     for a, s in scen4]
    plain = {"pallas-compact": kernel.interactions_compact_plain,
             "pallas": kernel.interactions_padded_plain}

    def kernel_args(args, backend):
        if backend == "pallas":
            return args
        return args[:7] + ops.compact_schedule(args[7], args[8], *args[10:13]) + args[11:]

    counts = []
    for args, _ in scen8:
        rc = ops.compact_schedule(args[7], args[8], *args[10:13])
        n_live = int(rc[3][0])
        counts.append(pair_counts(args, rc[0][:n_live], rc[1][:n_live], contact_uniform))
    n8 = {k: sum(c[k] for c in counts) for k in counts[0]}
    log(f"[batched] B=8 scenarios on one layout: live tiles "
        f"{[int(ops.compact_schedule(a[7], a[8], *a[10:13])[3][0]) for a, _ in scen8]}, "
        f"candidates={n8['candidates']} contributing={n8['contributing']} "
        f"contacts={n8['contacts']}")
    records = {}
    for kname, (wname, backend, traced, _) in KERNELS.items():
        for width, scen in ((4, scen4), (8, scen8)):
            args, src = stack_scenarios(scen)
            ka = kernel_args(args, backend)
            kw = dict(block_size=BLOCK, src_val=src) if traced else dict(block_size=BLOCK)
            before = wrappers[kname].launches
            out_k = wrappers[kname](*ka, **kw)
            if wrappers[kname].launches != before + 1:
                raise AssertionError(f"[batched] {kname}: a batch of {width} took "
                                     f"{wrappers[kname].launches - before} launches")
            out_p = plain[backend](*ka, **kw)
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(out_k, out_p)):
                if a.shape[0] != width or not torch.equal(a, b):
                    raise AssertionError(f"[batched] B={width} {kname} output {i} != plain")
            alone = []
            for j, (a1, s1) in enumerate(scen):
                kw1 = dict(block_size=BLOCK, src_val=s1) if traced else dict(block_size=BLOCK)
                ka1 = kernel_args(a1, backend)
                out1 = wrappers[kname](*ka1, **kw1)
                alone.append((ka1, kw1))
                for i, (a, b) in enumerate(zip(out_k, out1)):
                    if not torch.equal(a[j], b):
                        raise AssertionError(f"[batched] B={width} {kname} scenario {j} "
                                             f"output {i} != its own launch")
            if width == 4:
                log(f"[batched] B=4 {kname}: one launch, bitwise equal to plain and, per "
                    f"scenario (early, mid, all, shuffled), to its own launch; contacts "
                    f"{out_k[1].sum(dim=1).tolist()}")
                continue
            run_k = lambda: wrappers[kname](*ka, **kw)
            run_p = lambda: plain[backend](*ka, **kw)
            run_1 = lambda: [wrappers[kname](*a1, **k1) for a1, k1 in alone]
            ms = cuda_ms(run_k, 20)
            device_ms, host_ms = device_host_ms(run_k, 20)
            seq_device_ms, seq_host_ms = device_host_ms(run_1, 5)
            plain_ms = cuda_ms(run_p, 1)
            err = float((out_k[0] - out_p[0]).abs().max())
            inputs = list(ka) + ([src] if traced else [])
            bound_ms, bound_by, n_int, n_float = bound(inputs, out_k, n8, traced)
            records[kname] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            log(f"[batched] B=8 {kname}: one launch bitwise equal to plain and to eight B=1 "
                f"launches; kernel_ms={ms:.4f} device_ms={device_ms:.4f} host_ms={host_ms:.4f} "
                f"| eight B=1 launches device_ms={seq_device_ms:.4f} host_ms={seq_host_ms:.4f} "
                f"| plain_ms={plain_ms:.3f} bound_ms={bound_ms:.5f} ({bound_by}; "
                f"{100.0 * bound_ms / device_ms:.2f}% device alone; int_ops={n_int} "
                f"float_ops={n_float}) max_abs_err={err}; {card}")
    return records


def ensemble_phase(pop, covid, epi, wrappers, card) -> tuple:
    """This slice's main path: md-mini scenario batches on the card.

    The B = 8 ensemble (ENSEMBLE_PRESETS x 2 replicates) for DAYS days on
    each backend under sync-debug "error": DAYS launches for the batch, each
    column bitwise equal to its B = 1 card run, the backends bitwise equal;
    a profiled week at B = 1 is phase 4b's, here at B = 8 and 64; the TTI
    ensemble (tti x TTI_REPLICATES) on both backends, bitwise; api.run at
    B = 1, 8 and 64 (ms per scenario-day, one launch a day for the batch,
    B = 8 equal to the ensemble); and the sweep CLI once. Returns the main
    path's launch counts by kernel and the last api.run result of each
    study width, and the cores it built (phase 4f captures their runners),
    by (label, backend) and "B=64"."""
    from repro_torch import api
    from repro_torch.configs import INTERVENTION_PRESETS
    from repro_torch.configs.sweep import ScenarioBatch
    from repro_torch.engine import EngineCore
    from repro_torch.launch import sweep

    main_launches, cores = {}, {}
    batch = ScenarioBatch.from_product(
        interventions={n: INTERVENTION_PRESETS[n] for n in ENSEMBLE_PRESETS},
        tau=epi.tau, seeds=[0, 1])
    B = len(batch)
    runs = {}
    for backend, kname in (("pallas-compact", "interactions_compact"),
                           ("pallas", "interactions_padded")):
        core = EngineCore(pop, batch, block_size=BLOCK, device="cuda", backend=backend)
        cores[("B=8", backend)] = core
        # every observable updates inside the loop (none may sync)
        final, hist, launches, dt = run_path(core, wrappers, DAYS, column=None,
                                             observables=tuple(api.OBSERVABLES))
        expect_launches(launches, kname, DAYS, f"ensemble B={B}, {backend}")
        main_launches[kname] = launches[kname]
        if not np.array_equal(hist["edges"], hist["contacts"]):
            raise AssertionError(f"ensemble {backend}: edges != contacts")
        runs[backend] = (final, hist, dt, core)
        log(f"[ensemble] {DATASET} B={B} ({', '.join(batch.names)}), {backend}, {DAYS} days: "
            f"launches={launches[kname]} for the batch; cumulative "
            f"{hist['cumulative'][-1].tolist()}; {1e3 * dt / DAYS:.3f} ms/day, "
            f"{1e3 * dt / (DAYS * B):.4f} ms per scenario-day; {card}")
    (fa, ha, dt_a, core), (fb, hb, _, _) = runs["pallas-compact"], runs["pallas"]
    same_run((fa, ha), (fb, hb), f"ensemble B={B}, pallas against pallas-compact")
    cum = ha["cumulative"]
    if (np.diff(cum, axis=0) < 0).any() or not (cum[-1] > 70).all():
        raise AssertionError(f"ensemble cumulative not monotone or not above the seeds: {cum[-1]}")
    if np.array_equal(ha["cumulative"][:, 0], ha["cumulative"][:, 2]):
        raise AssertionError("ensemble: lockdown never parted from the baseline")
    one_dt = 0.0
    for i, scen in enumerate(batch):
        c1 = EngineCore(pop, [scen], block_size=BLOCK, device="cuda")
        f1, h1, _, dt1 = run_path(c1, wrappers, DAYS)
        one_dt += dt1
        for k in h1:
            if not np.array_equal(h1[k], ha[k][:, i]):
                raise AssertionError(f"ensemble column {i} ({scen.name}) '{k}' != its B=1 run")
        for f in ("health", "dwell", "cumulative", "vaccinated", "iv_active"):
            if not torch.equal(getattr(f1, f)[0], getattr(fa, f)[i]):
                raise AssertionError(f"ensemble column {i} ({scen.name}): final '{f}' differs")
    log(f"[ensemble] each of the {B} columns bitwise equal to its B=1 card run (histories "
        f"and final states); both backends bitwise equal; B={B} in one loop "
        f"{1e3 * dt_a / (DAYS * B):.4f} ms per scenario-day against {B} B=1 runs "
        f"{1e3 * one_dt / (DAYS * B):.4f}; {card}")
    profile_days(core, core.run_days(PROFILE_FROM)[0], card, f"ensemble-B{B}")

    tti = ScenarioBatch.from_product(interventions={"tti": INTERVENTION_PRESETS["tti"]},
                                     tau=epi.tau, seeds=list(range(TTI_REPLICATES)))
    tti_runs = {}
    for backend, kname in (("pallas-compact", "interactions_compact_traced"),
                           ("pallas", "interactions_padded_traced")):
        c = EngineCore(pop, tti, block_size=BLOCK, device="cuda", backend=backend)
        cores[(f"TTI B={len(tti)}", backend)] = c
        final, hist, launches, dt = run_path(c, wrappers, DAYS, column=None)
        expect_launches(launches, kname, DAYS, f"TTI ensemble, {backend}")
        main_launches[kname] = launches[kname]
        if not np.array_equal(hist["edges"], hist["contacts"]) or \
                hist["tests_used"].max() > TTI_TESTS_PER_DAY:
            raise AssertionError(f"TTI ensemble {backend}: edges != contacts or budget exceeded")
        for k in ("tests_used", "isolated", "traced"):
            if (hist[k].max(axis=0) <= 0).any():
                raise AssertionError(f"TTI ensemble {backend}: '{k}' zero in a scenario")
        tti_runs[backend] = (final, hist)
        log(f"[ensemble] TTI B={len(tti)} ({', '.join(tti.names)}), {backend}: "
            f"launches={launches[kname]}; cumulative {hist['cumulative'][-1].tolist()}, "
            f"tests {hist['tests_used'].sum(axis=0).tolist()}; {1e3 * dt / DAYS:.3f} ms/day, "
            f"{1e3 * dt / (DAYS * len(tti)):.4f} ms per scenario-day; {card}")
    same_run(tti_runs["pallas"], tti_runs["pallas-compact"], "TTI ensemble across backends")
    log("[ensemble] TTI ensemble bitwise equal across backends")

    stamp("api.run studies")
    studies = {}
    for width, _, _, _ in STUDIES + STUDIES[::-1]:
        spec = study_spec(width)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        r = api.run(spec, population=pop)
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        expect_launches(launches, "interactions_compact", DAYS, f"api.run B={width}")
        if r.num_scenarios != width or r.history["cumulative"].shape != (DAYS, width) or \
                not np.array_equal(r.history["edges"], r.history["contacts"]):
            raise AssertionError(f"api.run B={width}: history shape or edges wrong")
        if width == B:
            for k in ha:
                if not np.array_equal(r.history[k], ha[k]):
                    raise AssertionError(f"api.run B={width} '{k}' != the ensemble's history")
        band = r.observables["ensemble_mean_ci"]["new_infections"]
        if not all(np.isfinite(np.asarray(band[x])).all() for x in ("mean", "lo", "hi")):
            raise AssertionError(f"api.run B={width}: mean/CI band not finite")
        prov = r.provenance
        studies[width] = r
        log(f"[study] api.run {DATASET} B={width} ({prov['engine']}, {prov['route']}), {DAYS} "
            f"days: launches={launches['interactions_compact']} (one a day for the batch); "
            f"run_wall_s={prov['run_wall_s']} -> {1e3 * prov['run_wall_s'] / DAYS:.3f} ms/day, "
            f"{1e3 * prov['run_wall_s'] / (DAYS * width):.4f} ms per scenario-day; "
            f"api.run wall {wall:.3f} s; mean attack rate "
            f"{100.0 * float(np.mean(r.history['cumulative'][-1])) / pop.num_people:.2f}%; "
            f"teps={prov['teps']:.4g}; {card}")
    big = api.ExperimentSpec(dataset=DATASET, interventions=STUDIES[2][1],
                             tau_scales=STUDIES[2][2], replicates=STUDIES[2][3]).build_batch()
    c64 = EngineCore(pop, big, block_size=BLOCK, device="cuda")
    cores["B=64"] = c64
    profile_days(c64, c64.run_days(PROFILE_FROM)[0], card, f"ensemble-B{len(big)}")

    stamp("sweep CLI")
    sweep.main(["--dataset", DATASET, "--days", "30", "--interventions", "none,lockdown",
                "--replicates", "2"])
    return main_launches, studies, cores


def same_study(a, b, what: str) -> None:
    """Two RunResults with bitwise-equal histories and observables, or raise."""
    for k in a.history:
        if not np.array_equal(a.history[k], b.history[k]):
            raise AssertionError(f"{what}: history '{k}' differs")
    for name, obs in a.observables.items():
        for k, v in obs.items():
            w = b.observables[name][k]
            if isinstance(v, dict):
                same = all(np.array_equal(v[x], w[x], equal_nan=True) for x in v)
            else:
                same = np.array_equal(np.asarray(v), np.asarray(w), equal_nan=True)
            if not same:
                raise AssertionError(f"{what}: observable {name}.{k} differs")


def counted_run(spec, pop, wrappers, kernel: str, days: int, what: str, **kw):
    """api.run with every launch count set to 0 just before and read just
    after; the run must launch ``kernel`` ``days`` times and nothing else."""
    from repro_torch import api

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    r = api.run(spec, population=pop, **kw)
    expect_launches({k: w.launches for k, w in wrappers.items()}, kernel, days, what)
    return r


def chunked_phase(pop, wrappers, studies, card) -> None:
    """Phase 4e: chunked runs and recovery on md-mini (covid, 200 days),
    each run into a fresh directory under CKPT_ROOT; every check fatal."""
    import shutil

    from repro_torch import api
    from repro_torch.api import runner
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import ChaosEvent, ChaosSchedule

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    dirs = iter(range(1000))
    fresh = lambda: os.path.join(CKPT_ROOT, f"run{next(dirs)}")
    ck = lambda spec, d, **kw: spec.with_overrides(ckpt_dir=d, ckpt_every=CKPT_EVERY, **kw)
    K = "interactions_compact"
    ref8 = studies[8]

    r = counted_run(ck(study_spec(8), fresh()), pop, wrappers, K, DAYS, "checkpointed B=8")
    same_study(ref8, r, "checkpointed B=8 against the unchunked study")
    if r.provenance["chunks"] != DAYS // CKPT_EVERY or r.provenance["chunk_days"] != CKPT_EVERY:
        raise AssertionError(f"checkpointed B=8: provenance {r.provenance}")
    log(f"[chunked] {DATASET} B=8 every {CKPT_EVERY} days: {r.provenance['chunks']} chunks, "
        f"launches={DAYS}; every history column and observable bitwise equal to the "
        f"unchunked api.run; {card}")

    d = fresh()
    counted_run(ck(study_spec(8, days=DAYS // 2), d), pop, wrappers, K, DAYS // 2, "prefix")
    r = counted_run(ck(study_spec(8), d), pop, wrappers, K, DAYS - DAYS // 2, "resume")
    if r.provenance["resumed_from_day"] != DAYS // 2:
        raise AssertionError(f"resume: resumed_from_day {r.provenance['resumed_from_day']}")
    same_study(ref8, r, "resumed B=8")
    r2 = counted_run(ck(study_spec(8), d), pop, wrappers, K, 0, "second resume")
    if r2.provenance["resumed_from_day"] != DAYS or r2.provenance["chunks"] != 0:
        raise AssertionError(f"second resume: provenance {r2.provenance}")
    same_study(ref8, r2, "second resume B=8")
    log(f"[chunked] {DAYS // 2}-day prefix + resume from day {DAYS // 2}: launches "
        f"{DAYS // 2} + {DAYS - DAYS // 2}, bitwise; a second resume launched nothing, "
        "bitwise")

    for kind, day in CHAOS:
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        r = api.run(ck(study_spec(8), fresh(), resilient=True), population=pop,
                    chaos=ChaosSchedule((ChaosEvent(kind, day=day),)))
        rep = r.provenance["resilience"]
        replayed = CKPT_EVERY * rep["chunks_replayed"]
        expect_launches({k: w.launches for k, w in wrappers.items()}, K, DAYS + replayed,
                        f"chaos {kind}@{day}")
        same_study(ref8, r, f"chaos {kind}@{day}")
        if rep["restarts"] != 1 or (kind == "corrupt" and not rep["snapshots_quarantined"]) \
                or (kind == "nan" and not rep["guard_violations"]):
            raise AssertionError(f"chaos {kind}@{day}: report {rep}")
        log(f"[chunked] chaos {kind}@{day} B=8: bitwise; launches={DAYS + replayed} "
            f"({DAYS} + {replayed} replayed); resumed_from_day="
            f"{r.provenance['resumed_from_day']}; report {json.dumps(rep)}")

    tti = study_spec(1, name="md-mini-tti", interventions=("tti",), tau_scales=(1.0,),
                     replicates=1, backend="pallas")
    KT = "interactions_padded_traced"
    ref = counted_run(tti, pop, wrappers, KT, DAYS, "TTI B=1 unchunked")
    d = fresh()
    counted_run(ck(tti, d, days=DAYS // 2), pop, wrappers, KT, DAYS // 2, "TTI prefix")
    r = counted_run(ck(tti, d), pop, wrappers, KT, DAYS - DAYS // 2, "TTI resume")
    same_study(ref, r, "TTI B=1 resumed on pallas")
    if min(r.history[k].sum() for k in ("tests_used", "isolated", "traced")) <= 0:
        raise AssertionError("TTI resume: tests, isolation or tracing unused")
    log(f"[chunked] TTI B=1 on pallas ({KT}): {DAYS // 2}-day prefix + resume, bitwise "
        "against the unchunked run")

    # Timing: the host copy and the writer's wait per boundary, the restore,
    # and the bytes per snapshot, through a manager that times its calls.
    times = {"copy": [], "wait": [], "verify": [], "restore": []}

    class TimedManager(CheckpointManager):
        def save(self, *a, **kw):
            self.wait()  # timed below when a write is in flight
            t0 = time.perf_counter()
            super().save(*a, **kw)
            times["copy"].append(time.perf_counter() - t0)

        def wait(self):
            t0 = time.perf_counter()
            busy = self._thread is not None
            super().wait()
            if busy:
                times["wait"].append(time.perf_counter() - t0)

        def latest_valid_step(self, *a, **kw):
            t0 = time.perf_counter()
            out = super().latest_valid_step(*a, **kw)
            times["verify"].append(time.perf_counter() - t0)
            return out

        def restore_flat(self, *a, **kw):
            t0 = time.perf_counter()
            out = super().restore_flat(*a, **kw)
            times["restore"].append(time.perf_counter() - t0)
            return out

    runner.CheckpointManager = TimedManager
    try:
        for width in (8, 64):
            walls = {"unchunked": [], "checkpointed": []}
            for mode in ("unchunked", "checkpointed", "checkpointed", "unchunked"):
                for v in times.values():
                    v.clear()
                d = fresh()
                spec = study_spec(width) if mode == "unchunked" else ck(study_spec(width), d)
                r = counted_run(spec, pop, wrappers, K, DAYS, f"{mode} B={width}")
                walls[mode].append(r.provenance["run_wall_s"])
                if mode == "checkpointed":
                    same_study(studies[width], r, f"checkpointed B={width}")
                    step = os.path.join(d, f"step-{DAYS:010d}")
                    nbytes = sum(os.path.getsize(os.path.join(step, f)) for f in os.listdir(step))
                    copy_ms = [round(1e3 * t, 3) for t in times["copy"]]
                    wait_ms = round(1e3 * sum(times["wait"]), 3)
                    for v in times.values():
                        v.clear()
                    t0 = time.perf_counter()
                    r2 = counted_run(spec, pop, wrappers, K, 0, f"no-op resume B={width}")
                    log(f"[chunked] B={width} checkpointed: host copy per boundary ms "
                        f"{copy_ms}; wait on the writer {wait_ms} ms over the run "
                        f"({round(wait_ms / (DAYS // CKPT_EVERY), 3)} per boundary); "
                        f"bytes per snapshot {nbytes}; restore: verify "
                        f"{round(1e3 * sum(times['verify']), 3)} ms + restore_flat "
                        f"{round(1e3 * sum(times['restore']), 3)} ms, a no-op resume's "
                        f"run_wall_s {r2.provenance['run_wall_s']} (api.run wall "
                        f"{time.perf_counter() - t0:.3f} s); {card}")
            log(f"[chunked] B={width} ms per scenario-day, unchunked "
                f"{[round(1e3 * w / (DAYS * width), 4) for w in walls['unchunked']]} vs "
                f"checkpointed every {CKPT_EVERY} "
                f"{[round(1e3 * w / (DAYS * width), 4) for w in walls['checkpointed']]} "
                f"(order: unchunked, checkpointed, checkpointed, unchunked; run_wall_s "
                f"{walls}); {card}")
    finally:
        runner.CheckpointManager = CheckpointManager
    checkpoint_breakdown(pop, 64, fresh, card)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def checkpoint_breakdown(pop, width: int, fresh, card) -> None:
    """Where a checkpointed study's extra time goes: the study at ``width``
    through ``run_chunked`` on one core, five ways, in turns (the order,
    then the reverse): one chunk; four chunks with a save that does
    nothing (the boundaries alone); with a save that only copies the state
    to the host; with the manager's background writer; with the writer run
    in the loop's thread (``blocking``, so its whole cost is serial)."""
    from repro_torch.api import observables as obs_lib
    from repro_torch.checkpoint import CheckpointManager, flatten_tree
    from repro_torch.engine import core as engine_lib

    spec = study_spec(width)
    core = engine_lib.EngineCore(pop, spec.build_batch(), block_size=BLOCK, device="cuda")
    observables = obs_lib.make_observables(spec.observables)
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=width,
                             device=str(core.device))

    class NoSave:
        def save(self, *a, **kw):
            pass

        def wait(self):
            pass

    class CopyOnly(NoSave):
        def save(self, step, tree, **kw):
            for v in flatten_tree(tree).values():
                if isinstance(v, torch.Tensor):
                    v.to("cpu", copy=True)

    saves = []

    class Blocking(CheckpointManager):
        def save(self, *a, **kw):
            t0 = time.perf_counter()
            super().save(*a, **kw, blocking=True)
            saves.append(time.perf_counter() - t0)

    modes = {"one chunk": lambda: None, "4 chunks, no save": NoSave,
             "4 chunks, host copy": CopyOnly,
             "4 chunks, writer thread": lambda: CheckpointManager(fresh()),
             "4 chunks, blocking writer": lambda: Blocking(fresh())}
    walls = {m: [] for m in modes}
    for m in list(modes) + list(modes)[::-1]:
        mgr = modes[m]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_lib.run_chunked(engine_lib.CoreDriver(core, observables), DAYS, observables,
                               ctx, manager=mgr, every=CKPT_EVERY, resume=False)
        torch.cuda.synchronize()
        walls[m].append(round(time.perf_counter() - t0, 4))
    log(f"[chunked] B={width} breakdown, run_chunked wall s (two turns each, "
        f"order then reverse): {json.dumps(walls)}; blocking save (copy + digests + "
        f"np.save) per boundary ms {[round(1e3 * t, 3) for t in saves]}; {card}")


# Phase 4f: the simulation server (repro_torch.serve) on md-mini, covid. A
# bucket's runner is a CUDA graph of SERVE_CHUNK batched days.
SERVE_CHUNK = 10
SERVE_TIMED_DAYS = 100  # eager run_days against SERVE_TIMED_DAYS / SERVE_CHUNK replays
# The closed-loop mix's buckets, (interventions, backend): requests of 1-4
# scenarios, so each kind has one B = 8 bucket; between them they run all
# four interaction kernels inside captured graphs.
SERVE_KINDS = ((("none",), "pallas-compact"), (("lockdown",), "pallas-compact"),
               (("school-closure",), "pallas"), (("vax-seniors",), "pallas-compact"),
               (("tti",), "pallas-compact"), (("tti",), "pallas"))
SERVE_REQUESTS = 18
SERVE_CONCURRENCY = 3  # closed-loop clients, one request in flight each
SERVE_SOLO = 6  # the mix's first requests (one per kind), each against its solo api.run
SERVE_WIDE = 16  # requests of four scenarios packed into one B = 64 dispatch
SERVE_WIDE_SOLO = 1


def serve_mix(epi) -> list:
    """The closed-loop mix: request i is kind i % 6 with 1-4 scenarios,
    its own seed and tau, and 60-200 days."""
    from repro_torch import api

    mix = []
    for i in range(SERVE_REQUESTS):
        ivs, backend = SERVE_KINDS[i % len(SERVE_KINDS)]
        mix.append(api.ExperimentSpec(
            name=f"req{i}", dataset=DATASET, interventions=ivs, backend=backend,
            replicates=1 + (3 * i) % 4, seed=1000 + 17 * i,
            tau=epi.tau * (1.0, 0.85, 1.15)[i % 3], days=(60, 100, 150, 200)[(i // 2) % 4]))
    return mix


def captured_runner_checks(cores, wrappers, card) -> None:
    """The captured runner against eager run_days: for phase 4d's B = 8
    ensemble and TTI ensemble cores on each backend, three SERVE_CHUNK-day
    replays from the initial state (under sync-debug "error", launches
    counted per replay) bitwise equal to one eager run of 3 * SERVE_CHUNK
    days, history and final state."""
    for label, traced in (("B=8", ""), (f"TTI B={TTI_REPLICATES}", "_traced")):
        for backend, kname in (("pallas-compact", "interactions_compact"),
                               ("pallas", "interactions_padded")):
            kname += traced
            core = cores[(label, backend)]
            final, _, hist, _ = core.run_days(3 * SERVE_CHUNK)
            runner = core.runner_fn(SERVE_CHUNK)
            runner(core.params, core.init_state())  # the capture
            (build,) = runner.builds()
            state, hists = core.init_state(), []
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(3):
                    state, _, h, _ = runner(core.params, state)
                    hists.append(h)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            expect_launches({k: w.launches for k, w in wrappers.items()}, kname,
                            3 * SERVE_CHUNK, f"captured runner {label} {backend}")
            if not torch.equal(torch.cat(hists), hist):
                raise AssertionError(f"captured runner {label} {backend}: history != eager")
            for f in ("health", "dwell", "cumulative", "iv_active", "vaccinated", "tested",
                      "traced", "isolated_until", "day"):
                if not torch.equal(getattr(final, f), getattr(state, f)):
                    raise AssertionError(f"captured runner {label} {backend}: final '{f}' "
                                         "!= eager")
            log(f"[served] captured runner {label} {backend}: 3 replays of {SERVE_CHUNK} "
                f"days bitwise equal to eager run_days (chunks 1-3, final state); "
                f"launches={3 * SERVE_CHUNK} ({kname}); capture {build.capture_s:.3f} s, "
                f"graph pool {build.pool_bytes} bytes, static inputs {build.input_bytes} "
                f"bytes; {card}")


def profile_replays(core, runner, state, label: str, card: str) -> None:
    """torch.profiler over three replays of ``runner`` from ``state``: device
    ops per replayed day, busy time, idle share, and one interaction-kernel
    launch per replayed day."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    days = 3 * SERVE_CHUNK
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state = runner(core.params, state)[0]
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e for e in dev if "interactions_kernel" in e.name]
    if len(kern) != days:
        raise AssertionError(f"[profile:{label}] {len(kern)} interaction-kernel launches "
                             f"in {days} replayed days")
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    k_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    B = core.num_real
    log(f"[profile:{label}] B={B}, 3 replays of {SERVE_CHUNK} days (profiler on): wall "
        f"{wall_ms / days:.3f} ms/day ({wall_ms / days / B:.4f} ms per scenario-day), device "
        f"busy {busy / days:.3f} ms/day over a span of {span / days:.3f} ms/day, idle share "
        f"{1.0 - busy / span:.4f}; {len(dev) / days:.1f} device ops/day; interactions_kernel "
        f"{len(kern)} launches ({len(kern) / days:.0f} per replayed day), {k_ms / days:.4f} "
        f"ms/day; {card}")
    by_name: dict = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        log(f"[profile:{label}]   {ms / days:9.4f} ms/day  {n / days:6.1f}/day  {name[:110]}")


def graph_against_eager(cores, card) -> None:
    """ms/day of eager run_days against replays of the captured runner at
    B = 8 and 64 (phase 4d's pallas-compact cores, untraced),
    SERVE_TIMED_DAYS days each, in the order eager, graph, graph, eager;
    then a profile of three replays at each width."""
    for core in (cores[("B=8", "pallas-compact")], cores["B=64"]):
        runner = core.runner_fn(SERVE_CHUNK)
        runner(core.params, core.init_state())  # built already at B = 8
        (build,) = runner.builds()

        def eager():
            core.run_days(SERVE_TIMED_DAYS)

        def graph():
            state = core.init_state()
            for _ in range(SERVE_TIMED_DAYS // SERVE_CHUNK):
                state = runner(core.params, state)[0]

        ms = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (eager if mode == "eager" else graph)()
            torch.cuda.synchronize()
            ms[mode].append(round((time.perf_counter() - t0) * 1e3 / SERVE_TIMED_DAYS, 4))
        B = core.num_real
        log(f"[served] B={B} ms/day over {SERVE_TIMED_DAYS} days (order eager, graph, graph, "
            f"eager): eager run_days {ms['eager']}, captured runner {ms['graph']} -> "
            f"{sum(ms['eager']) / sum(ms['graph']):.2f}x; "
            f"ms per scenario-day {[round(g / B, 5) for g in ms['graph']]} (graph); capture "
            f"{build.capture_s:.3f} s, graph pool {build.pool_bytes} bytes; {card}")
        profile_replays(core, runner, core.run_days(PROFILE_FROM)[0], f"served-B{B}", card)


def served_phase(pop, epi, cores, wrappers, card) -> dict:
    """Phase 4f: the simulation server (``cores``: phase 4d's). Returns the
    closed-loop mix's launch counts by kernel (counts set to 0 just before
    the mix, read just after)."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    from repro_torch import api
    from repro_torch.serve import ServeConfig, SimulationServer

    captured_runner_checks(cores, wrappers, card)
    graph_against_eager(cores, card)

    stamp("served mix")
    mix = serve_mix(epi)
    server = SimulationServer(ServeConfig(chunk_days=SERVE_CHUNK, b_lattice=(8,),
                                          max_executables=len(SERVE_KINDS)))
    server._pops[DATASET] = pop
    for ivs, backend in SERVE_KINDS:
        spec = next(s for s in mix if s.interventions == ivs and s.backend == backend)
        info = server.warm_up(spec)
        (build,) = server._buckets.peek(spec_bucket(spec, server)).runner().builds()
        log(f"[served] warm-up {info['bucket']}: capture {info['compile_s']:.3f} s "
            f"(eager warm-up chunk + capture), graph pool {build.pool_bytes} bytes")
    builds = lambda srv: sum(b.runner().cache_size() for b in
                             (srv._buckets.peek(k) for k in srv._buckets))
    before = builds(server)
    chunks0 = server.metrics_dict()["batches"]["chunks_run"]
    results = [None] * len(mix)

    def client(worker: int):
        for i in range(worker, len(mix), SERVE_CONCURRENCY):
            results[i] = server.submit(mix[i]).result(timeout=600)

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with server:
        with Pool(max_workers=SERVE_CONCURRENCY) as pool:
            for f in [pool.submit(client, w) for w in range(SERVE_CONCURRENCY)]:
                f.result()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    m = server.metrics_dict()
    chunks = m["batches"]["chunks_run"] - chunks0
    if sum(launches.values()) != chunks * SERVE_CHUNK or min(launches.values()) <= 0:
        raise AssertionError(f"served mix: launches {launches} for {chunks} chunks of "
                             f"{SERVE_CHUNK} days (every kernel must run)")
    ex = m["executables"]
    if builds(server) != before or ex["recompile_violations"] or \
            ex["cold_compiles"] != len(SERVE_KINDS) or m["requests"]["failed"] or \
            m["requests"]["completed"] != len(mix) or \
            not all(r.served_from["warm"] for r in results):
        raise AssertionError(f"served mix: a capture after warm-up, a failure or a cold "
                             f"dispatch: {json.dumps(m)}")
    for i, (spec, served) in enumerate(zip(mix[:SERVE_SOLO], results)):
        solo = api.run(spec, population=pop)
        same_study(solo, served, f"served request {i}")
        if solo.summaries != served.summaries or \
                served.history["cumulative"].shape != (spec.days, spec.num_scenarios):
            raise AssertionError(f"served request {i}: summaries or shape differ")
    per_day = [r.served_from["dispatch_wall_s"] / r.served_from["padded_days"] for r in results]
    lat = m["request_latency"]
    log(f"[served] closed-loop mix, {len(mix)} requests ({SERVE_CONCURRENCY} clients; "
        f"kinds {[f'{i[0]}/{b}' for i, b in SERVE_KINDS]}; 1-4 scenarios, 60-200 days): "
        f"{m['batches']['dispatched'] - len(SERVE_KINDS)} dispatches, {chunks} chunks, "
        f"launches {launches}; zero captures after warm-up; the first {SERVE_SOLO} bitwise "
        f"equal to their solo api.run (history, observables, summaries); {card}")
    log(f"[served] B=8 mix: request latency p50 {lat['p50_s']:.4f} s p99 {lat['p99_s']:.4f} "
        f"s (mean {lat['mean_s']:.4f}); time to first day p50 "
        f"{m['time_to_first_day']['p50_s']:.4f} s; {len(mix) / wall:.3f} requests/s "
        f"({wall:.3f} s); served ms/day (dispatch wall / padded days) median "
        f"{1e3 * float(np.median(per_day)):.3f} min {1e3 * min(per_day):.3f} max "
        f"{1e3 * max(per_day):.3f}; occupancy {m['batches']['occupancy']:.3f}; {card}")

    # One served dispatch under the profiler: one interaction launch a day.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one = mix[0].with_overrides(days=3 * SERVE_CHUNK, seed=7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.run(one)
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == DeviceType.CUDA and "interactions_kernel" in e.name)
    if n != 3 * SERVE_CHUNK:
        raise AssertionError(f"served dispatch: the profiler counts {n} interaction "
                             f"launches in {3 * SERVE_CHUNK} days")
    log(f"[served] one dispatch of {3 * SERVE_CHUNK} days under the profiler: {n} "
        "interaction-kernel launches, one per replayed day")

    # B = 64: sixteen four-scenario requests packed into one dispatch.
    wide = SimulationServer(ServeConfig(chunk_days=SERVE_CHUNK, b_lattice=(64,)))
    wide._pops[DATASET] = pop
    reqs = [api.ExperimentSpec(name=f"wide{i}", dataset=DATASET,
                               interventions=ENSEMBLE_PRESETS, seed=2000 + 31 * i,
                               tau=epi.tau * (1.0, 0.9)[i % 2], days=SERVE_TIMED_DAYS)
            for i in range(SERVE_WIDE)]
    info = wide.warm_up(reqs[0])
    before = builds(wide)
    t0 = time.perf_counter()
    tickets = [wide.submit(r) for r in reqs]
    wide.drain()
    wall = time.perf_counter() - t0
    res = [t.result(timeout=600) for t in tickets]
    m = wide.metrics_dict()
    if builds(wide) != before or m["executables"]["recompile_violations"] or \
            any(r.served_from["batch_requests"] != SERVE_WIDE or not r.served_from["warm"]
                for r in res):
        raise AssertionError(f"B=64 server: not one warm dispatch: {json.dumps(m)}")
    for spec, served in list(zip(reqs, res))[:SERVE_WIDE_SOLO]:
        same_study(api.run(spec, population=pop), served, f"B=64 served {spec.name}")
    d = res[0].served_from
    log(f"[served] B=64: {SERVE_WIDE} requests of 4 scenarios in one dispatch of "
        f"{d['padded_days']} days: served {1e3 * d['dispatch_wall_s'] / d['padded_days']:.3f} "
        f"ms/day ({1e3 * d['dispatch_wall_s'] / d['padded_days'] / 64:.5f} ms per "
        f"scenario-day), {SERVE_WIDE / wall:.3f} requests/s ({wall:.3f} s submit to drained), "
        f"request latency p50 {m['request_latency']['p50_s']:.4f} s p99 "
        f"{m['request_latency']['p99_s']:.4f} s; capture {info['compile_s']:.3f} s; the first "
        f"{SERVE_WIDE_SOLO} bitwise equal to their solo api.run; {card}")

    stamp("serve_sim CLI")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_sim", "--dataset", DATASET,
         "--days", "60", "--chunk-days", str(SERVE_CHUNK), "--requests", "8",
         "--concurrency", "2", "--b-lattice", "8", "--check"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    if proc.returncode != 0 or "check OK" not in proc.stdout:
        raise AssertionError(f"serve_sim --check failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    load = json.loads(proc.stdout[proc.stdout.index("{"):proc.stdout.rindex("}") + 1])
    log(f"[served] serve_sim --check on {DATASET}: {json.dumps(load['load'])}; "
        f"{json.dumps(load['executables'])}")
    return launches


MESH_TIMEOUT_S = 60.0  # every group's timeout in phase 4g
MESH_WALL_S = 400.0  # the wall limit of each spawn
MESH_ROOT = os.path.join(ROOT, "build", "chip_smoke_mesh")


def _kernel_counts(reset: bool = False) -> dict:
    """This process's launch counts by kernel name (set to 0 with reset)."""
    from repro_torch.kernels.interactions import kernel

    out = {}
    for kname, (wname, *_) in KERNELS.items():
        w = getattr(kernel, wname)
        out[kname] = w.launches
        if reset:
            w.launches = 0
    return out


def _mesh_run(core, days: int, sync_debug: bool) -> dict:
    """``days`` days of ``core`` (a mesh layout) from its initial state, the
    launch counts set to 0 just before and read just after; the day loop
    under sync-debug "error" when asked (gloo's collectives block the host,
    so gloo runs are exempt). Returns what the parent compares and prints."""
    import torch.distributed as dist

    from repro_torch.engine import hist_to_numpy

    state = core.init_state()
    group = core.mesh.worker_group or core.mesh.scenario_group
    dist.all_reduce(torch.zeros(1, dtype=torch.float32, device="cuda"),
                    group=group)  # communicator up
    torch.cuda.synchronize()
    core.topo.reset_counts()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error" if sync_debug else 0)
    try:
        final, _, hist, _ = core.run_days(days, state=state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _kernel_counts()
    counts, sent = dict(core.topo.counts), dict(core.topo.bytes_sent)
    full = core.gather_state(final)
    return dict(final={f: getattr(full, f).cpu().numpy() for f in MESH_STATE},
                hist=hist_to_numpy(hist), launches=launches, ms_per_day=1e3 * dt / days,
                per_day={k: v / days for k, v in counts.items()},
                bytes_per_day={k: v / days for k, v in sent.items()})


MESH_STATE = ("health", "dwell", "cumulative", "vaccinated", "tested", "traced",
              "isolated_until")


def _mesh_cores(pop, days: int, cases, sync_debug: bool) -> dict:
    """The ``workers`` layout over the whole group (one plan for every core)
    on each (preset, backend) of ``cases``: {(preset, backend): _mesh_run}."""
    import torch.distributed as dist

    from repro_torch.configs import INTERVENTION_PRESETS, get_epidemic
    from repro_torch.core import disease as disease_lib
    from repro_torch.core import simulator_dist as sd
    from repro_torch.core import transmission as tx_lib
    from repro_torch.engine import EngineCore

    epi = get_epidemic(DATASET)
    t0 = time.perf_counter()
    plan = sd.build_dist_plan(pop, dist.get_world_size(), BLOCK)
    out = {"plan_build_s": time.perf_counter() - t0}
    for preset, backend in cases:
        core = EngineCore.single(pop, disease_lib.covid_model(),
                                 tx_lib.TransmissionModel(tau=epi.tau), seed=0,
                                 block_size=BLOCK, device="cuda", backend=backend,
                                 layout="workers", plan=plan,
                                 interventions=INTERVENTION_PRESETS[preset])
        out[(preset, backend)] = _mesh_run(core, days, sync_debug)
    out["fold_mismatches"] = sd.fold_mismatches(plan, pop)
    return out


def _counted_study(spec, pop, **kw) -> tuple:
    """api.run on this rank (``kw`` passed on) with the launch counts set to 0
    just before and read just after: (RunResult, launches)."""
    from repro_torch import api

    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    r = api.run(spec, population=pop, **kw)
    return r, _kernel_counts()


def _rank_nccl(pop, days):
    """Phase 4g (a): one rank over nccl, W = 1, both backends, the day loop
    under sync-debug "error"."""
    return _mesh_cores(pop, days, (("none", "pallas-compact"), ("none", "pallas")), True)


def _rank_two(pop, days, root):
    """Phase 4g (b)-(d) on two ranks sharing the card over gloo: W = 2 on both
    backends, untraced and TTI; the B = 8 study sharded over S = 2; the
    B = 1 study on engine dist checkpointed, and a prefix resumed (its
    snapshot copied for the parent to resume under local)."""
    import shutil

    import torch.distributed as dist

    out = {"workers": _mesh_cores(pop, days, (
        ("none", "pallas-compact"), ("none", "pallas"), ("tti", "pallas-compact"),
        ("tti", "pallas")), False)}
    out["sharded"] = _counted_study(study_spec(8).with_overrides(scenarios=2), pop)
    ck = lambda d, **kw: study_spec(1, **kw).with_overrides(
        workers=2, ckpt_dir=os.path.join(root, d), ckpt_every=CKPT_EVERY)
    out["chunked"] = _counted_study(ck("chunked"), pop)
    out["prefix"] = _counted_study(ck("prefix", days=DAYS // 2), pop)
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(root, "prefix"), os.path.join(root, "prefix-for-local"))
    dist.barrier()
    out["resumed"] = _counted_study(ck("prefix"), pop)
    out["shrink"] = _rank_shrink_two(pop, days, SHRINK_ROOT)
    return out


def _rank_four(pop, days):
    """Phase 4g (c): the B = 8 study on a 2 x 2 hybrid mesh, four ranks
    sharing the card over gloo; then phase 4h (b) on the same ranks."""
    return {"hybrid": _counted_study(study_spec(8).with_overrides(workers=2, scenarios=2),
                                     pop),
            "shrink": _rank_shrink_four(pop, days, SHRINK_ROOT)}


def _mesh_line(tag: str, r: dict, card: str) -> None:
    log(f"[mesh] {tag}: {r['ms_per_day']:.3f} ms/day; collectives/day {json.dumps(r['per_day'], sort_keys=True)}; bytes sent/day "
        f"{json.dumps({k: round(v) for k, v in r['bytes_per_day'].items()}, sort_keys=True)}; "
        f"{card}")


def _same_as_local(r: dict, ref: tuple, P: int, what: str) -> None:
    """A rank's gathered final state and history bitwise ``ref`` =
    (final (1, P) tensors, hist {stat: (days,)})."""
    final, hist = ref
    for k, v in hist.items():
        if not np.array_equal(r["hist"][k][:, 0], v[:len(r["hist"][k])]):
            raise AssertionError(f"{what}: history '{k}' differs from the local run")
    for f in MESH_STATE:
        got = r["final"][f]
        got = got[..., :P] if got.ndim == 2 else got
        if not np.array_equal(got, getattr(final, f).cpu().numpy()):
            raise AssertionError(f"{what}: final '{f}' differs from the local run")


def mesh_phase(pop, wrappers, local, studies, card) -> dict:
    """Phase 4g: the mesh layouts on one card. ``local``: phase 4/4c's runs
    by (preset, backend) -> (final, hist); ``studies``: phase 4d's api.run
    results by width. The same spawns run phase 4h (a) and (b) after phase
    4g's work (a spawn of four ranks costs ~40 s of start-up alone). Returns
    the mesh runs' launches by kernel, summed over ranks, and phase 4h's
    results of the two- and four-rank spawns."""
    import shutil
    import tempfile

    from repro_torch.api import observables as obs_lib
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import EngineCore, core as core_lib
    from repro_torch.launch import mesh as mesh_lib

    P, days = pop.num_people, DAYS
    log(f"[mesh] ranks share one card; no scaling claim. {DAYS} days of {DATASET}; "
        f"every group's timeout {MESH_TIMEOUT_S:.0f} s, each spawn's wall limit "
        f"{MESH_WALL_S:.0f} s; {card}")
    for d in (MESH_ROOT, SHRINK_ROOT):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    init = tempfile.mkdtemp(prefix="pg-", dir=MESH_ROOT)
    spawn = lambda fn, n, backend, *args: mesh_lib.spawn(
        fn, n, backend=backend, device="cuda:0", init_dir=init, args=(pop, days, *args),
        timeout_s=MESH_TIMEOUT_S, wall_s=MESH_WALL_S)
    total = {k: 0 for k in KERNELS}

    def launched(launches, kname, n, what):
        expect_launches(launches, kname, n, what)
        for k, v in launches.items():
            total[k] += v

    kname = {("none", "pallas-compact"): "interactions_compact",
             ("none", "pallas"): "interactions_padded",
             ("tti", "pallas-compact"): "interactions_compact_traced",
             ("tti", "pallas"): "interactions_padded_traced"}

    # (a) one rank over nccl
    stamp("mesh (a): one rank over nccl")
    t0 = time.perf_counter()
    (one,) = spawn(_rank_nccl, 1, "nccl")
    log(f"[mesh] (a) spawn of 1 rank: {time.perf_counter() - t0:.1f} s")
    for key in (("none", "pallas-compact"), ("none", "pallas")):
        r = one[key]
        launched(r["launches"], kname[key], days, f"mesh W=1 nccl {key}")
        _same_as_local(r, local[key], P, f"mesh W=1 nccl {key}")
        _mesh_line(f"(a) workers W=1 over nccl, {key[1]}, day loop under sync-debug "
                   f"\"error\", bitwise equal to phase 4, {days} launches", r, card)
    log(f"[mesh] (a) plan build (W=1) {one['plan_build_s']:.2f} s on the host; location runs "
        f"cut unlike the local layout: {one['fold_mismatches']}")

    # (b)-(d) two ranks sharing the card over gloo
    stamp("mesh (b)-(d): two ranks over gloo")
    t0 = time.perf_counter()
    two = spawn(_rank_two, 2, "gloo", MESH_ROOT)
    log(f"[mesh] (b)-(d) spawn of 2 ranks: {time.perf_counter() - t0:.1f} s")
    for rank, res in enumerate(two):
        log(f"[mesh] (b) rank {rank}: plan build (W=2) {res['workers']['plan_build_s']:.2f} s "
            f"on the host; location runs cut unlike the local layout: "
            f"{res['workers']['fold_mismatches']}")
        for key in kname:
            r = res["workers"][key]
            launched(r["launches"], kname[key], days, f"mesh W=2 rank {rank} {key}")
            _same_as_local(r, local[key], P, f"mesh W=2 rank {rank} {key}")
            _mesh_line(f"(b) workers W=2 over gloo, rank {rank}, {key[0]} on {key[1]}, "
                       f"bitwise equal to phase {'4c' if key[0] == 'tti' else '4'}, "
                       f"{days} launches", r, card)
        sharded, launches = res["sharded"]
        launched(launches, "interactions_compact", days, f"sharded S=2 rank {rank}")
        same_study(studies[8], sharded, f"sharded S=2 rank {rank} against phase 4d's B=8")
        prov = sharded.provenance
        log(f"[mesh] (c) api.run B=8 sharded over S=2, rank {rank}: every column and "
            f"observable bitwise phase 4d's; {days} launches on this rank (B=4 a day); "
            f"run_wall_s={prov['run_wall_s']} -> {1e3 * prov['run_wall_s'] / days:.3f} ms/day; "
            f"host build {prov['plan_build_s']:.2f} s (the local week); collectives "
            f"{json.dumps(prov['collectives'], sort_keys=True)}, bytes sent "
            f"{json.dumps(prov['bytes_sent'], sort_keys=True)}; {card}")
        for what, n in (("chunked", DAYS), ("prefix", DAYS // 2), ("resumed", DAYS - DAYS // 2)):
            r, launches = res[what]
            launched(launches, "interactions_compact", n, f"dist W=2 {what}, rank {rank}")
            if what != "prefix":
                same_study(studies[1], r, f"dist W=2 {what} rank {rank}")
        r = res["resumed"][0]
        if r.provenance["resumed_from_day"] != DAYS // 2 or \
                res["chunked"][0].provenance["chunks"] != DAYS // CKPT_EVERY:
            raise AssertionError(f"dist W=2 rank {rank}: provenance {r.provenance}")
        log(f"[mesh] (d) api.run B=1 dist W=2, rank {rank}: checkpointed every {CKPT_EVERY} "
            f"days bitwise the unchunked study; a {DAYS // 2}-day prefix resumed to {DAYS} "
            f"bitwise; launches {DAYS}, {DAYS // 2} + {DAYS - DAYS // 2}; run_wall_s "
            f"{res['chunked'][0].provenance['run_wall_s']} (chunked); host build "
            f"{res['chunked'][0].provenance['plan_build_s']:.2f} s (plan + tables); {card}")
    # (d) the W = 2 prefix snapshot resumed under local (its resume key names
    # the mesh, as the reference's does: resumed through run_chunked)
    mgr = CheckpointManager(os.path.join(MESH_ROOT, "prefix-for-local"))
    step = mgr.latest_valid_step()
    key = mgr.manifest(step)["extra"]["resume_key"]
    spec = study_spec(1)
    obs = obs_lib.make_observables(spec.observables)
    ctx = obs_lib.ObsContext(num_people=P, num_scenarios=1, device="cuda")
    core = EngineCore(pop, spec.build_batch(), block_size=BLOCK, device="cuda")
    _kernel_counts(reset=True)
    _, hist, _, _, resumed, _ = core_lib.run_chunked(
        core_lib.CoreDriver(core, obs), DAYS, obs, ctx, manager=mgr, every=CKPT_EVERY,
        resume_key=key)
    launched(_kernel_counts(), "interactions_compact", DAYS - step, "W=2 snapshot under local")
    for k, v in hist.items():
        if resumed != DAYS // 2 or not np.array_equal(v, studies[1].history[k]):
            raise AssertionError(f"W=2 snapshot resumed under local: '{k}' differs "
                                 f"(resumed from {resumed})")
    log(f"[mesh] (d) the W=2 snapshot of day {step} resumed under local to day {DAYS}: "
        f"bitwise the unchunked study; {DAYS - step} launches")

    # (c) four ranks sharing the card, hybrid 2 x 2
    stamp("mesh (c): four ranks over gloo, hybrid 2 x 2")
    t0 = time.perf_counter()
    four = spawn(_rank_four, 4, "gloo")
    log(f"[mesh] (c) spawn of 4 ranks: {time.perf_counter() - t0:.1f} s")
    for rank, res in enumerate(four):
        r, launches = res["hybrid"]
        launched(launches, "interactions_compact", days, f"hybrid 2x2 rank {rank}")
        same_study(studies[8], r, f"hybrid 2x2 rank {rank} against phase 4d's B=8")
        prov = r.provenance
        log(f"[mesh] (c) api.run B=8 hybrid 2x2, rank {rank}: every column and observable "
            f"bitwise phase 4d's; {days} launches (B=4 a day, half the people); "
            f"run_wall_s={prov['run_wall_s']} -> {1e3 * prov['run_wall_s'] / days:.3f} ms/day; "
            f"host build {prov['plan_build_s']:.2f} s (plan + tables); collectives "
            f"{json.dumps(prov['collectives'], sort_keys=True)}, bytes sent "
            f"{json.dumps(prov['bytes_sent'], sort_keys=True)}; {card}")
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    return total, {"two": [r["shrink"] for r in two], "four": [r["shrink"] for r in four]}


SHRINK_DAY = 100  # phase 4h's device loss, at a chunk boundary (every CKPT_EVERY)
SHRINK_ROOT = os.path.join(ROOT, "build", "chip_smoke_shrink")
# Phase 4h (c): the float32 decision band against the oracle's float64. The
# engine sums a person's exposure in float32 over its contacts (relative
# error up to ~K * 2^-24 for K terms), so exp(-A) may move by ~A * K * 6e-8;
# 1e-5 of (1 + A) covers K up to ~160 in the worst case. A dwell draw
# -7 log(u) is a few float32 roundings (~2e-7 relative) from the oracle's.
BAND_INFECT = 1e-5
BAND_DWELL = 1e-6
WS_CASE = dict(people=500, locations=120, pop_seed=9, seed=4, tau=1.5e-5, days=30)
STATIC_SEED = 0
STATIC_DAYS = DAYS  # md-mini days of phase 4h (c)


def _shrink_study(spec, pop, root, tag):
    """One resilient study on this rank, checkpointed every CKPT_EVERY days
    into its own directory, under a device loss of one worker at
    SHRINK_DAY: (RunResult, launches); then every rank waits for the
    others (the retired ones for the survivors)."""
    import torch.distributed as dist

    from repro_torch.runtime import ChaosEvent, ChaosSchedule

    spec = spec.with_overrides(ckpt_dir=os.path.join(root, tag), ckpt_every=CKPT_EVERY,
                               resilient=True)
    out = _counted_study(spec, pop, chaos=ChaosSchedule((
        ChaosEvent("device_loss", day=SHRINK_DAY, workers_lost=1),)))
    dist.barrier()
    return out


def _rank_shrink_two(pop, days, root):
    """Phase 4h (a) on each of two ranks sharing the card over gloo: engine
    dist, W = 2 -> 1, B = 1, on each backend; and the wall s of both."""
    t0 = time.perf_counter()
    out = {backend: _shrink_study(study_spec(1, days=days, backend=backend)
                                  .with_overrides(workers=2), pop, root, f"dist-{backend}")
           for backend in ("pallas-compact", "pallas")}
    return dict(out, wall_s=time.perf_counter() - t0)


def _rank_shrink_four(pop, days, root):
    """Phase 4h (b) on each of four ranks: engine hybrid 2 x 2 -> 1 x 2 at
    B = 8; and its wall s."""
    t0 = time.perf_counter()
    out = _shrink_study(study_spec(8, days=days).with_overrides(workers=2, scenarios=2),
                        pop, root, "hybrid")
    return {"hybrid": out, "wall_s": time.perf_counter() - t0}


def _check_shrink(res: list, survivors: int, ref, kname: str, layout: str, what: str,
                  total: dict, card: str) -> None:
    """Phase 4h's checks of one shrink over its ranks' (RunResult,
    launches): the survivors bitwise ``ref`` with DAYS launches, the
    retired ranks with SHRINK_DAY and an empty history, every rank's report
    reading 2 -> 1; then its numbers."""
    for rank, (r, launches) in enumerate(res):
        prov = r.provenance
        rep = prov["resilience"]
        if rep["device_losses"] != [{"workers_before": 2, "workers_after": 1}] or \
                rep["final_workers"] != 1 or rep["final_layout"] != layout:
            raise AssertionError(f"{what} rank {rank}: report {rep}")
        alive = rank < survivors
        expect_launches(launches, kname, DAYS if alive else SHRINK_DAY, f"{what} rank {rank}")
        for k, v in launches.items():
            total[k] += v
        if not alive:
            if r.history or rep.get("retired_at_day") != SHRINK_DAY:
                raise AssertionError(f"{what} rank {rank}: not retired at day {SHRINK_DAY}: "
                                     f"{prov}")
            log(f"[shrink] {what} rank {rank}: retired at day {SHRINK_DAY} after "
                f"{launches[kname]} launches, history empty")
            continue
        same_study(ref, r, f"{what} rank {rank}")
        if prov["resumed_from_day"] != SHRINK_DAY or prov["final_mesh"]["workers"] != 1:
            raise AssertionError(f"{what} rank {rank}: provenance {prov}")
        chunks = [e for e in prov["timeline"] if e["kind"] == "chunk"]
        before = [e["s"] for e in chunks if e["workers"] == 2]
        after = [e["s"] for e in chunks if e["workers"] == 1]
        restores = [e["ms"] for e in prov["timeline"] if e["kind"] == "restore"]
        (el,) = prov["elastic"]
        log(f"[shrink] {what} rank {rank}: bitwise phase 4d's study; device loss at day "
            f"{SHRINK_DAY}, 2 -> 1 workers, {launches[kname]} launches "
            f"({SHRINK_DAY} on W=2, {DAYS - SHRINK_DAY} on W=1); ms/day before "
            f"{1e3 * sum(before) / SHRINK_DAY:.3f}, after "
            f"{1e3 * sum(after) / (DAYS - SHRINK_DAY):.3f}; rebuild {el['rebuild_s']:.3f} s "
            f"(groups {el['groups_s']:.3f} s, plan and tables {el['plan_and_tables_s']:.3f} "
            f"s); restore {restores[-1]:.3f} ms; collectives "
            f"{json.dumps(prov['collectives'], sort_keys=True)}; {card}")


def static_oracle_phase(pop, wrappers, card) -> None:
    """Phase 4h (c): the static-network mode on the card against the
    EpiHiper-style oracle (``core/baseline.py``): the Watts-Strogatz 500 case
    on both backends, equal on every day; then md-mini with the oracle's SIR
    model and seeding, equal on every day until a day that a decision inside
    the float32 band (BAND_INFECT, BAND_DWELL) explains; that day and the
    first in-band day are printed."""
    from repro_torch.configs import get_epidemic
    from repro_torch.core import baseline
    from repro_torch.core import disease as disease_lib
    from repro_torch.core import transmission as tx_lib
    from repro_torch.data import watts_strogatz_population
    from repro_torch.engine import EngineCore

    c = WS_CASE
    ws = watts_strogatz_population(c["people"], c["locations"], seed=c["pop_seed"], name="bl")
    tm = tx_lib.TransmissionModel(tau=c["tau"])
    oracle = baseline.run_sir_on_network(
        ws, baseline.precompute_contact_network(ws, seed=c["seed"]), tm, c["days"],
        c["seed"], seed_per_day=2, seed_days=5, recovery_days=7.0)
    for backend, kname in (("pallas-compact", "interactions_compact"),
                           ("pallas", "interactions_padded")):
        core = EngineCore.single(ws, disease_lib.sir_model(7.0), tm, seed=c["seed"],
                                 static_network=True, seed_per_day=2, seed_days=5,
                                 block_size=BLOCK, device="cuda", backend=backend)
        _, hist, launches, _ = run_path(core, wrappers, c["days"])
        expect_launches(launches, kname, c["days"], f"static WS-500 {backend}")
        for k in ("cumulative", "infectious"):
            if not np.array_equal(hist[k], oracle[k]):
                raise AssertionError(f"static WS-500 {backend}: '{k}' differs from the "
                                     f"oracle: {hist[k]} vs {oracle[k]}")
    log(f"[static] Watts-Strogatz 500, SIR, tau {c['tau']}, seed {c['seed']}, {c['days']} "
        f"days on both backends: cumulative and infectious equal to the oracle on every "
        f"day (attack rate {oracle['cumulative'][-1]} of {c['people']})")

    tm = tx_lib.TransmissionModel(tau=get_epidemic(DATASET).tau)
    t0 = time.perf_counter()
    net = baseline.precompute_contact_network(pop, seed=STATIC_SEED)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = baseline.run_sir_on_network(pop, net, tm, STATIC_DAYS, STATIC_SEED,
                                         seed_per_day=2, seed_days=5, recovery_days=7.0,
                                         margins=True)
    run_s = time.perf_counter() - t0
    core = EngineCore.single(pop, disease_lib.sir_model(7.0), tm, seed=STATIC_SEED,
                             static_network=True, seed_per_day=2, seed_days=5,
                             block_size=BLOCK, device="cuda")
    _, hist, launches, dt = run_path(core, wrappers, STATIC_DAYS)
    expect_launches(launches, "interactions_compact", STATIC_DAYS, "static md-mini")
    # A day's infections show that day; a dwell draw shows at its recovery,
    # later: so the first day the histories part must have an infection
    # decision in the band, or follow a dwell draw in the band.
    in_infect = oracle["infect_margin"] < BAND_INFECT
    in_dwell = np.minimum.accumulate(oracle["dwell_margin"]) < BAND_DWELL
    band = np.flatnonzero(in_infect | (oracle["dwell_margin"] < BAND_DWELL))
    first_band = int(band[0]) if band.size else None
    parts = np.flatnonzero(np.any([hist[k] != oracle[k]
                                   for k in ("cumulative", "infectious")], axis=0))
    first_diff = int(parts[0]) if parts.size else None
    if first_diff is not None and not (in_infect[first_diff] or in_dwell[first_diff]):
        raise AssertionError(
            f"static md-mini: the card parts from the oracle on day {first_diff} with no "
            f"decision inside the float32 band (infect margin "
            f"{oracle['infect_margin'][first_diff]:.3g}, least dwell margin so far "
            f"{np.min(oracle['dwell_margin'][:first_diff + 1]):.3g})")
    edges = sum(len(s) for s in net.src)
    log(f"[static] {DATASET}, SIR(7), tau {tm.tau}, seed {STATIC_SEED}, {STATIC_DAYS} days: "
        + ("equal to the oracle on every day" if first_diff is None else
           f"equal to the oracle on days 0-{first_diff - 1}, parting on day {first_diff} "
           f"(infect margin {oracle['infect_margin'][first_diff]:.3g}, least dwell margin "
           f"so far {np.min(oracle['dwell_margin'][:first_diff + 1]):.3g})")
        + f"; the first day with a decision inside the float32 band: {first_band} "
        f"({0 if first_band is None else band.size} such days); attack rate "
        f"{int(hist['cumulative'][-1])} of {pop.num_people} (oracle "
        f"{int(oracle['cumulative'][-1])}); {STATIC_DAYS} launches")
    log(f"[static] oracle network build {build_s:.3f} s ({edges} directed contact edges a "
        f"week), oracle run {run_s:.3f} s ({1e3 * run_s / STATIC_DAYS:.3f} ms/day, numpy "
        f"float64 on the host); the card {1e3 * dt / STATIC_DAYS:.3f} ms/day; {card}")


def shrink_phase(pop, wrappers, studies, spawned, day_cores, day_state, card) -> dict:
    """Phase 4h: (a) engine dist W = 2 -> 1 on both backends, (b) engine
    hybrid 2 x 2 -> 1 x 2 at B = 8, each under a device loss at SHRINK_DAY
    and bitwise phase 4d's study (``spawned``: their ranks' results, run at
    the end of phase 4g's spawns); (c) the static-network oracle; (d) no
    float64 op in a card day of either route (``day_cores``: phase 4's
    cores by backend, stepped from ``day_state``, day PROFILE_FROM); (e) the
    port's detlint clean. Returns (a) and (b)'s launches by kernel, summed
    over ranks."""
    import shutil

    from repro_torch.analysis.dispatch import assert_no_f64
    from repro_torch.analysis.lint import LintConfig, run_lint
    from repro_torch.engine import day as day_lib

    total = {k: 0 for k in KERNELS}
    two, four = spawned["two"], spawned["four"]
    log(f"[shrink] ranks share one card over gloo (phase 4g's spawns); a device_loss chaos "
        f"event (one worker) fires on every rank at day {SHRINK_DAY} of {DAYS}, "
        f"checkpoints every {CKPT_EVERY} days; the ranks' wall for (a) "
        f"{max(r['wall_s'] for r in two):.1f} s, for (b) {max(r['wall_s'] for r in four):.1f} "
        f"s; {card}")
    for backend, kname in (("pallas-compact", "interactions_compact"),
                           ("pallas", "interactions_padded")):
        _check_shrink([rank[backend] for rank in two], 1, studies[1], kname, "workers",
                      f"(a) dist W=2 -> 1 on {backend}", total, card)
    _check_shrink([rank["hybrid"] for rank in four], 2, studies[8], "interactions_compact",
                  "hybrid", "(b) hybrid 2x2 -> 1x2, B=8", total, card)
    shutil.rmtree(SHRINK_ROOT, ignore_errors=True)

    stamp("static-network oracle")
    static_oracle_phase(pop, wrappers, card)

    stamp("f64 and detlint")
    for backend, core in day_cores.items():
        assert_no_f64(day_lib.day_step, core.topo, core.static, core.week, core.params,
                      day_state)
        log(f"[f64] one card day of {DATASET} on {backend} (day {PROFILE_FROM}): no float64 "
            "op dispatched")
    findings, errors = run_lint([os.path.join(ROOT, "src", "repro_torch"),
                                 os.path.join(ROOT, "chip_smoke.py")], LintConfig())
    if findings or errors:
        raise AssertionError("detlint: " + "; ".join(
            [f"{f.path}:{f.line}: {f.rule} {f.message}" for f in findings] + errors))
    log("[detlint] src/repro_torch and chip_smoke.py: 0 findings, no baseline")
    return total


def spec_bucket(spec, server):
    """The BucketKey a spec lands in on ``server``."""
    from repro_torch.serve import bucketize

    return bucketize(spec.validate(), server.config).bucket


def interactions_only(src: str) -> int:
    """Phases 1 and 3 alone, on the interaction kernels of the checkout whose
    ``src`` directory is given (its own build, wrappers and plain versions,
    this script's inputs, timers and bounds): the way to time an earlier
    commit's kernels beside this one's in one call."""
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.configs import get_epidemic
    from repro_torch.core import disease as disease_lib
    from repro_torch.core import transmission as tx_lib
    from repro_torch.engine import EngineCore
    from repro_torch.kernels.interactions import kernel, ops

    card = card_line()
    log(f"[device] {card}")
    log(f"[interactions-only] kernels from {os.path.abspath(src)}")
    lib, report = kernel.build()
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    epi = get_epidemic(DATASET)
    pop = epi.build()
    covid = disease_lib.covid_model()
    core = EngineCore.single(pop, covid, tx_lib.TransmissionModel(tau=epi.tau), seed=0,
                             block_size=BLOCK, device="cuda")
    wrappers = {k: getattr(kernel, v[0]) for k, v in KERNELS.items()}
    records = interaction_phase(core, covid, kernel, ops, wrappers, card)
    log(json.dumps({"interactions": records}))
    return 0


def main() -> int:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--interactions-only":
        return interactions_only(sys.argv[2])
    if len(sys.argv) != 1:
        print("usage: chip_smoke.py [--interactions-only SRC_DIR]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import INTERVENTION_PRESETS, get_epidemic
    from repro_torch.core import disease as disease_lib
    from repro_torch.core import interventions as iv_lib
    from repro_torch.core import transmission as tx_lib
    from repro_torch.engine import EngineCore
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.interactions import kernel, ops

    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices={count}")
    wrappers = {k: getattr(kernel, v[0]) for k, v in KERNELS.items()}

    # ---- phase 2: build (one nvcc per source, all started together) --------
    stamp("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {m: pool.submit(m.build) for m in (kernel, flash_kernel)}
        built = {m: f.result() for m, f in futures.items()}
    log(f"[build] both sources in {time.perf_counter() - t0:.2f} s")
    for m, (lib, _) in built.items():
        log(f"[build] {os.path.relpath(m.SOURCE, ROOT)} -> {os.path.relpath(lib, ROOT)}")
    ptxas = built[kernel][1]
    log(f"[build] interactions_kernel: {kernel.threads(BLOCK)} threads per CTA at "
        f"b={BLOCK}, dynamic shared memory {kernel.shared_bytes(BLOCK)} bytes")
    inst = None
    for line in ptxas.splitlines():
        m = re.search(r"interactions_kernelILb([01])ELb([01])E", line)
        if m and "entry function" in line:
            inst = f"traced={m.group(1)} padded={m.group(2)}"
        elif inst and ("registers" in line or "spill" in line):
            log(f"[build] interactions_kernel<{inst}>: {line.strip()}")
    inst = None
    for line in built[flash_kernel][1].splitlines():
        m = re.search(r"(flash_fwd_wgmma_kernel|flash_fwd_kernel)I\w*?Li(\d+)E", line)
        if m and "entry function" in line:
            wgmma = m.group(1) == "flash_fwd_wgmma_kernel"
            dt, threads = (torch.bfloat16, 384) if wgmma else (torch.float32, 256)
            inst = f"{m.group(1)}<{'bf16' if wgmma else 'f32'}, Dh={m.group(2)}>"
            log(f"[build] {inst}: dynamic shared memory "
                f"{flash_kernel.shared_bytes(int(m.group(2)), dt)} bytes per CTA of "
                f"{threads} threads")
        elif inst and ("registers" in line or "spill" in line or "smem" in line):
            log(f"[build] {inst}: {line.strip()}")
        elif "Performance Loss" in line:  # ptxas names the kernel it warns about
            log(f"[build] {line.strip()[:240]}")

    # ---- phase 3: kernels against their plain versions ----------------------
    stamp("interaction kernels")
    epi = get_epidemic(DATASET)
    t0 = time.perf_counter()
    pop = epi.build()
    covid = disease_lib.covid_model()
    tm = tx_lib.TransmissionModel(tau=epi.tau)
    core = EngineCore.single(pop, covid, tm, seed=0, block_size=BLOCK, device="cuda")
    torch.cuda.synchronize()
    log(f"[setup] {DATASET}: {pop.num_people} people, "
        f"{pop.num_locations} locations, V={core.week['pid'].shape[1]}, "
        f"NP={core.week['row'].shape[1]}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    P = pop.num_people
    records = interaction_phase(core, covid, kernel, ops, wrappers, card)

    # ---- phase 3b: the kernels with the scenario axis -----------------------
    stamp("batched interaction kernels")
    batched = batched_kernel_phase(core, covid, kernel, ops, wrappers, card)

    # ---- phase 4: the main path -------------------------------------------
    stamp("main path")
    torch.use_deterministic_algorithms(True)
    run1 = run_path(core, wrappers, DAYS)
    final1, hist1, launches, dt1 = run1
    expect_launches(launches, "interactions_compact", DAYS, "main path")
    if not np.array_equal(hist1["edges"], hist1["contacts"]):
        raise AssertionError("in-kernel edges != contacts on some day")
    cum = hist1["cumulative"]
    seeds = core.batch[0].seed_per_day * core.batch[0].seed_days
    if np.any(np.diff(cum) < 0) or cum[-1] <= seeds:
        raise AssertionError(f"cumulative not monotone or not above {seeds}: {cum}")
    final2, hist2, _, dt2 = run_path(core, wrappers, DAYS)
    same_run((final1, hist1), (final2, hist2), "main path second run")
    edges = int(hist1["edges"].sum())
    log(f"[main] {DATASET} covid seed 0, {DAYS} days: launches={launches['interactions_compact']}, "
        f"cumulative={int(cum[-1])} ({100.0 * cum[-1] / P:.2f}%), "
        f"peak_infectious={int(hist1['infectious'].max())} on day "
        f"{int(np.argmax(hist1['infectious']))}, edges={edges}")
    log(f"[main] run 1: {1e3 * dt1 / DAYS:.3f} ms/day; run 2: "
        f"{1e3 * dt2 / DAYS:.3f} ms/day, {edges / dt2:.4g} traversed edges/s; "
        f"bitwise identical; {card}")
    padded_core = EngineCore.single(pop, covid, tm, seed=0, block_size=BLOCK,
                                    device="cuda", backend="pallas")
    final_p, hist_p, launches, dt_p = run_path(padded_core, wrappers, DAYS)
    expect_launches(launches, "interactions_padded", DAYS, "main path, pallas")
    same_run((final1, hist1), (final_p, hist_p), "main path, pallas against pallas-compact")
    log(f"[main] backend pallas: launches={launches['interactions_padded']}, "
        f"{1e3 * dt_p / DAYS:.3f} ms/day, {edges / dt_p:.4g} traversed edges/s; "
        f"bitwise equal to pallas-compact; {card}")

    # ---- phase 4b: where a day's time goes --------------------------------
    mid_state = core.run_days(PROFILE_FROM)[0]
    profile_days(core, mid_state, card, "main")

    # ---- phase 4c: the TTI path -------------------------------------------
    stamp("TTI path")
    tti = {}
    for backend in ("pallas-compact", "pallas", "pallas", "pallas-compact"):
        c = EngineCore.single(pop, covid, tm, seed=0, block_size=BLOCK, device="cuda",
                              backend=backend, interventions=INTERVENTION_PRESETS["tti"])
        final, hist, launches, dt = run_path(c, wrappers, DAYS)
        traced = "interactions_compact_traced" if backend == "pallas-compact" \
            else "interactions_padded_traced"
        expect_launches(launches, traced, DAYS, f"TTI path, {backend}")
        if not np.array_equal(hist["edges"], hist["contacts"]):
            raise AssertionError(f"TTI {backend}: edges != contacts on some day")
        if hist["tests_used"].max() > TTI_TESTS_PER_DAY:
            raise AssertionError(f"TTI {backend}: test budget exceeded")
        for k in ("tests_used", "isolated", "traced"):
            if hist[k].max() <= 0:
                raise AssertionError(f"TTI {backend}: '{k}' is zero on every day")
        if backend in tti:
            same_run(tti[backend][:2], (final, hist), f"TTI {backend} second run")
        tti.setdefault(backend, (final, hist, []))[2].append(dt)
        e = int(hist["edges"].sum())
        log(f"[tti] {DATASET} covid seed 0 preset tti, backend {backend}, {DAYS} days: "
            f"launches={launches[traced]} ({traced}), cumulative={int(hist['cumulative'][-1])} "
            f"({100.0 * hist['cumulative'][-1] / P:.2f}%), tests={int(hist['tests_used'].sum())}, "
            f"isolated_peak={int(hist['isolated'].max())}, traced={int(hist['traced'].sum())}, "
            f"edges={e}; {1e3 * dt / DAYS:.3f} ms/day, {e / dt:.4g} traversed edges/s; {card}")
    same_run(tti["pallas"][:2], tti["pallas-compact"][:2], "TTI pallas against pallas-compact")
    log("[tti] both backends bitwise equal (histories and final states), and each "
        "second run bitwise identical")
    tti_core = EngineCore.single(pop, covid, tm, seed=0, block_size=BLOCK, device="cuda",
                                 interventions=INTERVENTION_PRESETS["tti"])
    tti_mid = tti_core.run_days(PROFILE_FROM)[0]
    profile_days(tti_core, tti_mid, card, "tti")

    # ---- phase 4d: scenario batches, this slice's main path -----------------
    stamp("ensembles")
    main_launches, studies, cores = ensemble_phase(pop, covid, epi, wrappers, card)

    # ---- phase 4e: chunked runs and recovery ------------------------------
    stamp("chunked runs")
    chunked_phase(pop, wrappers, studies, card)

    # ---- phase 4f: the simulation server ----------------------------------
    stamp("simulation server")
    served_launches = served_phase(pop, epi, cores, wrappers, card)

    # ---- phase 4g: meshes ---------------------------------------------------
    stamp("meshes")
    local = {("none", "pallas-compact"): (final1, hist1), ("none", "pallas"): (final_p, hist_p),
             ("tti", "pallas-compact"): tti["pallas-compact"][:2],
             ("tti", "pallas"): tti["pallas"][:2]}
    mesh_launches, shrunk = mesh_phase(pop, wrappers, local, studies, card)

    # ---- phase 4h: elastic shrink, the static-network oracle, detlint -------
    stamp("elastic shrink")
    shrink_launches = shrink_phase(pop, wrappers, studies, shrunk,
                                   {"pallas-compact": core, "pallas": padded_core},
                                   mid_state, card)

    # ---- phase 5: reference on a small input ------------------------------
    stamp("reference")
    torch.use_deterministic_algorithms(False)
    small = get_epidemic("twin-2k")
    spop = small.build()
    tti_slot = [iv_lib.TestTraceIsolate("tti", tests_per_day=15, start_day=3,
                                        isolation_days=6, trace_isolation_days=9)]
    for label, days, kw in (("untraced", 30, dict(seed=0)),
                            ("tti", 25, dict(seed=7, seed_per_day=4,
                                             interventions=tti_slot))):
        hists = {}
        for device in ("cuda", "cpu"):
            c = EngineCore.single(spop, covid, tx_lib.TransmissionModel(tau=small.tau),
                                  block_size=BLOCK, device=device, **kw)
            hists[device] = c.run1(days)[1]
        diff = [d for d in range(days)
                if any(hists["cuda"][k][d] != hists["cpu"][k][d] for k in hists["cpu"])]
        ar = {d: 100.0 * h["cumulative"][-1] / spop.num_people for d, h in hists.items()}
        if abs(ar["cuda"] - ar["cpu"]) > 5.0:
            raise AssertionError(f"twin-2k {label} attack rates differ: {ar}")
        if label == "tti" and min(hists["cuda"][k].sum()
                                  for k in ("tests_used", "isolated", "traced")) <= 0:
            raise AssertionError("twin-2k tti: tests, isolation or tracing unused")
        log(f"[reference] twin-2k {label} {days} days, card vs CPU plain path: first "
            f"differing day {diff[0] if diff else None}; attack rate "
            f"{ar['cuda']:.2f}% vs {ar['cpu']:.2f}%")

    # ---- phase 6: flash attention against its plain version -----------------
    stamp("flash attention")
    flash_rec = flash_phase(flash_kernel, card)

    # ---- phase 7: the serving path ------------------------------------------
    stamp("serving")
    flash_launches = serve_phase(flash_kernel, card)

    stamp("end")
    log(card)
    line = []
    for kname, (_, _, _, replaces) in KERNELS.items():
        rec = batched[kname]  # at B = 8, the main path's batch width
        line.append({
            "name": kname,
            "route": "cuda",
            "source": os.path.relpath(kernel.SOURCE, ROOT),
            "replaces": replaces,
            "launches": main_launches[kname],
            "served_launches": served_launches[kname],
            "mesh_launches": mesh_launches[kname],
            "shrink_launches": shrink_launches[kname],
            "max_abs_err": max(rec["max_abs_err"],
                               *(r["max_abs_err"] for r in records[kname].values())),
            "ms": rec["ms"],
            "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    line.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": os.path.relpath(flash_kernel.SOURCE, ROOT),
        "replaces": FLASH_REPLACES,
        "launches": flash_launches,
        **flash_rec,
    })
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
