#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --interactions-only SRC_DIR
    python3 chip_smoke.py --flash-only SRC_DIR
    python3 chip_smoke.py --families-only
    python3 chip_smoke.py --train-only
    python3 chip_smoke.py --shard-only
    python3 chip_smoke.py --tooling-only

The second form runs phases 1 and 3 alone on the interaction kernels of the
checkout whose src/ directory is given (an earlier commit's, unpacked with
git archive, to time its kernels beside this one's in one call); the third
runs phase 6 alone on that checkout's flash-attention kernels, with this
script's cases, inputs, timers and bounds; the fourth runs phase 7b alone;
the fifth phase 8 alone (it builds no kernel: training launches none); the
sixth builds the flash source and runs phase 9 alone; the seventh builds the
flash source and runs phase 10 alone (the train step timed there).

Phases, each fatal on failure (a traceback and a non-zero exit, no result):

  1. device — the card's name and power limit; no CUDA device is an error;
  2. build  — nvcc builds the interaction kernels (one source, four
     instantiations), the flash-attention kernels (one source: the bf16
     wgmma/TMA design at Dh 64/128/256 and the float32 split-TF32 mma.sync
     design at the same three) and the counter draw (one source), all at
     once, from the checkout's sources and prints ptxas's registers /
     shared memory / spills for each;
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
  3c. the counter draw — rng_uniform_kernel against core/rng.py's int64
     path on the card at the day's draw shape, B = 1 and (256, 55,130),
     bitwise; its device-alone time beside its bound and the int64 path's;
  4. one scenario — EngineCore.single on md-mini, covid, seed 0, 200 days
     under torch.use_deterministic_algorithms(True), the day loop under
     torch.cuda.set_sync_debug_mode("error"): one kernel launch per day and
     four counter draws (one more a day per testing slot under "tti", here
     and wherever phases 4-4h count launches), edges == contacts every day,
     a monotone cumulative count above the seeds, and a bitwise-identical second run; then the same run on the
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
     scenario-day), once each; launch/sweep.py once;
  4e. chunked runs and recovery — api.run at B = 8 checkpointed every 50
     days into a fresh directory under build/: every history column and
     observable bitwise equal to phase 4d's unchunked B = 8 study, 200
     launches; a 100-day prefix resumed to 200 days, bitwise, then a second
     resume that launches nothing; under the recovery policy, chaos events
     raise@100, nan@150 and corrupt@150, each bitwise, with 200 launches plus
     the replayed days and the recovery report printed; a TTI B = 1 study on
     "pallas" (the traced padded kernel) resumed bitwise; the unchunked,
     then the checkpointed study at B = 8 and 64 (ms per scenario-day),
     the host copy and the wait on the writer per
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
     group's timeout 60 s, each spawn's wall limit 700 s; the three spawns
     start before phase 4e and run at once, beside phases 4e and 4f, whose
     times include their load); the ranks share one card, so no scaling
     claim: (a) one rank over nccl, the ``workers``
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
     per day by kind and bytes sent; (e) the simulation server on each mesh
     layout, inside the same spawns: W = 2 and S = 2 (two ranks) and hybrid
     2 x 2 (four ranks), md-mini, covid, SERVE_CHUNK-day chunks, two width-4
     buckets (("none",) on pallas-compact, ("tti",) on pallas), four
     requests of 1-3 scenarios and 20-40 days from two client threads on
     rank 0 while the other ranks follow: every result bitwise phase 4d's
     columns, the first of each bucket bitwise its solo api.run on the same
     mesh, every rank's dispatch log equal, no build (runner, plan, tables,
     group) after the warm-ups, one launch per served day on every rank;
     served ms/day, latency p50/p99 and requests/s per layout;
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
  4i. the reference's lower-level entry points (core/simulator.py) on phase
     4's B = 1 cores, EAGER_DAYS (14) days on each backend: run_eager, and
     run_scan then one day_step, each bitwise phase 4's first days and
     run1's final state, one launch a day; run_eager's visits / interact /
     update ms per day (each phase ends in a synchronise) beside phase 4's
     eager ms/day;
  5. reference — twin-2k on the card against the plain path on the CPU, 30
     days untraced and 25 days under test-trace-isolate: the same
     trajectory up to float ulps in exp/log;
  6. flash attention — the kernels (built in phase 2 beside the interaction
     kernels) against their plain version at qwen2-1.5b's prefill shape (B=8,
     S=512, 12 query heads over 2 KV heads, Dh=128, bf16, causal) and in
     extra cases (Dh 64 and 256, float32 at Dh 64/128/256 and 2048 keys,
     end-aligned Sq < Sk, a window of 128, ragged tiles, a long 2048-token
     causal prefill, and phase 7b's prefill shapes: llava, mixtral,
     moonshot, recurrentgemma at 128 and 2,560 tokens, whisper), each within its stated tolerance; times of the kernel,
     the plain version and F.scaled_dot_product_attention (the library
     yardstick, never used by the port; in float32 the profiler names the
     kernels it runs), and the bound (float32: under the split-TF32 model
     and, beside it, the FP32 lanes');
  7. the serving path — repro_torch.launch.serve.serve with qwen2-1.5b at
     full width and depth (28 layers, d_model 1536), bf16, attn_impl
     "flash", seeded random parameters, batch 8, prompt 512, 32 greedy
     tokens: 28 kernel launches per prefill, the prefill's last logits
     against the replay's at position 511 and a "naive" prefill, a second
     session giving identical tokens; prefill ms, decode ms per step and
     tokens/s;
  7b. the other families — serve() at full width, bf16, "flash", batch 8,
     prompt 128, 16 greedy tokens, one model at a time (FAMILY_CASES):
     llava-next-mistral-7b (32 layers, 576 zero patches), mixtral-8x7b (4 of
     32 layers, served twice: identical tokens), moonshot-v1-16b-a3b (6 of
     48), recurrentgemma-9b (38) and mamba2-130m (24); flash launches per
     prefill 32 / 4 / 6 / 12 / 0; the prefill's last logits against a
     "naive" prefill and against the replay at position 127 (vlm: the
     replay against a text-only prefill, since decode never sees the
     patches; moe: at a capacity where nothing drops, a row exempt from the
     layer where its own last token routes differently at a near tie;
     ssm: the bf16 replay on 6 layers, the full depth's in float32); a
     recurrentgemma prefill at S = 2,560 (past its 2,048 window) against
     naive; whisper-base through models/model.py (1,500 frames, a 64-token
     prompt, 6 flash launches, then 16 decode steps); prefill ms, decode ms
     per step, tokens/s and peak memory per family;
  8. LM training (TRAIN_* below), every kernel's launch count set to 0 at
     its start and read at its end: 0 (training attends through the
     chunked online softmax, as the reference does without a mesh; the
     flash kernel is forward-only) — (a) all ten archs at reduced_config in
     float32, one step on the card against the same step on the CPU from
     the same parameters and batch: loss, every gradient leaf and an AdamW
     update from the same gradients, each within its stated tolerance;
     (b) smollm-360m at full width and depth through launch/train.py's
     train(), the "full" preset (bf16 compute, float32 parameters and
     moments), batch 8 x 256, 30 steps checkpointed every 10 into a
     temporary directory under build/ (removed) with a failure injected at
     step 15: restarts 1, parameters, moments and every logged loss bitwise
     an uninterrupted 30-step run's; the first batch's loss lower after
     training; median ms per step, tokens/s, peak memory, a profiled step
     (device busy, idle share, ops); 3 steps under attn_impl=flash: 0 flash
     launches, losses bitwise attn_impl=chunked's; (c) mixtral-8x7b (2 of
     32 layers), moonshot-v1-16b-a3b (4 of 48), llava-next-mistral-7b (4 of
     32, 576 patches + 128 tokens), recurrentgemma-9b (one cycle),
     mamba2-130m and whisper-base (whole), bf16, batch 4, 5 steps each,
     twice: finite losses, a finite non-zero gradient norm, the rerun
     bitwise (losses and a word-sum fingerprint of parameters and moments);
     ms per step, peak memory, the MoE's dropped_fraction;
  9. LM sharding (SHARD_* below) — one spawn of four ranks sharing cuda:0
     over gloo (started beside phase 4g's spawns, read after phase 8; alone
     under --shard-only), a (data 2, model 2) DeviceMesh, weights drawn on the card
     leaf by leaf and placed by the shardings of launch/steps.py: (a)
     qwen2-1.5b (28 layers) served: a float32 sharded prefill against the
     unsharded port (the float32 kernel per data shard), a bf16 prefill
     through make_prefill_step (28 flash launches per rank), again bitwise,
     and 16 greedy decode steps through make_decode_step against an
     unsharded session (logits within the 8% band, tokens compared); (b)
     smollm-360m (32 layers) trained: a float32 step against unsharded
     (loss, every gradient leaf, AdamW from the same gradients), then three
     bf16 steps through make_train_step and the first again, bitwise, 0
     flash launches;
     (c) mixtral-8x7b (2 of 32 layers) with the shard_map MoE dispatch: a
     float32 prefill against unsharded where nothing drops, layer 0's MoE
     against moe_ffn on each data shard, a bf16 prefill (2 launches per
     rank), again bitwise; on each rank one layer's local planes through
     the kernel and its plain version; ms per prefill, decode step and train
     step, collectives by kind and operand bytes (analysis/hlo.py), peak memory per
     rank, a profiled sharded prefill on rank 0 — four ranks sharing one
     card, not a scaling figure;
  10. the LM tooling (DRYRUN_* and ROOFLINE_* below) — [roofline] phase
     7's qwen2-1.5b prefill and phase 8's smollm-360m train step once more
     on the card under analysis/hlo.py:measure_compiled (the flash kernel's
     analytic flops added, its launches counted from 0: 28), measured flops
     against model_flops, useful_flops_fraction, the median ms and
     mfu = model_flops / (989e12 x t), with the card's name and power limit;
     then [dryrun] repro_torch.launch.dryrun in two subprocesses at once,
     each within its wall limit: qwen2-1.5b's prefill_32k cell on a fake
     16 x 16 world (--quick; meta tensors) and the md-mini epidemic day on
     256 fake workers, each record's headline; beside them [dryrun:3d]
     whisper-base's encoder self-attention forward and backward on meta
     DTensors on a fake 2 x 16 x 16 world, in this process (the op of the
     train_4k cell whose backward failed before; seconds, fatal).

The line before the last is the kernels' JSON record (``launches``: phase
4d's; the counter draw's ``launches`` phase 4d's B = 8 ensemble on
pallas-compact, ``timed_launches`` phase 3c's; flash's ``launches`` phase
7's, ``family_launches`` phase 7b's; ``served_launches``: phase 4f's
closed-loop mix; ``mesh_launches``:
phase 4g (a)-(d)'s, ``mesh_served_launches``: phase 4g (e)'s mixes and
``shrink_launches``: phase 4h (a)-(b)'s, each summed over its ranks;
``eager_launches``: phase 4i's run_eager; ``train_launches``: phase 8's,
and for flash ``train_flash_launches``, its attn_impl=flash run's, and
``shard_launches``, phase 9's per rank, by run, and
``roofline_launches``, phase 10's measured prefill's); the
last line is
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
# The counter draw's launch count (kernels/rng/kernel.py:uniform_cuda), and
# the draws of an eager day: infection, seeding, transition and dwell (one
# more per testing slot, engine/day.py's TEST draw).
DRAW = "rng_uniform"
DRAWS_PER_DAY = 4
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
# bf16 FLOP/s and 495e12 TF32. One TF32 product cannot hold the float32
# tolerance, so the float32 kernel takes each product as three TF32 ones
# (split TF32, csrc/flash_attention.cu): its float32-accurate rate is a third
# of the TF32 peak. FLASH_OLD_PEAK, printed beside it, is the FP32 lanes'
# 67e12 FLOP/s, the bound of a float32 kernel off the tensor cores.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
FLASH_OLD_PEAK = {torch.float32: 67e12}
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
# kernel, float32 the split-TF32 one. "long" and "f32_long" (~103 GFLOP of
# live pairs) are bound by operations: they show how near the tensor cores'
# rate each design comes.
FLASH_CASES = (
    ("prefill", 8, 12, 2, 512, 512, 128, torch.bfloat16, True, None),
    ("dh64", 8, 12, 2, 512, 512, 64, torch.bfloat16, True, None),
    ("dh256", 8, 12, 2, 512, 512, 256, torch.bfloat16, True, None),
    ("f32", 8, 12, 2, 512, 512, 128, torch.float32, True, None),
    ("end_aligned", 8, 12, 2, 256, 512, 128, torch.bfloat16, True, None),
    ("window128", 8, 12, 2, 512, 512, 128, torch.bfloat16, True, 128),
    ("ragged", 2, 12, 2, 200, 300, 64, torch.float32, False, None),
    ("long", 8, 12, 2, 2048, 2048, 128, torch.bfloat16, True, None),
    ("f32_dh64", 8, 12, 2, 512, 512, 64, torch.float32, True, None),
    ("f32_dh256", 8, 12, 2, 512, 512, 256, torch.float32, True, None),
    ("f32_long", 8, 12, 2, 2048, 2048, 128, torch.float32, True, None),
    # phase 7b's prefill shapes: llava (576 patches + 128 tokens, window
    # 4096), mixtral (window 4096), moonshot (16 query heads over 16 KV
    # heads), recurrentgemma (16 query heads over one KV head, Dh 256, window
    # 2048; at 2,560 tokens past the window), whisper's decoder
    ("llava", 8, 32, 8, 704, 704, 128, torch.bfloat16, True, 4096),
    ("mixtral", 8, 32, 8, 128, 128, 128, torch.bfloat16, True, 4096),
    ("moonshot", 8, 16, 16, 128, 128, 128, torch.bfloat16, True, None),
    ("rgemma", 8, 16, 1, 128, 128, 256, torch.bfloat16, True, 2048),
    ("rgemma_2560", 4, 16, 1, 2560, 2560, 256, torch.bfloat16, True, 2048),
    ("whisper", 8, 8, 8, 64, 64, 64, torch.bfloat16, True, None),
)
# the plain version's timed calls (default 20)
FLASH_PLAIN_REPS = {"long": 3, "f32_long": 3, "rgemma_2560": 3}
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
    ``launches`` maps each wrapper and :data:`DRAW` to its count; ``hist``
    maps each stat to scenario ``column``'s (days,) series, or with
    ``column=None`` to the (days, B) array."""
    from repro_torch.api import observables as obs_lib
    from repro_torch.engine import hist_to_numpy
    from repro_torch.kernels.rng import kernel as rng_kernel

    state = core.init_state()
    obs = obs_lib.make_observables(observables)
    carries = obs_lib.init_carries(obs, obs_lib.ObsContext(
        num_people=core.pop.num_people, num_scenarios=core.num_real, device=str(core.device)))
    torch.cuda.synchronize()
    for w in (*wrappers.values(), rng_kernel.uniform_cuda):
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
    launches[DRAW] = rng_kernel.uniform_cuda.launches
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


def expect_launches(launches: dict, kernel: str, days: int, what: str,
                    draws: int = DRAWS_PER_DAY) -> None:
    """``kernel`` launched once a day and no other interaction kernel; where
    ``launches`` counts the draw kernel (:data:`DRAW`), ``draws`` a day."""
    want = {k: days if k == kernel else 0 for k in launches}
    if DRAW in launches:
        want[DRAW] = draws * days
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def flash_bound(q, k, v, o, live_pairs: int, peaks=PEAK_FLOPS):
    """Least time for the attention function: Q, K, V read once and O written
    once at peak bandwidth (K/V at their kv-head count: the kernel reads them
    in place), against 4 Dh flops (two multiply-adds) per unmasked
    (query, key) pair and query head at the input type's peak rate in
    ``peaks``."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
    flops = 4 * q.shape[-1] * live_pairs * q.shape[0]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peaks[q.dtype] * 1e3
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


def device_kernel_names(fn) -> list:
    """The device kernels of ``fn``, by torch.profiler over 20 calls: the
    device events, else the averages with device time, else "not measured"
    (what the whole script has printed here, after its earlier phases; the
    --flash-only mode names them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    if not names:
        names = {a.key for a in prof.key_averages()
                 if getattr(a, "self_device_time_total", 0) > 0}
    return sorted(names) or ["not measured"]


def flash_phase(fk, card: str) -> dict:
    """The flash kernel against its plain version in each of FLASH_CASES;
    times by CUDA events; returns each case's JSON fields by label."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products in
    torch.backends.cudnn.allow_tf32 = False  # the plain version and SDPA
    # detlint: ignore[DET001] — the flash cases' inputs: a seeded generator
    # on the card, not simulation state
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
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
        old = ""
        if dt in FLASH_OLD_PEAK:
            old_ms, old_by, _ = flash_bound(q, k, v, o_k, live, FLASH_OLD_PEAK)
            old = (f" (FP32-lane model {old_ms:.5f}, {old_by}; device alone "
                   f"{100.0 * old_ms / device_ms:.2f}% of it)")
            log(f"[flash:{label}] SDPA's device kernels in float32: "
                f"{device_kernel_names(run_lib)}")
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
            f"{flops / 1e9:.3f} GFLOP, live fraction {live / (Sq * Sk):.4f}){old} "
            f"{100.0 * bound_ms / ms:.2f}% of bound; {flops / ms / 1e9:.2f} TFLOP/s (device "
            f"alone {100.0 * bound_ms / device_ms:.2f}%, {flops / device_ms / 1e9:.2f}); {card}")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms, device_ms=device_ms,
                          library_device_ms=lib_device_ms)
    return out


# The flash kernels' mangled names (flash_fwd_kernel: the FP32-lane float32
# kernel of older checkouts, which --flash-only may build).
FLASH_KERNEL_NAME = re.compile(
    r"(flash_fwd_wgmma_kernel|flash_fwd_f32_kernel|flash_fwd_kernel)I\w*?Li(\d+)E")


def log_flash_build(report: str, fk=None) -> None:
    """ptxas's registers, shared memory and spills for each flash kernel in
    a build's ``-Xptxas -v`` report (and, given this checkout's module
    ``fk``, each one's dynamic shared memory and threads per CTA)."""
    inst = None
    for line in report.splitlines():
        m = FLASH_KERNEL_NAME.search(line)
        if m and "entry function" in line:
            bf16 = m.group(1) == "flash_fwd_wgmma_kernel"
            dt, Dh = (torch.bfloat16 if bf16 else torch.float32), int(m.group(2))
            inst = f"{m.group(1)}<{'bf16' if bf16 else 'f32'}, Dh={Dh}>"
            if fk is not None:  # threads: bf16 three warpgroups, float32 a warp per 16 rows
                threads = 384 if bf16 else 32 * fk.TILES[dt][0] // 16
                log(f"[build] {inst}: dynamic shared memory {fk.shared_bytes(Dh, dt)} "
                    f"bytes per CTA of {threads} threads")
        elif inst and ("registers" in line or "spill" in line or "smem" in line):
            log(f"[build] {inst}: {line.strip()}")
        elif "Performance Loss" in line:  # ptxas names the kernel it warns about
            log(f"[build] {line.strip()[:240]}")


def flash_only(src: str) -> int:
    """Phase 6 alone, on the flash-attention kernels of the checkout whose
    ``src`` directory is given (its own build, wrapper and plain version;
    this script's cases, inputs, timers and bounds): the way to time an
    earlier commit's kernels beside this one's in one call."""
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels.flash_attention import kernel as fk

    card = card_line()
    log(f"[device] {card}")
    log(f"[flash-only] kernels from {os.path.abspath(src)}")
    t0 = time.perf_counter()
    _, report = fk.build()
    log(f"[build] {os.path.relpath(fk.SOURCE, os.path.abspath(src))} in "
        f"{time.perf_counter() - t0:.2f} s")
    log_flash_build(report)
    records = flash_phase(fk, card)
    log(card)
    log(json.dumps({"flash": records}))
    return 0


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


# Phase 7b: the other families served at full width through serve(), bf16,
# attn_impl "flash", seeded random weights drawn on the card, batch 8, prompt
# 128 (each session replays 127 positions and generates 16), one model at a
# time: (arch, layers run (None: all), flash launches per prefill). Depth is
# cut only where one card's memory forces it: mixtral's 32 layers of eight
# 4096 x 14336 experts are ~93 GB in bf16, moonshot's 48 layers of 64
# experts ~33 GB (with the float32 draw they come from, more than one card).
FAMILY_CASES = (
    ("llava-next-mistral-7b", None, 32),
    ("mixtral-8x7b", 4, 4),
    ("moonshot-v1-16b-a3b", 6, 6),
    ("recurrentgemma-9b", None, 12),
    ("mamba2-130m", None, 0),
)
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 8, 128, 16
FAMILY_RERUN = "mixtral-8x7b"  # served twice: identical tokens
# recurrentgemma prefilled past its 2,048-token local window against naive
WINDOW_ARCH, WINDOW_BATCH, WINDOW_S = "recurrentgemma-9b", 4, 2560
# whisper through models/model.py (the serve driver refuses audio, as the
# reference's): 1,500 frames, a 64-token prompt, then 16 decode steps
AUDIO_ARCH, AUDIO_PROMPT, AUDIO_STEPS, AUDIO_FLASH = "whisper-base", 64, 16, 6
# A MoE routing decision the rounding cannot order: a token's top-k experts
# may differ between two paths whose router logits for that token agree
# within this fraction of the layer's largest |router logit|: one bf16 step
# there (the router's bf16 logits round to 2^-8..2^-7 of their magnitude).
# On an H100 the largest such difference at a token routed differently was
# 0.0039 of 0.918 (moonshot) and 0.0029 of 1.07 (mixtral): 2^-7.9 and
# 2^-8.5. See moe_exempt_rows for the rows this exempts.
ROUTER_TIE_TOL = 2**-7
# The ssm replay in float32 compute against its prefill: the decode
# recurrence and the chunked scan sum in other orders (on the CPU at 24
# layers: the port's replay 4.1e-5 of max |logit| from its prefill, the
# reference's 6.2e-5 from its own)
F32_REL_TOL = 1e-3
# mamba2's bf16 replay is held to SERVE_REL_TOL on a cut of this depth,
# where the reference's own replay reads 0.024 of max |logit| on the CPU
SSM_BF16_LAYERS = 6


def moe_routes(fn):
    """fn()'s result and, for each MoE layer call it made, the dispatch's
    own routing (``moe.assign``): router logits (T, E) and each token's kept
    experts (T, K; -1 where dropped over capacity). The record keeps the
    dispatch's tensors (no copy, no sync), so it adds nothing to a timed
    session."""
    from repro_torch.models import moe as moe_lib

    record, orig = [], moe_lib.assign

    def recorded(router_logits, k, C):
        out = orig(router_logits, k, C)
        record.append((router_logits, out[1], out[3]))
        return out

    moe_lib.assign = recorded
    try:
        result = fn()
    finally:
        moe_lib.assign = orig
    return result, [(lg, torch.where(keep, gi.reshape(-1), -1).reshape(gi.shape))
                    for lg, gi, keep in record]


def dropped_fraction(calls) -> float:
    """The assignments dropped over capacity, as a fraction (mean over calls)."""
    return float(sum(float((kept < 0).float().mean()) for _, kept in calls)) / len(calls)


def moe_exempt_rows(a_calls, b_calls, a_last, b_last) -> tuple:
    """The rows whose logits two runs' MoE layer calls (each dropping
    nothing) leave ill-posed to compare. Row r's last token is
    ``a_last[r]`` in each of ``a_calls`` and ``b_last[r]`` in ``b_calls``.
    With nothing dropped, a row's routing depends on its own tokens alone.
    Walking the layers in order, a row becomes exempt in the first layer
    where its last token is routed to other experts with its own router
    logits within ROUTER_TIE_TOL of the layer's largest (a near tie), and
    stays exempt (its hidden state differs after that). A last token routed
    otherwise in a row not yet exempt is a fault. Returns (rows, log text)."""
    rows, notes = set(), []
    for layer, ((la, ka), (lb, kb)) in enumerate(zip(a_calls, b_calls)):
        if bool((ka < 0).any()) or bool((kb < 0).any()):
            raise AssertionError(f"MoE layer {layer}: an assignment was dropped")
        scale = float(la.abs().max())
        for r, (ta, tb) in enumerate(zip(a_last, b_last)):
            if r in rows or torch.equal(ka[ta].sort().values, kb[tb].sort().values):
                continue
            d = float((la[ta] - lb[tb]).abs().max())
            if d > ROUTER_TIE_TOL * scale:
                raise AssertionError(f"MoE layer {layer}: row {r}'s last token routed "
                                     f"differently with no near tie (its router logits "
                                     f"differ by {d} of {scale})")
            rows.add(r)
            notes.append(f"layer {layer}: row {r} (its router |d| {d:.4g} of {scale:.4g})")
    return rows, "; ".join(notes) or "none"


def held_rows(pre, other, rows, what: str, label: str, tol=SERVE_REL_TOL) -> None:
    """``pre`` against ``other`` ((B, 1, V) logits) on the rows not in
    ``rows``, within ``tol`` of the largest |logit|."""
    scale = float(pre.abs().max())
    d_rows = (pre.float() - other.float()).abs().amax(dim=(1, 2))
    held = [r for r in range(pre.shape[0]) if r not in rows]
    if not held:
        raise AssertionError(f"[family:{label}] {what}: every row exempt")
    d = float(d_rows[held].max())
    agree = float((pre.argmax(-1) == other.argmax(-1)).float().mean())
    log(f"[family:{label}] prefill logits against {what}: max |d| {d:.5f} over rows {held} "
        f"of max |logit| {scale:.4f} (tolerance {tol} x that; per row "
        f"{[round(float(v), 4) for v in d_rows]}), argmax agreement {agree:.3f}")
    if d > tol * scale:
        raise AssertionError(f"[family:{label}] prefill logits against {what}: {d} > "
                             f"{tol} x {scale}")


def moe_replay(cfg, params, prompts, res, calls, pre_last, label: str) -> None:
    """The MoE replay against its prefill: held where the prefill dropped
    nothing; where it dropped (a decode step of FAMILY_BATCH tokens cannot),
    the session is served again at a capacity factor of E / K, where
    nothing can drop, and that replay is held to that prefill."""
    import dataclasses

    from repro_torch.launch.serve import serve

    L = cfg.num_layers
    dropped = dropped_fraction(calls[:L])
    log(f"[family:{label}] the prefill dropped {dropped:.6f} of its assignments "
        f"(mean over layers) at capacity factor {cfg.capacity_factor}")
    if dropped > 0.0:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
        res, calls = moe_routes(lambda: serve(cfg, params, prompts, FAMILY_GEN, device="cuda"))
    step = calls[L + (FAMILY_PROMPT - 1) * L:L + FAMILY_PROMPT * L]
    rows, note = moe_exempt_rows(calls[:L], step, pre_last, list(range(FAMILY_BATCH)))
    log(f"[family:{label}] replay routed differently from prefill: {note}")
    held_rows(res.prefill_logits, res.replay_logits, rows,
              f"replay at capacity factor {cfg.capacity_factor}", label)


def ssm_replay(cfg, prompts, pre, rep, label: str) -> None:
    """The ssm replay against its prefill. In bf16 the recurrence's rounding
    grows through mamba2's 24 layers of random weights in the reference too
    (on the CPU, at full width, vocab cut to 4,096, a 64-token prompt: the
    reference's replay against its own prefill 0.217 of max |logit| in
    bf16, 6.2e-5 in float32; 0.024 at 6 layers), so the full depth's bf16
    gap is logged; the bf16 replay is held on SSM_BF16_LAYERS layers, and
    the full depth's in float32 compute."""
    import dataclasses

    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    d = float((pre - rep).abs().max())
    log(f"[family:{label}] bf16 replay against prefill at {cfg.num_layers} layers (held at "
        f"{SSM_BF16_LAYERS} and in float32): max |d| {d:.5f} of max "
        f"|logit| {float(pre.abs().max()):.4f}")
    cut = dataclasses.replace(cfg, num_layers=SSM_BF16_LAYERS)
    res = serve(cut, family_params(cut), prompts, FAMILY_GEN, device="cuda")
    held_rows(res.prefill_logits, res.replay_logits, set(),
              f"bf16 replay on {SSM_BF16_LAYERS} of {cfg.num_layers} layers", label)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    # detlint: ignore[DET001] — the same seeded random weights, in float32
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    res = serve(cfg, params, prompts, FAMILY_GEN, device="cuda")
    held_rows(res.prefill_logits, res.replay_logits, set(), "replay in float32 compute",
              label, tol=F32_REL_TOL)


def family_params(cfg):
    """Seeded random parameters drawn on the card (float32, as init_params
    draws them), cast once to bf16; the float32 draw is freed."""
    from repro_torch.models import model as M

    # detlint: ignore[DET001] — random model weights from a seed (the LM
    # side-stack serves random weights), not simulation state
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    p16 = M.cast_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    return p16


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def family_serve(fk, arch: str, layers, expect: int, card: str) -> dict:
    """One family served at full width (see FAMILY_CASES); returns its
    flash launches per prefill and times."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.serve import serve, summary
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf_lib

    full = get_config(arch)
    cfg = dataclasses.replace(full, compute_dtype="bfloat16", attn_impl="flash",
                              num_layers=layers or full.num_layers)
    label = cfg.name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = family_params(cfg)
    prompts = TokenPipeline(cfg.vocab_size, FAMILY_PROMPT, FAMILY_BATCH, 0).batch(0)
    toks = torch.as_tensor(prompts, device="cuda").long()
    torch.cuda.synchronize()
    log(f"[family:{label}] {cfg.family}: {cfg.num_layers} of {full.num_layers} layers, "
        f"d_model {cfg.d_model}, {M.param_count(cfg)} parameters run "
        f"({M.param_count(full)} at full depth), compute {cfg.compute_dtype}, attn_impl "
        f"{cfg.attn_impl}; weights drawn and cast in {time.perf_counter() - t0:.1f} s")
    is_moe = cfg.family == "moe"
    sessions, launches, calls = [], [], []
    for _ in range(2 if arch == FAMILY_RERUN else 1):
        fk.flash_attention_bhsd_cuda.launches = 0
        res, c = moe_routes(lambda: serve(cfg, params, prompts, FAMILY_GEN, device="cuda"))
        launches.append(fk.flash_attention_bhsd_cuda.launches)
        sessions.append(res)
        calls.append(c)
    if launches != [expect] * len(sessions):
        raise AssertionError(f"[family:{label}] flash launches per session {launches}, "
                             f"expected {expect} (one prefill)")
    res = sessions[0]
    if len(sessions) > 1 and not np.array_equal(res.tokens, sessions[1].tokens):
        raise AssertionError(f"[family:{label}] a second session generated other tokens")
    pre, rep = res.prefill_logits.float(), res.replay_logits.float()
    V = cfg.vocab_size
    if pre.shape != (FAMILY_BATCH, 1, V) or not torch.isfinite(pre).all() \
            or not torch.isfinite(rep).all():
        raise AssertionError(f"[family:{label}] prefill logits {tuple(pre.shape)} not finite "
                             f"(B, 1, {V})")
    if res.tokens.shape != (FAMILY_BATCH, FAMILY_GEN) or res.tokens.min() < 0 \
            or res.tokens.max() >= V:
        raise AssertionError(f"[family:{label}] generated tokens {res.tokens.shape} out of range")
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((FAMILY_BATCH, cfg.num_patches, cfg.d_model),
                                            dtype=torch.float32, device="cuda")
    S = FAMILY_PROMPT + cfg.num_patches
    pre_last = [r * S + S - 1 for r in range(FAMILY_BATCH)]
    # A MoE drop depends on every earlier token of the batch (token-major
    # positions), so one row's near tie moves another row's drops: the MoE's
    # flash prefill is held to its naive one at capacity factor E / K, where
    # nothing drops and each row's routing is its own.
    hcfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token) \
        if is_moe else cfg
    with torch.no_grad():
        (_, warm_ms) = timed(lambda: M.forward_prefill(cfg, params, batch))
        fk.flash_attention_bhsd_cuda.launches = 0
        held, held_calls = moe_routes(lambda: M.forward_prefill(hcfg, params, batch)[0])
        if fk.flash_attention_bhsd_cuda.launches != expect:
            raise AssertionError(f"[family:{label}] {fk.flash_attention_bhsd_cuda.launches} "
                                 f"flash launches per prefill, expected {expect}")
        naive, naive_calls = moe_routes(lambda: M.forward_prefill(
            dataclasses.replace(hcfg, attn_impl="naive"), params, batch)[0])
    rows, note = (moe_exempt_rows(held_calls, naive_calls, pre_last, pre_last)
                  if is_moe else (set(), "none"))
    if is_moe:
        log(f"[family:{label}] at capacity factor {hcfg.capacity_factor}, routed differently "
            f"from naive: {note}")
    held_rows(held, naive, rows, "naive" + (f" at capacity factor {hcfg.capacity_factor}"
                                            if is_moe else ""), label)
    if cfg.family == "vlm":  # the replay never sees the patches (ROADMAP queue 3)
        with torch.no_grad():
            text = M.forward_prefill(dataclasses.replace(cfg, family="dense"), params,
                                     {"tokens": toks})[0]
        held_rows(text, rep, set(), "the text-only replay (against a text-only prefill)", label)
    elif is_moe:
        moe_replay(cfg, params, prompts, res, calls[0], pre_last, label)
    elif cfg.family == "ssm":
        ssm_replay(cfg, prompts, pre, rep, label)
    else:
        held_rows(pre, rep, set(), "replay", label)
    out = {"launches": launches[0], "prefill_ms": 1e3 * res.prefill_s, "warm_prefill_ms": warm_ms,
           "decode_ms": 1e3 * res.decode_s / res.decode_steps,
           "tokens_per_s": res.tokens.size / res.decode_s}
    if arch == WINDOW_ARCH:
        wtoks = torch.as_tensor(TokenPipeline(cfg.vocab_size, WINDOW_S, WINDOW_BATCH, 1).batch(0),
                                device="cuda").long()
        with torch.no_grad():
            fk.flash_attention_bhsd_cuda.launches = 0
            (wl, _), w_ms = timed(lambda: M.forward_prefill(cfg, params, {"tokens": wtoks}))
            n = fk.flash_attention_bhsd_cuda.launches
            wn = M.forward_prefill(dataclasses.replace(cfg, attn_impl="naive"), params,
                                   {"tokens": wtoks})[0]
        if n != expect:
            raise AssertionError(f"[family:{label}] S={WINDOW_S}: {n} flash launches, "
                                 f"expected {expect}")
        if not torch.isfinite(wl.float()).all():
            raise AssertionError(f"[family:{label}] S={WINDOW_S}: non-finite logits")
        held_rows(wl, wn, set(), f"naive at S={WINDOW_S} > local_window {cfg.local_window}",
                  label)
        out["window_prefill_ms"] = w_ms
        log(f"[family:{label}] S={WINDOW_S} batch {WINDOW_BATCH}: prefill_ms={w_ms:.3f}; {card}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(sessions):
        log(f"[family:{label}] session {i + 1}: prefill_ms={1e3 * r.prefill_s:.3f} (warm "
            f"{warm_ms:.3f}) decode_ms_per_step={1e3 * r.decode_s / r.decode_steps:.3f} "
            f"({r.decode_steps} steps of batch {FAMILY_BATCH}: {FAMILY_PROMPT - 1} replayed, "
            f"{FAMILY_GEN} generated) tokens_per_s={r.tokens.size / r.decode_s:.2f} "
            f"flash {launches[i]} per prefill; peak memory {out['peak_gib']:.2f} GiB; {card}")
        log(f"[family:{label}:{i + 1}] {json.dumps(summary(cfg, r))}")
    del params, sessions, res, calls, held_calls, naive_calls
    torch.cuda.empty_cache()
    return out


def audio_phase(fk, card: str) -> dict:
    """whisper-base through models/model.py: a prefill over 1,500 frames
    and a 64-token prompt against its naive prefill, then AUDIO_STEPS greedy
    decode steps on a fresh cache (whose cross-attention keys stay zero, as
    the reference's)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(AUDIO_ARCH), compute_dtype="bfloat16",
                              attn_impl="flash")
    label = cfg.name
    torch.cuda.reset_peak_memory_stats()
    params = family_params(cfg)
    # detlint: ignore[DET001] — the stubbed frontend's frame embeddings, seeded
    gen = torch.Generator(device="cuda").manual_seed(1)
    # detlint: ignore[DET001] — the same seeded frames
    frames = torch.randn((FAMILY_BATCH, cfg.enc_frames, cfg.d_model), generator=gen,
                         device="cuda")
    toks = torch.as_tensor(TokenPipeline(cfg.vocab_size, AUDIO_PROMPT, FAMILY_BATCH, 0).batch(0),
                           device="cuda").long()
    batch = {"frames": frames, "tokens": toks}
    with torch.no_grad():
        fk.flash_attention_bhsd_cuda.launches = 0
        (logits, enc), first_ms = timed(lambda: M.forward_prefill(cfg, params, batch))
        n = fk.flash_attention_bhsd_cuda.launches
        _, warm_ms = timed(lambda: M.forward_prefill(cfg, params, batch))
        naive = M.forward_prefill(dataclasses.replace(cfg, attn_impl="naive"), params, batch)[0]
        if n != AUDIO_FLASH:
            raise AssertionError(f"[family:{label}] {n} flash launches per prefill, "
                                 f"expected {AUDIO_FLASH} (the decoder's self-attention)")
        if enc["enc_out"].shape != (FAMILY_BATCH, cfg.enc_frames, cfg.d_model) or \
                not torch.isfinite(logits.float()).all():
            raise AssertionError(f"[family:{label}] prefill outputs malformed")
        held_rows(logits, naive, set(), "naive", label)
        cache = M.init_cache(cfg, FAMILY_BATCH, AUDIO_STEPS, device="cuda")
        tok, out = toks[:, :1], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(AUDIO_STEPS):
            lg, cache = M.decode_step(cfg, params, cache, tok, pos)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            out.append(tok)
        torch.cuda.synchronize()
        dec_ms = 1e3 * (time.perf_counter() - t0) / AUDIO_STEPS
    gen_toks = torch.cat(out, 1)
    if not torch.isfinite(lg.float()).all() or int(gen_toks.min()) < 0 or \
            int(gen_toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"[family:{label}] decode logits or tokens malformed")
    if cache["xk"].any() or cache["xv"].any():
        raise AssertionError(f"[family:{label}] the cross-attention cache is no longer zero")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[family:{label}] audio: prefill ({cfg.enc_frames} frames, {AUDIO_PROMPT} tokens, batch "
        f"{FAMILY_BATCH}) prefill_ms={first_ms:.3f} (warm {warm_ms:.3f}), flash {n} per "
        f"prefill; {AUDIO_STEPS} decode steps decode_ms_per_step={dec_ms:.3f} "
        f"tokens_per_s={FAMILY_BATCH * 1e3 / dec_ms:.2f}; peak memory {peak:.2f} GiB; {card}")
    del params, cache, enc
    torch.cuda.empty_cache()
    return {"launches": n, "prefill_ms": first_ms, "warm_prefill_ms": warm_ms,
            "decode_ms": dec_ms, "tokens_per_s": FAMILY_BATCH * 1e3 / dec_ms, "peak_gib": peak}


def families_phase(fk, card: str) -> dict:
    """Phase 7b: every family but dense at full width; returns each arch's
    record (flash launches per prefill, times, peak memory)."""
    out = {}
    for arch, layers, expect in FAMILY_CASES:
        out[arch] = family_serve(fk, arch, layers, expect, card)
    out[AUDIO_ARCH] = audio_phase(fk, card)
    return out


def families_only() -> int:
    """Phases 1, the flash build and 7b alone."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel as fk

    card = card_line()
    log(f"[device] {card}")
    t0 = time.perf_counter()
    _, report = fk.build()
    log(f"[build] {os.path.relpath(fk.SOURCE, ROOT)} in {time.perf_counter() - t0:.2f} s")
    stamp("families")
    rec = families_phase(fk, card)
    stamp("end")
    log(card)
    log(json.dumps({"families": rec}))
    return 0


# Phase 8: LM training. (a) every arch at reduced width in float32, one step
# on the card against the same step on the CPU from the same parameters and
# batch (vlm: 8 patches + 24 tokens, as tests/test_models.py's make_batch).
# The card's float32 matmuls are full float32 (TF32 off, PyTorch's default),
# so the two differ by summation order only: the loss within 1e-5 relative;
# each gradient leaf within 1e-4 of its largest |g| plus 1e-8 (the key
# biases' gradients are zero in exact arithmetic, softmax being invariant
# to a shift of a row, and read as ~1e-10 of rounding on either device);
# one AdamW update on the card from the CPU's gradients within 1e-6 of each
# leaf's largest |x| (the same elementwise arithmetic, a few correctly
# rounded operations apart).
TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SEQ = 2, 32
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_OPT_RTOL = 1e-5, (1e-4, 1e-8), 1e-6
# (b) smollm-360m (launch/train.py's default arch) at full width and depth,
# the "full" preset (bf16 compute, float32 parameters and moments), through
# launch/train.py's train(): 30 steps checkpointed every 10 with a failure
# injected at step 15, against the same 30 steps uninterrupted, bitwise;
# then 3 steps under attn_impl=flash against 3 under chunked. At lr 3e-4:
# at the driver's default 3e-3 (20 warm-up steps) the loss climbs at this
# width, from 10.99 to ~11.3, in bf16 and in float32 alike, and the port
# follows the reference step for step there (2 of 32 layers at full width on
# the CPU). The token stream holds nothing that 30 steps of 2,048 tokens can
# generalise from (a new segment of the successor permutation in every
# row), so a step's loss on its own fresh batch moves by noise (~0.02); the
# check that the optimiser descends is the first batch's loss, evaluated
# again with the trained parameters, against its logged first_loss.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = "smollm-360m", 8, 256, 30, 3e-4
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_FLASH_STEPS = 10, 15, 3
TRAIN_HELD_OUT = 1000  # the pipeline's step whose batch no run trains on
# (c) the other families at their published widths, bf16, batch 4, 5 steps,
# each twice (bitwise); (arch, layers run (None: all), seq). Depth is cut to
# fit one card's 80 GB with float32 parameters, gradients and moments
# (16 bytes a parameter): mixtral 2 of 32 layers (3.2 B parameters, ~51 GB),
# moonshot 4 of 48 (3.0 B, ~47 GB), llava 4 of 32 (its 576 patches + 128
# tokens), recurrentgemma one (rec, rec, attn) cycle.
TRAIN_FAMILIES = (
    ("mixtral-8x7b", 2, 256),
    ("moonshot-v1-16b-a3b", 4, 256),
    ("llava-next-mistral-7b", 4, 704),
    ("recurrentgemma-9b", 3, 256),
    ("mamba2-130m", None, 256),
    ("whisper-base", None, 256),
)
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_STEPS = 4, 5


def _tree_to(tree, device):
    """A copy of a dict tree of tensors on ``device`` (a copy even where the
    device is the tensor's own: the optimizer updates in place)."""
    from repro_torch.models.base import tree_map

    return tree_map(lambda a: a.to(device, copy=True), tree)


def _leaf_gap(got, want) -> float:
    """max |got - want| over max |want| (0 where both are zero)."""
    want = want.float().cpu()
    d = (got.float().cpu() - want).abs().max().item()
    m = want.abs().max().item()
    return d / m if m else d


def reduced_train_batch(cfg, seed: int) -> dict:
    """tests/test_models.py's make_batch, seeded: (2, 32) tokens; vlm 8
    patch embeddings + 24 tokens, audio the reduced encoder's frames."""
    # detlint: ignore[DET001] — seeded test inputs, not simulation state
    gen = torch.Generator().manual_seed(seed)
    B, S = TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SEQ
    # detlint: ignore[DET001] — the same seeded inputs
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    # detlint: ignore[DET001] — the same seeded inputs
    normal = lambda n: torch.randn((B, n, cfg.d_model), generator=gen,
                                   dtype=torch.float32) * 0.1
    if cfg.family == "audio":
        return {"tokens": toks, "frames": normal(cfg.enc_frames)}
    if cfg.family == "vlm":
        return {"tokens": toks[:, : S - cfg.num_patches], "patch_embeds": normal(cfg.num_patches)}
    return {"tokens": toks}


def train_card_vs_cpu(card: str) -> None:
    """Phase 8 (a)."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.base import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

    opt_cfg = AdamWConfig(lr=3e-3, schedule=cosine_schedule(20, 100))
    for i, arch in enumerate(sorted(ARCHS)):
        cfg = dataclasses.replace(reduced_config(ARCHS[arch]), compute_dtype="float32")
        # detlint: ignore[DET001] — seeded random weights for the comparison
        params = M.init_params(cfg, torch.Generator().manual_seed(i), "cpu",
                               max_target_positions=64)
        batch = reduced_train_batch(cfg, i)
        out = {}
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            loss, _, grads = loss_and_grads(cfg, p, b)
            _, _, m = make_train_step(cfg, opt_cfg)(p, adamw_init(p), b)
            out[dev] = (loss.item(), m["loss"].item(), grads)
        (l_cpu, s_cpu, g_cpu), (l_gpu, s_gpu, g_gpu) = out["cpu"], out["cuda"]
        loss_gap = max(abs(l_gpu - l_cpu) / abs(l_cpu), abs(s_gpu - s_cpu) / abs(s_cpu))
        if not loss_gap <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"[train:card-cpu] {arch}: loss {l_gpu} on the card, {l_cpu} "
                                 f"on the CPU ({loss_gap:.3g} relative)")
        worst = (0.0, "")
        rel, floor = TRAIN_GRAD_TOL
        for (path, gc), (_, gg) in zip(tree_leaves(g_cpu), tree_leaves(g_gpu)):
            m = gc.abs().max().item()
            d = (gg.cpu() - gc).abs().max().item()
            if d > rel * m + floor:
                raise AssertionError(f"[train:card-cpu] {arch}: gradient {'/'.join(path)} "
                                     f"differs by {d:.3g} (largest |g| {m:.3g})")
            worst = max(worst, (d / (m + floor / rel), "/".join(path)))
        # one update from the CPU's gradients on each device
        upd = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            p, st, _ = adamw_update(opt_cfg, p, _tree_to(g_cpu, dev), adamw_init(p))
            upd[dev] = {"params": p, "mu": st["mu"], "nu": st["nu"]}
        opt_gap = max(_leaf_gap(b, a) for (_, a), (_, b)
                      in zip(tree_leaves(upd["cpu"]), tree_leaves(upd["cuda"])))
        if not opt_gap <= TRAIN_OPT_RTOL:
            raise AssertionError(f"[train:card-cpu] {arch}: AdamW on the card {opt_gap:.3g} "
                                 f"of a leaf's largest |x| from the CPU's")
        log(f"[train:card-cpu] {arch} (reduced, float32, batch {TRAIN_REDUCED_BATCH} x "
            f"{TRAIN_REDUCED_SEQ}): loss {l_gpu:.7f} on the card, {l_cpu:.7f} on the CPU "
            f"({loss_gap:.3g} relative); worst gradient leaf {worst[1]} at {worst[0]:.3g} of "
            f"its largest |g|; AdamW params/mu/nu within {opt_gap:.3g} of a leaf's largest |x|")


def fingerprint(tree) -> list:
    """A bit-level fingerprint of a dict tree of 32-bit tensors: per leaf,
    the int64 sum of its words (taken 2^28 at a time), in leaf order."""
    from repro_torch.models.base import tree_leaves

    out = []
    for _, a in tree_leaves(tree):
        words = a.detach().reshape(-1).view(torch.int32)
        out.append(sum(int(c.sum(dtype=torch.int64)) for c in words.split(1 << 28)))
    return out


def _same_trees(a, b) -> bool:
    from repro_torch.models.base import tree_leaves

    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def train_smollm(fk, card: str) -> tuple:
    """Phase 8 (b); returns the flash launches of the attn_impl=flash run and
    the median ms of a step."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, cosine_schedule

    base = ["--arch", TRAIN_ARCH, "--preset", "full", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--log-every", "1", "--lr", str(TRAIN_LR)]
    full = base + ["--steps", str(TRAIN_STEPS)]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="train_ckpt-", dir=os.path.join(ROOT, "build"))
    try:
        args = T.parse_args(full + ["--ckpt-dir", ckdir, "--ckpt-every", str(TRAIN_CKPT_EVERY),
                                    "--inject-failures", str(TRAIN_FAIL_AT)])
        cfg = T.build_cfg(args)
        pa, oa, ra = T.train(cfg, args)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    args_b = T.parse_args(full)
    pb, ob, rb = T.train(cfg, args_b)
    peak = torch.cuda.max_memory_allocated() / 2**30
    label = f"[train:{TRAIN_ARCH}]"
    if ra["restarts"] != 1 or rb["restarts"] != 0:
        raise AssertionError(f"{label} restarts {ra['restarts']} / {rb['restarts']}, "
                             "expected 1 / 0")
    if not (_same_trees(pa, pb) and _same_trees(oa, ob)):
        raise AssertionError(f"{label} the recovered run's parameters or moments differ from "
                             "the uninterrupted run's")
    losses = dict(rb["losses"])
    if sorted(losses) != list(range(TRAIN_STEPS)) or dict(ra["losses"]) != losses:
        raise AssertionError(f"{label} the runs logged other losses")
    # the first batch and a held-out one, before (the seeded draw again) and
    # after training
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, args_b.seed)
    evals = [T.make_batch(cfg, pipe, s, "cuda") for s in (0, TRAIN_HELD_OUT)]
    # detlint: ignore[DET001] — the driver's seeded draw, again
    p0 = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(args_b.seed), "cuda",
                       max_target_positions=TRAIN_SEQ + 8)
    with torch.no_grad():
        before = [float(M.forward_train(cfg, p0, b)[0]) for b in evals]
        after = [float(M.forward_train(cfg, pb, b)[0]) for b in evals]
    del p0
    if not all(np.isfinite(v) for v in losses.values()) or before[0] != rb["first_loss"] \
            or not after[0] < rb["first_loss"]:
        raise AssertionError(f"{label} first batch's loss {rb['first_loss']} (again: "
                             f"{before[0]}) -> {after[0]} after training: not finite and "
                             "falling")
    ms = 1e3 * float(np.median(rb["step_s"][1:]))
    log(f"{label} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}), compute {cfg.compute_dtype}, attn_impl {cfg.attn_impl}, remat "
        f"{cfg.remat_policy}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, lr {TRAIN_LR}: logged loss "
        f"{rb['first_loss']:.4f} -> {rb['final_loss']:.4f} over {TRAIN_STEPS} steps (mean of "
        f"the first 10 {np.mean([losses[s] for s in range(10)]):.4f}, last 10 "
        f"{np.mean([losses[s] for s in range(TRAIN_STEPS - 10, TRAIN_STEPS)]):.4f}); the first "
        f"batch {before[0]:.4f} -> {after[0]:.4f}, a held-out batch {before[1]:.4f} -> "
        f"{after[1]:.4f}; the run with a failure at step {TRAIN_FAIL_AT} (restarts "
        f"{ra['restarts']}, checkpoints {ra['checkpoints']}) bitwise the uninterrupted one "
        f"(parameters, moments, step; every logged loss)")
    log(f"{label} median step {ms:.3f} ms after the first ({rb['step_s'][0] * 1e3:.1f} ms), "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} tokens/s, peak memory {peak:.2f} GiB "
        f"(the recovered run's trees alive); wall {rb['wall_s']} s uninterrupted, "
        f"{ra['wall_s']} s with the failure and checkpoints; {card}")
    # one more step under the profiler, from the uninterrupted run's state
    step = make_train_step(cfg, AdamWConfig(lr=args_b.lr,
                                            schedule=cosine_schedule(20, TRAIN_STEPS)))
    batch = T.make_batch(cfg, pipe, TRAIN_STEPS, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(pb, ob, batch)
        torch.cuda.synchronize()
    device_summary(prof, (time.perf_counter() - t0) * 1e3, 1, f"train:{TRAIN_ARCH}", card)
    del pa, oa, pb, ob, prof
    torch.cuda.empty_cache()
    # attn_impl=flash trains through the chunked online softmax: no launch
    short = base + ["--steps", str(TRAIN_FLASH_STEPS)]
    runs = {}
    for impl in ("flash", "chunked"):
        fk.flash_attention_bhsd_cuda.launches = 0
        a = T.parse_args(short + ["--set", f"attn_impl={impl}"])
        _, _, r = T.train(T.build_cfg(a), a)
        runs[impl] = (r["losses"], fk.flash_attention_bhsd_cuda.launches)
    n = runs["flash"][1]
    if n or runs["flash"][0] != runs["chunked"][0]:
        raise AssertionError(f"{label} attn_impl=flash: {n} flash launches, losses "
                             f"{runs['flash'][0]} against chunked {runs['chunked'][0]}")
    log(f"{label} attn_impl=flash: {TRAIN_FLASH_STEPS} steps, {n} flash launches, losses "
        f"bitwise attn_impl=chunked's ({[v for _, v in runs['flash'][0]]})")
    torch.cuda.empty_cache()
    return n, ms


def train_family(arch: str, layers, seq: int, card: str) -> dict:
    """Phase 8 (c): one family, TRAIN_FAMILY_STEPS steps twice."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    full = get_config(arch)
    argv = ["--arch", arch, "--preset", "full", "--batch", str(TRAIN_FAMILY_BATCH), "--seq",
            str(seq), "--steps", str(TRAIN_FAMILY_STEPS), "--log-every", "1"]
    if layers:
        argv += ["--set", f"num_layers={layers}"]
    args = T.parse_args(argv)
    cfg = T.build_cfg(args)
    label = f"[train:{arch}]"
    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        params, opt, res = T.train(cfg, args)
        runs.append((res, fingerprint({"params": params, "opt": opt}),
                     torch.cuda.max_memory_allocated() / 2**30))
        del params, opt
        torch.cuda.empty_cache()
    (res, fp, peak), (res2, fp2, _) = runs
    losses = [v for _, v in res["losses"]]
    gnorm = res["metrics"]["grad_norm"]
    if len(losses) != TRAIN_FAMILY_STEPS or not all(np.isfinite(losses)) or \
            not (np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"{label} losses {losses}, last gradient norm {gnorm}")
    if res2["losses"] != res["losses"] or fp2 != fp:
        raise AssertionError(f"{label} a rerun of the {TRAIN_FAMILY_STEPS} steps differs")
    ms = 1e3 * float(np.median(res["step_s"][1:]))
    cut = f"{cfg.num_layers} of {full.num_layers} layers" if layers else \
        f"all {cfg.num_layers} layers"
    drop = res["metrics"].get("dropped_fraction")
    log(f"{label} {cfg.family}, {cut}, d_model {cfg.d_model}, {M.param_count(cfg)} parameters, "
        f"bf16, batch {TRAIN_FAMILY_BATCH} x {seq}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"gradient norm {gnorm:.4g}; median step {ms:.3f} ms after the first "
        f"({res['step_s'][0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB"
        + (f", dropped_fraction {drop:.4f}" if drop is not None else "")
        + f"; rerun bitwise; {card}")
    return {"ms": ms, "peak_gib": peak, "dropped_fraction": drop}


def train_phase(fk, card: str) -> dict:
    """Phase 8: (a), (b), (c); returns the kernels' launches over it and the
    flash run's, with the timings."""
    from repro_torch.kernels.interactions import kernel as ik

    counted = {"flash_attention": fk.flash_attention_bhsd_cuda,
               **{k: getattr(ik, w) for k, (w, *_) in KERNELS.items()}}
    for w in counted.values():
        w.launches = 0
    train_card_vs_cpu(card)
    flash_n, smollm_ms = train_smollm(fk, card)
    fam = {arch: train_family(arch, layers, seq, card) for arch, layers, seq in TRAIN_FAMILIES}
    launches = {k: w.launches for k, w in counted.items()}
    if any(launches.values()):
        raise AssertionError(f"[train] kernel launches in phase 8: {launches}")
    return {"launches": launches, "flash_launches": flash_n, "families": fam,
            "smollm_ms": smollm_ms}


def train_only() -> int:
    """Phases 1 and 8 alone (no kernel is built: phase 8 launches none)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel as fk

    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    stamp("phase 8")
    rec = train_phase(fk, card)
    stamp("end")
    log(card)
    log(json.dumps({"train": rec}))
    return 0


# Phase 9: LM sharding. Four ranks share cuda:0 over gloo (NCCL refuses two
# ranks on one card) and form the (data 2, model 2) DeviceMesh; weights are
# drawn from a seed on the card leaf by leaf, in init_params' order, and each
# leaf is placed by the shardings at once, so no rank holds a whole tree
# longer than one leaf (rank 0 keeps one for the unsharded comparisons).
# Four ranks on one card: every time here is that, not a scaling figure.
# (a) qwen2-1.5b at full width and depth served: a float32 sharded prefill
# (flash_sharded sends each rank's data shard of the planes to the float32
# kernel) against the unsharded port on rank 0; then bf16: a sharded prefill
# through make_prefill_step with parameters placed by prefill_shardings (the
# bf16 kernel, 28 launches per rank), again bitwise, and 16 greedy decode
# steps through make_decode_step on the cache placed by decode_shardings,
# against an unsharded session on rank 0 (prefill logits within the 8% band
# of phases 7 and 7b; tokens compared, a row that turns away where the
# unsharded top-2 gap exceeds the band is a failure). (b) smollm-360m at
# full width and depth trained: one float32 step sharded against unsharded
# (loss, gradients, then AdamW from the unsharded gradients), then three bf16
# steps through make_train_step with parameters and moments placed by
# train_shardings and the first step again, bitwise; its 15 heads and 5 kv
# heads do not divide the model axis, so the guard replicates them
# (rules.dropped). (c)
# mixtral-8x7b at published widths, 2 of 32 layers (one card's memory, as
# phase 8), moe_dispatch "shard_map": a float32 prefill at capacity factor
# E / K (nothing drops, so per-shard and global dispatch are one function)
# against the unsharded port; layer 0's MoE at the default capacity against
# moe_ffn on each data shard in turn with the auxiliary terms averaged (the
# reference's shard_map body); a bf16 prefill (2 launches per rank), again
# bitwise. On every rank one layer's local planes go through the kernel and
# its plain version (phase 6's tolerance), in bf16 and float32. The spawn
# starts beside phase 4g's and is read after phase 8, so its times include
# that load.
SHARD_MESH = ((2, 2), ("data", "model"))
SHARD_TIMEOUT_S, SHARD_WALL_S = 120.0, 900.0
SHARD_THREADS = 2  # intra-op threads per rank: the ranks' work is host dispatch and gloo
SHARD_ROOT = os.path.join(ROOT, "build", "chip_smoke_shard")
SHARD_DECODE = 16
SHARD_TRAIN_ARCH, SHARD_TRAIN_STEPS = "smollm-360m", 3
SHARD_MOE_ARCH, SHARD_MOE_LAYERS, SHARD_MOE_BATCH, SHARD_MOE_SEQ = "mixtral-8x7b", 2, 8, 128
# Sharded against unsharded in float32 (TF32 off): the same arithmetic with
# the partial sums of the sharded contractions in another order. Logits
# within 1e-4 of the largest |logit| (28 layers of reordered float32 sums);
# the loss, gradients and AdamW as phase 8 (a) (TRAIN_*); the MoE layer's
# output within 1e-4 of its largest |x|, its auxiliary terms within 1e-5 of
# max(|term|, 1) (the dropped fraction may be 0; the others are of order 1).
SHARD_LOGIT_TOL, SHARD_AUX_TOL = 1e-4, 1e-5


def _drawn_placed(cfg, seed: int, shardings, keep_full: bool, mtp: int = 0):
    """The parameters init_params draws from ``seed`` on the card, each leaf
    placed by ``shardings`` as soon as it is drawn; the whole tree too where
    ``keep_full``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import base as base_lib
    from repro_torch.models import model as M

    specs = M.model_specs(cfg, mtp)
    flat = dict(base_lib.tree_leaves(shardings))
    # detlint: ignore[DET001] — random model weights from a seed (the LM
    # side-stack serves random weights), not simulation state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    placed, full = {}, {}
    for path, spec in base_lib.tree_leaves(specs):
        a = base_lib._init_one(spec, gen, "cuda")
        placed[path] = distribute_tensor(a, flat[path].mesh, flat[path].placements,
                                         src_data_rank=None)
        if keep_full:
            full[path] = a
        del a
    return (base_lib.tree_unflatten(specs, placed),
            base_lib.tree_unflatten(specs, full) if keep_full else None)


def _comm_stats(fn):
    """fn() with its collectives counted on this rank by
    analysis/hlo.py:collective_bytes (per kind: calls and operand bytes, an
    all-gather's input shard, a reduce-scatter's whole input); returns (fn's
    result, {kind: count}, {kind: bytes})."""
    from repro_torch.analysis.hlo import collective_bytes

    box = []
    coll = collective_bytes(lambda: box.append(fn()))
    return box[0], coll["count"], coll["bytes"]


def _flash_vs_plain(fk, q, k, v, kw) -> float:
    """One layer's local planes (the model layout) through the kernel and its
    plain version; phase 6's tolerance. Returns max |d|."""
    B, Sq, M, G, Dh = q.shape
    Sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * M * G, Sq, Dh).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * M, Sk, Dh).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * M, Sk, Dh).contiguous()
    o_k = fk.flash_attention_bhsd_cuda(qf, kf, vf, **kw).float()
    o_p = fk.flash_attention_bhsd_plain(qf, kf, vf, **kw).float()
    atol, rtol = FLASH_TOL[q.dtype]
    diff = (o_k - o_p).abs()
    if float((diff - rtol * o_p.abs()).max()) > atol:
        raise AssertionError(f"[shard] flash kernel != plain on a rank's planes "
                             f"{tuple(q.shape)} {q.dtype}: max |d| {float(diff.max())}")
    return float(diff.max())


def _spied_prefill(fk, step, *args):
    """step(*args) without grad, the flash launches counted from 0 and the
    first kernel call's inputs kept; returns (out, launches, inputs)."""
    from repro_torch.models import attention as attn

    first, real = [], attn.flash_attention

    def spy(q, k, v, **kw):
        if not first:
            first.append((q, k, v, kw))
        return real(q, k, v, **kw)

    attn.flash_attention = spy
    fk.flash_attention_bhsd_cuda.launches = 0
    try:
        with torch.no_grad():
            out = step(*args)
        torch.cuda.synchronize()
    finally:
        attn.flash_attention = real
    return out, fk.flash_attention_bhsd_cuda.launches, first[0] if first else None


def _local_bytes(tree) -> list:
    from repro_torch.models.base import tree_leaves
    from repro_torch.models.sharding import is_dtensor

    return fingerprint({"/".join(p): (a.to_local() if is_dtensor(a) else a)
                        for p, a in tree_leaves(tree)})


def _shard_serve(mesh, fk, say, card) -> dict:
    """Phase 9 (a) on one rank."""
    import dataclasses

    import torch.distributed as dist

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.sharding import MeshRules

    rank, out = dist.get_rank(), {}
    cfgs = {dt: dataclasses.replace(get_config(SERVE_ARCH), compute_dtype=dt, attn_impl="flash")
            for dt in ("float32", "bfloat16")}
    cfg = cfgs["bfloat16"]
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SHARD_DECODE
    rules = MeshRules.for_mesh(mesh)
    (ps, bs), _ = steps.prefill_shardings(cfg, ShapeConfig("p", "prefill", P, B), rules, mesh,
                                          None)
    params, full = _drawn_placed(cfg, 0, ps, keep_full=rank == 0)
    toks = torch.as_tensor(TokenPipeline(cfg.vocab_size, P, B, 0).batch(0), device="cuda").long()
    batch = steps.place({"tokens": toks}, bs)
    label = f"[shard:{SERVE_ARCH}]"
    # float32: sharded against unsharded, the float32 kernel per data shard
    (lg, _), n32, planes = _spied_prefill(fk, steps.make_prefill_step(cfgs["float32"], rules),
                                          params, batch)
    out["f32_err"] = _flash_vs_plain(fk, *planes)
    whole = lg.full_tensor()
    if rank == 0:
        with torch.no_grad():
            ref = M.forward_prefill(cfgs["float32"], full, {"tokens": toks})[0]
        gap = float((whole - ref).abs().max() / ref.abs().max())
        if not gap <= SHARD_LOGIT_TOL:
            raise AssertionError(f"{label} float32 sharded prefill {gap:.3g} of max |logit| "
                                 f"from the unsharded port's (tolerance {SHARD_LOGIT_TOL})")
        say(f"{label} float32 prefill B={B} S={P}, 28 layers: sharded within {gap:.3g} of max "
            f"|logit| of the unsharded port (tolerance {SHARD_LOGIT_TOL}); float32 kernel on "
            f"each rank's {tuple(planes[0].shape)} planes, within tolerance of plain "
            f"(max |d| {out['f32_err']:.3g})")
        del ref
    del lg, whole, planes
    # bf16 prefill, twice
    prefill = steps.make_prefill_step(cfg, rules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (lg, cache), n16, planes = _spied_prefill(fk, prefill, params, batch)
    ms_first = 1e3 * (time.perf_counter() - t0)
    out["bf16_err"] = _flash_vs_plain(fk, *planes)
    del planes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (lg2, cache2), _, _ = _spied_prefill(fk, prefill, params, batch)
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    if _local_bytes({"l": lg, **cache}) != _local_bytes({"l": lg2, **cache2}):
        raise AssertionError(f"{label} a second sharded prefill differs on rank {rank}")
    del lg2, cache2
    out["launches"], out["launches_f32"] = n16, n32
    # the decode cache: the prefill's, P + G slots, placed by decode_shardings
    dshape = ShapeConfig("d", "decode", P + G, B)
    (_, dcs, dts, _), _ = steps.decode_shardings(
        cfg, dshape, rules, mesh, M.init_cache(cfg, B, P + G, abstract=True))
    cache = {k: torch.cat([c, torch.zeros_like(c[:, :, :, :G])], dim=3)
             .redistribute(mesh, dcs[k].placements) for k, c in cache.items()}
    decode = steps.make_decode_step(cfg, rules)
    tok = torch.argmax(lg[:, -1, :].full_tensor(), dim=-1).to(torch.int32)[:, None]
    tokens = [tok]
    tok = steps.place(tok, dts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(G - 1):
            tok, cache = decode(params, cache, tok, P + i)
            tok = tok.redistribute(mesh, dts.placements)
            tokens.append(tok.full_tensor())
        torch.cuda.synchronize()
        out["decode_ms"] = 1e3 * (time.perf_counter() - t0) / (G - 1)
        (tok, cache), dcounts, dbytes = _comm_stats(lambda: decode(params, cache, tok, P + G - 1))
        tokens.append(tok.full_tensor())
        (_, _), pcounts, pbytes = _comm_stats(lambda: prefill(params, batch))
        # one more prefill, profiled on rank 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prefill(params, batch)
                torch.cuda.synchronize()
            device_summary(prof, (time.perf_counter() - t0) * 1e3, 1,
                           f"shard:{SERVE_ARCH} prefill, rank 0 of 4 sharing the card", card)
            del prof
        else:
            prefill(params, batch)
    out["comm"] = {"prefill": (pcounts, pbytes), "decode step": (dcounts, dbytes)}
    whole = lg.full_tensor()[:, -1].float()
    got = torch.cat(tokens, dim=1)
    if rank == 0:
        # the unsharded session: prefill, the same greedy decode
        p16 = M.cast_params(cfg, full)
        with torch.no_grad():
            ref, rc = M.forward_prefill(cfg, p16, {"tokens": toks})
            rc = {k: torch.cat([c, torch.zeros_like(c[:, :, :, :G])], dim=3)
                  for k, c in rc.items()}
            steps_lg = [ref[:, -1].float()]
            want = [torch.argmax(ref[:, -1], dim=-1).to(torch.int32)[:, None]]
            for i in range(G):
                lgi, rc = M.decode_step(cfg, p16, rc, want[-1], P + i)
                steps_lg.append(lgi[:, -1].float())
                want.append(torch.argmax(lgi[:, -1], dim=-1).to(torch.int32)[:, None])
        want = torch.cat(want, dim=1)  # (B, G + 1), as got
        scale = float(steps_lg[0].abs().max())
        d = float((whole - steps_lg[0]).abs().max())
        if d > SERVE_REL_TOL * scale:
            raise AssertionError(f"{label} bf16 sharded prefill logits {d} from the unsharded "
                                 f"port's, band {SERVE_REL_TOL} x {scale}")
        agree, turned = int((got == want).sum()), []
        for row in range(B):
            bad = (got[row] != want[row]).nonzero()
            if len(bad):
                s = int(bad[0])
                top2 = steps_lg[s][row].topk(2).values
                gap = float(top2[0] - top2[1])
                band = SERVE_REL_TOL * float(steps_lg[s].abs().max())
                turned.append((row, s, gap, band))
                if gap > band:
                    raise AssertionError(f"{label} row {row} turns away from the unsharded "
                                         f"greedy tokens at step {s}, where its top-2 gap "
                                         f"{gap:.4f} exceeds the band {band:.4f}")
        say(f"{label} bf16 prefill B={B} S={P}: {n16} flash launches on rank 0 (the bf16 "
            f"kernel on {tuple(lg.to_local().shape)} local logits' rows), a second prefill "
            f"bitwise; logits within {d:.5f} of the unsharded port's (band {SERVE_REL_TOL} x "
            f"max |logit| {scale:.4f}); greedy tokens {agree} of {got.numel()} equal to the "
            f"unsharded session's over {G} decode steps (rows turning away: (row, step, "
            f"unsharded top-2 gap, band) {turned}); kernel vs plain on the local planes max "
            f"|d| {out['bf16_err']:.3g}")
        say(f"{label} four ranks sharing one card (not a scaling figure): sharded prefill "
            f"{out['prefill_ms']:.1f} ms (first {ms_first:.1f} ms), decode "
            f"{out['decode_ms']:.2f} ms per step; collectives per prefill {pcounts}, operand "
            f"bytes {pbytes}; per decode step {dcounts}, operand bytes {dbytes}; {card}")
    del params, cache, lg
    return out


def _shard_train(mesh, fk, say, card) -> dict:
    """Phase 9 (b) on one rank."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch import train as T
    from repro_torch.models.base import tree_leaves, tree_map
    from repro_torch.models.sharding import MeshRules
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    rank, out = dist.get_rank(), {}
    base = dataclasses.replace(get_config(SHARD_TRAIN_ARCH), attn_impl="naive",
                               remat_policy="nothing")
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    cfg = dataclasses.replace(base, compute_dtype="bfloat16")
    B, S = TRAIN_BATCH, TRAIN_SEQ
    rules = MeshRules.for_mesh(mesh)
    (tps, tos, tbs), _ = steps.train_shardings(cfg, ShapeConfig("t", "train", S, B), rules, mesh)
    label = f"[shard:{SHARD_TRAIN_ARCH}]"
    if rank == 0:
        say(f"{label} rules.dropped (the guard's replications): {rules.dropped}")
    params, full = _drawn_placed(cfg, 0, tps, keep_full=True)
    pipe = TokenPipeline(cfg.vocab_size, S, B, 0)
    batch0 = T.make_batch(cfg, pipe, 0, "cuda")
    # float32: one step sharded against unsharded
    loss_s, _, g_s = steps.loss_and_grads(cfg32, params, steps.place(batch0, tbs), rules)
    loss_u, _, g_u = steps.loss_and_grads(cfg32, full, batch0)
    loss_s = float(loss_s.full_tensor())
    gaps = {"/".join(p): (g.full_tensor(), g_u_) for (p, g), (_, g_u_)
            in zip(tree_leaves(g_s), tree_leaves(g_u))}
    del g_s
    opt = AdamWConfig(lr=TRAIN_LR)
    pb = steps.place(tree_map(lambda a: a.clone(), full), tps)
    adamw_update(opt, pb, steps.place(g_u, tps), steps.place(adamw_init(full), tos))
    upd = {"/".join(p): a.full_tensor() for p, a in tree_leaves(pb)}
    del pb
    if rank == 0:
        if not abs(loss_s - float(loss_u)) <= TRAIN_LOSS_RTOL * abs(float(loss_u)):
            raise AssertionError(f"{label} float32 loss {loss_s} sharded, {float(loss_u)} not")
        rel, floor = TRAIN_GRAD_TOL
        worst = (0.0, "")
        for path, (g, want) in gaps.items():
            m, d = float(want.abs().max()), float((g - want).abs().max())
            if d > rel * m + floor:
                raise AssertionError(f"{label} gradient {path} differs by {d:.3g} (largest "
                                     f"|g| {m:.3g})")
            worst = max(worst, (d / (m + floor / rel), path))
        pa = tree_map(lambda a: a.clone(), full)
        adamw_update(opt, pa, g_u, adamw_init(pa))
        opt_gap = max(_leaf_gap(upd["/".join(p)], a) for p, a in tree_leaves(pa))
        if not opt_gap <= TRAIN_OPT_RTOL:
            raise AssertionError(f"{label} sharded AdamW {opt_gap:.3g} of a leaf's largest "
                                 "|x| from the unsharded one")
        say(f"{label} float32 step B={B} S={S}, 32 layers: loss {loss_s:.7f} sharded, "
            f"{float(loss_u):.7f} unsharded; worst gradient leaf {worst[1]} at {worst[0]:.3g} "
            f"of its largest |g|; AdamW from the same gradients within {opt_gap:.3g} of a "
            f"leaf's largest |x|")
        del pa
    del gaps, upd, g_u
    # bf16: three steps, twice
    step = steps.make_train_step(cfg, opt, rules)
    batches = [steps.place(T.make_batch(cfg, pipe, s, "cuda"), tbs)
               for s in range(SHARD_TRAIN_STEPS)]
    # the steps, then the first again from the same start under the
    # collective counters (they observe: its values stay bitwise)
    fresh = lambda: (steps.place(tree_map(lambda a: a.clone(), full), tps),
                     steps.place(adamw_init(full), tos))
    fk.flash_attention_bhsd_cuda.launches = 0
    p, o = fresh()
    losses, times = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"].full_tensor()))
        times.append(time.perf_counter() - t0)
        if i == 0:
            fp = _local_bytes({"p": p, "o": o})
    del p, o
    (p, o, m), counts, sent = _comm_stats(lambda: step(*fresh(), batches[0]))
    out["launches"] = fk.flash_attention_bhsd_cuda.launches
    if not all(np.isfinite(losses)) or float(m["loss"].full_tensor()) != losses[0] or \
            _local_bytes({"p": p, "o": o}) != fp:
        raise AssertionError(f"{label} bf16 steps: losses {losses}; the first step again "
                             f"not bitwise on rank {rank}")
    out["step_ms"] = 1e3 * float(np.median(times[1:]))
    if rank == 0:
        say(f"{label} bf16, remat nothing, naive attention, lr {TRAIN_LR}: losses {losses}, "
            f"the first step again from the same start bitwise (loss, parameters and "
            f"moments on every rank); {out['launches']} flash launches; four ranks sharing "
            f"one card (not a scaling figure): median step {out['step_ms']:.1f} ms; "
            f"collectives per step {counts}, operand bytes {sent}; {card}")
    del p, o, params, full, batches
    return out


def _shard_moe(mesh, fk, say, card) -> dict:
    """Phase 9 (c) on one rank."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.sharding import MeshRules

    rank, out = dist.get_rank(), {}
    base = dataclasses.replace(get_config(SHARD_MOE_ARCH), num_layers=SHARD_MOE_LAYERS,
                               moe_dispatch="shard_map", attn_impl="flash")
    E, K = base.num_experts, base.experts_per_token
    cfg = dataclasses.replace(base, compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    cfg32_all = dataclasses.replace(cfg32, capacity_factor=E / K)
    B, S = SHARD_MOE_BATCH, SHARD_MOE_SEQ
    rules = MeshRules.for_mesh(mesh)
    (ps, bs), _ = steps.prefill_shardings(cfg, ShapeConfig("p", "prefill", S, B), rules, mesh,
                                          None)
    params, full = _drawn_placed(cfg, 0, ps, keep_full=rank == 0)
    toks = torch.as_tensor(TokenPipeline(cfg.vocab_size, S, B, 0).batch(0), device="cuda").long()
    batch = steps.place({"tokens": toks}, bs)
    label = f"[shard:{SHARD_MOE_ARCH}]"
    # float32 at capacity factor E / K: sharded against unsharded
    (lg, _), _, _ = _spied_prefill(fk, steps.make_prefill_step(cfg32_all, rules), params, batch)
    whole = lg.full_tensor()
    # layer 0's MoE at the default capacity: shard_map against moe_ffn per
    # data shard, the auxiliary terms averaged
    # detlint: ignore[DET001] — seeded test activations, not simulation state
    gen = torch.Generator(device="cuda").manual_seed(1)
    # detlint: ignore[DET001] — the same seeded activations
    h = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    layer0 = {k: v[0] for k, v in params["layers"].items()
              if k in ("router", "w_gate", "w_up", "w_down")}
    with torch.no_grad():
        mo, maux = moe_lib.moe_ffn_dispatch(steps.place(h, steps.NamedSharding(
            mesh, rules.spec(h.shape, ("batch", "seq", "embed")))), layer0, cfg32, rules)
    mo = mo.full_tensor()
    maux = {k: float(v.full_tensor()) for k, v in maux.items()}
    if rank == 0:
        with torch.no_grad():
            ref = M.forward_prefill(cfg32_all, full, {"tokens": toks})[0]
            gap = float((whole - ref).abs().max() / ref.abs().max())
            f0 = {k: full["layers"][k][0] for k in layer0}
            halves = [moe_lib.moe_ffn(x, f0, cfg32) for x in h.chunk(2)]
        want = torch.cat([o for o, _ in halves])
        aux_want = {k: float((halves[0][1][k] + halves[1][1][k]) / 2) for k in maux}
        mgap = float((mo - want).abs().max() / want.abs().max())
        agap = max(abs(maux[k] - aux_want[k]) / max(abs(aux_want[k]), 1.0) for k in maux)
        if not (gap <= SHARD_LOGIT_TOL and mgap <= SHARD_LOGIT_TOL and agap <= SHARD_AUX_TOL):
            raise AssertionError(f"{label} float32: prefill {gap:.3g}, MoE layer {mgap:.3g} "
                                 f"of their largest |x|, aux {agap:.3g} of max(|term|, 1) "
                                 "from the unsharded references")
        say(f"{label} float32, {SHARD_MOE_LAYERS} of 32 layers, B={B} S={S}: shard_map "
            f"prefill at capacity factor E/K within {gap:.3g} of max |logit| of the unsharded "
            f"port's; layer 0's MoE at capacity factor {cfg.capacity_factor} within {mgap:.3g} "
            f"of moe_ffn on each data shard, aux {maux} within {agap:.3g} of max(|term|, 1) of "
            f"the shards' mean")
        del ref, halves, f0
    del lg, whole, mo
    # bf16, twice
    prefill = steps.make_prefill_step(cfg, rules)
    (lg, _), n, _ = _spied_prefill(fk, prefill, params, batch)
    t0 = time.perf_counter()
    (lg2, _), _, _ = _spied_prefill(fk, prefill, params, batch)
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    if _local_bytes({"l": lg}) != _local_bytes({"l": lg2}) or \
            not torch.isfinite(lg.to_local().float()).all():
        raise AssertionError(f"{label} bf16 prefill not finite or a rerun differs")
    out["launches"] = n
    (_, _), counts, sent = _comm_stats(lambda: prefill(params, batch))
    if rank == 0:
        say(f"{label} bf16 prefill B={B} S={S}: {n} flash launches on rank 0, a second "
            f"prefill bitwise; four ranks sharing one card (not a scaling figure): "
            f"{out['prefill_ms']:.1f} ms; collectives per prefill {counts}, operand bytes {sent}; "
            f"{card}")
    del params, full, lg, lg2
    return out


def _rank_shard(card: str) -> dict:
    """Phase 9 on one of four ranks sharing cuda:0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.flash_attention import kernel as fk

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    shape, names = SHARD_MESH
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=names)
    lines = []
    out = {"rank": dist.get_rank(), "lines": lines}
    t0 = time.perf_counter()
    for part, fn in (("serve", _shard_serve), ("train", _shard_train), ("moe", _shard_moe)):
        out[part] = fn(mesh, fk, lines.append, card)
        out[part]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _shard_spawn(card: str) -> tuple:
    """Phase 9's spawn of four ranks; returns (their results, wall s)."""
    import shutil

    from repro_torch.launch import mesh as mesh_lib

    shutil.rmtree(SHARD_ROOT, ignore_errors=True)
    os.makedirs(SHARD_ROOT)
    t0 = time.perf_counter()
    try:
        res = mesh_lib.spawn(_rank_shard, 4, backend="gloo", device="cuda:0",
                             init_dir=SHARD_ROOT, args=(card,), timeout_s=SHARD_TIMEOUT_S,
                             wall_s=SHARD_WALL_S, threads=SHARD_THREADS)
    finally:
        shutil.rmtree(SHARD_ROOT, ignore_errors=True)
    return res, time.perf_counter() - t0


def start_shard_spawn(card: str):
    """Start phase 9's spawn in a background thread, beside phase 4g's
    spawns and phases 4e-4f (its ranks' card memory fits beside theirs; the
    phases after 4i would not leave it room), so its times include that
    load; :func:`shard_phase` takes the result."""
    pool = ThreadPoolExecutor(max_workers=1)
    job = pool.submit(_shard_spawn, card)
    pool.shutdown(wait=False)
    return job


def shard_phase(card: str, job=None) -> dict:
    """Phase 9: the spawn's results (``job``'s, or a spawn run here), its
    lines and checks; returns the flash launches per rank of each part."""
    res, wall = job.result() if job is not None else _shard_spawn(card)
    for line in res[0]["lines"]:
        log(line)
    launches = {f"{SERVE_ARCH} prefill": [r["serve"]["launches"] for r in res],
                f"{SERVE_ARCH} float32 prefill": [r["serve"]["launches_f32"] for r in res],
                f"{SHARD_MOE_ARCH} prefill": [r["moe"]["launches"] for r in res],
                f"{SHARD_TRAIN_ARCH} train steps": [r["train"]["launches"] for r in res]}
    want = {f"{SERVE_ARCH} prefill": 28, f"{SERVE_ARCH} float32 prefill": 28,
            f"{SHARD_MOE_ARCH} prefill": SHARD_MOE_LAYERS, f"{SHARD_TRAIN_ARCH} train steps": 0}
    for k, n in want.items():
        if launches[k] != [n] * 4:
            raise AssertionError(f"[shard] flash launches per rank, {k}: {launches[k]}, "
                                 f"expected {n} on each")
    log(f"[shard] flash launches per rank: {json.dumps(launches)}; kernel vs plain on each "
        f"rank's planes: bf16 max |d| {[r['serve']['bf16_err'] for r in res]}, float32 "
        f"{[r['serve']['f32_err'] for r in res]}")
    log(f"[shard] peak memory per rank (GiB): {[round(r['peak_gib'], 2) for r in res]}; "
        f"rank 0's parts ended at {[round(res[0][p]['wall_s'], 1) for p in ('serve', 'train', 'moe')]} "
        f"s; phase 9 wall {wall:.1f} s (spawn, four processes reaching the card, the draws; "
        f"{'beside phases 4e-4i' if job is not None else 'alone'}); four ranks sharing one "
        f"card; {card}")
    return {"launches": launches}


def shard_only() -> int:
    """Phases 1, 2 (the flash source alone) and 9."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel as fk

    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    stamp("build")
    log_flash_build(fk.build()[1], fk)
    stamp("phase 9")
    rec = shard_phase(card)
    stamp("end")
    log(card)
    log(json.dumps({"shard": rec}))
    return 0


# Phase 10: the LM tooling. [dryrun] two dry runs of launch/dryrun.py, each
# in a subprocess of its own (a fake world of 256 ranks in one process, which
# must never meet phase 9's gloo ranks), both at once after the roofline's
# card work, each within its wall limit: qwen2-1.5b's prefill_32k cell on the
# 16 x 16 mesh (--quick: meta tensors, no card) and the md-mini epidemic day
# on 256 fake workers (the host's CPU). [roofline] phase 7's qwen2-1.5b
# prefill (8 x 512, bf16, flash)
# and phase 8's smollm-360m train step (8 x 256, bf16) once more on the card
# under analysis/hlo.py:measure_compiled; the flash kernel is a ctypes launch
# the dispatcher does not see, so its analytic flops are added, as the dry
# run does. mfu = model_flops / (PEAK_FLOPS_BF16 * t), t the median of
# ROOFLINE_REPS timed prefills here (CUDA events) and phase 8's median step.
DRYRUN_RUNS = (("qwen2-1.5b prefill_32k 16x16", ["--arch", SERVE_ARCH, "--shape", "prefill_32k",
                                                "--quick"]),
               ("md-mini epidemic, 256 workers", ["--epidemic", DATASET]))
DRYRUN_WALL_S = 240.0
ROOFLINE_REPS = 5


def start_dryruns(out_dir: str) -> list:
    """Phase 10's dry runs, started at once: [(label, process, start time)]."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return [(label, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out", out_dir],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        time.perf_counter()) for label, argv in DRYRUN_RUNS]


def collect_dryruns(jobs: list, out_dir: str) -> dict:
    """Wait for each dry run within DRYRUN_WALL_S of its start (killing it
    past that), print its headline; a failure or an overrun is fatal."""
    out = {}
    for label, proc, t0 in jobs:
        try:
            text, _ = proc.communicate(timeout=max(1.0, DRYRUN_WALL_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"[dryrun] {label}: over its {DRYRUN_WALL_S:.0f} s wall limit")
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[dryrun] {label}: exit {proc.returncode}:\n{text[-4000:]}")
        if "epidemic" in label:
            with open(os.path.join(out_dir, f"epidemic_{DATASET}_256w.json")) as f:
                rec = json.load(f)
            coll = rec["measured"]["collectives"]
            log(f"[dryrun] {label}: ok, {rec['pop']['people']} people; plan + tables "
                f"{rec['build_s']} s, one day {rec['day_s']} s ({rec['day']}); per rank: "
                f"collectives {json.dumps(coll['count'], sort_keys=True)}, operand bytes "
                f"{json.dumps(coll['bytes'], sort_keys=True)}, bytes moved "
                f"{rec['measured']['bytes_accessed']:.4g}, tables {rec['bytes']['tables']} B, "
                f"plan (all workers) {rec['bytes']['plan_all_workers']} B; wall {wall:.1f} s")
        else:
            with open(os.path.join(out_dir, f"{SERVE_ARCH}_prefill_32k_16x16.json")) as f:
                rec = json.load(f)
            if "error" in rec or "skipped" in rec:
                raise AssertionError(f"[dryrun] {label}: {rec.get('error', rec.get('skipped'))}")
            r = rec["roofline"]
            log(f"[dryrun] {label}: ok, flops/chip {rec['scanned']['flops']:.4g}, bytes/chip "
                f"{rec['scanned']['bytes_accessed']:.4g}, collective bytes/chip "
                f"{rec['scanned']['collectives']['total_bytes']}, temp "
                f"{rec['scanned']['memory']['temp_bytes'] / 2**30:.2f} GiB, bottleneck "
                f"{r['bottleneck']}, roofline fraction {r['roofline_fraction']:.4g}, useful "
                f"{r['useful_flops_fraction']:.4g}; build {rec['lower_s']} s, run "
                f"{rec['compile_s']} s; wall {wall:.1f} s")
        out[label] = round(wall, 2)
    return out


def _roofline_line(label, meas, add, mf, ms, card) -> dict:
    """Print one card step's measurement against the H100 roofline."""
    from repro_torch.analysis import roofline as rf

    flops = meas["flops"] + add
    terms = rf.RooflineTerms(flops, meas["bytes_accessed"], meas["collectives"]["total_bytes"],
                             mf, 1)
    mfu = mf / (rf.PEAK_FLOPS_BF16 * ms * 1e-3)
    log(f"[roofline] {label}: measured flops {flops:.6g} (dispatched {meas['flops']:.6g} + "
        f"flash analytic {add:.6g}), model_flops {mf:.6g}, useful_flops_fraction "
        f"{terms.useful_flops_fraction:.4f}; bytes moved (unfused ops) "
        f"{meas['bytes_accessed']:.6g}, transcendentals {meas['transcendentals']:.4g}, peak "
        f"live intermediates {meas['memory']['temp_bytes'] / 2**30:.2f} GiB; roofline terms "
        f"compute {terms.t_compute * 1e3:.3f} ms, memory {terms.t_memory * 1e3:.3f} ms "
        f"({terms.bottleneck}-bound); median {ms:.3f} ms; mfu {mfu:.4f} "
        f"(model flops / (989e12 x t)); {card}")
    return {"flops": flops, "model_flops": mf, "useful_flops_fraction":
            terms.useful_flops_fraction, "ms": ms, "mfu": mfu, "bound_ms": terms.t_bound * 1e3}


def roofline_phase(fk, card: str, train_ms=None) -> dict:
    """Phase 10 [roofline]; returns the flash launches of its measured
    prefill and the two steps' numbers. ``train_ms``: phase 8's median step
    (None: time ROOFLINE_REPS steps here, by the host's clock after a
    synchronise, as phase 8 does)."""
    import dataclasses

    from repro_torch.analysis import roofline as rf
    from repro_torch.analysis.hlo import measure_compiled
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init

    out = {}
    # qwen2-1.5b prefill: phase 7's model, batch and prompt
    cfg = dataclasses.replace(get_config(SERVE_ARCH), compute_dtype="bfloat16",
                              attn_impl="flash")
    # detlint: ignore[DET001] — random model weights from a seed, as phase 7's
    params = M.prepare(cfg, M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                          "cuda"))
    tokens = torch.as_tensor(TokenPipeline(cfg.vocab_size, SERVE_PROMPT, SERVE_BATCH, 0)
                             .batch(0), device="cuda").long()
    prefill = torch.no_grad()(lambda: M.forward_prefill(cfg, params, {"tokens": tokens}))
    prefill()
    torch.cuda.synchronize()
    fk.flash_attention_bhsd_cuda.launches = 0
    meas = measure_compiled(prefill)
    torch.cuda.synchronize()
    launches = fk.flash_attention_bhsd_cuda.launches
    if launches != cfg.num_layers:
        raise AssertionError(f"[roofline] {launches} flash launches in the measured prefill, "
                             f"expected {cfg.num_layers}")
    times = []
    for _ in range(ROOFLINE_REPS):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        prefill()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    shape = ShapeConfig("serve_prefill", "prefill", SERVE_PROMPT, SERVE_BATCH)
    n, na = M.param_count(cfg), M.param_count(cfg, active_only=True)
    out["prefill"] = _roofline_line(
        f"{SERVE_ARCH} prefill {SERVE_BATCH} x {SERVE_PROMPT} bf16 flash ({launches} kernel "
        f"launches)", meas, rf.analytic_attention_flops(cfg, shape),
        rf.model_flops(cfg, shape, n, na), float(np.median(times)), card)
    out["prefill"]["times_ms"] = [round(t, 3) for t in times]
    del params, prefill
    torch.cuda.empty_cache()
    # smollm-360m train step: phase 8's model, batch and optimiser
    args = T.parse_args(["--arch", TRAIN_ARCH, "--preset", "full", "--batch", str(TRAIN_BATCH),
                         "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR)])
    tcfg = T.build_cfg(args)
    # detlint: ignore[DET001] — launch/train.py's seeded draw, as phase 8's
    params = M.init_params(tcfg, torch.Generator(device="cuda").manual_seed(args.seed), "cuda",
                           max_target_positions=TRAIN_SEQ + 8)
    opt = adamw_init(params)
    step = make_train_step(tcfg, AdamWConfig(lr=TRAIN_LR))
    batch = T.make_batch(tcfg, TokenPipeline(tcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, args.seed),
                         0, "cuda")
    step(params, opt, batch)
    torch.cuda.synchronize()
    meas = measure_compiled(step, params, opt, batch)
    torch.cuda.synchronize()
    from_phase8 = train_ms is not None
    if train_ms is None:  # --tooling-only: no phase 8, so time steps here
        times = []
        for _ in range(ROOFLINE_REPS):
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        train_ms = float(np.median(times))
    shape = ShapeConfig("train_step", "train", TRAIN_SEQ, TRAIN_BATCH)
    n, na = M.param_count(tcfg), M.param_count(tcfg, active_only=True)
    out["train"] = _roofline_line(
        f"{TRAIN_ARCH} train step {TRAIN_BATCH} x {TRAIN_SEQ} {tcfg.compute_dtype} ("
        f"{'phase 8' if from_phase8 else 'phase 10'}'s median step)", meas, 0.0, rf.model_flops(tcfg, shape, n, na), train_ms, card)
    del params, opt
    torch.cuda.empty_cache()
    return {"launches": launches, **out}


# [dryrun:3d] the op of the 2 x 16 x 16 whisper-base train_4k cell whose
# backward viewed a non-contiguous gradient block, alone: the encoder
# self-attention (models/encdec.py:_mha) forward and backward on meta
# DTensors placed by the train step's shardings, as rank 0 of a fake 512-rank
# world in this process (which holds no process group), the output's gradient
# placed as the encoder layer's backward gives it (batch over pod and data, a
# partial sum over model). The whole cell takes ten minutes on a host; this
# takes seconds, beside the two dry-run subprocesses.
DRYRUN_3D_ARCH = "whisper-base"


def dryrun_3d_check() -> dict:
    """Phase 10 [dryrun:3d]; fatal on failure."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import encdec, sharding
    from repro_torch.models import model as M
    from repro_torch.models.transformer import layer_list

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(DRYRUN_3D_ARCH), enc_layers=1)
    shape = get_shape("train_4k")
    mtp = shape.seq_len + 8
    with dryrun.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        rules = sharding.MeshRules.for_mesh(mesh)
        p_s, _, b_s = steps.train_shardings(cfg, shape, rules, mesh, mtp)[0]
        layers = steps.place(M.abstract_params(cfg, mtp)["enc_layers"], p_s["enc_layers"])
        x = steps.place(M.input_specs(cfg, shape)["frames"], b_s["frames"]).requires_grad_()
        leaves = {k: v.detach().requires_grad_() for k, v in layers.items()}
        try:
            with torch.enable_grad(), sharding.replicate_plain():
                out = encdec._mha(x, x, layer_list(M.cast_params(cfg, leaves))[0], cfg,
                                  train=True, rules=rules)
                local = (x.shape[0] // (mesh.size(0) * mesh.size(1)), *x.shape[1:])
                g_out = DTensor.from_local(
                    torch.empty(local, dtype=out.dtype, device="meta"), mesh,
                    (Shard(0), Shard(0), Partial()), shape=out.shape, stride=out.stride(),
                    run_check=False)
                grads = torch.autograd.grad(out, [x, *leaves.values()], g_out,
                                            allow_unused=True)
        except RuntimeError as e:
            raise AssertionError(f"[dryrun:3d] {DRYRUN_3D_ARCH} encoder self-attention on "
                                 f"2 x 16 x 16: {e!r}") from e
        got = dict(zip(["frames", *leaves], grads))
        if got["frames"].shape != x.shape or any(
                got[k] is None or got[k].shape != leaves[k].shape
                for k in ("wq", "wk", "wv", "wo")):
            raise AssertionError("[dryrun:3d] a gradient is missing or misshapen")
        rec = {"frames_local": list(x.to_local().shape),
               "grad_placements": str(tuple(got["frames"].placements)),
               "dropped": len(rules.dropped), "s": round(time.perf_counter() - t0, 2)}
    log(f"[dryrun:3d] {DRYRUN_3D_ARCH} train_4k encoder self-attention, forward and backward "
        f"on meta DTensors, rank 0 of a fake 2 x 16 x 16 world: frames {tuple(x.shape)}, local "
        f"{tuple(rec['frames_local'])} placed {tuple(x.placements)}, output gradient placed "
        f"(S(0), S(0), P), frames' gradient {rec['grad_placements']}; guard events "
        f"{rec['dropped']}; ok in {rec['s']} s on the host (torch {torch.__version__})")
    return rec


def tooling_phase(fk, card: str, train_ms=None) -> dict:
    """Phase 10: the roofline on the card, then the two dry runs at once in
    subprocesses (after the card's timed steps: their host work beside a
    prefill slowed it from 36 to 47 ms), and beside them the 3-D check."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="dryrun-", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    roof = roofline_phase(fk, card, train_ms)
    jobs = start_dryruns(out_dir)
    try:
        check_3d = dryrun_3d_check()
        walls = collect_dryruns(jobs, out_dir)
    finally:
        for _, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[tooling] phase 10 wall {time.perf_counter() - t0:.1f} s (dry runs {walls})")
    return {"dryrun_wall_s": walls, "dryrun_3d": check_3d, **roof}


def tooling_only() -> int:
    """Phases 1, 2 (the flash source alone) and 10 (the train step timed
    here, not by phase 8)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel as fk

    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    stamp("build")
    log_flash_build(fk.build()[1], fk)
    stamp("phase 10")
    rec = tooling_phase(fk, card)
    stamp("end")
    log(card)
    log(json.dumps({"tooling": rec}))
    return 0


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
# replicates), each run once, in that order.
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


# The counter draw at the benchmark cell's shape: B scenarios x P people.
RNG_SHAPE = (256, 55_130)
RNG_REPS = 200


def rng_phase(rk, rng, card: str) -> dict:
    """The counter draw's kernel (``csrc/rng.cu``) against its plain version
    (``core/rng.py``'s int64 path, on the card) at B = 1 and at the study
    cell's (B, P), bitwise, for the day's draw shape (seed and day (B, 1),
    the person ids (P,)); then its device-alone time beside its bound (the
    float32 store at 3.35 TB/s) and the plain path's."""
    B, P = RNG_SHAPE
    seed = torch.arange(B, dtype=torch.int64, device="cuda") * 0x9E3779B1 + 2**40 - 3
    seed, day = seed[:, None], torch.full((B, 1), 117, dtype=torch.int64, device="cuda")
    gpid = torch.arange(P, dtype=torch.int64, device="cuda")
    for b in (1, B):
        got = rk.uniform_cuda(seed[:b], rng.INFECT, day[:b], gpid)
        if not torch.equal(got, rng.uniform_plain(seed[:b], rng.INFECT, day[:b], gpid)):
            raise AssertionError(f"[rng] kernel differs from the int64 path at ({b}, {P})")
    launches = rk.uniform_cuda.launches
    device_ms, host_ms = device_host_ms(
        lambda: rk.uniform_cuda(seed, rng.INFECT, day, gpid), RNG_REPS)
    timed_launches = rk.uniform_cuda.launches - launches
    if timed_launches != RNG_REPS + 1:
        raise AssertionError("[rng] the timed calls did not each launch the kernel once")
    plain_ms, _ = device_host_ms(lambda: rng.uniform_plain(seed, rng.INFECT, day, gpid), 20)
    bound_ms = B * P * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"[rng] rng_uniform_kernel at ({B}, {P}), seed + 3 words: bitwise the int64 path "
        f"(also at B = 1); device alone {device_ms:.4f} ms (bound {bound_ms:.4f} ms, the "
        f"float32 store: {100 * bound_ms / device_ms:.1f}%), host {host_ms:.4f} ms a call; "
        f"plain int64 path {plain_ms:.4f} ms; {card}")
    return dict(device_ms=device_ms, host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                timed_launches=timed_launches)


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
    study width (the draw kernel's under :data:`DRAW`: the B = 8 ensemble's
    on pallas-compact), and the cores it built (phase 4f captures their
    runners), by (label, backend) and "B=64"."""
    from repro_torch import api
    from repro_torch.configs import INTERVENTION_PRESETS
    from repro_torch.configs.sweep import ScenarioBatch
    from repro_torch.engine import EngineCore
    from repro_torch.kernels.rng import kernel as rng_kernel
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
        if backend == "pallas-compact":
            main_launches[DRAW] = launches[DRAW]
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
        expect_launches(launches, kname, DAYS, f"TTI ensemble, {backend}",
                        draws=DRAWS_PER_DAY + len(c.static.pa_slots))
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
    for width, _, _, _ in STUDIES:
        spec = study_spec(width)
        torch.cuda.synchronize()
        for w in (*wrappers.values(), rng_kernel.uniform_cuda):
            w.launches = 0
        t0 = time.perf_counter()
        r = api.run(spec, population=pop)
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        launches[DRAW] = rng_kernel.uniform_cuda.launches
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
    return main_launches, studies, cores, tti_runs["pallas"][1]


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
            for mode in ("unchunked", "checkpointed"):
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
                f"(order: unchunked, checkpointed; run_wall_s "
                f"{walls}); {card}")
    finally:
        runner.CheckpointManager = CheckpointManager
    checkpoint_breakdown(pop, 64, fresh, card)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def checkpoint_breakdown(pop, width: int, fresh, card) -> None:
    """Where a checkpointed study's extra time goes: the study at ``width``
    through ``run_chunked`` on one core, five ways, once each: one chunk;
    four chunks with a save that does
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
    for m in modes:
        mgr = modes[m]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_lib.run_chunked(engine_lib.CoreDriver(core, observables), DAYS, observables,
                               ctx, manager=mgr, every=CKPT_EVERY, resume=False)
        torch.cuda.synchronize()
        walls[m].append(round(time.perf_counter() - t0, 4))
    log(f"[chunked] B={width} breakdown, run_chunked wall s (one run each): "
        f"{json.dumps(walls)}; blocking save (copy + digests + "
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
MESH_WALL_S = 700.0  # the wall limit of each spawn (they run at once, beside 4e-4f)
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
    out["plan"] = plan  # this rank's; the rank's server reuses it, never pickled back
    return out


def _counted_study(spec, pop, **kw) -> tuple:
    """api.run on this rank (``kw`` passed on) with the launch counts set to 0
    just before and read just after: (RunResult, launches)."""
    from repro_torch import api

    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    r = api.run(spec, population=pop, **kw)
    return r, _kernel_counts()


# Phase 4g (e): the simulation server on a mesh. Four requests of 1-3
# scenarios and 20-40 days from two client threads on rank 0 over two
# width-4 buckets, ("none",) on pallas-compact and ("tti",) on pallas, so the
# untraced compacted and the traced padded kernel run on every rank; each
# request's columns are phase 4d's (the B = 8 study's "none" columns, the
# TTI ensemble's), and the first of each bucket also runs solo through
# api.run on the same mesh (on the scenario mesh a B = 1 request runs
# single: one scenario cannot be split over scenario shards).
MESH_SERVE = {"workers": dict(workers=2), "scenarios": dict(scen_shards=2),
              "hybrid": dict(workers=2, scen_shards=2)}
MESH_MIX = ((30, ("none",), "pallas-compact", 2, 0), (20, ("none",), "pallas-compact", 1, 1),
            (40, ("tti",), "pallas", 2, 0), (25, ("tti",), "pallas", 1, 2))
MESH_SOLO = (0, 2)  # the first request of each bucket


def mesh_mix() -> list:
    """Phase 4g (e)'s requests: (days, interventions, backend, replicates,
    seed) rows of MESH_MIX."""
    from repro_torch import api

    return [api.ExperimentSpec(name=f"mesh{i}", dataset=DATASET, days=d, interventions=iv,
                               backend=b, replicates=r, seed=sd)
            for i, (d, iv, b, r, sd) in enumerate(MESH_MIX)]


def _solo_on_mesh(spec, layout: str):
    kw = {"workers": dict(workers=2), "hybrid": dict(workers=2, scenarios=2)}.get(layout, {})
    if layout == "scenarios" and spec.num_scenarios > 1:
        kw = dict(scenarios=2)
    return spec.with_overrides(**kw)


def _serve_on_mesh(pop, layout: str, plan=None) -> dict:
    """One mesh server on this rank: rank 0 warms both buckets, serves the
    mix from two client threads, closes; the other ranks follow. The launch
    counts are set to 0 before the mix on rank 0 and before following on the
    others (whose count then holds the two warm-ups, SERVE_CHUNK days each).
    Then the MESH_SOLO requests through api.run on the same mesh."""
    import threading

    from repro_torch import api
    from repro_torch.serve import ServeConfig, SimulationServer

    mix = mesh_mix()
    t0 = time.perf_counter()
    server = SimulationServer(ServeConfig(layout=layout, chunk_days=SERVE_CHUNK,
                                          b_lattice=(4,), max_executables=2,
                                          **MESH_SERVE[layout]))
    server._pops[DATASET] = pop
    if plan is not None:  # the plan phase 4g (b) built for this population and W
        server._plans[(DATASET, BLOCK)] = plan
    out = {"rank": server.rank, "build_s": time.perf_counter() - t0}
    if server.rank == 0:
        t0 = time.perf_counter()
        for i in MESH_SOLO:
            if server.warm_up(mix[i])["already_warm"]:
                raise AssertionError(f"mesh {layout}: a bucket warm before its warm-up")
        out["warm_up_s"] = time.perf_counter() - t0
        out["builds_warm"] = dict(server.mesh_builds)
        results = [None] * len(mix)

        def client(k):
            for i in range(k, len(mix), 2):
                results[i] = server.submit(mix[i]).result(timeout=600)

        torch.cuda.synchronize()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        with server:
            threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if any(t.is_alive() for t in threads):
                raise AssertionError(f"mesh {layout}: a client thread did not finish")
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = _kernel_counts()
        server.close()
        out["results"] = results
        out["metrics"] = server.metrics_dict()
    else:
        _kernel_counts(reset=True)
        out["followed"] = server.follow()
        out["launches"] = _kernel_counts()
        out["metrics"] = server.metrics_dict()
        if server.follow_errors:
            raise AssertionError(f"mesh {layout}: rank {server.rank} failed a dispatch:\n"
                                 f"{server.follow_errors[0]}")
    out["builds"] = dict(server.mesh_builds)
    out["log"] = server.dispatch_log
    t0 = time.perf_counter()
    out["solo"] = [api.run(_solo_on_mesh(mix[i], layout), population=pop) for i in MESH_SOLO]
    out["solo_s"] = time.perf_counter() - t0
    return out


def _check_served(res: list, layout: str, study8, tti_hist, total: dict, card: str) -> None:
    """Phase 4g (e)'s checks of one layout's ranks (``res``): every served
    result bitwise phase 4d's columns (``study8``: the B = 8 study,
    ``tti_hist``: the TTI ensemble's history) and, for MESH_SOLO, its solo
    api.run on the mesh; the ranks' dispatch logs equal; no build after the
    warm-ups; one launch per served day on every rank."""
    lead, mix = res[0], mesh_mix()
    for rank, r in enumerate(res):
        if r["log"] != lead["log"]:
            raise AssertionError(f"served {layout}: rank {rank}'s dispatch log differs")
        if r["builds"] != lead["builds"] or r["metrics"]["executables"]["recompile_violations"]:
            raise AssertionError(f"served {layout}: rank {rank} builds {r['builds']} / "
                                 f"{json.dumps(r['metrics']['executables'])}")
    if lead["builds"] != lead["builds_warm"] or not all(
            x.served_from["warm"] for x in lead["results"]):
        raise AssertionError(f"served {layout}: a build or a cold dispatch after the "
                             f"warm-ups: {lead['builds_warm']} -> {lead['builds']}")
    cols = {"none": study8.history, "tti": tti_hist}
    for i, (spec, served) in enumerate(zip(mix, lead["results"])):
        ref = cols[spec.interventions[0]]
        lo = spec.seed  # the seeds 0.. are the columns 0.. of each reference
        for k in served.history:
            want = np.asarray(ref[k])[:spec.days, lo:lo + spec.num_scenarios]
            if not np.array_equal(served.history[k], want):
                raise AssertionError(f"served {layout} request {i}: '{k}' != phase 4d's "
                                     "columns")
    for rank, r in enumerate(res):
        for j, i in enumerate(MESH_SOLO):
            same_study(r["solo"][j], lead["results"][i],
                       f"served {layout} request {i} against its solo api.run on rank {rank}")
    chunks = lead["metrics"]["batches"]["chunks_run"]  # the two warm-ups count one each
    days = (chunks - 2) * SERVE_CHUNK
    for rank, r in enumerate(res):
        got = dict(r["launches"])
        if rank > 0:  # a follower's count holds the warm-ups
            got["interactions_compact"] -= SERVE_CHUNK
            got["interactions_padded_traced"] -= SERVE_CHUNK
        if sum(got.values()) != days or min(got["interactions_compact"],
                                            got["interactions_padded_traced"]) <= 0:
            raise AssertionError(f"served {layout} rank {rank}: launches {r['launches']} "
                                 f"for {days} served days")
        for k, v in got.items():
            total[k] += v
    m = lead["metrics"]
    lat = m["request_latency"]
    per_day = [x.served_from["dispatch_wall_s"] / x.served_from["padded_days"]
               for x in lead["results"]]
    log(f"[served-mesh] {layout} {json.dumps(MESH_SERVE[layout])}, {len(res)} ranks over "
        f"gloo on one card: {len(mix)} requests (1-3 scenarios, 20-40 days, two clients), "
        f"{m['batches']['dispatched'] - 2} dispatches, {days} served days; every result "
        f"bitwise phase 4d's columns, requests {list(MESH_SOLO)} bitwise their solo api.run "
        f"on the mesh on every rank; dispatch logs equal on every rank ({len(lead['log'])} "
        f"entries); builds {json.dumps(lead['builds'], sort_keys=True)}, none after the "
        f"warm-ups; launches per rank {[r['launches'] for r in res]}")
    log(f"[served-mesh] {layout}: served ms/day (dispatch wall / padded days) median "
        f"{1e3 * float(np.median(per_day)):.3f} min {1e3 * min(per_day):.3f} max "
        f"{1e3 * max(per_day):.3f}; request latency p50 {lat['p50_s']:.4f} s p99 "
        f"{lat['p99_s']:.4f} s; {len(mix) / lead['wall_s']:.3f} requests/s "
        f"({lead['wall_s']:.3f} s); server build {max(r['build_s'] for r in res):.2f} s, "
        f"warm-ups {lead['warm_up_s']:.2f} s, solo runs {max(r['solo_s'] for r in res):.2f} "
        f"s per rank; {card}")


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
    plan = out["workers"].pop("plan")
    out["sharded"] = _counted_study(study_spec(8).with_overrides(scenarios=2), pop)
    ck = lambda d, **kw: study_spec(1, **kw).with_overrides(
        workers=2, ckpt_dir=os.path.join(root, d), ckpt_every=CKPT_EVERY)
    out["chunked"] = _counted_study(ck("chunked"), pop)
    out["prefix"] = _counted_study(ck("prefix", days=DAYS // 2), pop)
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(root, "prefix"), os.path.join(root, "prefix-for-local"))
    dist.barrier()
    out["resumed"] = _counted_study(ck("prefix"), pop)
    out["served"] = {"workers": _serve_on_mesh(pop, "workers", plan),
                     "scenarios": _serve_on_mesh(pop, "scenarios")}
    out["shrink"] = _rank_shrink_two(pop, days, SHRINK_ROOT)
    return out


def _rank_four(pop, days):
    """Phase 4g (c): the B = 8 study on a 2 x 2 hybrid mesh, four ranks
    sharing the card over gloo; then phase 4h (b) on the same ranks."""
    return {"hybrid": _counted_study(study_spec(8).with_overrides(workers=2, scenarios=2),
                                     pop),
            "served": {"hybrid": _serve_on_mesh(pop, "hybrid")},
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


def start_mesh_spawns(pop) -> dict:
    """Start phase 4g's three spawns (one rank over nccl, two and four over
    gloo, each in its own rendezvous and checkpoint directories) in
    background threads; :func:`mesh_phase` takes their results. The ranks'
    work is mostly host work (plans, tables, gloo round trips) that took
    ~450 s of the script's 1,200 one spawn after another on a slow host, so
    the spawns run at once and beside phases 4e and 4f, whose times include
    that load. Returns each spawn's future of (results, wall s)."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh as mesh_lib

    for d in (MESH_ROOT, SHRINK_ROOT):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    init = tempfile.mkdtemp(prefix="pg-", dir=MESH_ROOT)

    def spawn(fn, n, backend, *args):
        t0 = time.perf_counter()
        out = mesh_lib.spawn(fn, n, backend=backend, device="cuda:0", init_dir=init,
                             args=(pop, DAYS, *args), timeout_s=MESH_TIMEOUT_S,
                             wall_s=MESH_WALL_S)
        return out, time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=3)
    jobs = {"one": pool.submit(spawn, _rank_nccl, 1, "nccl"),
            "two": pool.submit(spawn, _rank_two, 2, "gloo", MESH_ROOT),
            "four": pool.submit(spawn, _rank_four, 4, "gloo")}
    pool.shutdown(wait=False)
    return jobs


def mesh_phase(pop, wrappers, local, studies, tti_hist, jobs, card) -> dict:
    """Phase 4g: the mesh layouts on one card, from the spawns that
    :func:`start_mesh_spawns` started (``jobs``). ``local``: phase 4/4c's runs
    by (preset, backend) -> (final, hist); ``studies``: phase 4d's api.run
    results by width; ``tti_hist``: phase 4d's TTI ensemble history. The
    same spawns run phase 4g (e) (the mesh servers) and phase 4h (a) and (b)
    after phase 4g's work (a spawn of four ranks costs ~40 s of start-up
    alone). Returns the mesh runs' launches by kernel, the mesh servers'
    mixes' launches by kernel, each summed over ranks, and phase 4h's
    results of the two- and four-rank spawns."""
    import shutil

    from repro_torch.api import observables as obs_lib
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import EngineCore, core as core_lib

    P, days = pop.num_people, DAYS
    log(f"[mesh] ranks share one card; no scaling claim. {DAYS} days of {DATASET}; "
        f"every group's timeout {MESH_TIMEOUT_S:.0f} s, each spawn's wall limit "
        f"{MESH_WALL_S:.0f} s; the three spawns ran at once, beside phases 4e and 4f; "
        f"{card}")
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
    (one,), wall = jobs["one"].result()
    stamp("mesh (a): one rank over nccl")
    log(f"[mesh] (a) spawn of 1 rank: {wall:.1f} s")
    for key in (("none", "pallas-compact"), ("none", "pallas")):
        r = one[key]
        launched(r["launches"], kname[key], days, f"mesh W=1 nccl {key}")
        _same_as_local(r, local[key], P, f"mesh W=1 nccl {key}")
        _mesh_line(f"(a) workers W=1 over nccl, {key[1]}, day loop under sync-debug "
                   f"\"error\", bitwise equal to phase 4, {days} launches", r, card)
    log(f"[mesh] (a) plan build (W=1) {one['plan_build_s']:.2f} s on the host; location runs "
        f"cut unlike the local layout: {one['fold_mismatches']}")

    # (b)-(d) two ranks sharing the card over gloo
    two, wall = jobs["two"].result()
    stamp("mesh (b)-(d): two ranks over gloo")
    log(f"[mesh] (b)-(d) spawn of 2 ranks: {wall:.1f} s")
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
    four, wall = jobs["four"].result()
    stamp("mesh (c): four ranks over gloo, hybrid 2 x 2")
    log(f"[mesh] (c) spawn of 4 ranks: {wall:.1f} s")
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
    # (e) the simulation server on the three mesh layouts
    stamp("mesh (e): served on a mesh")
    served = {k: 0 for k in KERNELS}
    for layout, ranks in (("workers", two), ("scenarios", two), ("hybrid", four)):
        _check_served([r["served"][layout] for r in ranks], layout, studies[8], tti_hist,
                      served, card)
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    return total, served, {"two": [r["shrink"] for r in two],
                           "four": [r["shrink"] for r in four]}


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


# Phase 4i: the reference's lower-level entry points (core/simulator.py's
# views over the engine's day) at B = 1 on each backend.
EAGER_DAYS = 14


def lowlevel_phase(cores: dict, local: dict, eager_ms: dict, wrappers, card) -> dict:
    """Phase 4i: ``run_eager``, ``run_scan`` (then one ``day_step``) on phase
    4's B = 1 cores by backend, each bitwise phase 4's first EAGER_DAYS days
    and final state (``core.run1``), one launch a day; ``run_eager``'s
    visits / interact / update ms per day beside phase 4's eager ms/day
    (``eager_ms``). Returns ``run_eager``'s launches by kernel."""
    from repro_torch.core import simulator as sim_lib

    eager = {k: 0 for k in KERNELS}
    kname = {"pallas-compact": "interactions_compact", "pallas": "interactions_padded"}
    for backend, core in cores.items():
        hist4 = local[("none", backend)][1]
        final, _ = core.run1(EAGER_DAYS)

        def counted(fn):
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            out = fn()
            torch.cuda.synchronize()
            return out, {k: w.launches for k, w in wrappers.items()}

        (st, he, times), launches = counted(lambda: sim_lib.run_eager(core, EAGER_DAYS))
        expect_launches(launches, kname[backend], EAGER_DAYS, f"run_eager on {backend}")
        for k, v in launches.items():
            eager[k] += v
        static, week, cp, params = sim_lib.legacy_parts(core)
        (scan, launches) = counted(lambda: sim_lib.run_scan(static, week, cp, params,
                                                            core.init_state1(), EAGER_DAYS - 1))
        expect_launches(launches, kname[backend], EAGER_DAYS - 1, f"run_scan on {backend}")
        (stepped, launches) = counted(lambda: sim_lib.day_step(static, week, cp, params,
                                                               scan[0]))
        expect_launches(launches, kname[backend], 1, f"day_step on {backend}")
        for k in sim_lib.STAT_KEYS:
            want = hist4[k][:EAGER_DAYS]
            if not np.array_equal(he[k], want):
                raise AssertionError(f"run_eager on {backend}: '{k}' != phase 4's first days")
            if not np.array_equal(scan[1][k].cpu().numpy(), want[:-1]) or \
                    int(stepped[1][k]) != int(want[-1]):
                raise AssertionError(f"run_scan/day_step on {backend}: '{k}' != phase 4's")
        for f in ("health", "dwell", "cumulative", "vaccinated", "iv_active"):
            for what, got in (("run_eager", st), ("run_scan + day_step", stepped[0])):
                if not torch.equal(getattr(got, f), getattr(final, f)):
                    raise AssertionError(f"{what} on {backend}: final '{f}' != run1's")
        ms = {k: 1e3 * v for k, v in times.items()}
        total = sum(ms.values())
        log(f"[eager] run_eager {DATASET} B=1 on {backend}, {EAGER_DAYS} days: run_eager, "
            f"run_scan and day_step bitwise phase 4's first {EAGER_DAYS} days and run1's "
            f"final state, one launch a day; per phase ms/day (mean over days 1-"
            f"{EAGER_DAYS - 1} / median / day 0): "
            + "; ".join(f"{k} {v[1:].mean():.3f} / {np.median(v):.3f} / {v[0]:.3f}"
                        for k, v in ms.items())
            + f"; phases sum {total[1:].mean():.3f} ms/day against phase 4's eager day "
            f"{eager_ms[backend]:.3f} ms/day; {card}")
    return eager


def main() -> int:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--interactions-only":
        return interactions_only(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--flash-only":
        return flash_only(sys.argv[2])
    if sys.argv[1:] == ["--families-only"]:
        return families_only()
    if sys.argv[1:] == ["--train-only"]:
        return train_only()
    if sys.argv[1:] == ["--shard-only"]:
        return shard_only()
    if sys.argv[1:] == ["--tooling-only"]:
        return tooling_only()
    if len(sys.argv) != 1:
        print("usage: chip_smoke.py [--interactions-only SRC_DIR | --flash-only SRC_DIR | "
              "--families-only | --train-only | --shard-only | --tooling-only]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import INTERVENTION_PRESETS, get_epidemic
    from repro_torch.core import disease as disease_lib
    from repro_torch.core import interventions as iv_lib
    from repro_torch.core import transmission as tx_lib
    from repro_torch.engine import EngineCore
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.core import rng
    from repro_torch.kernels.interactions import kernel, ops
    from repro_torch.kernels.rng import kernel as rng_kernel

    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices={count}")
    wrappers = {k: getattr(kernel, v[0]) for k, v in KERNELS.items()}

    # ---- phase 2: build (one nvcc per source, all started together) --------
    stamp("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = {m: pool.submit(m.build) for m in (kernel, flash_kernel, rng_kernel)}
        built = {m: f.result() for m, f in futures.items()}
    log(f"[build] the three sources in {time.perf_counter() - t0:.2f} s")
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
    log_flash_build(built[flash_kernel][1], flash_kernel)
    seen = False
    for line in built[rng_kernel][1].splitlines():
        if "entry function" in line:
            seen = "rng_uniform_kernel" in line
        elif seen and ("registers" in line or "spill" in line):
            log(f"[build] rng_uniform_kernel: {line.strip()}")

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

    # ---- phase 3c: the counter draw ----------------------------------------
    stamp("counter draw")
    rng_rec = rng_phase(rng_kernel, rng, card)

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
        expect_launches(launches, traced, DAYS, f"TTI path, {backend}",
                        draws=DRAWS_PER_DAY + len(c.static.pa_slots))
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
    main_launches, studies, cores, tti_hist = ensemble_phase(pop, covid, epi, wrappers, card)

    # ---- phase 4g's spawns start here and run beside phases 4e and 4f ------
    mesh_jobs = start_mesh_spawns(pop)
    # ---- and phase 9's (LM sharding), collected after phase 8 ---------------
    shard_job = start_shard_spawn(card)

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
    mesh_launches, mesh_served, shrunk = mesh_phase(pop, wrappers, local, studies, tti_hist,
                                                    mesh_jobs, card)

    # ---- phase 4h: elastic shrink, the static-network oracle, detlint -------
    stamp("elastic shrink")
    shrink_launches = shrink_phase(pop, wrappers, studies, shrunk,
                                   {"pallas-compact": core, "pallas": padded_core},
                                   mid_state, card)

    # ---- phase 4i: the lower-level entry points -------------------------------
    stamp("lower-level entry points")
    eager_launches = lowlevel_phase({"pallas-compact": core, "pallas": padded_core}, local,
                                    {"pallas-compact": 1e3 * dt1 / DAYS,
                                     "pallas": 1e3 * dt_p / DAYS}, wrappers, card)

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
    flash_rec = flash_phase(flash_kernel, card)[FLASH_CASES[0][0]]

    # ---- phase 7: the serving path ------------------------------------------
    stamp("serving")
    flash_launches = serve_phase(flash_kernel, card)

    # ---- phase 7b: the other families ------------------------------------------
    stamp("families")
    families = families_phase(flash_kernel, card)

    # ---- phase 8: training -------------------------------------------------
    stamp("phase 8")
    train = train_phase(flash_kernel, card)

    # ---- phase 9: LM sharding on a 2 x 2 mesh (started beside phase 4g) -------
    stamp("phase 9")
    shard = shard_phase(card, shard_job)

    # ---- phase 10: the LM tooling: dry runs and the H100 roofline -------------
    stamp("phase 10")
    tooling = tooling_phase(flash_kernel, card, train["smollm_ms"])

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
            "mesh_served_launches": mesh_served[kname],
            "shrink_launches": shrink_launches[kname],
            "eager_launches": eager_launches[kname],
            "train_launches": train["launches"][kname],
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
        "family_launches": {a: r["launches"] for a, r in families.items()},
        "train_launches": train["launches"]["flash_attention"],
        "train_flash_launches": train["flash_launches"],
        "shard_launches": shard["launches"],
        "roofline_launches": tooling["launches"],
        **flash_rec,
    })
    line.append({
        "name": "rng_uniform",
        "route": "cuda",
        "source": os.path.relpath(rng_kernel.SOURCE, ROOT),
        "replaces": None,
        "launches": main_launches[DRAW],
        **rng_rec,
    })
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
