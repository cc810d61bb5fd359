"""The epidemic day loop (Algorithm 2) on the local topology.

:func:`day_step` is one day: visits -> interactions -> update, in the
reference's order (``repro/engine/day.py:day_step``):

  1. classic interventions;
  1b. per-agent interventions (test-trace-isolate), only when the scenario
     has such a slot: isolation masks visits, then each slot spends its
     testing budget, an exact top-k over a tiered random score;
  2. dispatch of person channels to visit slots (plus today's positives as
     tracing sources when a slot traces);
  3. the interaction pass (the CUDA kernels on the card), traced when a
     slot traces;
  4. the exposure combine back to people (two channels when tracing);
  5. infection draws and outbreak seeding;
  6. the FSA health update and the per-agent state advance;
  7. the ``STAT_KEYS`` reductions and trigger evaluation.

:func:`run_days` is the whole run: a Python loop over days that keeps the
per-day statistics on the device. Nothing in the loop waits for the device
or copies to the host (the day, the live-tile count, the testing threshold
and the kernel's ``meta`` stay tensors; Python branches read only
``EngineStatic``), so the loop is ready to be captured as a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import disease as disease_lib
from repro_torch.core import interventions as iv_lib
from repro_torch.core import population as pop_lib
from repro_torch.core import rng
from repro_torch.core import simulator as sim_lib
from repro_torch.core import transmission as tx_lib
from repro_torch.engine.topology import LocalTopology
from repro_torch.kernels.interactions import ops as iops

STAT_KEYS = sim_lib.STAT_KEYS


@dataclasses.dataclass(frozen=True)
class EngineStatic:
    """Structure of a run that the day step branches on in Python."""

    num_people: int
    num_locations: int
    block_size: int
    iv_slots: tuple  # tuple[iv_lib.IvSlotStatic, ...]
    # Per-agent slots; empty = no test-trace-isolate code runs at all.
    pa_slots: tuple = ()  # tuple[iv_lib.PaSlotStatic, ...]
    backend: str = "pallas-compact"  # interaction pass: ops.BACKENDS


@dataclasses.dataclass
class Exposure:
    """What phases 1-4 hand to phases 5-7."""

    A: torch.Tensor  # (P,) f32 propensity
    cnt: torch.Tensor  # (V,) int32 contact counts per visit
    edges: torch.Tensor  # () int64 traversed edges
    vaccinated: torch.Tensor  # (P,) bool, updated
    # --- per-agent interventions (None without a TestTraceIsolate slot) ---
    takes: tuple = ()  # per slot: (P,) bool tested today
    in_iso: Optional[torch.Tensor] = None  # (P,) bool isolated today
    detectable: Optional[torch.Tensor] = None  # (P,) bool would test positive
    tests_used: Optional[torch.Tensor] = None  # () int64
    trc_p: Optional[torch.Tensor] = None  # (P,) f32 traced contacts (tracing on)


def exposure(topo: LocalTopology, static: EngineStatic, week: dict,
             params: sim_lib.SimParams, state: sim_lib.SimState) -> Exposure:
    """Phases 1-4 of a day: interventions, the testing budget, dispatch,
    the interaction pass and the exposure combine."""
    P = static.num_people
    day = state.day
    dow = (day % pop_lib.DAYS_PER_WEEK).reshape(1)
    take = lambda k: week[k].index_select(0, dow)[0]
    pid, loc = take("pid"), take("loc")

    # ---- interventions + per-person epidemiological channels -----------
    visit_ok, loc_open, sus_mult, inf_mult, vaccinated = iv_lib.apply_iv_params(
        static.iv_slots, params.iv, state.iv_active, state.vaccinated,
        P, static.num_locations,
    )

    # ---- per-agent interventions: isolation and the testing budget -------
    iv = params.iv
    tracing_on = any(ps.trace for ps in static.pa_slots)
    ex = {}
    if static.pa_slots:
        gpid = torch.arange(P, dtype=torch.int64, device=day.device)
        in_iso = day < state.isolated_until
        visit_ok = visit_ok & ~in_iso
        sym = params.sym_table[state.health] > 0.0
        detectable = params.inf_table[state.health] > 0.0
        take_any = torch.zeros_like(in_iso)
        tests_used = torch.zeros((), dtype=torch.int64, device=day.device)
        takes = []
        for k2 in range(len(static.pa_slots)):
            act = iv.pa_enabled[k2] & (day >= iv.pa_start[k2])
            elig = act & iv.pa_people[k2] & ~state.tested & ~in_iso & (sym | state.traced)
            # Symptomatic candidates draw in (0,1), traced-only in (2,3),
            # ineligible sit at 4.0: one lexicographic top-k over
            # (score, gpid) is then an exact priority-tiered budget.
            u = rng.uniform(params.seed, rng.TEST, day, k2, gpid)
            score = torch.where(elig & sym, u, torch.where(elig, u + 2.0, 4.0))
            T, G = topo.rank_threshold(score, gpid, iv.pa_tests[k2], P)
            take_k = (elig & (iv.pa_tests[k2] > 0)
                      & ((score < T) | ((score == T) & (gpid <= G))))
            takes.append(take_k)
            take_any = take_any | take_k
            tests_used = tests_used + take_k.sum()
        # Result latency: positives circulate today as tracing sources and
        # enter isolation from day + 1.
        positives = take_any & detectable
        ex = dict(takes=tuple(takes), in_iso=in_iso, detectable=detectable,
                  tests_used=tests_used)

    person_sus = params.sus_table[state.health] * params.beta_sus * sus_mult
    person_inf = params.inf_table[state.health] * params.beta_inf * inf_mult

    # ---- visit dispatch: person channels to visit slots -------------------
    person_chans = [person_sus, person_inf, visit_ok.to(torch.float32)]
    if tracing_on:
        person_chans.append(positives.to(torch.float32))
    visit_vals = topo.dispatch(pid, torch.stack(person_chans, dim=-1))
    sus_v, inf_v, ok_v = visit_vals[:, 0], visit_vals[:, 1], visit_vals[:, 2]
    open_v = loc_open[loc.clamp(max=static.num_locations - 1)]
    active = (pid >= 0) & (ok_v > 0.0) & open_v
    eff_pid = torch.where(active, pid, -1)
    sus_v = sus_v * active
    inf_v = inf_v * active

    # ---- the interaction pass ---------------------------------------------
    b = static.block_size
    nb = pid.shape[0] // b
    contact_day = torch.where(params.static_network, day % pop_lib.DAYS_PER_WEEK, day)
    meta = torch.stack([params.seed, contact_day])
    args = (eff_pid, loc, take("start"), take("end"), take("p"), sus_v, inf_v,
            take("row"), take("col"), take("rs"), take("pa"),
            iops.col_has_infectious(inf_v, eff_pid, nb, b),
            iops.row_has_susceptible(sus_v, eff_pid, nb, b), meta)
    slots = take("slots")
    if tracing_on:
        # Second accumulator: traced contacts ride the exposure tiles, and
        # the traced-contact channel rides the exposure combine.
        acc, cnt, edges, trc = iops.interactions_auto_traced(
            *args, backend=static.backend, block_size=b,
            src_val=visit_vals[:, 3] * active)
        combined = topo.combine_many(
            slots, active, torch.stack([acc, trc.to(torch.float32)], dim=-1))
        A = combined[:, 0] * params.tau_eff
        ex["trc_p"] = combined[:, 1]
    else:
        acc, cnt, edges = iops.interactions_auto_edges(
            *args, backend=static.backend, block_size=b)
        A = topo.combine(slots, active, acc) * params.tau_eff
    return Exposure(A=A, cnt=cnt, edges=edges, vaccinated=vaccinated, **ex)


def advance_per_agent(static: EngineStatic, params: sim_lib.SimParams,
                      state: sim_lib.SimState, ex: Exposure):
    """The per-agent state after the day and its stats: ``(tested, traced,
    isolated_until, stats)``, ``stats`` the () int64 ``tests_used``,
    ``isolated`` and ``traced`` (people newly traced). Positives isolate
    from day + 1 for ``pa_iso`` days, newly traced contacts for
    ``pa_trace_iso`` days."""
    if not static.pa_slots:
        zero = torch.zeros((), dtype=torch.int64, device=state.day.device)
        return (state.tested, state.traced, state.isolated_until,
                dict(tests_used=zero, isolated=zero, traced=zero))
    day, iv = state.day, params.iv
    iso_until = state.isolated_until
    newly_traced = torch.zeros_like(state.traced)
    # isolated_until stays int32: cast each candidate end day before max.
    until = lambda days, mask: torch.where(
        mask, (day + 1 + days).to(torch.int32), 0)
    for k2, ps in enumerate(static.pa_slots):
        iso_until = torch.maximum(iso_until, until(iv.pa_iso[k2],
                                                   ex.takes[k2] & ex.detectable))
        if ps.trace:
            act = iv.pa_enabled[k2] & (day >= iv.pa_start[k2])
            nt_k = (ex.trc_p > 0.0) & iv.pa_people[k2] & act
            newly_traced = newly_traced | nt_k
            iso_until = torch.maximum(iso_until, until(iv.pa_trace_iso[k2], nt_k))
    tested = state.tested
    for take_k in ex.takes:
        tested = tested | take_k
    return (tested, state.traced | newly_traced, iso_until,
            dict(tests_used=ex.tests_used, isolated=ex.in_iso.sum(),
                 traced=newly_traced.sum()))


def update(topo: LocalTopology, static: EngineStatic, params: sim_lib.SimParams,
           state: sim_lib.SimState, ex: Exposure):
    """Phases 5-7 of a day. Returns ``(new_state, stats)``, ``stats`` a dict
    of () int64 tensors keyed by ``STAT_KEYS``."""
    P = static.num_people
    day = state.day
    A = ex.A
    gpid = torch.arange(P, dtype=torch.int64, device=A.device)
    infected = tx_lib.sample_infections(A, params.seed, day, gpid)

    # Outbreak seeding; both branches of the reference's lax.cond are
    # computed and the day decides, so no host sync.
    sus_ok = params.sus_table[state.health] > 0.0
    us = torch.where(sus_ok, rng.uniform(params.seed, rng.SEED_CHOICE, day, gpid), 2.0)
    thresh = topo.seed_threshold(us, params.seed_per_day, P)
    seeded = (us <= thresh) & sus_ok & (params.seed_per_day > 0) & (day < params.seed_days)

    new_mask = (infected | seeded) & sus_ok
    health, dwell = disease_lib.update_health_tables(
        params.cum_trans, params.dwell_mean, params.sus_table,
        params.entry_state, state.health, state.dwell, new_mask,
        params.seed, day, gpid,
    )
    tested, traced, isolated_until, pa_stats = advance_per_agent(
        static, params, state, ex)

    # ---- reductions (Algorithm 2 line 34), int64 throughout ---------------
    new_count = new_mask.sum()
    cumulative = state.cumulative + new_count
    stats = {
        "day": day,
        "new_infections": new_count,
        "cumulative": cumulative,
        "infectious": (params.inf_table[health] > 0.0).sum(),
        "susceptible": (params.sus_table[health] > 0.0).sum(),
        "contacts": ex.cnt.sum(dtype=torch.int64),
        "edges": ex.edges,
        **pa_stats,
    }
    iv_active = iv_lib.evaluate_iv_triggers(
        static.iv_slots, params.iv, day, stats, state.iv_active
    )
    new_state = sim_lib.SimState(
        day=day + 1, health=health, dwell=dwell, cumulative=cumulative,
        iv_active=iv_active, vaccinated=ex.vaccinated, tested=tested,
        traced=traced, isolated_until=isolated_until,
    )
    return new_state, stats


def day_step(topo, static, week, params, state):
    """One simulated day; pure in (params, state)."""
    return update(topo, static, params, state,
                  exposure(topo, static, week, params, state))


def run_days(topo, static, week, params, state, days: int):
    """``days`` days from ``state``. Returns ``(final_state, hist)``: ``hist``
    is a (days, len(STAT_KEYS)) int64 tensor on the run's device."""
    rows = []
    for _ in range(days):
        state, stats = day_step(topo, static, week, params, state)
        rows.append(torch.stack([stats[k] for k in STAT_KEYS]))
    if not rows:
        return state, torch.zeros((0, len(STAT_KEYS)), dtype=torch.int64,
                                  device=state.day.device)
    return state, torch.stack(rows)
