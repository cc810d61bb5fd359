"""The epidemic day loop (Algorithm 2) on a topology, for a batch.

:func:`day_step` is one day of B scenarios at once: visits -> interactions
-> update, in the reference's order (``repro/engine/day.py:day_step``,
which the reference vmaps over its scenario axis). Every ``SimParams`` and
``SimState`` leaf carries the leading scenario axis ``(B, ...)``, B = 1
included; every op runs on the whole batch, and the interaction pass is one
kernel launch for all B scenarios:

  1. classic interventions;
  1b. per-agent interventions (test-trace-isolate), only when the scenarios
     have such a slot: isolation masks visits, then each slot spends its
     testing budget, an exact top-k over a tiered random score;
  2. dispatch of person channels to visit slots (plus today's positives as
     tracing sources when a slot traces);
  3. the interaction pass (the CUDA kernels on the card), traced when a
     slot traces;
  4. the exposure combine back to people (two channels when tracing);
  5. infection draws and outbreak seeding;
  6. the FSA health update and the per-agent state advance;
  7. the ``STAT_KEYS`` reductions, (B,) each, and trigger evaluation.

On a mesh (``engine/topology.py``) the step runs on this rank's shard: its
``Pw`` people (the state's person axis; global ids from ``topo.gpid``), its
workers' visits and the exchange tables of its week, and its slice of the
batch; the exchange, the order statistics, the day's sums and the gather
of the statistics are the topology's collectives, and the arithmetic per
person and per visit is the local layout's, so every layout gives bitwise
the local run.

The scenarios of a batch advance in lockstep (the core starts them all on
day 0), so the day's visit schedule is read once, at scenario 0's day, and
shared. Each scenario's trajectory is bitwise the one it has in a batch of
one: its rows go through the same elementwise ops, row-wise sorts and
fixed-order sums, and the kernel computes each scenario apart.

:func:`run_days` is the whole run: a Python loop over days that keeps the
per-day statistics on the device and updates the observables inside the
loop. Nothing in the loop waits for the device or copies to the host (the
day, the live-tile counts, the testing thresholds and the kernel's ``meta``
stay tensors; Python branches read only ``EngineStatic``), so the loop is
ready to be captured as a CUDA graph.
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
from repro_torch.kernels.interactions import ops as iops
from repro_torch.runtime import spans

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
    """What phases 1-4 hand to phases 5-7 (leading axis: scenarios)."""

    A: torch.Tensor  # (B, P) f32 propensity
    cnt: torch.Tensor  # (B, V) int32 contact counts per visit
    edges: torch.Tensor  # (B,) int64 traversed edges
    vaccinated: torch.Tensor  # (B, P) bool, updated
    # --- per-agent interventions (None without a TestTraceIsolate slot) ---
    takes: tuple = ()  # per slot: (B, P) bool tested today
    in_iso: Optional[torch.Tensor] = None  # (B, P) bool isolated today
    detectable: Optional[torch.Tensor] = None  # (B, P) bool would test positive
    tests_used: Optional[torch.Tensor] = None  # (B,) int64
    trc_p: Optional[torch.Tensor] = None  # (B, P) f32 traced contacts (tracing on)


def _look(table, idx):
    """Each scenario's (B, S) table row read at its (B, P) indices."""
    return table.gather(1, idx.long())


def visits(static: EngineStatic, params: sim_lib.SimParams, state: sim_lib.SimState,
           num_people: int):
    """Phase 1 of a day: the classic interventions folded into masks and
    multipliers, and the person channels. Returns (visit_ok (B, P),
    loc_open (B, L), person_sus (B, P), person_inf (B, P), vaccinated
    (B, P)) for ``num_people`` people (this shard's on a mesh)."""
    visit_ok, loc_open, sus_mult, inf_mult, vaccinated = iv_lib.apply_iv_params(
        static.iv_slots, params.iv, state.iv_active, state.vaccinated,
        num_people, static.num_locations,
    )
    person_sus = _look(params.sus_table, state.health) * params.beta_sus * sus_mult
    person_inf = _look(params.inf_table, state.health) * params.beta_inf * inf_mult
    return visit_ok, loc_open, person_sus, person_inf, vaccinated


def interact(topo, static: EngineStatic, take, person_chans: torch.Tensor,
             loc_open: torch.Tensor, seed: torch.Tensor, contact_day: torch.Tensor,
             tau: torch.Tensor):
    """Phases 2-4 of a day: dispatch of the person channels to visit slots,
    the interaction pass (one launch for the batch) and the exposure
    combine.

    ``take(key)`` reads the week's ``key`` at today's day of the week;
    ``person_chans`` (B, P, ch) stacks sus, inf and visit_ok as float, and
    when a slot traces, today's positives as tracing sources; ``seed`` and
    ``contact_day`` are the (B,) words of the contact hash, ``tau`` the (B,)
    prefactor. Returns ``(A (B, P), cnt (B, V), edges (B,), trc_p)``,
    ``trc_p`` the (B, P) traced contacts, or None when nothing traces."""
    with spans.span("day.dispatch"):
        pid, loc = take("pid"), take("loc")
        route = topo.day_route(take)
        visit_vals = topo.dispatch(pid, person_chans, route)  # (B, V, ch)
        sus_v, inf_v, ok_v = visit_vals[..., 0], visit_vals[..., 1], visit_vals[..., 2]
        open_v = loc_open[:, loc.clamp(max=static.num_locations - 1)]
        active = (pid >= 0) & (ok_v > 0.0) & open_v
        eff_pid = torch.where(active, pid, -1)
        sus_v = sus_v * active
        inf_v = inf_v * active

    b = static.block_size
    nb = pid.shape[0] // b
    traced = any(ps.trace for ps in static.pa_slots)
    with spans.span("day.interactions"):
        meta = torch.stack([seed, contact_day], dim=-1)
        args = (eff_pid, loc, take("start"), take("end"), take("p"), sus_v, inf_v,
                take("row"), take("col"), take("rs"), take("pa"),
                iops.col_has_infectious(inf_v, eff_pid, nb, b),
                iops.row_has_susceptible(sus_v, eff_pid, nb, b), meta)
        if traced:
            # Second accumulator: traced contacts ride the exposure tiles,
            # and the traced-contact channel rides the exposure combine.
            acc, cnt, edges, trc = iops.interactions_auto_traced(
                *args, backend=static.backend, block_size=b,
                src_val=visit_vals[..., 3] * active)
        else:
            acc, cnt, edges = iops.interactions_auto_edges(
                *args, backend=static.backend, block_size=b)
    with spans.span("day.combine"):
        tau = tau[:, None]
        if traced:
            combined = topo.combine_many(
                route, active, torch.stack([acc, trc.to(torch.float32)], dim=-1))
            return combined[..., 0] * tau, cnt, edges, combined[..., 1]
        return topo.combine(route, active, acc) * tau, cnt, edges, None


def exposure(topo, static: EngineStatic, week: dict,
             params: sim_lib.SimParams, state: sim_lib.SimState) -> Exposure:
    """Phases 1-4 of a day: interventions, the testing budget, dispatch,
    the interaction pass and the exposure combine."""
    P = static.num_people
    Pw = state.health.shape[-1]  # this shard's people (P on one worker)
    day = state.day  # (B,), one value: the batch advances in lockstep
    dow = (day[:1] % pop_lib.DAYS_PER_WEEK)
    take = lambda k: week[k].index_select(0, dow)[0]
    seed_w, day_w = params.seed[:, None], day[:, None]  # hash words (B, 1)

    tracing_on = any(ps.trace for ps in static.pa_slots)
    ex = {}
    with spans.span("day.interventions"):
        # ---- interventions + per-person epidemiological channels -------
        visit_ok, loc_open, person_sus, person_inf, vaccinated = visits(
            static, params, state, Pw)

        # ---- per-agent interventions: isolation and the testing budget ---
        iv = params.iv
        if static.pa_slots:
            gpid = topo.gpid(Pw, day.device)
            in_iso = day_w < state.isolated_until
            visit_ok = visit_ok & ~in_iso
            sym = _look(params.sym_table, state.health) > 0.0
            detectable = _look(params.inf_table, state.health) > 0.0
            take_any = torch.zeros_like(in_iso)
            tests_used = torch.zeros_like(day)
            takes = []
            for k2 in range(len(static.pa_slots)):
                act = (iv.pa_enabled[:, k2] & (day >= iv.pa_start[:, k2]))[:, None]
                elig = act & iv.pa_people[:, k2] & ~state.tested & ~in_iso & (sym | state.traced)
                # Symptomatic candidates draw in (0,1), traced-only in (2,3),
                # ineligible sit at 4.0: one lexicographic top-k over
                # (score, gpid) is then an exact priority-tiered budget.
                u = rng.uniform(seed_w, rng.TEST, day_w, k2, gpid)
                score = torch.where(elig & sym, u, torch.where(elig, u + 2.0, 4.0))
                T, G = topo.rank_threshold(score, gpid, iv.pa_tests[:, k2], P)
                take_k = (elig & (iv.pa_tests[:, k2, None] > 0)
                          & ((score < T[:, None])
                             | ((score == T[:, None]) & (gpid <= G[:, None]))))
                takes.append(take_k)
                take_any = take_any | take_k
                tests_used = tests_used + take_k.sum(dim=-1)
            # Result latency: positives circulate today as tracing sources
            # and enter isolation from day + 1.
            positives = take_any & detectable
            ex = dict(takes=tuple(takes), in_iso=in_iso, detectable=detectable,
                      tests_used=tests_used)

        person_chans = [person_sus, person_inf, visit_ok.to(torch.float32)]
        if tracing_on:
            person_chans.append(positives.to(torch.float32))
        person_chans = torch.stack(person_chans, dim=-1)
        contact_day = torch.where(params.static_network, day % pop_lib.DAYS_PER_WEEK, day)

    # ---- dispatch, the interaction pass (one launch), the combine --------
    A, cnt, edges, trc_p = interact(topo, static, take, person_chans,
                                    loc_open, params.seed, contact_day, params.tau_eff)
    if tracing_on:
        ex["trc_p"] = trc_p
    return Exposure(A=A, cnt=cnt, edges=edges, vaccinated=vaccinated, **ex)


def advance_per_agent(static: EngineStatic, params: sim_lib.SimParams,
                      state: sim_lib.SimState, ex: Exposure):
    """The per-agent state after the day and its stats: ``(tested, traced,
    isolated_until, stats)``, ``stats`` the (B,) int64 ``tests_used``,
    ``isolated`` and ``traced`` (people newly traced). Positives isolate
    from day + 1 for ``pa_iso`` days, newly traced contacts for
    ``pa_trace_iso`` days."""
    if not static.pa_slots:
        zero = torch.zeros_like(state.day)
        return (state.tested, state.traced, state.isolated_until,
                dict(tests_used=zero, isolated=zero, traced=zero))
    day, iv = state.day, params.iv
    iso_until = state.isolated_until
    newly_traced = torch.zeros_like(state.traced)
    # isolated_until stays int32: cast each candidate end day before max.
    until = lambda days, mask: torch.where(
        mask, (day + 1 + days).to(torch.int32)[:, None], 0)
    for k2, ps in enumerate(static.pa_slots):
        iso_until = torch.maximum(iso_until, until(iv.pa_iso[:, k2],
                                                   ex.takes[k2] & ex.detectable))
        if ps.trace:
            act = (iv.pa_enabled[:, k2] & (day >= iv.pa_start[:, k2]))[:, None]
            nt_k = (ex.trc_p > 0.0) & iv.pa_people[:, k2] & act
            newly_traced = newly_traced | nt_k
            iso_until = torch.maximum(iso_until, until(iv.pa_trace_iso[:, k2], nt_k))
    tested = state.tested
    for take_k in ex.takes:
        tested = tested | take_k
    return (tested, state.traced | newly_traced, iso_until,
            dict(tests_used=ex.tests_used, isolated=ex.in_iso.sum(dim=-1),
                 traced=newly_traced.sum(dim=-1)))


def update(topo, static: EngineStatic, params: sim_lib.SimParams,
           state: sim_lib.SimState, ex: Exposure):
    """Phases 5-7 of a day. Returns ``(new_state, stats)``, ``stats`` a dict
    of (B,) int64 tensors keyed by ``STAT_KEYS``."""
    P = static.num_people
    day = state.day
    seed_w, day_w = params.seed[:, None], day[:, None]
    A = ex.A
    gpid = topo.gpid(A.shape[-1], A.device)
    with spans.span("day.infect"):
        infected = tx_lib.sample_infections(A, seed_w, day_w, gpid)

    # Outbreak seeding; both branches of the reference's lax.cond are
    # computed and the day decides, so no host sync.
    with spans.span("day.seed"):
        sus_ok = _look(params.sus_table, state.health) > 0.0
        us = torch.where(sus_ok, rng.uniform(seed_w, rng.SEED_CHOICE, day_w, gpid), 2.0)
        thresh = topo.seed_threshold(us, params.seed_per_day, P)
        seeded = ((us <= thresh[:, None]) & sus_ok
                  & ((params.seed_per_day > 0) & (day < params.seed_days))[:, None])

    with spans.span("day.health"):
        new_mask = (infected | seeded) & sus_ok
        health, dwell = disease_lib.update_health_tables(
            params.cum_trans, params.dwell_mean, params.sus_table,
            params.entry_state, state.health, state.dwell, new_mask,
            seed_w, day_w, gpid,
        )
        tested, traced, isolated_until, pa_stats = advance_per_agent(
            static, params, state, ex)

    # ---- reductions (Algorithm 2 line 34), int64 throughout, summed over
    # the workers in one psum ------------------------------------------------
    # Every sum is int64 (torch sums integers to int64; contacts says so), the
    # widening DET004 asks for before a collective, which it reads only in
    # JAX's ``.astype`` form.
    with spans.span("day.stats"):
        # detlint: ignore[DET004]
        sums = topo.psum({
            "new_infections": new_mask.sum(dim=-1),
            "infectious": (_look(params.inf_table, health) > 0.0).sum(dim=-1),
            "susceptible": (_look(params.sus_table, health) > 0.0).sum(dim=-1),
            "contacts": ex.cnt.sum(dim=-1, dtype=torch.int64),
            "edges": ex.edges,
            **pa_stats,
        })
        cumulative = state.cumulative + sums["new_infections"]
        stats = {"day": day, "cumulative": cumulative, **sums}
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
    """One simulated day of the batch; pure in (params, state)."""
    return update(topo, static, params, state,
                  exposure(topo, static, week, params, state))


def run_days(topo, static, week, params, state, days: int, observables: tuple = (),
             carries: tuple = (), num_real: Optional[int] = None):
    """``days`` days from ``state``, with the observables' updates inside the
    loop, as the reference runs them inside its scan
    (``repro/engine/day.py:run_days``).

    ``params``/``state`` carry the leading scenario axis (on a scenario mesh,
    this rank's slice of it). The observables see the first ``num_real``
    scenarios of the whole batch each day (the real ones: pad slots, if any,
    come last; all of them by default). Returns ``(final_state, carries,
    hist, dailies)``: ``final_state`` this rank's shard, ``hist`` a (days,
    len(STAT_KEYS), B) int64 tensor of the whole batch on the run's device,
    ``dailies`` the observables' per-day outputs stacked day-major
    (``api/observables.py:stack_days``)."""
    from repro_torch.api import observables as obs_lib  # cycle-free at call time

    rows, daily = [], []
    for _ in range(days):
        with spans.span("day"):
            state, stats = day_step(topo, static, week, params, state)
            with spans.span("day.observe"):
                # the whole batch's statistics (a gather when the batch is sharded)
                rows.append(topo.scen_gather(torch.stack([stats[k] for k in STAT_KEYS])))
                real = {k: rows[-1][i, :num_real] for i, k in enumerate(STAT_KEYS)}
                carries, d = obs_lib.update_all(observables, carries, real)
                daily.append(d)
    if not rows:
        B = state.day.shape[0]
        return state, carries, torch.zeros((0, len(STAT_KEYS), B), dtype=torch.int64,
                                           device=state.day.device), None
    return state, carries, torch.stack(rows), obs_lib.stack_days(daily)
