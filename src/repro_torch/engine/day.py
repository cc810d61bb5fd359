"""The epidemic day loop (Algorithm 2) on the local topology.

:func:`day_step` is one day: visits -> interactions -> update, in the
reference's order (``repro/engine/day.py:day_step`` with no per-agent
intervention slot):

  1. classic interventions;
  2. dispatch of person channels to visit slots;
  3. the interaction pass (the CUDA kernel on the card);
  4. the exposure combine back to people;
  5. infection draws and outbreak seeding;
  6. the FSA health update;
  7. the ``STAT_KEYS`` reductions and trigger evaluation.

:func:`run_days` is the whole run: a Python loop over days that keeps the
per-day statistics on the device. Nothing in the loop waits for the device
or copies to the host — the day, the live-tile count and the kernel's
``meta`` stay tensors — so the loop is ready to be captured as a CUDA graph.
"""

from __future__ import annotations

import dataclasses

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


def exposure(topo: LocalTopology, static: EngineStatic, week: dict,
             params: sim_lib.SimParams, state: sim_lib.SimState):
    """Phases 1-4 of a day. Returns ``(A, cnt, edges, vaccinated)``: the
    per-person propensity (P,) f32, per-visit contact counts, the
    traversed-edge count and the updated vaccination flags."""
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
    person_sus = params.sus_table[state.health] * params.beta_sus * sus_mult
    person_inf = params.inf_table[state.health] * params.beta_inf * inf_mult

    # ---- visit dispatch: person channels to visit slots -------------------
    chans = torch.stack([person_sus, person_inf, visit_ok.to(torch.float32)], dim=-1)
    visit_vals = topo.dispatch(pid, chans)
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
    acc, cnt, edges = iops.interactions_compact_edges(
        eff_pid, loc, take("start"), take("end"), take("p"), sus_v, inf_v,
        take("row"), take("col"), take("pa"),
        iops.col_has_infectious(inf_v, eff_pid, nb, b),
        iops.row_has_susceptible(sus_v, eff_pid, nb, b),
        meta, block_size=b,
    )

    # ---- exposure combine --------------------------------------------------
    A = topo.combine(take("slots"), active, acc) * params.tau_eff
    return A, cnt, edges, vaccinated


def update(topo: LocalTopology, static: EngineStatic, params: sim_lib.SimParams,
           state: sim_lib.SimState, A, cnt, edges, vaccinated):
    """Phases 5-7 of a day. Returns ``(new_state, stats)``, ``stats`` a dict
    of () int64 tensors keyed by ``STAT_KEYS``."""
    P = static.num_people
    day = state.day
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

    # ---- reductions (Algorithm 2 line 34), int64 throughout ---------------
    new_count = new_mask.sum()
    cumulative = state.cumulative + new_count
    zero = torch.zeros((), dtype=torch.int64, device=A.device)
    stats = {
        "day": day,
        "new_infections": new_count,
        "cumulative": cumulative,
        "infectious": (params.inf_table[health] > 0.0).sum(),
        "susceptible": (params.sus_table[health] > 0.0).sum(),
        "contacts": cnt.sum(dtype=torch.int64),
        "edges": edges,
        "tests_used": zero,
        "isolated": zero,
        "traced": zero,
    }
    iv_active = iv_lib.evaluate_iv_triggers(
        static.iv_slots, params.iv, day, stats, state.iv_active
    )
    new_state = sim_lib.SimState(
        day=day + 1, health=health, dwell=dwell, cumulative=cumulative,
        iv_active=iv_active, vaccinated=vaccinated,
    )
    return new_state, stats


def day_step(topo, static, week, params, state):
    """One simulated day; pure in (params, state)."""
    return update(topo, static, params, state,
                  *exposure(topo, static, week, params, state))


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
