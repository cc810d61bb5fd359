"""The worker partition of one population: plan, per-rank tables, padding
(the port of the reference's ``repro.core.simulator_dist``, numpy on the
host).

People and locations are partitioned exactly as in the paper: people in
uniform blocks of ``Pw`` (gpid = w * Pw + local index), locations by the
geo-sorted visit-weighted static scheme (§V-B). :func:`build_dist_plan` is
the reference's plan, array for array: each worker's location-sorted,
occupancy-packed visits for every day of the week, its block-pair
schedules, and the capacity-bucketed exchange routing of
``core/exchange.py``. Every rank builds the same plan from the same numpy
inputs.

What the port adds is what makes every worker count bitwise equal to the
local layout:

  * ``week_vid`` — for every worker's visit slot, the visit's index in the
    population's day (``pop.week[d]``), and ``local_slot`` — that visit's
    slot in the local layout's packed week (``core/interactions.py:
    build_week_data``). Both come from running the same packing on the
    visit indices in place of the person ids: the packing reads only
    locations and start times, so the layouts are the ones the person ids
    get;
  * :func:`rank_tables` — for one rank, the gather tables of
    ``core/exchange.py``: ``dsend``/``drecv`` for the dispatch, ``csend``
    and the ``fold`` table for the combine, whose columns list each
    person's received visits in ascending local slot, the local combine's
    order;
  * :func:`fold_mismatches` — the check that the interaction pass's sums
    per visit are the local layout's too: a visit's ``acc`` is its run's
    per-block partial sums added in block order, so it is bitwise equal
    across layouts when every location run has the same visit order and is
    cut into blocks at the same places. Occupancy packing starts every run
    of at least ``block_size`` visits on a block boundary and keeps smaller
    runs inside one block, in every layout.

:func:`pad_params` and :func:`init_state_padded` pad the person axis to
``W * Pw``; pad people sit in the disease's absorbing non-susceptible state
with zero betas and outside every selector, so they never take part.

The reference's pure distributed step is here too, as a view over the
engine's day on a :class:`~repro_torch.engine.topology.MeshTopology`:
``DistStatic`` / ``make_dist_static``, ``dist_init_state``,
``dist_day_step`` and ``dist_run_scan``, run by every rank of a worker mesh
on its shard (:func:`local_shard`), bitwise equal to the engine's
``workers`` layout; ``dist_param_specs`` / ``dist_state_specs`` say, per
leaf, which dimension the worker axis ``AXIS`` splits, as the reference's
``PartitionSpec`` trees do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import disease as disease_lib
from repro_torch.core import exchange as ex_lib
from repro_torch.core import interventions as iv_lib
from repro_torch.core import population as pop_lib
from repro_torch.core import simulator as sim_lib

#: The mesh axis the people and locations are split over.
AXIS = "workers"
STAT_KEYS = sim_lib.STAT_KEYS


@dataclasses.dataclass
class DistPlan:
    """Host-built static partition + routing data (all numpy)."""

    num_workers: int
    people_per_worker: int  # Pw (padded)
    num_people: int  # P real
    locs_per_worker: int  # Lw (padded)
    visits_per_worker: int  # Vw (padded, uniform across workers & days)
    pairs_per_worker: int  # NPw
    block_size: int
    # (7, W, Vw)
    week_pid: np.ndarray  # global person ids, -1 pad
    week_loc: np.ndarray  # *global* loc id (for the contact hash), pad ok
    week_start: np.ndarray
    week_end: np.ndarray
    week_p: np.ndarray  # per-visit contact probability (gathered at build)
    # (7, W, NPw) block schedules
    row_idx: np.ndarray
    col_idx: np.ndarray
    row_start: np.ndarray
    pair_active: np.ndarray
    # (7, W, W, C) exchange routing
    send_idx: np.ndarray
    recv_slot: np.ndarray
    capacity: int
    # location partition (for elastic re-partitioning / stats)
    loc_partition: np.ndarray  # (L,)
    # --- the port's: visit identity across layouts -------------------------
    week_vid: np.ndarray = None  # (7, W, Vw) int32 index into pop.week[d], -1 pad
    local_slot: tuple = ()  # 7 x (num_real,) int64: each visit's local packed slot
    local_vid: tuple = ()  # 7 x (V_d,) int32: the local packed layout's visit ids


def _tagged(d: pop_lib.DayVisits) -> pop_lib.DayVisits:
    """``d`` with each visit's index in the day in place of its person id."""
    n = d.num_real
    tag = np.full((len(d),), -1, np.int32)
    tag[:n] = np.arange(n, dtype=np.int32)
    return dataclasses.replace(d, person=tag)


def _persons(d: pop_lib.DayVisits, vid: np.ndarray) -> np.ndarray:
    """Person ids of the visit indices ``vid`` of day ``d`` (-1 stays -1)."""
    return np.where(vid >= 0, d.person[np.maximum(vid, 0)], -1).astype(np.int32)


def build_dist_plan(
    pop: pop_lib.Population,
    num_workers: int,
    block_size: int = 128,
    balanced: bool = True,
    pack: bool = True,
) -> DistPlan:
    """The reference's plan (``repro.core.simulator_dist.build_dist_plan``),
    byte for byte, plus the visit identity fields (module docstring)."""
    W = num_workers
    P_real = pop.num_people
    Pw = int(np.ceil(P_real / W))

    # Location partition: the paper's static load balancing (or naive).
    visits_per_loc = np.zeros((pop.num_locations,), np.int64)
    for d in pop.week:
        np.add.at(visits_per_loc, d.loc[: d.num_real], 1)
    if balanced:
        loc_part = pop_lib.balanced_location_partition(
            pop.geo_key, visits_per_loc, W
        )
    else:
        loc_part = pop_lib.naive_location_partition(pop.num_locations, W)

    person_owner = (np.arange(P_real) // Pw).astype(np.int32)
    person_local = (np.arange(P_real) % Pw).astype(np.int32)

    # Per-worker, per-day location-sorted visit arrays, carrying visit
    # indices (person ids are looked up at the end: the layout is the same).
    days = []
    for d in pop.week:
        n = d.num_real
        t = _tagged(d)
        v_part = loc_part[d.loc[:n]]
        per_worker = []
        for w in range(W):
            sel = np.flatnonzero(v_part == w)
            per_worker.append(
                pop_lib.pack_day(
                    t.person[:n][sel], d.loc[:n][sel],
                    d.start[:n][sel], d.end[:n][sel],
                    pad_multiple=block_size,
                )
            )
        days.append(per_worker)
    if pack:
        # Occupancy-aware run packing per worker shard (smaller block-pair
        # schedules; layout is epidemiologically free — global-id draws).
        days = [
            [pop_lib.pack_day_occupancy(pw, block_size) for pw in day]
            for day in days
        ]
        Vw = max(len(pw) for day in days for pw in day)
        Vw = int(np.ceil(Vw / block_size) * block_size)
        days = [[pop_lib.extend_packed(pw, Vw) for pw in day] for day in days]
        extents = [[pw.extent for pw in day] for day in days]
    else:
        Vw = max(len(pw) for day in days for pw in day)
        Vw = int(np.ceil(Vw / block_size) * block_size)
        days = [
            [
                pop_lib.pack_day(
                    pw.person[: pw.num_real], pw.loc[: pw.num_real],
                    pw.start[: pw.num_real], pw.end[: pw.num_real],
                    pad_to=Vw, pad_multiple=block_size,
                )
                for pw in day
            ]
            for day in days
        ]
        extents = [[pw.num_real for pw in day] for day in days]

    # Block schedules, padded to a uniform pair count.
    scheds = [
        [
            pop_lib.build_block_schedule(pw.loc, e, block_size)
            for pw, e in zip(day, ext)
        ]
        for day, ext in zip(days, extents)
    ]
    NPw = max(s.row_block.shape[0] for day in scheds for s in day)
    scheds = [
        [
            pop_lib.build_block_schedule(pw.loc, e, block_size, pad_to=NPw)
            for pw, e in zip(day, ext)
        ]
        for day, ext in zip(days, extents)
    ]

    week_vid = np.stack([np.stack([pw.person for pw in day]) for day in days])
    week_pid = np.stack([_persons(d, week_vid[i]) for i, d in enumerate(pop.week)])

    # Exchange plans (same routing structure every day; capacity = max).
    plans = [
        ex_lib.build_exchange_plan(week_pid[i], person_owner, person_local)
        for i in range(len(days))
    ]
    C = max(p.capacity for p in plans)
    send_idx = np.full((7, W, W, C), -1, np.int32)
    recv_slot = np.full((7, W, W, C), -1, np.int32)
    for d, p in enumerate(plans):
        send_idx[d, :, :, : p.capacity] = p.send_idx
        recv_slot[d, :, :, : p.capacity] = p.recv_slot

    stack = lambda f: np.stack([np.stack([f(x) for x in day]) for day in days])
    sstack = lambda f: np.stack([np.stack([f(s) for s in day]) for day in scheds])

    # Per-visit contact probability, gathered on host (location attrs are
    # static; this is the paper's "store p as a location attribute").
    week_p = np.stack(
        [
            np.stack([pop.contact_prob[np.minimum(pw.loc, pop.num_locations - 1)]
                      for pw in day])
            for day in days
        ]
    ).astype(np.float32)

    # Padded locations per worker (only used for closure masks / stats).
    Lw = int(np.max(np.bincount(loc_part, minlength=W)))

    # The local layout's packed week (core/interactions.py:build_week_data
    # packs each day the same way) in visit indices, and its inverse.
    local_vid = tuple(pop_lib.pack_day_occupancy(_tagged(d), block_size).person
                      for d in pop.week)
    local_slot = []
    for d, lv in zip(pop.week, local_vid):
        slot = np.full((d.num_real,), -1, np.int64)
        real = np.flatnonzero(lv >= 0)
        slot[lv[real]] = real
        local_slot.append(slot)

    return DistPlan(
        num_workers=W,
        people_per_worker=Pw,
        num_people=P_real,
        locs_per_worker=Lw,
        visits_per_worker=Vw,
        pairs_per_worker=NPw,
        block_size=block_size,
        week_pid=week_pid,
        week_loc=stack(lambda x: x.loc),
        week_start=stack(lambda x: x.start),
        week_end=stack(lambda x: x.end),
        week_p=week_p,
        row_idx=sstack(lambda s: s.row_block),
        col_idx=sstack(lambda s: s.col_block),
        row_start=sstack(lambda s: s.row_start.astype(np.int32)),
        pair_active=sstack(lambda s: s.pair_active.astype(np.int32)),
        send_idx=send_idx,
        recv_slot=recv_slot,
        capacity=C,
        loc_partition=loc_part,
        week_vid=week_vid,
        local_slot=tuple(local_slot),
        local_vid=local_vid,
    )


# --------------------------------------------------------------------------
# the interaction pass's sums per visit across layouts
# --------------------------------------------------------------------------


def _run_links(vid: np.ndarray, loc: np.ndarray, block_size: int) -> dict:
    """For each real visit of one layout (``vid`` (V,), -1 pad): its
    predecessor in its location run (-1 first) and whether it opens a new
    block of the run. Two layouts with the same links fold every visit's
    interaction sum in the same order and grouping."""
    i = np.flatnonzero(vid >= 0)
    prev = np.maximum(i - 1, 0)
    same_run = (i > 0) & (vid[prev] >= 0) & (loc[prev] == loc[i])
    pred = np.where(same_run, vid[prev], -1)
    opens = ~same_run | (i % block_size == 0)
    return dict(zip(vid[i].tolist(), zip(pred.tolist(), opens.tolist())))


def fold_mismatches(plan: DistPlan, pop: pop_lib.Population) -> int:
    """The number of visits (over the week) whose location run is ordered or
    cut into blocks differently on the plan's workers than in the local
    layout; 0 means the interaction pass's per-visit sums are bitwise the
    local layout's (module docstring)."""
    b, bad = plan.block_size, 0
    for d, day in enumerate(pop.week):
        local = _run_links(plan.local_vid[d], _local_loc(plan, d, day), b)
        mesh = {}
        for w in range(plan.num_workers):
            mesh.update(_run_links(plan.week_vid[d, w], plan.week_loc[d, w], b))
        bad += sum(mesh.get(v) != link for v, link in local.items())
    return bad


def _local_loc(plan: DistPlan, d: int, day: pop_lib.DayVisits) -> np.ndarray:
    """Location per slot of the local packed layout of day ``d`` (padding
    repeats a neighbour's location, which no real visit links to)."""
    lv = plan.local_vid[d]
    return np.where(lv >= 0, day.loc[np.maximum(lv, 0)], -1)


# --------------------------------------------------------------------------
# one rank's device arrays
# --------------------------------------------------------------------------


def rank_tables(plan: DistPlan, worker: int) -> dict:
    """The exchange's gather tables of ``worker`` for each day of the week,
    int64 numpy: ``dsend`` (7, W, C) person row per send slot (pad ``Pw``),
    ``drecv`` (7, Vw) received slot per visit (pad ``W * C``), ``csend``
    (7, W, C) visit per send slot (pad ``Vw``) and ``fold`` (7, Pw, K) each
    person's received slots in ascending local slot (pad ``W * C``)."""
    W, C, w = plan.num_workers, plan.capacity, worker
    Pw, Vw = plan.people_per_worker, plan.visits_per_worker
    dsend = np.where(plan.send_idx[:, w] >= 0, plan.send_idx[:, w], Pw).astype(np.int64)
    csend = np.where(plan.recv_slot[:, w] >= 0, plan.recv_slot[:, w], Vw).astype(np.int64)
    flat = np.arange(W * C, dtype=np.int64).reshape(W, C)  # received slot index
    drecv = np.full((7, Vw), W * C, np.int64)
    folds = []
    for d in range(7):
        ok = plan.recv_slot[d, w] >= 0
        drecv[d, plan.recv_slot[d, w][ok]] = flat[ok]
        # combine: slot (dst, c) holds the visit recv_slot[d, dst, w, c] of
        # worker dst, for this worker's person send_idx[d, w, dst, c]
        dst, c = np.nonzero(plan.send_idx[d, w] >= 0)
        person = plan.send_idx[d, w, dst, c].astype(np.int64)
        visit = plan.recv_slot[d, dst, w, c]
        key = plan.local_slot[d][plan.week_vid[d, dst, visit]]
        order = np.lexsort((key, person))
        person, entry = person[order], flat[dst, c][order]
        counts = np.bincount(person, minlength=Pw)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        folds.append((person, np.arange(len(person)) - first[person], entry,
                      int(counts.max(initial=0))))
    K = max(1, max(f[3] for f in folds))
    fold = np.full((7, Pw, K), W * C, np.int64)
    for d, (person, rank, entry, _) in enumerate(folds):
        fold[d, person, rank] = entry
    return {"dsend": dsend, "drecv": drecv, "csend": csend, "fold": fold}


def week_device_arrays(plan: DistPlan, worker: int, *, device) -> dict:
    """The day step's ``week`` dict of ``worker`` on ``device``: its own
    (7, ...) shard of the schedule (the keys of ``core/interactions.py:
    week_from_numpy``, ``slots`` aside) and its exchange tables
    (:func:`rank_tables`). Nothing of another worker's shard moves."""
    w = worker
    t = lambda a, dtype: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    week = {
        "pid": t(plan.week_pid[:, w], torch.int32),
        "loc": t(plan.week_loc[:, w], torch.int32),
        "start": t(plan.week_start[:, w], torch.float32),
        "end": t(plan.week_end[:, w], torch.float32),
        "p": t(plan.week_p[:, w], torch.float32),
        "row": t(plan.row_idx[:, w], torch.int32),
        "col": t(plan.col_idx[:, w], torch.int32),
        "rs": t(plan.row_start[:, w], torch.int32),
        "pa": t(plan.pair_active[:, w], torch.int32),
    }
    week.update({k: t(v, torch.int64) for k, v in rank_tables(plan, w).items()})
    return week


# --------------------------------------------------------------------------
# the padded person axis
# --------------------------------------------------------------------------


def pad_params(params: sim_lib.SimParams, plan: DistPlan) -> sim_lib.SimParams:
    """Pad the person leaves of one scenario's SimParams to the plan's
    ``W * Pw`` person axis with zeros: zero betas, outside every selector."""
    pad = plan.num_workers * plan.people_per_worker - plan.num_people
    padp = lambda a: torch.nn.functional.pad(a, (0, pad))
    return dataclasses.replace(
        params,
        beta_sus=padp(params.beta_sus),
        beta_inf=padp(params.beta_inf),
        iv=dataclasses.replace(params.iv, people=padp(params.iv.people),
                               pa_people=padp(params.iv.pa_people)),
    )


def init_state_padded(disease: disease_lib.DiseaseModel, plan: DistPlan,
                      num_iv_slots: int, *, device) -> sim_lib.SimState:
    """One scenario's initial state on the ``W * Pw`` person axis; pad people
    enter an absorbing, non-susceptible state so they never participate
    (the reference's ``dist_init_state``)."""
    Ppad = plan.num_workers * plan.people_per_worker
    state = sim_lib.init_state(disease, Ppad, num_iv_slots, device=device)
    if Ppad > plan.num_people:
        non_sus = np.flatnonzero(np.asarray(disease.susceptibility) == 0.0)
        if len(non_sus) == 0:
            raise ValueError(
                f"disease model '{disease.name}' has no zero-susceptibility "
                "state to park the padded people in — they would be seedable "
                "and break the layouts' bitwise equality")
        state.health[plan.num_people:] = int(non_sus[0])
    return state


# --------------------------------------------------------------------------
# The pure distributed day: views over the engine's day on a MeshTopology
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistStatic:
    """What the distributed step branches on: the partition's geometry, the
    classic intervention slots and the interaction pass."""

    num_people: int  # real P (before padding)
    num_locations: int
    num_workers: int
    people_per_worker: int  # Pw
    visits_per_worker: int  # Vw
    block_size: int
    seed_topk: int  # per-worker candidates of the seeding threshold
    iv_slots: tuple  # tuple[iv_lib.IvSlotStatic, ...]
    backend: str = "pallas-compact"


def make_dist_static(plan: DistPlan, num_locations: int, iv_slots: tuple,
                     backend: str = "pallas-compact", max_seed_per_day: int = 10) -> DistStatic:
    """``seed_topk`` covers the largest ``seed_per_day`` any scenario runs
    with (clamped to the shard), so the seeding threshold is exact."""
    return DistStatic(
        num_people=plan.num_people, num_locations=num_locations,
        num_workers=plan.num_workers, people_per_worker=plan.people_per_worker,
        visits_per_worker=plan.visits_per_worker, block_size=plan.block_size,
        seed_topk=max(1, min(int(max_seed_per_day), plan.people_per_worker)),
        iv_slots=iv_slots, backend=backend)


def dist_init_state(disease: disease_lib.DiseaseModel, plan: DistPlan, num_iv_slots: int,
                    *, device="cuda") -> sim_lib.SimState:
    """The whole worker-padded initial state (:func:`init_state_padded`);
    :func:`local_shard` cuts a worker's shard from it."""
    return init_state_padded(disease, plan, num_iv_slots, device=device)


def local_shard(tree, plan: DistPlan, worker: int):
    """Worker ``worker``'s shard of one scenario's padded SimParams or
    SimState: its ``Pw`` people on every person leaf, the rest whole."""
    from repro_torch.engine.core import PERSON_PARAM_FIELDS, PERSON_STATE_FIELDS

    Pw = plan.people_per_worker
    person = PERSON_PARAM_FIELDS + PERSON_STATE_FIELDS

    def walk(obj):
        return type(obj)(**{
            f.name: walk(v) if dataclasses.is_dataclass(v) else
            (v[..., worker * Pw:(worker + 1) * Pw] if f.name in person else v)
            for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})

    return walk(tree)


def dist_day_step(static: DistStatic, plan, week: dict, params: sim_lib.SimParams,
                  state: sim_lib.SimState):
    """One distributed day on this rank's shard; pure in (params, state).

    ``plan`` is this rank's :class:`~repro_torch.launch.mesh.WorkerMesh` (a
    ``workers`` mesh of ``static.num_workers``): the exchange runs over its
    groups, and its routing tables ride in ``week``
    (:func:`week_device_arrays` of this rank's worker). ``params`` and
    ``state`` are unbatched, their person leaves this worker's (Pw,) shard.
    Draws key on global person ids, so the day is bitwise the engine's
    ``workers`` layout and the local run. Returns ``(new_state, stats)``
    with 0-d int64 stats summed over the workers (the per-agent stats
    zero)."""
    from repro_torch.engine import day as day_lib  # cycle-free at call time
    from repro_torch.engine.core import index_params, stack_params
    from repro_torch.engine.topology import MeshTopology

    estatic = day_lib.EngineStatic(
        num_people=static.num_people, num_locations=static.num_locations,
        block_size=static.block_size, iv_slots=static.iv_slots, backend=static.backend)
    topo = MeshTopology(plan, seed_topk=static.seed_topk)
    new_state, stats = day_lib.day_step(topo, estatic, week, stack_params([params]),
                                        stack_params([state]))
    return index_params(new_state, 0), {k: v[0] for k, v in stats.items()}


def dist_run_scan(static: DistStatic, plan, week: dict, params: sim_lib.SimParams,
                  state: sim_lib.SimState, days: int):
    """``days`` days of :func:`dist_day_step`: ``(final_state, stats)``,
    each stat a (days,) int64 tensor."""
    rows = []
    for _ in range(days):
        state, stats = dist_day_step(static, plan, week, params, state)
        rows.append(stats)
    return state, {k: torch.stack([r[k] for r in rows]) if rows
                   else torch.zeros((0,), dtype=torch.int64, device=state.day.device)
                   for k in STAT_KEYS}


def _spec(batch_axis, *axes) -> tuple:
    return (batch_axis, *axes) if batch_axis is not None else tuple(axes)


def dist_param_specs(batch_axis=None) -> sim_lib.SimParams:
    """SimParams-shaped tree of partition specs for the worker-padded
    layout: each leaf a tuple naming, per dimension, the mesh axis that
    splits it (None: whole), the entries of the reference's
    ``PartitionSpec``. ``batch_axis`` prepends a scenario axis to every
    leaf (the hybrid mesh)."""
    s = lambda *axes: _spec(batch_axis, *axes)
    iv = iv_lib.IvParams(
        enabled=s(), day_start=s(), day_end=s(), thresh_on=s(), thresh_off=s(),
        factor=s(), people=s(None, AXIS), locations=s(), pa_enabled=s(), pa_start=s(),
        pa_tests=s(), pa_iso=s(), pa_trace_iso=s(), pa_people=s(None, AXIS))
    return sim_lib.SimParams(
        seed=s(), tau_eff=s(), sus_table=s(), inf_table=s(), sym_table=s(),
        cum_trans=s(), dwell_mean=s(), entry_state=s(), beta_sus=s(AXIS),
        beta_inf=s(AXIS), seed_per_day=s(), seed_days=s(), static_network=s(), iv=iv)


def dist_state_specs(batch_axis=None) -> sim_lib.SimState:
    """SimState-shaped tree of partition specs (:func:`dist_param_specs`)."""
    s = lambda *axes: _spec(batch_axis, *axes)
    return sim_lib.SimState(
        day=s(), health=s(AXIS), dwell=s(AXIS), cumulative=s(), iv_active=s(),
        vaccinated=s(AXIS), tested=s(AXIS), traced=s(AXIS), isolated_until=s(AXIS))
