"""Run state and scenario parameters of the day loop, as dataclasses of tensors.

* ``SimParams`` — every scenario-varying numeric (seed, transmissibility,
  disease tables, per-person betas, intervention thresholds/masks,
  outbreak-seeding knobs) as tensors on the run's device.
* ``SimState`` — what one day hands to the next.

:func:`build_params` and :func:`init_state` build one scenario (the shapes
commented below); the engine core stacks B of them on a leading scenario
axis (``engine/core.py:stack_params``), B = 1 included, and the day step
runs on the stacked ``(B, ...)`` leaves, as the reference's vmapped day step
does.

The reference's pure functions of one scenario are here too, as views over
the engine's day (``engine/day.py``) with a scenario axis of 1, so each is
bitwise equal to ``EngineCore`` for the same core when it has no
test-trace-isolate slot (the reference path carries none):
``SimStatic``, ``phase_visits`` / ``phase_interact`` / ``phase_update``
(the paper's three phases), ``day_step``, ``run_scan`` (a Python loop over
days, the stats stacked day-major), ``legacy_parts`` (their arguments from
a B = 1 local core) and ``run_eager``, the day loop with a wall time per
phase (on the card each phase ends in a synchronise before its clock is
read).

``params_from_numpy`` / ``state_from_numpy`` take the reference package's
``SimParams`` / ``SimState`` as nested dicts of numpy arrays (e.g.
``dataclasses.asdict(jax.device_get(x))``), so both packages can run a day
from one identical state, per-agent intervention fields (``sym_table``,
``pa_*``, ``tested``, ``traced``, ``isolated_until``) included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import disease as disease_lib
from repro_torch.core import interventions as iv_lib
from repro_torch.core import population as pop_lib
from repro_torch.core import transmission as tx_lib

# History keys of every day step, in emission order. "edges" is the
# traversed-edge count measured inside the interaction pass; it equals
# "contacts" exactly, which makes the kernel's counter a cross-checked
# quantity. The last three are per-agent intervention telemetry (tests
# spent, people in isolation, people newly traced); they are zero when the
# scenario has no TestTraceIsolate slot.
STAT_KEYS = ("day", "new_infections", "cumulative", "infectious",
             "susceptible", "contacts", "edges",
             "tests_used", "isolated", "traced")


@dataclasses.dataclass
class SimState:
    day: torch.Tensor  # () int64
    health: torch.Tensor  # (P,) int32 FSA state
    dwell: torch.Tensor  # (P,) f32 days left in state
    cumulative: torch.Tensor  # () int64 — infections so far (incl. seeds)
    iv_active: torch.Tensor  # (K,) bool
    vaccinated: torch.Tensor  # (P,) bool
    # --- persistent per-agent intervention state -------------------------
    tested: torch.Tensor  # (P,) bool — ever consumed a test
    traced: torch.Tensor  # (P,) bool — ever traced as a contact of a positive
    isolated_until: torch.Tensor  # (P,) int32 — isolated while day < this


@dataclasses.dataclass
class SimParams:
    seed: torch.Tensor  # () int64 holding a u32 — Monte Carlo stream
    tau_eff: torch.Tensor  # () f32 — tau * time_unit (Eq. 2 prefactor)
    sus_table: torch.Tensor  # (S,) f32 sigma(X)
    inf_table: torch.Tensor  # (S,) f32 iota(X)
    sym_table: torch.Tensor  # (S,) f32 — symptomatic states (test priority)
    cum_trans: torch.Tensor  # (S, S) f32 cumulative transition rows
    dwell_mean: torch.Tensor  # (S,) f32
    entry_state: torch.Tensor  # () int64 — state entered on infection
    beta_sus: torch.Tensor  # (P,) f32 person beta_sigma
    beta_inf: torch.Tensor  # (P,) f32 person beta_iota
    seed_per_day: torch.Tensor  # () int64 outbreak seeding intensity
    seed_days: torch.Tensor  # () int64 outbreak seeding duration
    static_network: torch.Tensor  # () bool — EpiHiper-style fixed weekly net
    iv: iv_lib.IvParams  # intervention numerics


def build_params(
    pop: pop_lib.Population,
    disease: disease_lib.DiseaseModel,
    tm: tx_lib.TransmissionModel,
    interventions: Sequence,
    seed: int,
    *,
    seed_per_day: int = 10,
    seed_days: int = 7,
    static_network: bool = False,
    iv_enabled: Sequence[bool] = (),
    device,
) -> tuple[tuple, tuple, SimParams]:
    """Compile one scenario's configs into (classic slots, per-agent slots,
    SimParams).

    ``iv_enabled`` (empty = all on) disables slots without changing the
    slot structure. It is positional over the mixed ``interventions`` list;
    each entry goes to the family of its intervention."""
    iv_slots, pa_slots, iv_params = iv_lib.compile_iv_params(
        interventions, pop, seed, device=device)
    if len(iv_enabled):
        if len(iv_enabled) != len(iv_slots) + len(pa_slots):
            raise ValueError("iv_enabled/slot mismatch")
        en = np.asarray(iv_enabled, np.bool_)
        is_pa = np.asarray([isinstance(iv, iv_lib.TestTraceIsolate)
                            for iv in interventions], np.bool_)
        iv_params.enabled = torch.as_tensor(en[~is_pa], device=device)
        iv_params.pa_enabled = torch.as_tensor(en[is_pa], device=device)
    t = lambda a, dtype: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    params = SimParams(
        seed=t(seed & 0xFFFFFFFF, torch.int64),
        tau_eff=t(np.float32(tm.tau * tm.time_unit), torch.float32),
        sus_table=t(disease.susceptibility, torch.float32),
        inf_table=t(disease.infectivity, torch.float32),
        sym_table=t(disease.sym_table, torch.float32),
        cum_trans=t(disease.cum_trans, torch.float32),
        dwell_mean=t(disease.dwell_mean_days, torch.float32),
        entry_state=t(disease.entry_state, torch.int64),
        beta_sus=t(pop.beta_sus, torch.float32),
        beta_inf=t(pop.beta_inf, torch.float32),
        seed_per_day=t(seed_per_day, torch.int64),
        seed_days=t(seed_days, torch.int64),
        static_network=t(static_network, torch.bool),
        iv=iv_params,
    )
    return iv_slots, pa_slots, params


@dataclasses.dataclass(frozen=True)
class SimStatic:
    """What the pure day functions branch on in Python: shapes, the classic
    intervention slots and the interaction pass (``backend`` one of
    ``kernels/interactions/ops.py:BACKENDS``, on blocks of ``block_size``
    visits, the size the week was built with)."""

    num_people: int
    num_locations: int
    iv_slots: tuple  # tuple[iv_lib.IvSlotStatic, ...]
    backend: str = "pallas-compact"
    block_size: int = 128


def init_state(disease: disease_lib.DiseaseModel, num_people: int,
               num_iv_slots: int, *, device) -> SimState:
    health, dwell = disease_lib.initial_health(disease, num_people, device=device)
    return SimState(
        day=torch.zeros((), dtype=torch.int64, device=device),
        health=health,
        dwell=dwell,
        cumulative=torch.zeros((), dtype=torch.int64, device=device),
        iv_active=torch.zeros((num_iv_slots,), dtype=torch.bool, device=device),
        vaccinated=torch.zeros((num_people,), dtype=torch.bool, device=device),
        tested=torch.zeros((num_people,), dtype=torch.bool, device=device),
        traced=torch.zeros((num_people,), dtype=torch.bool, device=device),
        isolated_until=torch.zeros((num_people,), dtype=torch.int32, device=device),
    )


def _tensors(d: dict, dtypes: dict, device) -> dict:
    """``dtypes``' keys of ``d`` as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(d[k]), device=device).to(dt)
            for k, dt in dtypes.items()}


_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool
_IV_DTYPES = dict(enabled=_BOOL, day_start=_I32, day_end=_I32,
                  thresh_on=_F32, thresh_off=_F32, factor=_F32, people=_BOOL,
                  locations=_BOOL, pa_enabled=_BOOL, pa_start=_I32,
                  pa_tests=_I32, pa_iso=_I32, pa_trace_iso=_I32,
                  pa_people=_BOOL)
_PARAM_DTYPES = dict(seed=_I64, tau_eff=_F32, sus_table=_F32, inf_table=_F32,
                     sym_table=_F32, cum_trans=_F32, dwell_mean=_F32,
                     entry_state=_I64, beta_sus=_F32, beta_inf=_F32,
                     seed_per_day=_I64, seed_days=_I64, static_network=_BOOL)
_STATE_DTYPES = dict(day=_I64, health=_I32, dwell=_F32, cumulative=_I64,
                     iv_active=_BOOL, vaccinated=_BOOL, tested=_BOOL,
                     traced=_BOOL, isolated_until=_I32)


def params_from_numpy(d: dict, *, device) -> SimParams:
    """SimParams from the reference's SimParams as a nested numpy dict."""
    iv = iv_lib.IvParams(**_tensors(d["iv"], _IV_DTYPES, device))
    return SimParams(iv=iv, **_tensors(d, _PARAM_DTYPES, device))


def state_from_numpy(d: dict, *, device) -> SimState:
    """SimState from the reference's SimState as a numpy dict."""
    return SimState(**_tensors(d, _STATE_DTYPES, device))


# --------------------------------------------------------------------------
# One scenario's pure day: views over engine/day.py with a scenario axis of 1
# --------------------------------------------------------------------------


def _engine_static(static: SimStatic):
    from repro_torch.engine import day as day_lib  # cycle-free at call time

    return day_lib.EngineStatic(num_people=static.num_people,
                                num_locations=static.num_locations,
                                block_size=static.block_size, iv_slots=static.iv_slots,
                                backend=static.backend)


def phase_visits(static: SimStatic, params: SimParams, state: SimState):
    """Phase 1: intervention masks and per-person epidemiological values.
    Returns (visit_ok (P,), loc_open (L,), person_sus (P,), person_inf (P,),
    vaccinated (P,))."""
    from repro_torch.engine import day as day_lib  # cycle-free at call time
    from repro_torch.engine.core import stack_params

    out = day_lib.visits(_engine_static(static), stack_params([params]),
                         stack_params([state]), static.num_people)
    return tuple(t[0] for t in out)


def phase_interact(static: SimStatic, week: dict, contact_prob: torch.Tensor,
                   params: SimParams, state: SimState, visit_ok, loc_open,
                   person_sus, person_inf):
    """Phase 2: the block-scheduled interaction pass and the exposure
    combine. Returns (A (P,), contacts ())."""
    from repro_torch.core import interactions as inter_lib  # cycle-free at call time

    dow = state.day % pop_lib.DAYS_PER_WEEK
    # a static network keys its draws by day of the week: the same every week
    contact_day = torch.where(params.static_network, dow, state.day)
    return inter_lib.day_exposure(
        week, dow, static.num_people, person_sus, person_inf, contact_prob, visit_ok,
        loc_open, params.tau_eff, params.seed, contact_day, backend=static.backend,
        block_size=static.block_size)


def phase_update(static: SimStatic, params: SimParams, state: SimState, A, contacts,
                 vaccinated):
    """Phase 3: infection draws, outbreak seeding, the FSA update and the
    triggers. Returns ``(new_state, stats)``, ``stats`` 0-d int64 tensors
    keyed by STAT_KEYS (``edges`` is ``contacts``; the per-agent stats are
    zero)."""
    from repro_torch.engine import day as day_lib  # cycle-free at call time
    from repro_torch.engine.core import index_params, stack_params
    from repro_torch.engine.topology import LocalTopology

    c = contacts.reshape(1).to(torch.int64)
    ex = day_lib.Exposure(A=A[None], cnt=c[:, None], edges=c, vaccinated=vaccinated[None])
    new_state, stats = day_lib.update(LocalTopology(), _engine_static(static),
                                      stack_params([params]), stack_params([state]), ex)
    return index_params(new_state, 0), {k: v[0] for k, v in stats.items()}


def day_step(static: SimStatic, week: dict, contact_prob: torch.Tensor,
             params: SimParams, state: SimState):
    """One simulated day of one scenario: ``(new_state, stats)``."""
    visit_ok, loc_open, person_sus, person_inf, vaccinated = phase_visits(
        static, params, state)
    A, contacts = phase_interact(static, week, contact_prob, params, state,
                                 visit_ok, loc_open, person_sus, person_inf)
    return phase_update(static, params, state, A, contacts, vaccinated)


def run_scan(static: SimStatic, week: dict, contact_prob: torch.Tensor,
             params: SimParams, state: SimState, days: int):
    """``days`` days of :func:`day_step`: ``(final_state, stats)``, each
    stat a (days,) int64 tensor on the run's device, as the reference's
    scan stacks them."""
    rows = []
    for _ in range(days):
        state, stats = day_step(static, week, contact_prob, params, state)
        rows.append(stats)
    return state, {k: torch.stack([r[k] for r in rows]) if rows
                   else torch.zeros((0,), dtype=torch.int64, device=state.day.device)
                   for k in STAT_KEYS}


def legacy_parts(core):
    """``(static, week, contact_prob, params)`` of the pure functions from a
    B = 1 ``layout="local"`` EngineCore: the arrays its day loop runs on,
    params unbatched."""
    from repro_torch.engine.core import index_params  # cycle-free at call time

    if core.layout != "local" or core.num_real != 1:
        raise ValueError("legacy_parts() needs a B=1 local EngineCore, got layout "
                         f"'{core.layout}' with {core.num_real} scenarios")
    static = SimStatic(num_people=core.pop.num_people, num_locations=core.pop.num_locations,
                       iv_slots=core.iv_slots, backend=core.static.backend,
                       block_size=core.block_size)
    contact_prob = torch.as_tensor(core.pop.contact_prob, device=core.device).to(torch.float32)
    return static, core.week, contact_prob, index_params(core.params, 0)


def run_eager(core, days: int, state: Optional[SimState] = None):
    """The day loop one phase at a time, with each phase's wall time.

    ``core`` is a B = 1 ``layout="local"`` EngineCore; ``state`` (unbatched)
    defaults to its initial state. Returns ``(state, hist, times)``:
    ``hist`` maps STAT_KEYS to host (days,) arrays, ``times`` maps
    ``"visits"``, ``"interact"`` and ``"update"`` to (days,) arrays of
    seconds. On the card each phase ends in ``torch.cuda.synchronize()``
    before its clock is read, so a phase's time is its host dispatch and
    its device work. The trajectory is bitwise ``core.run1``'s."""
    static, week, contact_prob, params = legacy_parts(core)
    state = state if state is not None else core.init_state1()
    on_card = core.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(core.device)) if on_card else (lambda: None)
    rows, times = [], {"visits": [], "interact": [], "update": []}
    for _ in range(days):
        t0 = time.perf_counter()
        visit_ok, loc_open, ps, pi, vacc = phase_visits(static, params, state)
        sync()
        t1 = time.perf_counter()
        A, contacts = phase_interact(static, week, contact_prob, params, state,
                                     visit_ok, loc_open, ps, pi)
        sync()
        t2 = time.perf_counter()
        state, stats = phase_update(static, params, state, A, contacts, vacc)
        sync()
        t3 = time.perf_counter()
        times["visits"].append(t1 - t0)
        times["interact"].append(t2 - t1)
        times["update"].append(t3 - t2)
        rows.append(torch.stack([stats[k] for k in STAT_KEYS]))
    h = (torch.stack(rows).cpu().numpy() if rows
         else np.zeros((0, len(STAT_KEYS)), np.int64))
    hist = {k: np.ascontiguousarray(h[:, i]) for i, k in enumerate(STAT_KEYS)}
    return state, hist, {k: np.asarray(v) for k, v in times.items()}


def attack_rate(hist) -> float:
    """The final cumulative infection count of a history."""
    return float(hist["cumulative"][-1])
