"""Run state and scenario parameters of the day loop, as dataclasses of tensors.

* ``SimParams`` — every scenario-varying numeric (seed, transmissibility,
  disease tables, per-person betas, intervention thresholds/masks,
  outbreak-seeding knobs) as tensors on the run's device.
* ``SimState`` — what one day hands to the next.

``params_from_numpy`` / ``state_from_numpy`` take the reference package's
``SimParams`` / ``SimState`` as nested dicts of numpy arrays (e.g.
``dataclasses.asdict(jax.device_get(x))``), so both packages can run a day
from one identical state, per-agent intervention fields (``sym_table``,
``pa_*``, ``tested``, ``traced``, ``isolated_until``) included.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
