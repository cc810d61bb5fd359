"""Disease models as finite state automata (paper §III-A1).

Each state carries a susceptibility sigma and infectivity iota. Transitions
are stochastic both in the next state (categorical) and in dwell time
(exponential around a per-state mean).

The FSA is represented with small dense tables, so the per-day update is a
handful of vectorized gathers over the (B, P) person-state tensors of a
scenario batch — no per-agent control flow. The model description is host-side numpy; the
update runs on tensors on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import rng

# Dwell value treated as "never times out" (absorbing states).
ABSORBING_DWELL = 1.0e9


@dataclasses.dataclass(frozen=True)
class DiseaseModel:
    """Immutable FSA description. All tables are small numpy arrays."""

    name: str
    states: tuple[str, ...]
    susceptibility: np.ndarray  # (S,) f32, sigma(X)
    infectivity: np.ndarray  # (S,) f32, iota(X)
    trans_probs: np.ndarray  # (S, S) f32, rows sum to 1 (absorbing: self=1)
    dwell_mean_days: np.ndarray  # (S,) f32; ABSORBING_DWELL for absorbing
    entry_state: int  # state entered on infection (e.g. E)
    initial_state: int  # state people start in (e.g. S)
    # Optional (S,) f32 mask of *symptomatic* states: the testing-priority
    # tier for per-agent interventions. None = "any infectious state".
    symptomatic: Optional[np.ndarray] = None

    @property
    def num_states(self) -> int:
        return len(self.states)

    @property
    def sym_table(self) -> np.ndarray:
        """(S,) f32: 1.0 for states that present symptoms (test priority)."""
        if self.symptomatic is not None:
            return np.asarray(self.symptomatic, np.float32)
        return (self.infectivity > 0).astype(np.float32)

    def state_index(self, name: str) -> int:
        return self.states.index(name)

    @property
    def cum_trans(self) -> np.ndarray:
        return np.cumsum(self.trans_probs, axis=-1).astype(np.float32)

    def validate(self) -> None:
        S = self.num_states
        if self.trans_probs.shape != (S, S):
            raise ValueError(f"trans_probs shape {self.trans_probs.shape} != {(S, S)}")
        if not np.allclose(self.trans_probs.sum(-1), 1.0, atol=1e-5):
            raise ValueError("transition rows must sum to 1")
        if not (0 <= self.entry_state < S and 0 <= self.initial_state < S):
            raise ValueError("entry/initial state out of range")


def make_disease(
    name: str,
    states: Sequence[str],
    susceptibility: Sequence[float],
    infectivity: Sequence[float],
    transitions: dict[str, dict[str, float]],
    dwell_mean_days: dict[str, float],
    entry_state: str,
    initial_state: str,
    symptomatic: Optional[Sequence[str]] = None,
) -> DiseaseModel:
    """Friendly constructor from dicts."""
    states = tuple(states)
    S = len(states)
    idx = {s: i for i, s in enumerate(states)}
    tp = np.zeros((S, S), np.float32)
    for s, outs in transitions.items():
        for t, p in outs.items():
            tp[idx[s], idx[t]] = p
    for i in range(S):
        if tp[i].sum() == 0.0:  # absorbing
            tp[i, i] = 1.0
    dwell = np.full((S,), ABSORBING_DWELL, np.float32)
    for s, d in dwell_mean_days.items():
        dwell[idx[s]] = d
    sym = None
    if symptomatic is not None:
        sym = np.zeros((S,), np.float32)
        for s in symptomatic:
            sym[idx[s]] = 1.0
    m = DiseaseModel(
        name=name,
        states=states,
        susceptibility=np.asarray(susceptibility, np.float32),
        infectivity=np.asarray(infectivity, np.float32),
        trans_probs=tp,
        dwell_mean_days=dwell,
        entry_state=idx[entry_state],
        initial_state=idx[initial_state],
        symptomatic=sym,
    )
    m.validate()
    return m


def covid_model() -> DiseaseModel:
    """Expanded SEIR tuned to represent COVID-19 (paper §III-A1): exposed,
    presymptomatic, symptomatic/asymptomatic branch, recovered."""
    return make_disease(
        name="covid-seir+",
        states=("S", "E", "Ipre", "Isym", "Iasym", "R"),
        susceptibility=[1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        infectivity=[0.0, 0.0, 0.8, 1.0, 0.5, 0.0],
        transitions={
            "E": {"Ipre": 1.0},
            "Ipre": {"Isym": 0.65, "Iasym": 0.35},
            "Isym": {"R": 1.0},
            "Iasym": {"R": 1.0},
        },
        dwell_mean_days={"E": 3.0, "Ipre": 2.0, "Isym": 5.0, "Iasym": 4.0},
        entry_state="E",
        initial_state="S",
        symptomatic=["Isym"],
    )


def sir_model(recovery_days: float = 7.0) -> DiseaseModel:
    """Simple SIR used for the EpiHiper validation study (paper §VI/§VIII)."""
    return make_disease(
        name="sir",
        states=("S", "I", "R"),
        susceptibility=[1.0, 0.0, 0.0],
        infectivity=[0.0, 1.0, 0.0],
        transitions={"I": {"R": 1.0}},
        dwell_mean_days={"I": recovery_days},
        entry_state="I",
        initial_state="S",
    )


def seir_model() -> DiseaseModel:
    """Classic SEIR (FRED-style fixed pipeline) — used in ablations."""
    return make_disease(
        name="seir",
        states=("S", "E", "I", "R"),
        susceptibility=[1.0, 0.0, 0.0, 0.0],
        infectivity=[0.0, 0.0, 1.0, 0.0],
        transitions={"E": {"I": 1.0}, "I": {"R": 1.0}},
        dwell_mean_days={"E": 3.0, "I": 6.0},
        entry_state="E",
        initial_state="S",
    )


# ----------------------------------------------------------------------------
# Vectorized per-day FSA update
# ----------------------------------------------------------------------------


def initial_health(model: DiseaseModel, num_people: int, *, device):
    """(state, dwell_left) tensors for a fresh population."""
    state = torch.full((num_people,), model.initial_state, dtype=torch.int32,
                       device=device)
    dwell = torch.full((num_people,), ABSORBING_DWELL, dtype=torch.float32,
                       device=device)
    return state, dwell


def update_health_tables(
    cum_trans: torch.Tensor,  # (B, S, S) cumulative transition rows
    dwell_mean: torch.Tensor,  # (B, S)
    susceptibility: torch.Tensor,  # (B, S)
    entry_state: torch.Tensor,  # (B,) int
    state: torch.Tensor,  # (B, P) int32
    dwell_left: torch.Tensor,  # (B, P) f32 days remaining in current state
    newly_infected: torch.Tensor,  # (B, P) bool
    seed,  # (B, 1)
    day,  # (B, 1)
    pid: torch.Tensor,  # (P,) ids keying the draws (global person ids)
):
    """End-of-day health update (Algorithm 2 line 30), table-driven, for a
    batch of scenarios: every table lookup gathers from the scenario's own
    row.

    Infections landed this day take precedence (a susceptible cannot also
    make a timed transition), then timed transitions fire for anyone whose
    dwell expired. Same operation order as the reference, so everything but
    the ``log`` in the dwell draw is bitwise equal to it.
    """
    look = lambda table, idx: table.gather(1, idx.long())
    S = cum_trans.shape[-1]
    rows = cum_trans.gather(1, state.long()[..., None].expand(-1, -1, S))
    # Timed transition draws (only applied where dwell expires).
    next_state = rng.categorical(rows, seed, rng.TRANSITION, day, pid)
    dwell_after = dwell_left - 1.0
    timed = dwell_after <= 0.0

    state_t = torch.where(timed, next_state, state)
    # Infection overrides: susceptible -> entry state.
    can_infect = look(susceptibility, state) > 0.0
    infected = newly_infected & can_infect
    state_new = torch.where(infected, entry_state.to(torch.int32)[:, None], state_t)

    changed = infected | (timed & (state_new != state))
    mean_new = look(dwell_mean, state_new)
    new_dwell = rng.exponential(mean_new, seed, rng.DWELL, day, pid)
    # Keep at least one day in any transient state (paper's day granularity).
    new_dwell = torch.clamp(new_dwell, min=1.0)
    new_dwell = torch.where(mean_new >= ABSORBING_DWELL, ABSORBING_DWELL, new_dwell)
    dwell_out = torch.where(changed, new_dwell, dwell_after)
    return state_new, dwell_out


# ----------------------------------------------------------------------------
# One scenario, model objects: the reference's convenience wrappers
# ----------------------------------------------------------------------------


def _one(model: DiseaseModel, state: torch.Tensor, seed, day):
    """The model's tables with a scenario axis of 1, the hash words (1, 1)
    and the person ids ``arange(P)`` on ``state``'s device."""
    dev = state.device
    t = lambda a, dtype: torch.as_tensor(np.asarray(a), device=dev).to(dtype)[None]
    word = lambda x: torch.as_tensor(x, device=dev).to(torch.int64).reshape(1, 1)
    tables = (t(model.cum_trans, torch.float32), t(model.dwell_mean_days, torch.float32),
              t(model.susceptibility, torch.float32), t(model.entry_state, torch.int64))
    pid = torch.arange(state.shape[-1], dtype=torch.int64, device=dev)
    return tables, word(seed), word(day), pid


def update_health(model: DiseaseModel, state: torch.Tensor, dwell_left: torch.Tensor,
                  newly_infected: torch.Tensor, seed, day):
    """:func:`update_health_tables` for one scenario from its model object:
    ``state``/``dwell_left``/``newly_infected`` are (P,), ``seed`` and
    ``day`` ints or 0-d tensors, the draws keyed by person ids ``arange(P)``."""
    tables, seed_w, day_w, pid = _one(model, state, seed, day)
    health, dwell = update_health_tables(*tables, state[None], dwell_left[None],
                                         newly_infected[None], seed_w, day_w, pid)
    return health[0], dwell[0]


def seed_infections(model: DiseaseModel, state: torch.Tensor, dwell_left: torch.Tensor,
                    num_to_seed: int, seed, day):
    """Infect the ``num_to_seed`` susceptible people with the smallest
    SEED_CHOICE draws (ties at the threshold all go) and update their health.
    The threshold is the k-th smallest draw among the susceptible, picked by
    the engine's own rule (``engine/topology.py:LocalTopology.seed_threshold``),
    so the seeded set is bitwise the engine's; ``num_to_seed`` <= 0 seeds
    nobody."""
    from repro_torch.engine.topology import LocalTopology  # cycle-free at call time

    (_, _, sus_table, _), seed_w, day_w, pid = _one(model, state, seed, day)
    sus = sus_table.gather(1, state.long()[None]) > 0.0
    u = torch.where(sus, rng.uniform(seed_w, rng.SEED_CHOICE, day_w, pid), 2.0)
    k = torch.tensor([int(num_to_seed)], dtype=torch.int64, device=state.device)
    thresh = LocalTopology().seed_threshold(u, k, state.shape[-1])
    chosen = (u <= thresh[:, None]) & sus & (num_to_seed > 0)
    return update_health(model, state, dwell_left, chosen[0], seed, day)
