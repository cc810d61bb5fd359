"""Intervention framework (paper §III-A5, §IV-C5): two families.

A classic intervention = trigger + selector + action:

  * **Trigger** — evaluated at the end of each simulation day from global
    statistics (a reduction over people).
  * **Selector** — a static or hash-random predicate over people/locations,
    resolved to a mask on the host when the run is built.
  * **Action** — either *ephemeral* (applies while the trigger holds:
    isolation visit masks, location closures, transmissibility scaling;
    "undo" is automatic because effects are recomputed from base attributes
    each day) or *persistent* (vaccination: a one-shot flag).

Everything is shape-static: triggers give scalar bools, selectors fixed
(P,)/(L,) masks, and actions fold into per-day effective masks and
multipliers, so the day loop never changes shape or syncs with the host.

The per-agent family (:class:`TestTraceIsolate`) drives persistent
per-person state instead (``tested``, ``traced``, ``isolated_until`` in
``SimState``); its static structure is :class:`PaSlotStatic` and its
numerics are the ``pa_*`` fields of :class:`IvParams`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import rng

# --------------------------------------------------------------------------
# Triggers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DayRange:
    """Active for day in [start, end)."""

    start: int
    end: int = 10**9

    def __call__(self, day, stats, was_active):
        return (day >= self.start) & (day < self.end)


@dataclasses.dataclass(frozen=True)
class CaseThreshold:
    """Activates when the metric crosses `on`; deactivates below `off`
    (hysteresis). Latches if `off` is None."""

    on: float
    off: Optional[float] = None
    metric: str = "infectious"  # or "cumulative"

    def __call__(self, day, stats, was_active):
        x = stats[self.metric]
        rising = x >= self.on
        if self.off is None:
            return was_active | rising
        return torch.where(was_active, x >= self.off, rising)


# --------------------------------------------------------------------------
# Selectors — return a fixed mask at build time (host side).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Everyone:
    def people_mask(self, pop, seed):
        return np.ones((pop.num_people,), np.bool_)

    def locations_mask(self, pop, seed):
        return np.ones((pop.num_locations,), np.bool_)


@dataclasses.dataclass(frozen=True)
class AgeGroupIs:
    group: int

    def people_mask(self, pop, seed):
        return pop.age_group == self.group

    def locations_mask(self, pop, seed):
        return np.zeros((pop.num_locations,), np.bool_)


@dataclasses.dataclass(frozen=True)
class LocTypeIs:
    loc_type: int  # 0 home, 1 work, 2 school, 3 other

    def people_mask(self, pop, seed):
        return np.zeros((pop.num_people,), np.bool_)

    def locations_mask(self, pop, seed):
        return pop.loc_type == self.loc_type


@dataclasses.dataclass(frozen=True)
class RandomFraction:
    """Hash-selected stable random fraction (e.g. compliance sampling)."""

    fraction: float
    salt: int = 0

    def people_mask(self, pop, seed):
        u = rng.np_uniform(seed, rng.INIT_ATTR, self.salt, np.arange(pop.num_people))
        return u < self.fraction

    def locations_mask(self, pop, seed):
        u = rng.np_uniform(
            seed, rng.INIT_ATTR, self.salt + 1_000_003, np.arange(pop.num_locations)
        )
        return u < self.fraction


@dataclasses.dataclass(frozen=True)
class And:
    a: object
    b: object

    def people_mask(self, pop, seed):
        return self.a.people_mask(pop, seed) & self.b.people_mask(pop, seed)

    def locations_mask(self, pop, seed):
        return self.a.locations_mask(pop, seed) & self.b.locations_mask(pop, seed)


# --------------------------------------------------------------------------
# Actions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Isolate:
    """Selected people stop visiting while active (visit-schedule edit)."""

    kind: str = dataclasses.field(default="ephemeral", init=False)


@dataclasses.dataclass(frozen=True)
class CloseLocations:
    """Selected locations reject visits while active (school closures)."""

    kind: str = dataclasses.field(default="ephemeral", init=False)


@dataclasses.dataclass(frozen=True)
class ScaleSusceptibility:
    """Multiply beta_sigma of selected people while active (e.g. masking)."""

    factor: float
    kind: str = dataclasses.field(default="ephemeral", init=False)


@dataclasses.dataclass(frozen=True)
class ScaleInfectivity:
    """Multiply beta_iota of selected people while active."""

    factor: float
    kind: str = dataclasses.field(default="ephemeral", init=False)


@dataclasses.dataclass(frozen=True)
class Vaccinate:
    """One-shot persistent susceptibility reduction on first activation."""

    efficacy: float  # 0.9 => beta_sigma *= 0.1 forever after
    kind: str = dataclasses.field(default="persistent", init=False)


@dataclasses.dataclass(frozen=True)
class Intervention:
    name: str
    trigger: object
    selector: object
    action: object


@dataclasses.dataclass(frozen=True)
class TestTraceIsolate:
    """Per-agent test-trace-isolate policy (the second intervention family).

    Each day, up to ``tests_per_day`` eligible people (symptomatic first,
    then traced contacts) are tested: an exact capacity-limited top-k under
    the counter RNG. Positives isolate from the next day for
    ``isolation_days``; if ``trace`` is set, today's contacts of positives
    are traced by a second accumulator of the interaction pass and isolate
    for ``trace_isolation_days``."""

    name: str
    tests_per_day: int
    selector: object = dataclasses.field(default_factory=Everyone)
    isolation_days: int = 10
    trace: bool = True
    trace_isolation_days: int = 14
    start_day: int = 0


def check_unique_names(interventions) -> None:
    """Reject duplicate slot names early: slots are keyed by name, so a
    silent last-wins merge would drop interventions."""
    seen = set()
    for iv in interventions:
        if iv.name in seen:
            raise ValueError(
                f"duplicate intervention name '{iv.name}': slot names must "
                "be unique within a scenario. Rename one of the "
                "interventions."
            )
        seen.add(iv.name)


# --------------------------------------------------------------------------
# Object formulation: one scenario's classic interventions with their
# selectors resolved to masks, folded with Python branches on the action.
# The day loop runs the stacked formulation below; this one is the readable
# specification it is held to (tests/test_torch_lowlevel.py).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompiledIntervention:
    """Intervention with selector masks resolved to tensors."""

    name: str
    trigger: object
    action: object
    people: torch.Tensor  # (P,) bool
    locations: torch.Tensor  # (L,) bool


def compile_interventions(interventions: Sequence[Intervention], pop, seed, *,
                          device="cuda") -> list:
    """Resolve each classic intervention's selector on ``pop`` (hash draws
    keyed by ``seed``) to masks on ``device``."""
    check_unique_names(interventions)
    return [CompiledIntervention(
        name=iv.name, trigger=iv.trigger, action=iv.action,
        people=torch.as_tensor(iv.selector.people_mask(pop, seed), device=device),
        locations=torch.as_tensor(iv.selector.locations_mask(pop, seed), device=device),
    ) for iv in interventions]


def apply_interventions(compiled: Sequence[CompiledIntervention], active, vaccinated,
                        num_people: int, num_locations: int):
    """Fold active interventions into the day's masks and multipliers, for
    one scenario: ``active`` (K,) bool (trigger states from the end of the
    previous day), ``vaccinated`` (P,) bool. Returns (visit_ok (P,),
    loc_open (L,), sus_mult (P,), inf_mult (P,), new_vaccinated (P,));
    effects are recomputed from base attributes each day, so "undo" is
    automatic."""
    dev = vaccinated.device
    visit_ok = torch.ones((num_people,), dtype=torch.bool, device=dev)
    loc_open = torch.ones((num_locations,), dtype=torch.bool, device=dev)
    sus_mult = torch.ones((num_people,), dtype=torch.float32, device=dev)
    inf_mult = torch.ones((num_people,), dtype=torch.float32, device=dev)
    for k, iv in enumerate(compiled):
        on, a = active[k], iv.action
        if isinstance(a, Isolate):
            visit_ok = visit_ok & ~(on & iv.people)
        elif isinstance(a, CloseLocations):
            loc_open = loc_open & ~(on & iv.locations)
        elif isinstance(a, ScaleSusceptibility):
            sus_mult = sus_mult * torch.where(on & iv.people, a.factor, 1.0)
        elif isinstance(a, ScaleInfectivity):
            inf_mult = inf_mult * torch.where(on & iv.people, a.factor, 1.0)
        elif isinstance(a, Vaccinate):
            vaccinated = vaccinated | (on & iv.people)
        else:
            raise TypeError(f"unknown action {a!r}")
    # Vaccination's effect persists whatever the trigger says today.
    for iv in compiled:
        if isinstance(iv.action, Vaccinate):
            sus_mult = sus_mult * torch.where(vaccinated & iv.people,
                                              1.0 - iv.action.efficacy, 1.0)
            break  # one vaccinated flag — first Vaccinate defines efficacy
    return visit_ok, loc_open, sus_mult, inf_mult, vaccinated


def evaluate_triggers(compiled: Sequence[CompiledIntervention], day, stats, active):
    """End-of-day trigger evaluation (Algorithm 2, line 34): each trigger
    called on the day, the day's statistics and its slot's state."""
    if not compiled:
        return active
    return torch.stack([iv.trigger(day, stats, active[k]) for k, iv in enumerate(compiled)])


# --------------------------------------------------------------------------
# Stacked (structure-of-arrays) formulation: the static slot structure
# lives in ``IvSlotStatic``, every numeric in ``IvParams`` tensors.
# --------------------------------------------------------------------------

NEVER_OFF = -3.0e38  # thresh_off encoding of "latched" (off=None)


@dataclasses.dataclass(frozen=True)
class IvSlotStatic:
    """Static per-slot structure."""

    name: str
    action: str  # isolate | close | scale_sus | scale_inf | vaccinate
    trigger: str  # day_range | case_threshold
    metric: str = "infectious"


@dataclasses.dataclass(frozen=True)
class PaSlotStatic:
    """Static structure of one per-agent slot: is tracing compiled in?"""

    name: str
    trace: bool


@dataclasses.dataclass
class IvParams:
    """Intervention numerics as tensors. The shapes below are one
    scenario's (slot axis K leads); in the day step every leaf carries a
    leading scenario axis B in front of them."""

    enabled: torch.Tensor  # (K,) bool — slot on/off
    day_start: torch.Tensor  # (K,) int32 (day_range)
    day_end: torch.Tensor  # (K,) int32
    thresh_on: torch.Tensor  # (K,) f32 (case_threshold)
    thresh_off: torch.Tensor  # (K,) f32; NEVER_OFF => latching
    factor: torch.Tensor  # (K,) f32 — scale factor, or 1-efficacy
    people: torch.Tensor  # (K, P) bool selector masks
    locations: torch.Tensor  # (K, L) bool
    # --- per-agent (test-trace-isolate) slots, K2 axis ------------------
    pa_enabled: torch.Tensor  # (K2,) bool — slot on/off
    pa_start: torch.Tensor  # (K2,) int32 — first active day
    pa_tests: torch.Tensor  # (K2,) int32 — daily testing-capacity budget
    pa_iso: torch.Tensor  # (K2,) int32 — isolation days for positives
    pa_trace_iso: torch.Tensor  # (K2,) int32 — isolation days for traced
    pa_people: torch.Tensor  # (K2, P) bool — who the policy covers

    @property
    def num_pa_slots(self) -> int:
        return self.pa_enabled.shape[-1]


_ACTION_KINDS = {
    Isolate: "isolate",
    CloseLocations: "close",
    ScaleSusceptibility: "scale_sus",
    ScaleInfectivity: "scale_inf",
    Vaccinate: "vaccinate",
}


def compile_iv_params(
    interventions: Sequence, pop, seed, *, device
) -> tuple[tuple[IvSlotStatic, ...], tuple[PaSlotStatic, ...], IvParams]:
    """Resolve a mixed intervention list into (classic static slots,
    per-agent static slots, params).

    Each family keeps its own slot order (the list order within the
    family). Selector masks are resolved host-side with the scenario seed.
    """
    check_unique_names(interventions)
    pa_ivs = [iv for iv in interventions if isinstance(iv, TestTraceIsolate)]
    interventions = [iv for iv in interventions
                     if not isinstance(iv, TestTraceIsolate)]

    n_vax = sum(1 for iv in interventions if isinstance(iv.action, Vaccinate))
    if n_vax > 1:
        raise ValueError(
            f"{n_vax} Vaccinate slots in one scenario: the single vaccinated "
            "flag carries exactly one efficacy."
        )

    K = len(interventions)
    statics = []
    enabled = np.ones((K,), np.bool_)
    day_start = np.zeros((K,), np.int32)
    day_end = np.full((K,), 2**31 - 1, np.int32)
    thresh_on = np.zeros((K,), np.float32)
    thresh_off = np.full((K,), NEVER_OFF, np.float32)
    factor = np.ones((K,), np.float32)
    people = np.zeros((K, pop.num_people), np.bool_)
    locations = np.zeros((K, pop.num_locations), np.bool_)

    for k, iv in enumerate(interventions):
        a, t = iv.action, iv.trigger
        kind = _ACTION_KINDS.get(type(a))
        if kind is None:
            raise TypeError(f"unknown action {a!r}")
        if isinstance(t, DayRange):
            tkind, metric = "day_range", "infectious"
            day_start[k] = t.start
            day_end[k] = min(t.end, 2**31 - 1)
        elif isinstance(t, CaseThreshold):
            tkind, metric = "case_threshold", t.metric
            thresh_on[k] = t.on
            thresh_off[k] = NEVER_OFF if t.off is None else t.off
        else:
            raise TypeError(f"unknown trigger {t!r}")
        statics.append(IvSlotStatic(iv.name, kind, tkind, metric))
        if isinstance(a, (ScaleSusceptibility, ScaleInfectivity)):
            factor[k] = a.factor
        elif isinstance(a, Vaccinate):
            factor[k] = 1.0 - a.efficacy
        people[k] = np.asarray(iv.selector.people_mask(pop, seed))
        locations[k] = np.asarray(iv.selector.locations_mask(pop, seed))

    K2 = len(pa_ivs)
    pa_statics = []
    pa_start = np.zeros((K2,), np.int32)
    pa_tests = np.zeros((K2,), np.int32)
    pa_iso = np.zeros((K2,), np.int32)
    pa_trace_iso = np.zeros((K2,), np.int32)
    pa_people = np.zeros((K2, pop.num_people), np.bool_)
    for k, iv in enumerate(pa_ivs):
        pa_statics.append(PaSlotStatic(iv.name, bool(iv.trace)))
        pa_start[k] = iv.start_day
        pa_tests[k] = iv.tests_per_day
        pa_iso[k] = iv.isolation_days
        pa_trace_iso[k] = iv.trace_isolation_days
        pa_people[k] = np.asarray(iv.selector.people_mask(pop, seed))

    t = lambda a: torch.as_tensor(a, device=device)
    params = IvParams(
        enabled=t(enabled), day_start=t(day_start), day_end=t(day_end),
        thresh_on=t(thresh_on), thresh_off=t(thresh_off), factor=t(factor),
        people=t(people), locations=t(locations),
        pa_enabled=t(np.ones((K2,), np.bool_)), pa_start=t(pa_start),
        pa_tests=t(pa_tests), pa_iso=t(pa_iso), pa_trace_iso=t(pa_trace_iso),
        pa_people=t(pa_people),
    )
    return tuple(statics), tuple(pa_statics), params


def apply_iv_params(
    slots: Sequence[IvSlotStatic],
    p: IvParams,  # leaves (B, ...): one row per scenario
    active: torch.Tensor,  # (B, K) bool — trigger states from end of previous day
    vaccinated: torch.Tensor,  # (B, P) bool persistent flag
    num_people: int,
    num_locations: int,
):
    """Fold active interventions into per-day effective masks/multipliers,
    for a batch of scenarios.

    Returns (visit_ok (B, P), loc_open (B, L), sus_mult (B, P), inf_mult
    (B, P), new_vaccinated (B, P)), in the reference's operation order."""
    dev = vaccinated.device
    B = vaccinated.shape[0]
    visit_ok = torch.ones((B, num_people), dtype=torch.bool, device=dev)
    loc_open = torch.ones((B, num_locations), dtype=torch.bool, device=dev)
    sus_mult = torch.ones((B, num_people), dtype=torch.float32, device=dev)
    inf_mult = torch.ones((B, num_people), dtype=torch.float32, device=dev)
    for k, s in enumerate(slots):
        on = active[:, k, None]
        factor = p.factor[:, k, None]
        if s.action == "isolate":
            visit_ok = visit_ok & ~(on & p.people[:, k])
        elif s.action == "close":
            loc_open = loc_open & ~(on & p.locations[:, k])
        elif s.action == "scale_sus":
            sus_mult = sus_mult * torch.where(on & p.people[:, k], factor, 1.0)
        elif s.action == "scale_inf":
            inf_mult = inf_mult * torch.where(on & p.people[:, k], factor, 1.0)
        elif s.action == "vaccinate":
            vaccinated = vaccinated | (on & p.people[:, k])
    for k, s in enumerate(slots):
        if s.action == "vaccinate":
            sus_mult = sus_mult * torch.where(
                vaccinated & p.people[:, k], p.factor[:, k, None], 1.0
            )
            break  # one vaccinated flag — first Vaccinate defines efficacy
    return visit_ok, loc_open, sus_mult, inf_mult, vaccinated


def evaluate_iv_triggers(slots, p: IvParams, day, stats, active):
    """End-of-day trigger evaluation (Algorithm 2, line 34) for a batch:
    ``day`` and each ``stats`` entry are (B,), ``active`` (B, K). Disabled
    slots (``p.enabled[:, k] == False``) never activate."""
    if not slots:
        return active
    new = []
    for k, s in enumerate(slots):
        if s.trigger == "day_range":
            t = (day >= p.day_start[:, k]) & (day < p.day_end[:, k])
        else:  # case_threshold (hysteresis; thresh_off == NEVER_OFF latches)
            x = stats[s.metric]
            rising = x >= p.thresh_on[:, k]
            t = torch.where(active[:, k], x >= p.thresh_off[:, k], rising)
        new.append(t & p.enabled[:, k])
    return torch.stack(new, dim=-1)
