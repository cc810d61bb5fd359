"""Scenario-ensemble configs (the reference's ``repro.configs.sweep``).

A :class:`Scenario` names one fully-specified run: disease model,
transmission model, interventions, Monte Carlo seed, seeding schedule. A
:class:`ScenarioBatch` is an ordered collection of scenarios that the engine
core (:mod:`repro_torch.engine`) runs as one batched day loop: every
scenario's ``SimParams`` stacked on a leading batch axis, every op of the day
over ``(B, ...)`` tensors, one interaction-kernel launch a day for the whole
batch.

Structural constraint: every scenario in a batch shares the same disease FSA
*shape* (number of states; table values may differ) and the same
intervention slot layout (same ordered list of action/trigger kinds;
thresholds, factors, selector draws and enabled flags may differ).
``from_product`` guarantees this by building each factorial cell from the
same template axes; for hand-rolled batches the engine validates it at build
time.

``from_product`` broadcasts: an axis given as one value applies to every
cell; sequences become factorial axes. The order is
``interventions x tau x disease x seeds`` with seeds innermost, so
consecutive scenarios are Monte Carlo replicates of one design cell.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

from repro_torch.core import disease as disease_lib
from repro_torch.core import transmission as tx_lib


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One fully-specified simulation run."""

    name: str
    disease: disease_lib.DiseaseModel
    tm: tx_lib.TransmissionModel = dataclasses.field(
        default_factory=tx_lib.TransmissionModel
    )
    interventions: Tuple = ()
    # Per-slot enable mask; () means all enabled. A factorial design shares
    # one union slot layout across cells while each cell enables its own.
    iv_enabled: Tuple[bool, ...] = ()
    seed: int = 0
    seed_per_day: int = 10
    seed_days: int = 7
    static_network: bool = False


def _axis(x, default) -> tuple:
    """Broadcast a scalar-or-sequence factorial axis to a tuple."""
    if x is None:
        return (default,)
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """An ordered batch of scenarios run as one batched day loop."""

    scenarios: Tuple[Scenario, ...]

    def __len__(self) -> int:
        return len(self.scenarios)

    def __iter__(self) -> Iterator[Scenario]:
        return iter(self.scenarios)

    def __getitem__(self, i) -> Scenario:
        return self.scenarios[i]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.scenarios)

    def validate(self) -> None:
        if not self.scenarios:
            raise ValueError("empty scenario batch")
        S = self.scenarios[0].disease.num_states
        K = len(self.scenarios[0].interventions)
        for s in self.scenarios:
            if s.disease.num_states != S:
                raise ValueError(
                    f"scenario '{s.name}': disease has {s.disease.num_states} "
                    f"states, batch requires {S} (FSA structure must match; "
                    "perturb table values, not the state set)"
                )
            if len(s.interventions) != K:
                raise ValueError(
                    f"scenario '{s.name}': {len(s.interventions)} intervention "
                    f"slots, batch requires {K} (disable a slot with an "
                    "always-off trigger instead of dropping it)"
                )

    @classmethod
    def from_scenarios(cls, scenarios: Sequence[Scenario]) -> "ScenarioBatch":
        batch = cls(scenarios=tuple(scenarios))
        batch.validate()
        return batch

    @classmethod
    def from_product(
        cls,
        *,
        interventions: Optional[Dict[str, Sequence]] = None,
        tau: Union[float, Sequence[float], None] = None,
        disease: Union[disease_lib.DiseaseModel,
                       Dict[str, disease_lib.DiseaseModel], None] = None,
        seeds: Union[int, Sequence[int]] = 0,
        time_unit: float = 1.0,
        seed_per_day: int = 10,
        seed_days: int = 7,
        static_network: bool = False,
    ) -> "ScenarioBatch":
        """Factorial study builder: ``interventions x tau x disease x seeds``.

        The intervention axis (name -> intervention list) compiles to a
        *union* slot layout: each scenario carries every intervention of
        any design cell, with an ``iv_enabled`` mask enabling only its own
        cell's slots, so all scenarios share one structure (at most one
        Vaccinate slot per union: one ``vaccinated`` flag carries one
        efficacy). Monte Carlo ``seeds`` are the innermost axis."""
        iv_axis = tuple((interventions or {"baseline": ()}).items())
        union: tuple = sum((tuple(ivs) for _, ivs in iv_axis), ())
        masks, off = [], 0
        for _, ivs in iv_axis:
            n = len(ivs)
            masks.append(tuple(off <= j < off + n for j in range(len(union))))
            off += n
        tau_axis = _axis(tau, tx_lib.TransmissionModel().tau)
        if disease is None:
            dz_axis = (("covid", disease_lib.covid_model()),)
        elif isinstance(disease, dict):
            dz_axis = tuple(disease.items())
        else:
            dz_axis = ((disease.name, disease),)
        seed_axis = _axis(seeds, 0)

        scenarios = []
        for (iv_name, _), mask in zip(iv_axis, masks):
            for t in tau_axis:
                for dz_name, dz in dz_axis:
                    for seed in seed_axis:
                        parts = [iv_name]
                        if len(tau_axis) > 1:
                            parts.append(f"tau={t:g}")
                        if len(dz_axis) > 1:
                            parts.append(dz_name)
                        if len(seed_axis) > 1:
                            parts.append(f"s{seed}")
                        scenarios.append(Scenario(
                            name="/".join(parts),
                            disease=dz,
                            tm=tx_lib.TransmissionModel(tau=float(t),
                                                        time_unit=time_unit),
                            interventions=union,
                            iv_enabled=mask,
                            seed=int(seed),
                            seed_per_day=seed_per_day,
                            seed_days=seed_days,
                            static_network=static_network,
                        ))
        return cls.from_scenarios(scenarios)
