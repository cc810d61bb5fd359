"""Uniform run result: what every engine hands back through the facade
(the port of the reference's ``repro.api.result``).

A :class:`RunResult` carries the day-major history pytree (every array
``(days, B)`` — B=1 for single runs, so downstream analysis never branches
on engine), the finalized observables, per-scenario summary rows, the spec
echo, and provenance metadata. ``to_json``/``from_json`` round-trip through
plain JSON (arrays become nested lists) so results are CI artifacts and
``analysis/report.py`` inputs; a result saved by the reference loads here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.api.spec import ExperimentSpec


def _jsonify(x):
    if isinstance(x, dict):
        return {k: _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonify(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.generic,)):
        return x.item()
    return x


@dataclasses.dataclass
class RunResult:
    """What :func:`repro_torch.api.run` returns, for every engine."""

    spec: ExperimentSpec
    scenario_names: Tuple[str, ...]
    history: Dict[str, np.ndarray]  # day-major, every array (days, B)
    observables: Dict[str, Any]  # {observable name: numpy pytree}
    summaries: list  # one dict row per scenario (analysis/report.py)
    provenance: Dict[str, Any]  # engine, devices, wall clock, resume info

    # ------------------------------------------------------------------
    @property
    def num_scenarios(self) -> int:
        return len(self.scenario_names)

    @property
    def days(self) -> int:
        return int(next(iter(self.history.values())).shape[0])

    def scenario_history(self, i: int) -> Dict[str, np.ndarray]:
        """Scenario ``i``'s (days,) trajectory slices."""
        return {k: v[:, i] for k, v in self.history.items()}

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "scenario_names": list(self.scenario_names),
            "history": _jsonify(self.history),
            "observables": _jsonify(self.observables),
            "summaries": _jsonify(self.summaries),
            "provenance": _jsonify(self.provenance),
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def from_dict(cls, d: dict) -> "RunResult":
        hist = {k: np.asarray(v) for k, v in d["history"].items()}
        return cls(
            spec=ExperimentSpec.from_dict(d["spec"]),
            scenario_names=tuple(d["scenario_names"]),
            history=hist,
            observables=d["observables"],
            summaries=list(d["summaries"]),
            provenance=dict(d["provenance"]),
        )

    @classmethod
    def load(cls, path: str) -> "RunResult":
        with open(path) as f:
            return cls.from_dict(json.load(f))
