"""Config registry: ``get_epidemic(name)`` plus the preset vocabularies."""

from __future__ import annotations

from repro_torch.configs.base import EpidemicConfig  # noqa: F401
from repro_torch.configs.epidemics import EPIDEMICS  # noqa: F401
from repro_torch.configs.presets import (  # noqa: F401
    DISEASES,
    INTERVENTION_PRESETS,
)
from repro_torch.configs.sweep import Scenario  # noqa: F401


def get_epidemic(name: str) -> EpidemicConfig:
    if name not in EPIDEMICS:
        raise KeyError(f"unknown epidemic dataset '{name}'; have {sorted(EPIDEMICS)}")
    return EPIDEMICS[name]
