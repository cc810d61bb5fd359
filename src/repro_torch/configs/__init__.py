"""Config registry: ``get_config(name)`` / ``get_epidemic(name)`` plus the
preset vocabularies."""

from __future__ import annotations

from repro_torch.configs.archs import ARCHS, reduced_config  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    EpidemicConfig,
    LM_SHAPES,
    ModelConfig,
    ShapeConfig,
)
from repro_torch.configs.epidemics import EPIDEMICS  # noqa: F401
from repro_torch.configs.presets import (  # noqa: F401
    DISEASES,
    INTERVENTION_PRESETS,
)
from repro_torch.configs.sweep import Scenario, ScenarioBatch  # noqa: F401


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_epidemic(name: str) -> EpidemicConfig:
    if name not in EPIDEMICS:
        raise KeyError(f"unknown epidemic dataset '{name}'; have {sorted(EPIDEMICS)}")
    return EPIDEMICS[name]
