"""One fully-specified simulation run (the reference's ``Scenario``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
    # Per-slot enable mask; () means all enabled.
    iv_enabled: Tuple[bool, ...] = ()
    seed: int = 0
    seed_per_day: int = 10
    seed_days: int = 7
    static_network: bool = False
