"""Named disease + intervention presets (the names the CLI accepts).

The classic-family intervention presets only: a preset with a per-agent
test-trace-isolate slot is not part of this package yet (the engine raises
``NotImplementedError`` for one).
"""

from __future__ import annotations

from repro_torch.core import disease as disease_lib
from repro_torch.core import interventions as iv

DISEASES = {
    "covid": disease_lib.covid_model,
    "sir": disease_lib.sir_model,
    "seir": disease_lib.seir_model,
}

INTERVENTION_PRESETS = {
    "none": [],
    "school-closure": [iv.Intervention(
        "close-schools", iv.CaseThreshold(on=100), iv.LocTypeIs(2),
        iv.CloseLocations(),
    )],
    "vax-seniors": [iv.Intervention(
        "vaccinate-seniors", iv.DayRange(14), iv.AgeGroupIs(2),
        iv.Vaccinate(0.85),
    )],
    "lockdown": [iv.Intervention(
        "lockdown", iv.CaseThreshold(on=500, off=100),
        iv.RandomFraction(0.8, salt=3), iv.Isolate(),
    )],
}
