"""One front door: declarative :class:`ExperimentSpec` -> :func:`run`.

    from repro_torch import api

    spec = api.ExperimentSpec(
        dataset="twin-2k", days=60,
        interventions=("none", "school-closure"),
        tau_scales=(1.0, 0.8), replicates=2,
    )
    result = api.run(spec)           # on the card; device="cpu" on request
    result.save("run_result.json")   # uniform RunResult, any engine

The port of the reference's ``repro.api``: the same spec files, the same
observables, the same RunResult. See :mod:`repro_torch.api.runner` for the
engines it runs.
"""

from repro_torch.api.observables import (  # noqa: F401
    OBSERVABLES,
    Observable,
    ObsContext,
    make_observables,
    observe_history,
)
from repro_torch.api.result import RunResult  # noqa: F401
from repro_torch.api.runner import run, run_file  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    CheckpointSpec,
    ExperimentSpec,
    MeshSpec,
    ResilienceSpec,
)
