from repro_torch.runtime.fault import FaultTolerantLoop, FaultConfig  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    plan_elastic_rescale,
    repartition_person_array,
)
from repro_torch.runtime.guards import GuardContext, InvariantViolation  # noqa: F401
from repro_torch.runtime.chaos import (  # noqa: F401
    ChaosError,
    ChaosEvent,
    ChaosSchedule,
    DeviceLossError,
)
from repro_torch.runtime.resilience import (  # noqa: F401
    ResiliencePolicy,
    ResilienceReport,
    run_resilient,
)
