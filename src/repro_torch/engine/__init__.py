"""The day loop and its placement: ``EngineCore(pop, batch).run_days(days)``
for a scenario batch, ``EngineCore.single(...).run1(days)`` for one run."""

from repro_torch.engine.cache import BoundedLRU  # noqa: F401
from repro_torch.engine.core import (  # noqa: F401
    CORE_VERSION,
    CoreDriver,
    EngineCore,
    SequentialDriver,
    build_batch_params,
    hist_to_numpy,
    index_params,
    no_op_params,
    pad_batch,
    run_chunked,
    stack_params,
)
from repro_torch.engine.day import EngineStatic, day_step, run_days  # noqa: F401
from repro_torch.engine.topology import (  # noqa: F401
    LocalTopology,
    MeshTopology,
    ProductTopology,
    ScenarioTopology,
    Topology,
    make_topology,
)
