"""The day loop and its placement: ``EngineCore(pop, batch).run_days(days)``
for a scenario batch, ``EngineCore.single(...).run1(days)`` for one run."""

from repro_torch.engine.core import EngineCore, hist_to_numpy  # noqa: F401
from repro_torch.engine.day import EngineStatic, day_step, run_days  # noqa: F401
from repro_torch.engine.topology import LocalTopology  # noqa: F401
