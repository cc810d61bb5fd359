"""EngineCore: one scenario placed on one device, ready to run.

The reference's ``EngineCore`` places a scenario batch on one of four
layouts. This package places one scenario on one device (the reference's
``local`` layout with B=1), with the occupancy-packed visit layout; the
batch axis, the mesh layouts and chunked runs are later work.

The device defaults to ``"cuda"`` and a missing card is an error, never a
silent fall back to the CPU; tests pass ``device="cpu"``. ``backend`` picks
the interaction pass by the reference's names: ``"pallas-compact"`` (the
default) or ``"pallas"``; both give bitwise-equal runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.sweep import Scenario
from repro_torch.core import interactions as inter_lib
from repro_torch.core import population as pop_lib
from repro_torch.core import simulator as sim_lib
from repro_torch.core import transmission as tx_lib
from repro_torch.engine import day as day_lib
from repro_torch.engine.topology import LocalTopology
from repro_torch.kernels.interactions import ops as iops


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device


def local_week_arrays(pop: pop_lib.Population, week: inter_lib.WeekData,
                      *, device) -> dict:
    """The day step's ``week`` dict on ``device``: the stacked (7, ...)
    schedule, per-visit contact probabilities (location attributes are
    static, so gathered once) and the combine's person-slot table."""
    return inter_lib.week_from_numpy({
        "pid": week.pid, "loc": week.loc, "start": week.start, "end": week.end,
        "p": pop.contact_prob[week.loc], "row": week.row_idx,
        "col": week.col_idx, "rs": week.row_start, "pa": week.pair_active,
    }, pop.num_people, device=device)


class EngineCore:
    """One scenario on one device."""

    def __init__(
        self,
        pop: pop_lib.Population,
        scenario: Scenario,
        *,
        block_size: int = 128,
        device="cuda",
        backend: str = "pallas-compact",
    ):
        iops.check_backend(backend)
        self.device = resolve_device(device)
        self.pop = pop
        self.scenario = s = scenario
        self.block_size = block_size
        self.iv_slots, self.pa_slots, self.params = sim_lib.build_params(
            pop, s.disease, s.tm, s.interventions, s.seed,
            seed_per_day=s.seed_per_day, seed_days=s.seed_days,
            static_network=s.static_network, iv_enabled=s.iv_enabled,
            device=self.device,
        )
        self.week = local_week_arrays(
            pop, inter_lib.build_week_data(pop, block_size), device=self.device
        )
        self.topo = LocalTopology()
        self.static = day_lib.EngineStatic(
            num_people=pop.num_people,
            num_locations=pop.num_locations,
            block_size=block_size,
            iv_slots=self.iv_slots,
            pa_slots=self.pa_slots,
            backend=backend,
        )

    @classmethod
    def single(
        cls,
        pop: pop_lib.Population,
        disease,
        tm=None,
        *,
        interventions: Sequence = (),
        iv_enabled: Sequence = (),
        seed: int = 0,
        seed_per_day: int = 10,
        seed_days: int = 7,
        static_network: bool = False,
        name: str = "single",
        **core_kw,
    ) -> "EngineCore":
        """A core in one call; ``core_kw`` passes the placement fields
        (``block_size``, ``device``, ``backend``)."""
        scen = Scenario(
            name=name, disease=disease,
            tm=tm if tm is not None else tx_lib.TransmissionModel(),
            interventions=tuple(interventions),
            iv_enabled=tuple(iv_enabled), seed=seed,
            seed_per_day=seed_per_day, seed_days=seed_days,
            static_network=static_network,
        )
        return cls(pop, scen, **core_kw)

    def init_state1(self) -> sim_lib.SimState:
        """The scenario's initial state on the core's device."""
        return sim_lib.init_state(
            self.scenario.disease, self.pop.num_people, len(self.iv_slots),
            device=self.device,
        )

    def run_days(
        self,
        days: int,
        *,
        state: Optional[sim_lib.SimState] = None,
        params: Optional[sim_lib.SimParams] = None,
    ):
        """Run ``days`` days with no host sync. Returns ``(final_state,
        hist)``, ``hist`` a (days, len(STAT_KEYS)) int64 device tensor."""
        return day_lib.run_days(
            self.topo, self.static, self.week,
            params if params is not None else self.params,
            state if state is not None else self.init_state1(),
            days,
        )

    def run1(
        self,
        days: int,
        *,
        state: Optional[sim_lib.SimState] = None,
        params: Optional[sim_lib.SimParams] = None,
    ):
        """:meth:`run_days` with the history copied to the host: returns
        ``(final_state, {stat: (days,) int64 array})``."""
        final, hist = self.run_days(days, state=state, params=params)
        return final, hist_to_numpy(hist)


def hist_to_numpy(hist: torch.Tensor) -> dict:
    """(days, len(STAT_KEYS)) history tensor -> {stat: (days,) array}."""
    h = hist.cpu().numpy()
    return {k: np.ascontiguousarray(h[:, i]) for i, k in enumerate(day_lib.STAT_KEYS)}
