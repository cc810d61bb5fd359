"""EngineCore: a scenario batch placed on one device, ready to run.

``repro_torch.engine.day.run_days`` is the one day loop; this module owns
everything around it, as the reference's ``repro.engine.core`` does:

  * **building** — one path compiles a :class:`ScenarioBatch` into stacked
    ``SimParams``/``SimState`` (leading scenario axis B, B = 1 included)
    plus the week's device arrays the step consumes;
  * **placement** — the ``local`` layout: the whole batch on one device,
    every op of the day over ``(B, ...)`` and one interaction-kernel launch
    a day. The reference's mesh layouts (``workers``, ``scenarios``,
    ``hybrid``) are ROADMAP queue 1 item 4;
  * **running** — :func:`run_chunked` drives a run through a
    :class:`CoreDriver` (the batch in one loop, observables inside it) or a
    :class:`SequentialDriver` (one scenario at a time, observables replayed
    after the run), in one chunk: checkpointed chunks are ROADMAP queue 1
    item 3.

Scenario padding is *inert*: :func:`pad_batch` fills a batch with copies of
its last scenario, and :func:`no_op_params` gives them zero betas, zero
seeding and every intervention slot disabled, so nobody is seeded or
infected there and their live-tile count is 0. Padded slots come last and
are sliced off before any history or observable sees them.

The device defaults to ``"cuda"`` and a missing card is an error, never a
silent fall back to the CPU; tests pass ``device="cpu"``. ``backend`` picks
the interaction pass by the reference's names: ``"pallas-compact"`` (the
default) or ``"pallas"``; both give bitwise-equal runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.sweep import Scenario, ScenarioBatch
from repro_torch.core import interactions as inter_lib
from repro_torch.core import population as pop_lib
from repro_torch.core import simulator as sim_lib
from repro_torch.core import transmission as tx_lib
from repro_torch.engine import day as day_lib
from repro_torch.engine.topology import LocalTopology
from repro_torch.kernels.interactions import ops as iops

LAYOUTS = ("local",)

#: Engine-core generation marker (the reference's, for the same history
#: keys and state fields): part of every resume key once checkpoints land.
CORE_VERSION = "engine-v3"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device


# ---------------------------------------------------------------------------
# batch compilation (the one copy of the slot-structure loop)
# ---------------------------------------------------------------------------


def as_batch(batch: Union[ScenarioBatch, Sequence[Scenario]]) -> ScenarioBatch:
    if isinstance(batch, ScenarioBatch):
        return batch
    return ScenarioBatch.from_scenarios(tuple(batch))


def build_batch_params(pop, batch: ScenarioBatch, *, device):
    """Compile every scenario's configs into ``(iv_slots, pa_slots,
    [SimParams, ...])``, validating that the batch shares one slot
    structure (both intervention families)."""
    slots0, pa0, params_list = None, None, []
    for s in batch:
        slots, pa_slots, params = sim_lib.build_params(
            pop, s.disease, s.tm, s.interventions, s.seed,
            seed_per_day=s.seed_per_day, seed_days=s.seed_days,
            static_network=s.static_network, iv_enabled=s.iv_enabled,
            device=device,
        )
        if slots0 is None:
            slots0, pa0 = slots, pa_slots
        elif slots != slots0 or pa_slots != pa0:
            raise ValueError(
                f"scenario '{s.name}' intervention structure "
                f"{slots + pa_slots} differs from batch structure "
                f"{slots0 + pa0}; ensembles vary thresholds/factors/"
                "enabled, not slot kinds"
            )
        params_list.append(params)
    return slots0, pa0, params_list


def no_op_params(params: sim_lib.SimParams) -> sim_lib.SimParams:
    """An epidemiologically inert SimParams with the same structure: zero
    betas, zero outbreak seeding, every intervention slot disabled. A
    scenario run with these never seeds or infects anyone — the filler for
    padded batch slots."""
    return dataclasses.replace(
        params,
        beta_sus=torch.zeros_like(params.beta_sus),
        beta_inf=torch.zeros_like(params.beta_inf),
        seed_per_day=torch.zeros_like(params.seed_per_day),
        seed_days=torch.zeros_like(params.seed_days),
        iv=dataclasses.replace(
            params.iv,
            enabled=torch.zeros_like(params.iv.enabled),
            pa_enabled=torch.zeros_like(params.iv.pa_enabled),
        ),
    )


def pad_batch(batch: ScenarioBatch, multiple: int) -> ScenarioBatch:
    """Pad a batch to a multiple of ``multiple`` by repeating the final
    scenario under ``__pad`` names. The *params* of pad slots are replaced
    by :func:`no_op_params` when built; the repeated scenario only supplies
    the structure."""
    pad = (-len(batch)) % multiple
    if pad == 0:
        return batch
    filler = tuple(
        dataclasses.replace(batch[-1], name=f"__pad{i}") for i in range(pad)
    )
    return ScenarioBatch(scenarios=batch.scenarios + filler)


def local_week_arrays(pop: pop_lib.Population, week: inter_lib.WeekData,
                      *, device) -> dict:
    """The day step's ``week`` dict on ``device``: the stacked (7, ...)
    schedule, per-visit contact probabilities (location attributes are
    static, so gathered once) and the combine's person-slot table, shared
    by every scenario of a batch."""
    return inter_lib.week_from_numpy({
        "pid": week.pid, "loc": week.loc, "start": week.start, "end": week.end,
        "p": pop.contact_prob[week.loc], "row": week.row_idx,
        "col": week.col_idx, "rs": week.row_start, "pa": week.pair_active,
    }, pop.num_people, device=device)


# ---------------------------------------------------------------------------
# stacked-dataclass helpers
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the tensors of identically structured ``SimParams`` /
    ``SimState`` / ``IvParams`` dataclasses (nested), rebuilding the type."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)
        })
    return fn(*trees)


def stack_params(params_list: Sequence) -> object:
    """Stack identically structured dataclasses on a new leading batch axis."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def index_params(batched, i: int):
    """Slice scenario ``i`` back out of a stacked dataclass (inverse of
    :func:`stack_params`)."""
    return tree_map(lambda x: x[i], batched)


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------


class EngineCore:
    """One ScenarioBatch on one device, ready to run.

    ``layout`` is ``"local"``: the batch's B scenarios run as one batched
    day loop on ``device`` (single runs are B = 1)."""

    def __init__(
        self,
        pop: pop_lib.Population,
        batch: Union[ScenarioBatch, Sequence[Scenario]],
        *,
        layout: str = "local",
        block_size: int = 128,
        device="cuda",
        backend: str = "pallas-compact",
    ):
        if layout not in LAYOUTS:
            raise NotImplementedError(
                f"layout '{layout}' is not ported: the port places a batch on "
                "one device ('local'); the mesh layouts are ROADMAP queue 1 "
                "item 4 (multiple GPUs)")
        iops.check_backend(backend)
        self.device = resolve_device(device)
        self.pop = pop
        self.batch = as_batch(batch)
        self.num_real = len(self.batch)
        self.layout = layout
        self.block_size = block_size
        self.iv_slots, self.pa_slots, params_list = build_batch_params(
            pop, self.batch, device=self.device)
        self.params = stack_params(params_list)
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
        """A one-scenario core in one call; ``core_kw`` passes the placement
        fields (``block_size``, ``device``, ``backend``); pair with
        :meth:`run1` for unbatched results."""
        scen = Scenario(
            name=name, disease=disease,
            tm=tm if tm is not None else tx_lib.TransmissionModel(),
            interventions=tuple(interventions),
            iv_enabled=tuple(iv_enabled), seed=seed,
            seed_per_day=seed_per_day, seed_days=seed_days,
            static_network=static_network,
        )
        return cls(pop, [scen], **core_kw)

    def init_state(self) -> sim_lib.SimState:
        """The batch's stacked initial state on the core's device."""
        return stack_params([
            sim_lib.init_state(s.disease, self.pop.num_people, len(self.iv_slots),
                               device=self.device)
            for s in self.batch
        ])

    def scenario_params(self, i: int) -> sim_lib.SimParams:
        """Scenario ``i``'s un-stacked params."""
        return index_params(self.params, i)

    def run_days(
        self,
        days: int,
        *,
        params: Optional[sim_lib.SimParams] = None,
        state: Optional[sim_lib.SimState] = None,
        observables: tuple = (),
        carries: tuple = (),
    ):
        """Run ``days`` days with no host sync. ``params``/``state`` (stacked)
        substitute other same-structure ones, of any batch width.

        Returns ``(final_state, carries, hist, dailies)``, all on the
        device: ``hist`` a (days, len(STAT_KEYS), B) int64 tensor over the
        core's real scenarios (pad slots sliced off), ``carries``/``dailies``
        the observables' reductions (:func:`repro_torch.engine.day.run_days`)."""
        final, carries, hist, dailies = day_lib.run_days(
            self.topo, self.static, self.week,
            params if params is not None else self.params,
            state if state is not None else self.init_state(),
            days, tuple(observables), carries, self.num_real,
        )
        return final, carries, hist[..., :self.num_real], dailies

    def run(self, days: int, *, state=None, params=None):
        """``(final_state, hist)`` over the batch: ``hist`` maps STAT_KEYS to
        host ``(days, B)`` arrays; pad slots dropped from both."""
        final, _, hist, _ = self.run_days(days, state=state, params=params)
        return index_params(final, slice(0, self.num_real)), hist_to_numpy(hist)

    def run1(
        self,
        days: int,
        *,
        state: Optional[sim_lib.SimState] = None,
        params: Optional[sim_lib.SimParams] = None,
    ):
        """B = 1 convenience: :meth:`run` with the scenario axis squeezed.
        Takes and returns *unbatched* state/params; ``hist`` arrays are
        ``(days,)``."""
        if self.num_real != 1:
            raise ValueError("run1() needs a batch of exactly 1")
        add_b = lambda t: None if t is None else stack_params([t])
        final, hist = self.run(days, state=add_b(state), params=add_b(params))
        return index_params(final, 0), {k: v[:, 0] for k, v in hist.items()}

    def init_state1(self) -> sim_lib.SimState:
        """Unbatched initial state (B = 1 cores; pairs with :meth:`run1`)."""
        if self.num_real != 1:
            raise ValueError("init_state1() needs a batch of exactly 1")
        return index_params(self.init_state(), 0)


def hist_to_numpy(hist: torch.Tensor) -> dict:
    """(days, len(STAT_KEYS), B) history tensor -> {stat: (days, B) array}."""
    h = hist.cpu().numpy()
    return {k: np.ascontiguousarray(h[:, i]) for i, k in enumerate(day_lib.STAT_KEYS)}


# ---------------------------------------------------------------------------
# the run loop (one chunk) and its drivers
# ---------------------------------------------------------------------------


def concat_hists(hists: list) -> dict:
    return {k: np.concatenate([h[k] for h in hists], axis=0) for k in hists[0]}


def concat_dailies(chunks: list):
    """Day-major per-chunk observable outputs (nested dicts of arrays)
    joined along the day axis."""
    first = chunks[0]
    if isinstance(first, dict):
        return {k: concat_dailies([c[k] for c in chunks]) for k in first}
    if isinstance(first, tuple):
        return first  # an observable without a per-day series
    return np.concatenate(chunks, axis=0)


def run_chunked(driver, days: int, observables: tuple, ctx, *, manager=None):
    """Run ``days`` days through ``driver`` and return ``(state, hist,
    carries, dailies, resumed_from, num_chunks)``, the reference's
    ``repro.engine.core.run_chunked`` tuple.

    ``driver`` has ``init_state()``, ``run_chunk(n, state, carries) ->
    (state, hist, carries, dailies)`` and an ``in_scan`` flag (False for
    the sequential driver, whose observables replay after the run). The run
    is one chunk: a checkpoint ``manager`` (day-chunked checkpoints and
    resume) is ROADMAP queue 1 item 3 and raises."""
    from repro_torch.api import observables as obs_lib  # cycle-free at call time

    if manager is not None:
        raise NotImplementedError(
            "checkpointed, chunked runs are not ported: ROADMAP queue 1 item 3 "
            "(chunked runs and resilience)")
    state = driver.init_state()
    carries = obs_lib.init_carries(observables, ctx) if driver.in_scan else None
    state, hist, carries, dailies = driver.run_chunk(days, state, carries)
    hist = concat_hists([hist])
    dailies = concat_dailies([dailies]) if dailies is not None else None
    return state, hist, carries, dailies, None, 1


class CoreDriver:
    """The whole batch in one day loop on the core's device, so the
    observable updates run inside the loop."""

    in_scan = True

    def __init__(self, core: EngineCore, observables: tuple):
        self.core = core
        self.observables = tuple(observables)

    def init_state(self):
        return self.core.init_state()

    def run_chunk(self, n, state, carries):
        from repro_torch.api import observables as obs_lib  # cycle-free at call time

        state, carries, hist, dailies = self.core.run_days(
            n, state=state, observables=self.observables, carries=carries)
        return (state, hist_to_numpy(hist), carries,
                obs_lib.observables_to_numpy(dailies))


class SequentialDriver:
    """One scenario at a time through B = 1 slices of the core's params —
    the pinned ``single`` engine with B > 1. Cross-scenario observables
    cannot live inside per-scenario loops, so they replay after the run
    (``in_scan = False``)."""

    in_scan = False

    def __init__(self, core: EngineCore):
        self.core = core
        self.params_list = [
            index_params(core.params, slice(i, i + 1)) for i in range(core.num_real)
        ]

    def init_state(self):
        return self.core.init_state()

    def run_chunk(self, n, state, carries):
        finals, hists = [], []
        for i, params_i in enumerate(self.params_list):
            state_i = index_params(state, slice(i, i + 1))
            f, _, h, _ = self.core.run_days(n, params=params_i, state=state_i)
            finals.append(f)
            hists.append(h)
        state = tree_map(lambda *xs: torch.cat(xs), *finals)
        return state, hist_to_numpy(torch.cat(hists, dim=-1)), carries, None
