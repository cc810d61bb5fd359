"""EngineCore: a scenario batch placed on one device, ready to run.

``repro_torch.engine.day.run_days`` is the one day loop; this module owns
everything around it, as the reference's ``repro.engine.core`` does:

  * **building** — one path compiles a :class:`ScenarioBatch` into stacked
    ``SimParams``/``SimState`` (leading scenario axis B, B = 1 included)
    plus the week's device arrays the step consumes;
  * **placement** — four layouts, four topologies (``engine/topology.py``):
    ``local``, the whole batch on one device, every op of the day over
    ``(B, ...)`` and one interaction-kernel launch a day; and on a process
    mesh (``launch/mesh.py``), ``workers`` (each scenario's people and
    locations split over W ranks by the reference's partition,
    ``core/simulator_dist.py``), ``scenarios`` (the batch split over S
    ranks) and ``hybrid`` (both). Every rank builds the same plan, keeps
    only its shard of the params, the state and the week, and launches the
    interaction kernel once a day for its shard of the batch; every layout
    is bitwise equal to ``local``;
  * **warm runners** — :meth:`EngineCore.runner_fn` is the reference's
    compile-once seam: one :class:`~repro_torch.engine.runner.DayRunner`
    per ``(days, observables)`` key in a :class:`BoundedLRU`, on the card
    a captured CUDA graph of the ``days``-day batched loop, replayed for
    every call of the same shapes (the serving tier's warm bucket).
    :meth:`EngineCore.run_days` stays the eager loop;
  * **chunking** — :func:`run_chunked` drives a run through a
    :class:`CoreDriver` (the batch in one loop, observables inside it) or a
    :class:`SequentialDriver` (one scenario at a time, observables replayed
    after the run): one chunk, or with a checkpoint manager ``every``-day
    chunks with a snapshot at each boundary and a bitwise resume from the
    newest valid one. Snapshots are taken and restored at chunk boundaries
    only, so they synchronise with the card there and never inside the day
    loop.

Scenario padding is *inert*: :func:`pad_batch` fills a batch with copies of
its last scenario (to a multiple of the scenario shards), and
:func:`no_op_params` gives them zero betas, zero seeding and every
intervention slot disabled, so nobody is seeded or infected there and their
live-tile count is 0. Padded slots come last and are sliced off before any
history or observable sees them.

On a mesh, :meth:`EngineCore.run_days` takes and returns this rank's shard
of the state and the whole batch's history (every rank the same);
:meth:`EngineCore.shard_state` and :meth:`EngineCore.gather_state` move
between a shard and the whole state (real scenarios, the person axis padded
to ``W * Pw``), which is what the chunk loop carries, checkpoints and
restores: rank 0 writes a snapshot, the other ranks wait at a barrier, and
every rank takes its shard of a restored one (``adopt_state`` re-pads a
person axis written for another worker count, so a checkpoint moves between
layouts).

The device defaults to ``"cuda"`` and a missing card is an error, never a
silent fall back to the CPU; tests pass ``device="cpu"``. ``backend`` picks
the interaction pass by the reference's names: ``"pallas-compact"`` (the
default) or ``"pallas"``; both give bitwise-equal runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointCorruptionError
from repro_torch.configs.sweep import Scenario, ScenarioBatch
from repro_torch.core import interactions as inter_lib
from repro_torch.core import interventions as iv_lib
from repro_torch.core import population as pop_lib
from repro_torch.core import simulator as sim_lib
from repro_torch.core import simulator_dist as sd
from repro_torch.core import transmission as tx_lib
from repro_torch.engine import day as day_lib
from repro_torch.engine.cache import BoundedLRU
from repro_torch.engine.runner import DayRunner
from repro_torch.engine.topology import make_topology
from repro_torch.kernels.interactions import ops as iops
from repro_torch.launch import mesh as mesh_lib

LAYOUTS = ("local", "workers", "scenarios", "hybrid")
#: The mesh axes each layout shards (the reference's mesh axis names).
LAYOUT_AXES = {"local": (), "workers": ("workers",), "scenarios": ("scenarios",),
               "hybrid": ("workers", "scenarios")}
#: SimParams / IvParams fields with a person axis (last).
PERSON_PARAM_FIELDS = ("beta_sus", "beta_inf", "people", "pa_people")

#: Engine-core generation marker (the reference's, for the same history
#: keys and state fields): part of every resume key, beside the package's
#: name (``api/runner.py:_resume_key``), since the two packages' trajectories
#: are not bitwise equal.
CORE_VERSION = "engine-v3"

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(sim_lib.SimState))

#: SimState fields with a person axis (last) — the leaves an elastic
#: repartition must re-pad when the worker count changes.
PERSON_STATE_FIELDS = ("health", "dwell", "vaccinated", "tested", "traced",
                       "isolated_until")


class ResumeKeyError(ValueError):
    """A checkpoint exists but must not be resumed from under this spec
    (incompatible science, engine generation or package, or beyond the run
    length). A config error, not a fault — the resilient loop never retries
    it."""


def state_to_tree(state: sim_lib.SimState) -> dict:
    """SimState -> plain dict (stable checkpoint key paths)."""
    return {f: getattr(state, f) for f in _STATE_FIELDS}


def state_from_flat(flat: dict, template: sim_lib.SimState,
                    num_people: Optional[int] = None) -> sim_lib.SimState:
    """The ``state/<field>`` leaves of a checkpoint as a SimState on
    ``template``'s device (an ``EngineCore.full_init_state()``). Every leaf
    must have the template's dtype and shape — except that a person axis may
    have another length of at least ``num_people`` (default: the template's;
    padded for another worker count; ``EngineCore.adopt_state`` re-pads it)
    — or :class:`CheckpointCorruptionError` is raised: nothing is cast."""
    out = {}
    for f in _STATE_FIELDS:
        key, like = f"state/{f}", getattr(template, f)
        if key not in flat:
            raise CheckpointCorruptionError(f"leaf '{key}' is not in the checkpoint")
        t = torch.as_tensor(flat[key])
        if t.dtype != like.dtype:
            raise CheckpointCorruptionError(
                f"leaf '{key}' has dtype {t.dtype}, the engine's state has {like.dtype}")
        person = f in PERSON_STATE_FIELDS and t.dim() == like.dim() >= 1
        least = like.shape[-1] if num_people is None else num_people
        if not (t.shape == like.shape or person and t.shape[:-1] == like.shape[:-1]
                and t.shape[-1] >= least):
            raise CheckpointCorruptionError(
                f"leaf '{key}' has shape {tuple(t.shape)}, the engine's state has "
                f"{tuple(like.shape)}")
        out[f] = t.to(like.device)
    return sim_lib.SimState(**out)


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
    """One ScenarioBatch placed on one device or a process mesh, ready to run.

    ``layout`` picks the placement (the reference's four):

      * ``"local"`` — the batch's B scenarios as one batched day loop on
        ``device`` (single runs are B = 1);
      * ``"workers"`` — each scenario's people and locations split over the
        mesh's W workers;
      * ``"scenarios"`` — the batch split over the mesh's S shards;
      * ``"hybrid"`` — both, on a ``W x S`` mesh.

    A mesh layout runs on every rank of an initialised process group: pass
    ``mesh`` (a :class:`~repro_torch.launch.mesh.WorkerMesh` with the
    layout's axes) or let the core make one over the whole group
    (``workers`` / ``scen_shards``, default: the world size; ``workers`` for
    ``hybrid``). Outside a fitting group it raises, naming
    ``repro_torch.launch.mesh.spawn`` and ``torchrun``. The people and
    locations are split by the paper's load-balanced location partition;
    ``plan`` passes a :class:`~repro_torch.core.simulator_dist.DistPlan`
    already built for this population and worker count (cores of one
    population share it). ``plan_build_s`` is the host seconds this rank
    spent on the plan and its tables.

    ``max_runners`` bounds the warm runners held (one per ``(days,
    observables)`` key, LRU-evicted beyond it; ``None`` = unbounded).
    ``max_seed_per_day`` is the reference's static seeding top-k width: the
    candidates each worker contributes to the seeding threshold (default:
    the batch's largest ``seed_per_day``); the local layout sorts and does
    not need it."""

    def __init__(
        self,
        pop: pop_lib.Population,
        batch: Union[ScenarioBatch, Sequence[Scenario]],
        *,
        layout: str = "local",
        mesh=None,
        workers: Optional[int] = None,
        scen_shards: Optional[int] = None,
        plan: Optional[sd.DistPlan] = None,
        block_size: int = 128,
        device="cuda",
        backend: str = "pallas-compact",
        max_seed_per_day: Optional[int] = None,
        max_runners: Optional[int] = 8,
    ):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got '{layout}'")
        iops.check_backend(backend)
        self.device = resolve_device(device)
        self.pop = pop
        self.batch = as_batch(batch)
        self.num_real = len(self.batch)
        self.layout = layout
        self.mesh = _resolve_mesh(layout, mesh, workers, scen_shards)
        axes = LAYOUT_AXES[layout]
        self.workers = self.mesh.workers if "workers" in axes else 1
        self.scen_shards = self.mesh.scenarios if "scenarios" in axes else 1
        self.padded = pad_batch(self.batch, self.scen_shards)
        self.block_size = block_size
        self.max_seed_per_day = max_seed_per_day
        self.iv_slots, self.pa_slots, params_list = build_batch_params(
            pop, self.padded, device=self.device)
        # Pad slots carry inert params: nothing is seeded or infected there.
        for i in range(self.num_real, len(self.padded)):
            params_list[i] = no_op_params(params_list[i])
        t0 = time.perf_counter()
        if "workers" in axes:
            if plan is None:
                plan = sd.build_dist_plan(pop, self.workers, block_size)
            elif (plan.num_workers, plan.block_size, plan.num_people) != (
                    self.workers, block_size, pop.num_people):
                raise ValueError(
                    f"plan for {plan.num_workers} workers, block {plan.block_size}, "
                    f"{plan.num_people} people does not fit this core")
            self.plan = plan
            self.week = sd.week_device_arrays(self.plan, self.mesh.worker_index,
                                              device=self.device)
            params_list = [sd.pad_params(p, self.plan) for p in params_list]
            self.people_per_worker = self.plan.people_per_worker
        else:
            self.plan = None
            self.week = local_week_arrays(
                pop, inter_lib.build_week_data(pop, block_size), device=self.device)
            self.people_per_worker = pop.num_people
        self.plan_build_s = time.perf_counter() - t0
        self.params = self._shard(stack_params(params_list), PERSON_PARAM_FIELDS)
        Pw = self.people_per_worker
        max_spd = (max_seed_per_day if max_seed_per_day is not None
                   else max(s.seed_per_day for s in self.padded))
        # The test budget's per-worker candidates: the largest daily capacity
        # any scenario asks for (MeshTopology.rank_threshold is exact as long
        # as it covers min(budget, Pw)).
        max_tests = max([iv.tests_per_day for s in self.padded for iv in s.interventions
                         if isinstance(iv, iv_lib.TestTraceIsolate)] or [1])
        self.topo = make_topology(self.mesh, seed_topk=max(1, min(int(max_spd), Pw)),
                                  test_topk=max(1, min(int(max_tests), Pw)))
        self.static = day_lib.EngineStatic(
            num_people=pop.num_people,
            num_locations=pop.num_locations,
            block_size=block_size,
            iv_slots=self.iv_slots,
            pa_slots=self.pa_slots,
            backend=backend,
        )
        self._full_init = None
        self._runners = BoundedLRU(max_entries=max_runners)

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
        fields (``layout``, ``mesh``, ``workers``, ``block_size``,
        ``device``, ``backend``, ...); pair with :meth:`run1` for unbatched
        results."""
        scen = Scenario(
            name=name, disease=disease,
            tm=tm if tm is not None else tx_lib.TransmissionModel(),
            interventions=tuple(interventions),
            iv_enabled=tuple(iv_enabled), seed=seed,
            seed_per_day=seed_per_day, seed_days=seed_days,
            static_network=static_network,
        )
        return cls(pop, [scen], **core_kw)

    # ------------------------------------------------------------------
    # shards: this rank's slice of the scenario and person axes
    # ------------------------------------------------------------------

    def _shard(self, tree, person_fields):
        """This rank's slice of a stacked dataclass over the padded batch:
        its scenario slice, and its worker's people on ``person_fields``."""
        if self.mesh is None:
            return tree
        Bs = len(self.padded) // self.scen_shards
        s0 = self.mesh.scenario_index * Bs if self.scen_shards > 1 else 0
        Pw = self.people_per_worker
        p0 = self.mesh.worker_index * Pw if self.workers > 1 else 0

        def cut(t, name):
            t = t[s0:s0 + Bs]
            return t[..., p0:p0 + Pw] if name in person_fields else t

        def walk(obj):
            return type(obj)(**{
                f.name: walk(v) if dataclasses.is_dataclass(v) else cut(v, f.name)
                for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})

        return walk(tree)

    def full_init_state(self) -> sim_lib.SimState:
        """The whole initial state: the real scenarios, the person axis padded
        to ``W * Pw`` (pad people absorbing), on the core's device. On one
        device, :meth:`init_state`."""
        if self.mesh is None:
            return self.init_state()
        return index_params(self._padded_init(), slice(0, self.num_real))

    def _padded_init(self) -> sim_lib.SimState:
        """The initial state of every slot of the padded batch, on the whole
        (worker-padded) person axis; built once."""
        if self._full_init is None:
            K = len(self.iv_slots)

            def one(s):
                if self.plan is None:
                    return sim_lib.init_state(s.disease, self.pop.num_people, K,
                                              device=self.device)
                return sd.init_state_padded(s.disease, self.plan, K, device=self.device)

            self._full_init = stack_params([one(s) for s in self.padded])
        return self._full_init

    def init_state(self) -> sim_lib.SimState:
        """This rank's shard of the initial state (the whole batch's on one
        device), stacked, on the core's device."""
        if self.mesh is None:
            return stack_params([
                sim_lib.init_state(s.disease, self.pop.num_people, len(self.iv_slots),
                                   device=self.device)
                for s in self.batch
            ])
        return self._shard(self._padded_init(), PERSON_STATE_FIELDS)

    def shard_state(self, state: sim_lib.SimState) -> sim_lib.SimState:
        """A whole state (real scenarios, or the padded batch; this core's
        person axis) -> this rank's shard. Pad scenarios missing from
        ``state`` start from the initial state at the batch's day (they are
        inert and never surface). Identity on one device."""
        if self.mesh is None:
            return state
        B, tmpl = state.day.shape[0], self._padded_init()
        if self.scen_shards > 1 and B < len(self.padded):
            day = state.day[:1].expand(len(self.padded) - B)
            pad = dataclasses.replace(index_params(tmpl, slice(B, None)), day=day)
            state = tree_map(lambda a, b: torch.cat([a, b]), state, pad)
        return self._shard(state, PERSON_STATE_FIELDS)

    def gather_state(self, shard: sim_lib.SimState) -> sim_lib.SimState:
        """This rank's shard -> the whole state, real scenarios only, the same
        on every rank (collectives over the mesh, counted by the topology).
        Identity on one device."""
        if self.mesh is None:
            return shard
        topo, m = self.topo, self.mesh

        def gather(name, x):
            if self.workers > 1 and name in PERSON_STATE_FIELDS:
                x = topo.all_gather(x, m.worker_group, m.workers, dim=-1)
            if self.scen_shards > 1:
                x = topo.all_gather(x, m.scenario_group, m.scenarios, dim=0)
            return x[:self.num_real]

        return sim_lib.SimState(**{f: gather(f, getattr(shard, f)) for f in _STATE_FIELDS})

    def scenario_params(self, i: int) -> sim_lib.SimParams:
        """Scenario ``i``'s un-stacked params (on a mesh: of this rank's
        shard)."""
        return index_params(self.params, i)

    def adopt_state(self, state: sim_lib.SimState) -> sim_lib.SimState:
        """Re-home a whole SimState (possibly from another worker layout) onto
        this core's person axis, ``W * Pw`` — the elastic-degradation seam. A
        state already in this layout passes through untouched; person
        leaves padded for another worker count are repartitioned with
        :func:`repro_torch.runtime.elastic.repartition_person_array` (real
        people occupy the first ``num_people`` flat slots in every layout),
        pad entries filled from :meth:`full_init_state`'s last person."""
        from repro_torch.runtime.elastic import (
            plan_elastic_rescale, repartition_person_array,
        )

        tmpl = self.full_init_state()
        P = self.pop.num_people
        new_layout = plan_elastic_rescale(P, self.workers, self.workers)[1]
        ppad_new = new_layout["workers"] * new_layout["per_worker"]

        def adopt(name):
            old, t = getattr(state, name), getattr(tmpl, name)
            if name not in PERSON_STATE_FIELDS or old.shape == t.shape:
                return old
            if old.dim() < 2 or old.shape[0] != t.shape[0]:
                raise ValueError(
                    f"adopt_state: cannot re-home leaf '{name}' of shape "
                    f"{tuple(old.shape)} onto batch template {tuple(t.shape)}")
            old_h, t_h = old.cpu().numpy(), t.cpu().numpy()
            new = np.stack([
                repartition_person_array(old_h[i], P, self.workers,
                                         fill=t_h[i, -1] if ppad_new > P else 0).reshape(-1)
                for i in range(old_h.shape[0])])
            if new.shape != t_h.shape:
                raise ValueError(f"adopt_state: '{name}' re-homed to {new.shape}, "
                                 f"expected {t_h.shape}")
            return torch.as_tensor(new, device=self.device)

        return sim_lib.SimState(**{f: adopt(f) for f in _STATE_FIELDS})

    # ------------------------------------------------------------------
    # warm runners (the serving tier's compile-once seam)
    # ------------------------------------------------------------------

    def _runner(self, days: int, observables: tuple) -> DayRunner:
        key = (days, observables)
        cached = self._runners.get(key)
        if cached is not None:
            return cached
        topo, static, week, num_real = self.topo, self.static, self.week, self.num_real

        def run(params, state, carries):
            return day_lib.run_days(topo, static, week, params, state, days,
                                    observables, carries, num_real)

        runner = DayRunner(run, self.device, capture=self.mesh is None)
        self._runners.put(key, runner)
        return runner

    def runner_fn(self, days: int, observables: tuple = ()) -> DayRunner:
        """The warm runner for ``(days, observables)``, made (and cached)
        on first request: ``runner(params, state, carries=()) ->
        (final_state, carries, hist, dailies)`` over every slot of the
        batch, ``hist`` (days, len(STAT_KEYS), B) on the device. On the
        card its first call of a shape captures a CUDA graph and later calls
        replay it. On a mesh layout it is the eager loop: a graph cannot
        hold the day's ``torch.distributed`` collectives, so the serving tier
        stays on the local layout. Public so the serving
        tier wraps the steady-state loop in
        :class:`repro_torch.analysis.capture.recompile_sentinel` around the
        runner that actually runs."""
        return self._runner(days, tuple(observables))

    def runner_cached(self, days: int, observables: tuple = ()) -> bool:
        """Whether the ``(days, observables)`` runner is resident and built
        (on the card: captured), without a recency bump or stats churn —
        the warm/cold probe."""
        runner = self._runners.peek((days, tuple(observables)))
        return runner is not None and runner.cache_size() > 0

    def runner_cache_stats(self) -> dict:
        """Size/budget and lifetime hit/miss/eviction counts of the runner
        cache (:class:`repro_torch.engine.cache.BoundedLRU`)."""
        return self._runners.stats()

    def bench_fn(self, days: int, observables: tuple = ()):
        """A zero-argument timed callable: the whole ``days``-day runner
        from the initial state, returning a device tensor (the final day),
        so a timer that synchronises measures the loop, not a host copy of
        the history."""
        from repro_torch.api import observables as obs_lib  # cycle-free at call time

        observables = tuple(observables)
        runner = self._runner(days, observables)
        params, state = self.params, self.init_state()
        carries = obs_lib.init_carries(observables, obs_lib.ObsContext(
            num_people=self.pop.num_people, num_scenarios=self.num_real,
            device=str(self.device))) if observables else ()
        return lambda: runner(params, state, carries)[0].day

    def run_days(
        self,
        days: int,
        *,
        params: Optional[sim_lib.SimParams] = None,
        state: Optional[sim_lib.SimState] = None,
        observables: tuple = (),
        carries: tuple = (),
    ):
        """Run ``days`` days with no host sync. ``params``/``state`` (stacked;
        on a mesh, this rank's shards) substitute other same-structure ones,
        of any batch width.

        Returns ``(final_state, carries, hist, dailies)``, all on the
        device: ``final_state`` this rank's shard, ``hist`` a (days,
        len(STAT_KEYS), B) int64 tensor over the core's real scenarios (pad
        slots sliced off; the same on every rank), ``carries``/``dailies``
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
        host ``(days, B)`` arrays; pad slots dropped from both. ``state`` and
        the result are whole states (on a mesh: gathered, person axis padded
        to ``W * Pw``); ``params`` this rank's shard, as ``self.params``."""
        final, _, hist, _ = self.run_days(
            days, state=None if state is None else self.shard_state(state), params=params)
        final = self.gather_state(final)
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
        """Unbatched whole initial state (B = 1 cores; pairs with
        :meth:`run1`)."""
        if self.num_real != 1:
            raise ValueError("init_state1() needs a batch of exactly 1")
        return index_params(self.full_init_state(), 0)

    # ------------------------------------------------------------------
    # the mesh's checkpoint roles
    # ------------------------------------------------------------------

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes snapshots: rank 0 (the only rank on one
        device)."""
        return self.mesh is None or self.mesh.rank == 0

    def barrier(self, manager=None) -> None:
        """Wait for every rank of the mesh, once ``manager``'s write in flight
        (the writer's) is on disk. Nothing on one device."""
        if self.mesh is not None:
            if manager is not None:
                manager.wait()
            dist.barrier(group=self.mesh.world_group)

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the mesh: one integer
        ``all_reduce(MAX)`` over the mesh's ranks, which every rank must
        call, whatever its flag (on one device, ``flag``). It is a
        chunk-boundary vote, outside the day's counted schedule."""
        if self.mesh is None:
            return bool(flag)
        # gloo reduces host tensors; nccl only the card's
        dev = self.device if self.mesh.backend == "nccl" else torch.device("cpu")
        x = torch.full((1,), int(bool(flag)), dtype=torch.int64, device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.mesh.world_group)
        return bool(x.item())


def _resolve_mesh(layout: str, mesh, workers, scen_shards):
    """The layout's :class:`~repro_torch.launch.mesh.WorkerMesh`: ``mesh`` if
    given (its axes must be the layout's), else one made over the whole
    process group. None for ``local``."""
    axes = LAYOUT_AXES[layout]
    if not axes:
        if mesh is not None or (workers or 1) != 1 or (scen_shards or 1) != 1:
            raise ValueError(f"the local layout takes no mesh, got mesh={mesh}, "
                             f"workers={workers}, scen_shards={scen_shards}")
        return None
    if mesh is None:
        if layout == "workers":
            mesh = mesh_lib.make_worker_mesh(workers)
        elif layout == "scenarios":
            mesh = mesh_lib.make_scenario_mesh(scen_shards)
        else:
            if workers is None:
                raise ValueError("the hybrid layout needs workers=")
            mesh = mesh_lib.make_hybrid_mesh(workers, scen_shards)
    if tuple(mesh.axis_names) != axes:
        raise ValueError(f"layout '{layout}' expects mesh axes {axes}, "
                         f"got {tuple(mesh.axis_names)}")
    return mesh


def hist_to_numpy(hist: torch.Tensor) -> dict:
    """(days, len(STAT_KEYS), B) history tensor -> {stat: (days, B) array}."""
    h = hist.cpu().numpy()
    return {k: np.ascontiguousarray(h[:, i]) for i, k in enumerate(day_lib.STAT_KEYS)}


# ---------------------------------------------------------------------------
# the day-chunked checkpoint/resume loop and its drivers
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


def _hist_from_flat(flat: dict, step: int) -> dict:
    """The ``hist/<stat>`` leaves of a checkpoint at ``step``: int64
    ``(step, B)`` arrays, as the chunks return them, or a corruption error."""
    hist = {}
    for k in day_lib.STAT_KEYS:
        v = flat.get(f"hist/{k}")
        if v is None or v.dtype != np.int64 or v.ndim != 2 or v.shape[0] != step:
            raise CheckpointCorruptionError(
                f"step {step}: history leaf 'hist/{k}' is "
                + ("missing" if v is None else f"{v.dtype} {v.shape}")
                + f", expected int64 ({step}, B)")
        hist[k] = v
    return hist


def run_chunked(driver, days: int, observables: tuple, ctx, *, manager=None,
                every: int = 50, resume: bool = True,
                resume_key: Optional[dict] = None, hooks=None):
    """Run ``days`` days through ``driver`` in ``every``-day chunks,
    checkpointing state + history-so-far at each boundary and resuming
    bitwise from the newest compatible checkpoint (the reference's
    ``repro.engine.core.run_chunked``). Without a ``manager`` the run is
    one chunk.

    ``driver`` has ``init_state()``, ``run_chunk(n, state, carries) ->
    (state, hist, carries, dailies)``, ``adapt_state(state)``, its ``core``
    and an ``in_scan`` flag (False for the sequential driver, whose
    observables replay after the run). The state it carries is the whole
    state (``EngineCore.gather_state``), the same on every rank of a mesh,
    so hooks decide alike everywhere; rank 0 writes the snapshots. Observable carries are never checkpointed: on
    resume the pure updates replay over the restored history, which gives
    the carries bitwise (``api/observables.py:scan_history``).

    Resume picks the newest snapshot that passes integrity verification
    (corrupt ones are quarantined by the manager); its resume key must
    equal ``resume_key`` and its day must not pass ``days``, or
    :class:`ResumeKeyError` is raised. The restored state has the dtype and
    shape of ``driver.init_state()``, up to its person axis
    (:func:`state_from_flat`), and passes through ``driver.adapt_state``.

    ``hooks`` (see :mod:`repro_torch.runtime.resilience`) observes the loop
    at chunk granularity: ``on_restore(day, seconds)`` once a snapshot is
    restored (verified, read and re-homed), ``on_start(state, day)``,
    ``before_chunk(day, n)``, ``after_chunk(end_day, state, dt) -> state``
    (called *before* the boundary snapshot, so invariant guards can veto a
    poisoned state reaching disk; ``dt`` ends with the chunk's history copy
    to the host, so it times the device's work), ``after_save(day)``. Hook exceptions
    propagate — they are the fault-injection and guard-violation surface.

    Returns ``(state, hist, carries, dailies, resumed_from, num_chunks)``.
    """
    from repro_torch.api import observables as obs_lib  # cycle-free at call time

    state, carries, hists, daily_chunks = None, None, [], []
    day, resumed_from = 0, None
    core = driver.core
    step = None
    if manager is not None and resume:
        # On a mesh the writer verifies (and quarantines) first; the other
        # ranks then read what it left, so all restore the same step.
        step = manager.latest_valid_step() if core.is_writer else None
        core.barrier()
        if not core.is_writer:
            step = manager.latest_valid_step(quarantine=False)
    if step is not None:
        if step > days:
            raise ResumeKeyError(
                f"checkpoint at day {step} is beyond spec.days={days}")
        saved_key = manager.manifest(step).get("extra", {}).get("resume_key")
        if saved_key != resume_key:
            raise ResumeKeyError(
                f"checkpoint at day {step} in {manager.directory} was "
                + ("written by an incompatible spec or engine generation "
                   "(different parameters, sweep axes, mesh, package or "
                   "device, or another engine)" if saved_key is not None
                   else "not written by api.run (no resume_key in its "
                        "manifest)")
                + "; refusing to splice trajectories — point "
                "checkpoint.directory elsewhere or set "
                "checkpoint.resume=false")
        t0 = time.perf_counter()
        flat = manager.restore_flat(step)
        state = driver.adapt_state(
            state_from_flat(flat, driver.init_state(), core.pop.num_people))
        if hooks is not None:
            hooks.on_restore(step, time.perf_counter() - t0)
        hists = [_hist_from_flat(flat, step)]
        if driver.in_scan:
            # Replay the pure reductions over the restored history so the
            # carries continue exactly where the interrupted loop left off.
            carries, pre = obs_lib.scan_history(observables, hists[0], ctx)
            daily_chunks = [pre] if pre is not None else []
        day, resumed_from = step, step
    if state is None:
        state = driver.init_state()
    if carries is None and driver.in_scan:
        carries = obs_lib.init_carries(observables, ctx)
    if hooks is not None:
        hooks.on_start(state, day)

    chunk = every if manager is not None else days
    num_chunks = 0
    while day < days:
        n = min(chunk, days - day)
        t0 = time.perf_counter()
        if hooks is not None:
            hooks.before_chunk(day, n)
        state, hist, carries, dl = driver.run_chunk(n, state, carries)
        if hooks is not None:
            # May raise (guard veto of a poisoned state) — nothing below
            # runs, so the poison is never appended or checkpointed.
            state = hooks.after_chunk(day + n, state, time.perf_counter() - t0)
        hists.append(hist)
        if dl is not None:
            daily_chunks.append(dl)
        day += n
        num_chunks += 1
        if manager is not None:
            # Each boundary rewrites the full history-so-far (a few int64s
            # per scenario-day) beside the state, so the newest snapshot
            # alone restores the run. save() copies to the host here. On a
            # mesh rank 0 writes the whole state and the others wait.
            if core.is_writer:
                manager.save(day, {
                    "day": np.asarray(day, np.int32),
                    "state": state_to_tree(state),
                    "hist": concat_hists(hists),
                }, extra={"resume_key": resume_key})
            core.barrier(manager)
            if hooks is not None:
                hooks.after_save(day)
    if manager is not None:
        manager.wait()

    hist = concat_hists(hists)
    dailies = concat_dailies(daily_chunks) if daily_chunks else None
    return state, hist, carries, dailies, resumed_from, num_chunks


class CoreDriver:
    """The whole batch in one day loop on the core's device, so the
    observable updates run inside the loop."""

    in_scan = True

    def __init__(self, core: EngineCore, observables: tuple):
        self.core = core
        self.observables = tuple(observables)

    def init_state(self):
        return self.core.full_init_state()

    def adapt_state(self, state):
        return self.core.adopt_state(state)

    def run_chunk(self, n, state, carries):
        from repro_torch.api import observables as obs_lib  # cycle-free at call time

        core = self.core
        shard, carries, hist, dailies = core.run_days(
            n, state=core.shard_state(state), observables=self.observables,
            carries=carries)
        # The history's host copy ends the chunk: a chunk's wall time
        # (run_chunked's dt) includes the device's work.
        return (core.gather_state(shard), hist_to_numpy(hist), carries,
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
        return self.core.full_init_state()

    def adapt_state(self, state):
        return self.core.adopt_state(state)

    def run_chunk(self, n, state, carries):
        core, finals, hists = self.core, [], []
        for i, params_i in enumerate(self.params_list):
            state_i = core.shard_state(index_params(state, slice(i, i + 1)))
            f, _, h, _ = core.run_days(n, params=params_i, state=state_i)
            finals.append(core.gather_state(f))
            hists.append(h)
        # pad slots (if any) never run here; they keep their rows
        finals.append(index_params(state, slice(len(self.params_list), None)))
        state = tree_map(lambda *xs: torch.cat(xs), *finals)
        # as CoreDriver's: the host copy ends the chunk
        return state, hist_to_numpy(torch.cat(hists, dim=-1)), carries, None
