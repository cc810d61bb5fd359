"""``run(spec) -> RunResult``: the one front door to the engine core (the
port of the reference's ``repro.api.runner``).

The facade derives the engine from the spec's batch size and mesh shape
(``spec.engine`` can pin one) and hands everything to
:mod:`repro_torch.engine`:

  =========  =========================  ==================================
  engine     selected when              engine-core placement
  =========  =========================  ==================================
  single     B == 1, workers == 1       ``EngineCore(layout="local")``
  ensemble   B > 1, 1x1 mesh            ``EngineCore(layout="local")``
  dist       B == 1, workers > 1        ``EngineCore(layout="workers")``
  sharded    B > 1, scenarios > 1       ``EngineCore(layout="scenarios")``
  hybrid     B > 1, workers > 1         ``EngineCore(layout="hybrid")``
  =========  =========================  ==================================

Every layout runs the same batched day loop; the whole batch (on a mesh,
this rank's shard of it) goes through one day step and one
interaction-kernel launch a day, with the observables' updates inside the
loop, and every layout's results are bitwise the local one's. A pinned
``single`` or ``dist`` engine with B > 1 runs the scenarios one after
another and replays the observables after the run (bitwise equal inside
the port). Histories are day-major with a scenario axis: every array is
``(days, B)``, B = 1 included.

The mesh engines run SPMD: every rank of an initialised process group of
world size ``mesh.workers x mesh.scenarios`` (``dist``: ``workers``;
``sharded``: ``scenarios``) calls ``run(spec)`` and gets the same
:class:`RunResult`; ``repro_torch.launch.mesh.spawn`` or ``torchrun``
starts the ranks, and ``run`` outside such a group raises.

With ``checkpoint.directory`` the run goes in ``checkpoint.every``-day
chunks with a snapshot at each boundary, and resumes bitwise from the
newest valid one (:func:`repro_torch.engine.core.run_chunked`). Resume keys
carry the engine generation, the package and the device type: a checkpoint
written by the reference package (or on another device) is refused, not
spliced, since those trajectories are not bitwise equal to this run's. With
``resilience.enabled`` or ``chaos=`` the chunk loop runs under the recovery
policy of :mod:`repro_torch.runtime.resilience`; the result is bitwise the
uninterrupted run's, and ``provenance["resilience"]`` says what recovery
did.
"""

from __future__ import annotations

import time

import numpy as np
import torch.distributed as dist

from repro_torch.analysis.report import summarize_sweep
from repro_torch.api import observables as obs_lib
from repro_torch.api.result import RunResult
from repro_torch.api.spec import ROUTES, ExperimentSpec
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_epidemic
from repro_torch.engine import core as engine_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import resilience as resilience_lib

#: The engine-core layout of each engine.
LAYOUTS = {"single": "local", "ensemble": "local", "dist": "workers",
           "sharded": "scenarios", "hybrid": "hybrid"}


def _resume_key(spec: ExperimentSpec, engine: str, device) -> dict:
    """What must match for a checkpoint to be resumable under this spec:
    everything that shapes the state or the science — but not the run
    length (extending a run is the resume use case), the checkpoint and
    recovery policies, the study's display name or the observables (pure
    reductions replayed from the restored history). ``core`` marks the
    engine generation (the reference's marker); ``package`` and ``device``
    tell this port on this device type from the reference package and
    from another device: their trajectories differ in float ulps (``exp``,
    ``log``), so a snapshot from one must not continue in another."""
    d = spec.to_dict()
    for k in ("days", "checkpoint", "name", "engine", "observables",
              "resilience"):
        d.pop(k, None)
    d["engine_resolved"] = engine
    d["core"] = engine_lib.CORE_VERSION
    d["package"] = "repro_torch"
    d["device"] = device.type
    return d


def _resolve_engine(spec: ExperimentSpec, B: int) -> str:
    if spec.engine != "auto":
        return spec.engine
    W, S = spec.mesh.workers, spec.mesh.scenarios
    if W > 1:
        return "hybrid" if B > 1 else "dist"
    if B > 1:
        return "sharded" if S > 1 else "ensemble"
    return "single"


def mesh_ranks(spec: ExperimentSpec) -> int:
    """The ranks (processes) ``spec`` runs on: 1 for the one-device engines,
    the mesh's size for ``dist`` (workers), ``sharded`` (scenarios) and
    ``hybrid`` (both)."""
    layout = LAYOUTS[_resolve_engine(spec, spec.num_scenarios)]
    return ((spec.mesh.workers if layout in ("workers", "hybrid") else 1)
            * (spec.mesh.scenarios if layout in ("scenarios", "hybrid") else 1))


def _make_mesh(engine: str, spec: ExperimentSpec):
    """The engine's process mesh over the initialised group (None for the
    one-device engines); raises, naming ``spawn`` and ``torchrun``, outside a
    group of the mesh's size."""
    layout = LAYOUTS[engine]
    W = spec.mesh.workers if layout in ("workers", "hybrid") else 1
    S = spec.mesh.scenarios if layout in ("scenarios", "hybrid") else 1
    if layout == "local":
        return None
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != W * S:
        raise mesh_lib.no_group_error(W, S)
    if layout == "workers":
        return mesh_lib.make_worker_mesh(W)
    if layout == "scenarios":
        return mesh_lib.make_scenario_mesh(S)
    return mesh_lib.make_hybrid_mesh(W, S)


def _sweep_axes(spec: ExperimentSpec, B: int) -> tuple:
    """Per-scenario level assignments of the factorial sweep axes (axes
    with a single level carry no information and are dropped). Order
    matches ScenarioBatch.from_product: interventions x tau x replicates,
    replicates innermost."""
    n_iv = len(spec.interventions)
    n_tau = len(spec.tau_scales)
    n_rep = spec.replicates
    if n_iv * n_tau * n_rep != B:  # hand-built batch: no factorial info
        return ()
    idx = np.arange(B)
    axes = []
    if n_iv > 1:
        axes.append(("interventions", tuple((idx // (n_tau * n_rep)).tolist())))
    if n_tau > 1:
        axes.append(("tau_scales", tuple(((idx // n_rep) % n_tau).tolist())))
    if n_rep > 1:
        axes.append(("replicates", tuple((idx % n_rep).tolist())))
    return tuple(axes)


def run(spec: ExperimentSpec, *, population=None, device="cuda", chaos=None,
        on_straggler=None) -> RunResult:
    """Execute an :class:`ExperimentSpec` end to end on ``device`` (the card
    unless ``device="cpu"`` is asked for; without a card, an error). A mesh
    spec runs on every rank of an initialised process group of the mesh's
    size, each rank on its ``device`` (the module's docstring).
    ``population=`` substitutes a prebuilt Population for ``spec.dataset``
    (tests reuse one build).

    ``chaos=`` injects a deterministic fault schedule
    (:class:`repro_torch.runtime.chaos.ChaosSchedule`) into the chunk loop
    and implies the resilient path; ``on_straggler(day, dt, median)``
    observes straggler detections."""
    spec = spec.validate()
    t0 = time.time()
    device = engine_lib.resolve_device(device)
    B = spec.num_scenarios
    engine = _resolve_engine(spec, B)
    mesh = _make_mesh(engine, spec)
    pop = population if population is not None else get_epidemic(spec.dataset).build()
    batch = spec.build_batch()
    observables = obs_lib.make_observables(spec.observables)
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=B,
                             sweep_axes=_sweep_axes(spec, B), device=str(device))
    # A pinned single or dist engine with B > 1 runs the scenarios one at a
    # time; cross-scenario reductions then replay after the run.
    in_scan = not (engine in ("single", "dist") and B > 1)
    built = {"mesh": mesh}  # the most recently built core and its mesh
    shrinks = []  # per elastic shrink: its rebuild's seconds

    def build_driver():
        prev = built.get("core")
        # a rebuild on the same workers (the straggler policy's) reuses the
        # last core's plan; a plan is one worker count's, so a shrink builds
        # its own (and its per-rank tables)
        same = prev is not None and prev.mesh is built["mesh"]
        core = engine_lib.EngineCore(pop, batch, layout=LAYOUTS[engine], mesh=built["mesh"],
                                     plan=prev.plan if same else None,
                                     block_size=spec.block_size, device=device,
                                     backend=ROUTES[spec.backend])
        if prev is not None and mesh is not None:
            # the run's collectives and bytes continue across a rebuild
            core.topo.counts.update(prev.topo.counts)
            core.topo.bytes_sent.update(prev.topo.bytes_sent)
        built["core"] = core
        if in_scan:
            return engine_lib.CoreDriver(core, observables)
        return engine_lib.SequentialDriver(core)

    # The first driver is built before the run's clock starts, so run_wall_s
    # times the day loop, not the core's host build.
    first = [build_driver()]

    def make_driver(workers=None):
        """The chunk driver: the one built above, then a rebuild on each
        call — the rebuild seam of the recovery policy. Fewer ``workers``
        than the mesh has (after a device loss; every rank calls with the
        same count) first make the survivors' mesh
        (``WorkerMesh.shrink``), and return None on a rank that leaves."""
        if first:
            return first.pop()
        cur = built["mesh"]
        if cur is None or workers is None or workers == cur.workers:
            return build_driver()
        t0 = time.perf_counter()
        survivors = cur.shrink(cur.workers - workers)
        if survivors is None:
            return None
        built["mesh"] = survivors
        t1 = time.perf_counter()
        driver = build_driver()
        shrinks.append({"workers_before": cur.workers, "workers_after": workers,
                        "groups_s": round(t1 - t0, 3),
                        "plan_and_tables_s": round(built["core"].plan_build_s, 3),
                        "rebuild_s": round(time.perf_counter() - t0, 3)})
        return driver

    ck = spec.checkpoint
    mgr = CheckpointManager(ck.directory, keep=ck.keep) if ck.directory else None
    rs = spec.resilience
    report = None
    timeline = []  # the resilient loop's chunk and restore times

    t_run = time.time()
    if rs.enabled or chaos is not None:  # run_resilient refuses mgr=None
        policy = resilience_lib.ResiliencePolicy(
            max_restarts=rs.max_restarts, backoff_s=rs.backoff_s,
            guards=rs.guards, elastic=rs.elastic,
            straggler_window=rs.straggler_window,
            straggler_factor=rs.straggler_factor,
            repartition_on_straggler=rs.repartition_on_straggler,
        )
        state, hist, carries, dailies, resumed_from, num_chunks, report = \
            resilience_lib.run_resilient(
                make_driver, spec.days, observables, ctx,
                manager=mgr, every=ck.every, resume=ck.resume,
                resume_key=_resume_key(spec, engine, device),
                policy=policy, chaos=chaos, on_straggler=on_straggler,
                timeline=timeline,
            )
    else:
        state, hist, carries, dailies, resumed_from, num_chunks = \
            engine_lib.run_chunked(
                make_driver(None), spec.days, observables, ctx,
                manager=mgr, every=ck.every, resume=ck.resume,
                resume_key=_resume_key(spec, engine, device),
            )
    run_wall = time.time() - t_run
    core = built["core"]
    if state is None:  # this rank left a shrinking mesh (run_resilient)
        return _retired_result(spec, batch, engine, report, shrinks, timeline, t0, run_wall)

    if in_scan:
        obs = obs_lib.finalize_all(observables, carries, dailies, ctx)
    else:
        obs = obs_lib.observe_history(observables, hist, ctx)
    obs = obs_lib.observables_to_numpy(obs)
    if any(v.shape[1] != B for v in hist.values()):
        raise AssertionError("the engine core leaked padded scenario slots into the history")

    summaries = summarize_sweep(hist, batch.names, pop.num_people)
    provenance = {
        "engine": engine,
        "layout": core.layout,
        "topology": type(core.topo).__name__,
        "num_people": int(pop.num_people),
        "mesh": {"workers": spec.mesh.workers, "scenarios": spec.mesh.scenarios},
        "num_devices": 1 if mesh is None else mesh.size,  # ranks (they may share a card)
        "dist_backend": None if mesh is None else mesh.backend,
        "jax_backend": str(device),  # the reference's key: here the torch device
        "route": core.static.backend,  # the interaction pass that ran
        "wall_s": round(time.time() - t0, 3),  # end to end, incl. pop build
        "run_wall_s": round(run_wall, 3),  # the day loop only
        "chunks": num_chunks,
        "chunk_days": ck.every if mgr is not None else spec.days,
        "resumed_from_day": resumed_from,
        "observables_in_scan": in_scan,
        "core": engine_lib.CORE_VERSION,
    }
    if mesh is not None:
        # this rank's host build (plan and tables, or the week), its
        # collectives over the run by kind, and the bytes it sent
        provenance["plan_build_s"] = round(core.plan_build_s, 3)
        provenance["collectives"] = dict(core.topo.counts)
        provenance["bytes_sent"] = dict(core.topo.bytes_sent)
        provenance["final_mesh"] = {"workers": core.mesh.workers,
                                    "scenarios": core.mesh.scenarios}
    if shrinks:
        # each elastic shrink's host rebuild on this rank: the survivors'
        # groups, the new plan and per-rank tables, the whole rebuild
        provenance["elastic"] = shrinks
    if report is not None:
        # what recovery did: restarts, chunks replayed, snapshots
        # quarantined, straggler/device-loss events, final layout; and each
        # chunk's and restore's wall time, with the workers it ran on
        provenance["resilience"] = report.to_dict()
        provenance["timeline"] = timeline
    if "teps" in obs:
        provenance["edges_total"] = float(obs["teps"]["edges_total"])
        provenance["teps"] = float(obs["teps"]["edges_total"]) / max(run_wall, 1e-9)
    return RunResult(
        spec=spec,
        scenario_names=batch.names,
        history=hist,
        observables=obs,
        summaries=summaries,
        provenance=provenance,
    )


def _retired_result(spec, batch, engine, report, shrinks, timeline, t0,
                    run_wall) -> RunResult:
    """What ``run`` returns on a rank that left a shrinking mesh: an empty
    history and no observables or summaries; ``provenance["resilience"]``
    carries ``retired_at_day`` (the chunk boundary it left at) beside the
    device loss the survivors record too."""
    return RunResult(
        spec=spec, scenario_names=batch.names, history={}, observables={}, summaries=[],
        provenance={"engine": engine, "layout": LAYOUTS[engine], "retired": True,
                    "wall_s": round(time.time() - t0, 3),
                    "run_wall_s": round(run_wall, 3),
                    "resilience": report.to_dict(), "elastic": shrinks,
                    "timeline": timeline,
                    "core": engine_lib.CORE_VERSION})


def run_file(path: str, **overrides) -> RunResult:
    """Load a JSON/TOML spec from disk and run it; ``device=`` (if given)
    goes to :func:`run`, the other keywords override spec fields."""
    device = overrides.pop("device", "cuda")
    return run(ExperimentSpec.from_file(path).with_overrides(**overrides), device=device)
