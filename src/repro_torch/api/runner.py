"""``run(spec) -> RunResult``: the one front door to the engine core (the
port of the reference's ``repro.api.runner``).

The facade derives the engine from the spec's batch size and mesh shape
(``spec.engine`` can pin one) and hands everything to
:mod:`repro_torch.engine`:

  =========  =========================  ==================================
  engine     selected when              in the port
  =========  =========================  ==================================
  single     B == 1, workers == 1       ``EngineCore`` on one device
  ensemble   B > 1, 1x1 mesh            ``EngineCore`` on one device
  dist       B == 1, workers > 1        ROADMAP queue 1 item 4: raises
  sharded    B > 1, scenarios > 1       ROADMAP queue 1 item 4: raises
  hybrid     B > 1, workers > 1         ROADMAP queue 1 item 4: raises
  =========  =========================  ==================================

``single`` and ``ensemble`` run the same batched day loop; the whole batch
goes through one day step and one interaction-kernel launch a day, with the
observables' updates inside the loop. A pinned ``single`` engine with B > 1
runs the scenarios one after another and replays the observables after the
run (bitwise equal inside the port). Histories are day-major with a
scenario axis: every array is ``(days, B)``, B = 1 included.

The run is one chunk: checkpoints (``checkpoint.directory``), the resilient
loop (``resilience.enabled``) and fault injection (``chaos=``) are ROADMAP
queue 1 item 3 and raise.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.analysis.report import summarize_sweep
from repro_torch.api import observables as obs_lib
from repro_torch.api.result import RunResult
from repro_torch.api.spec import ROUTES, ExperimentSpec
from repro_torch.configs import get_epidemic
from repro_torch.engine import core as engine_lib

_UNPORTED_ENGINES = ("dist", "sharded", "hybrid")


def _resolve_engine(spec: ExperimentSpec, B: int) -> str:
    if spec.engine != "auto":
        return spec.engine
    W, S = spec.mesh.workers, spec.mesh.scenarios
    if W > 1:
        return "hybrid" if B > 1 else "dist"
    if B > 1:
        return "sharded" if S > 1 else "ensemble"
    return "single"


def _check_ported(spec: ExperimentSpec, engine: str, chaos) -> None:
    """Raise, naming the ROADMAP item, for what the port does not run yet."""
    if engine in _UNPORTED_ENGINES:
        raise NotImplementedError(
            f"engine '{engine}' is not ported: the port runs 'single' and "
            "'ensemble' on one device; meshes are ROADMAP queue 1 item 4 "
            "(multiple GPUs)")
    if spec.checkpoint.directory is not None:
        raise NotImplementedError(
            "checkpoint.directory is not ported: checkpointed, chunked runs "
            "are ROADMAP queue 1 item 3 (chunked runs and resilience)")
    if spec.resilience.enabled or chaos is not None:
        raise NotImplementedError(
            "the resilient run loop (resilience.enabled, chaos=) is not "
            "ported: ROADMAP queue 1 item 3 (chunked runs and resilience)")


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


def run(spec: ExperimentSpec, *, population=None, device="cuda", chaos=None) -> RunResult:
    """Execute an :class:`ExperimentSpec` end to end on ``device`` (the card
    unless ``device="cpu"`` is asked for; without a card, an error).
    ``population=`` substitutes a prebuilt Population for ``spec.dataset``
    (tests reuse one build). ``chaos=`` is the reference's fault-injection
    hook, ROADMAP queue 1 item 3: it raises."""
    spec = spec.validate()
    t0 = time.time()
    device = engine_lib.resolve_device(device)
    B = spec.num_scenarios
    engine = _resolve_engine(spec, B)
    _check_ported(spec, engine, chaos)
    pop = population if population is not None else get_epidemic(spec.dataset).build()
    batch = spec.build_batch()
    observables = obs_lib.make_observables(spec.observables)
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=B,
                             sweep_axes=_sweep_axes(spec, B), device=str(device))
    core = engine_lib.EngineCore(pop, batch, block_size=spec.block_size,
                                 device=device, backend=ROUTES[spec.backend])
    # A pinned single engine with B > 1 runs the scenarios one at a time;
    # cross-scenario reductions then replay after the run.
    in_scan = not (engine == "single" and B > 1)
    driver = (engine_lib.CoreDriver(core, observables) if in_scan
              else engine_lib.SequentialDriver(core))

    t_run = time.time()
    state, hist, carries, dailies, resumed_from, num_chunks = engine_lib.run_chunked(
        driver, spec.days, observables, ctx)
    run_wall = time.time() - t_run

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
        "num_devices": 1,
        "jax_backend": str(device),  # the reference's key: here the torch device
        "route": core.static.backend,  # the interaction pass that ran
        "wall_s": round(time.time() - t0, 3),  # end to end, incl. pop build
        "run_wall_s": round(run_wall, 3),  # the day loop only
        "chunks": num_chunks,
        "chunk_days": spec.days,
        "resumed_from_day": resumed_from,
        "observables_in_scan": in_scan,
        "core": engine_lib.CORE_VERSION,
    }
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


def run_file(path: str, **overrides) -> RunResult:
    """Load a JSON/TOML spec from disk and run it; ``device=`` (if given)
    goes to :func:`run`, the other keywords override spec fields."""
    device = overrides.pop("device", "cuda")
    return run(ExperimentSpec.from_file(path).with_overrides(**overrides), device=device)
