"""The resident simulation server: capture once, serve forever.

The port of the reference's ``repro.serve.server``. A
:class:`SimulationServer` keeps a BoundedLRU table of warm buckets — each a
resident :class:`~repro_torch.engine.core.EngineCore` built for one
:class:`~repro_torch.serve.buckets.BucketKey`, whose ``chunk_days`` runner
is, on the card, a captured CUDA graph of the batched day loop — and serves
admitted :class:`~repro_torch.api.spec.ExperimentSpec` requests by
**batching them onto the scenario axis** of that runner:

1. each request's scenarios are packed into consecutive slots of the
   bucket's width-``b_bucket`` batch; leftover slots run inert
   :func:`~repro_torch.engine.core.no_op_params`;
2. the dispatch runs as ``n_chunks`` calls of ONE runner (``chunk_days``
   days each, ``observables=()``; on the card, ``n_chunks`` replays of one
   graph, each chunk's final state copied into the graph's inputs for the
   next), streaming each chunk's day stats to every request's ticket as it
   leaves the device;
3. each request's history is sliced back out of its slot columns and
   trimmed to its own day count, observables are replayed after the run
   with the request's own ObsContext, and a RunResult is produced.

Bitwise contract (test-enforced in ``tests/test_torch_serve.py``, and on the
card in ``chip_smoke.py``): a served result equals a solo ``api.run`` of
the same spec bit for bit — each scenario of a batch is bitwise its run
alone, no-op padding is inert, chunked runs equal unchunked ones (the state
carries everything), history prefixes are causal, and observable replay
runs the in-loop updates over the same history on the same device.

Zero-rebuild contract: once a bucket's runner is built (its first
dispatch, or :meth:`SimulationServer.warm_up`), every later dispatch of
that bucket runs inside
:class:`repro_torch.analysis.capture.recompile_sentinel`. A build in steady
state (a capture on the card) trips the sentinel: counted in
``metrics.executables.recompile_violations`` and — under
``ServeConfig.strict`` — failing the batch loudly instead of silently
eating a capture.

Threads: every piece of CUDA work of the dispatch path runs under the
dispatch lock; the finisher thread replays observables on the server's
device. A capture must not overlap another thread's CUDA work, so the
server drains the finisher (under the dispatch lock, which is the only way
work reaches it) before any call that will build a runner.

On a mesh (``ServeConfig.layout`` ``workers``, ``scenarios`` or
``hybrid``) the server is SPMD: every rank of the initialised process
group constructs it with the same config (which makes the mesh, once, with
``launch/mesh.py``'s makers) and every rank runs every dispatch, since the
day's collectives span the ranks; the runner is the eager loop there.
Rank 0 is the server: admission, the batcher, the dispatch lock and the
finisher. The other ranks call :meth:`SimulationServer.follow`, which runs
what rank 0 announces until rank 0 calls :meth:`SimulationServer.close`.
Rank 0 announces a dispatch over the mesh's world group
(``broadcast_object_list``) inside the dispatch lock, once every host-side
check has passed (the dispatch's params built on the host, its slot
structure and width), so a refused request never reaches a follower; the
announcement carries the group's specs and its shape, and every rank then
builds the same bucket (at once: a cold bucket's host build is not
serialised behind rank 0's) and params from them (host builds are
deterministic: no tensor is broadcast) and calls the same runner chunks,
so every rank enters the same collectives in the same order. Each rank
logs what it ran (:attr:`SimulationServer.dispatch_log`). Only rank 0
assembles results: the scenario axis's gather gives it every column.

On every layout a dataset's buckets share the week's host build: the local
week arrays, or on a worker mesh the plan and this rank's tables, built by
the dataset's first bucket. A warm dispatch builds none of them, nor a
process group; ``ServeMetrics`` counts these mesh builds
(``executables.mesh_builds``) as it counts captures. Followers wait for
announcements within the mesh's timeout: the dispatch thread sends a ping
when idle, a caller that drives the server synchronously must keep its
gaps shorter.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.analysis import capture
from repro_torch.analysis.report import summarize_sweep
from repro_torch.api import observables as obs_lib
from repro_torch.api.result import RunResult
from repro_torch.api.runner import _sweep_axes
from repro_torch.api.spec import ROUTES, ExperimentSpec
from repro_torch.configs import get_epidemic
from repro_torch.configs.sweep import ScenarioBatch
from repro_torch.core import simulator_dist as sd
from repro_torch.engine import core as engine_lib
from repro_torch.engine.cache import BoundedLRU
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve.batcher import (
    RequestBatcher,
    ServeError,
    ServeRequest,
    ServeTicket,
)
from repro_torch.serve.buckets import BucketKey, ServeConfig, bucketize
from repro_torch.serve.metrics import ServeMetrics


class WarmBucket:
    """One resident executable: an EngineCore built for a bucket key, its
    cached stacked initial state (identical for every request in the bucket
    — it is a function of disease + slot count only), and dispatch
    bookkeeping."""

    def __init__(self, key: BucketKey, core, pop, chunk_days: int):
        self.key = key
        self.core = core
        self.pop = pop
        self.chunk_days = chunk_days
        self.init = core.init_state()  # reused: a runner never mutates it
        self.dispatches = 0
        self.compile_s: Optional[float] = None

    def runner(self):
        """The one runner this bucket ever runs — the sentinel watches
        exactly this object's builds."""
        return self.core.runner_fn(self.chunk_days, ())

    def is_warm(self) -> bool:
        return self.core.runner_cached(self.chunk_days, ())


class SimulationServer:
    """Request queue + warm bucket table + dispatch loop.

    Usable two ways: synchronously (``submit`` then ``drain``, or the
    one-call :meth:`run`) — what tests and benchmarks do — or with a
    background dispatch thread (``start``/``stop``, or as a context
    manager) so ``submit`` returns immediately and tickets stream.

    ``device`` is the card unless ``"cpu"`` is asked for (without a card,
    an error). A mesh layout needs an initialised process group of the
    mesh's size (otherwise ``launch/mesh.py:no_group_error``): the server
    never serves locally instead."""

    def __init__(self, config: Optional[ServeConfig] = None, *, device="cuda"):
        self.config = (config or ServeConfig()).validate()
        self.device = engine_lib.resolve_device(device)
        self.layout = self.config.resolved_layout()
        self.metrics = ServeMetrics()
        self.mesh = _serve_mesh(self.config, self.layout)
        self.rank = 0 if self.mesh is None else self.mesh.rank
        #: host builds a mesh bucket makes, by kind (plan, tables, groups)
        self.mesh_builds = collections.Counter()
        if self.mesh is not None:
            self._count_build("groups")
        #: what this rank ran, in order: (op, bucket, chunks, specs) per
        #: dispatch or warm-up; the same on every rank of a mesh
        self.dispatch_log: List[tuple] = []
        #: a follower's tracebacks of dispatches that failed on this rank
        self.follow_errors: List[str] = []
        self._closed = False
        self._last_announce = time.monotonic()
        # (dataset, block_size) -> DistPlan / the week's device arrays
        self._plans: Dict[tuple, object] = {}
        self._weeks: Dict[tuple, dict] = {}
        self._pops: Dict[str, object] = {}
        self._evicted_labels: List[str] = []
        self._buckets: BoundedLRU = BoundedLRU(
            max_entries=self.config.max_executables,
            on_evict=lambda k, b: self._evicted_labels.append(k.label()),
        )
        self._batcher = RequestBatcher()
        self._lock = threading.Lock()  # guards the pending queue
        self._cv = threading.Condition(self._lock)
        self._dispatch_lock = threading.Lock()  # serializes device work
        # One finisher thread keeps per-request work (observable replay,
        # result assembly) off the dispatch loop, FIFO-ordered. The
        # reference also caches a jitted replay per (observables, shape);
        # eager torch has nothing to trace or cache, so the port replays
        # with scan_history directly — the in-loop updates over the same
        # history on the same device, bitwise equal to a solo run's.
        self._finisher = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sim-serve-finish")
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "SimulationServer":
        if self._thread is not None:
            return self
        self._stopping = False
        self._thread = threading.Thread(
            target=self._loop, name="sim-serve-dispatch", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if self._thread is None:
            return
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join()
        self._thread = None
        if drain:
            self.drain()
        else:
            self.flush()

    def __enter__(self) -> "SimulationServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- admission -------------------------------------------------------
    def submit(self, spec: ExperimentSpec) -> ServeTicket:
        """Admit a spec: validate, normalize onto the bucket lattice,
        enqueue. Raises ValueError (and counts a rejection) for specs the
        serving tier refuses — see :func:`repro_torch.serve.buckets.bucketize`."""
        self._check_leader("submit")
        try:
            spec = spec.validate()
            shape = bucketize(spec, self.config)
        except ValueError:
            self.metrics.on_reject()
            raise
        req = ServeRequest(spec, shape)
        self.metrics.on_submit()
        with self._cv:
            self._batcher.add(req)
            self._cv.notify_all()
        return ServeTicket(req)

    def run(self, spec: ExperimentSpec,
            timeout: Optional[float] = None) -> RunResult:
        """Submit one spec and block for its result (drains inline when
        no dispatch thread is running)."""
        ticket = self.submit(spec)
        if self._thread is None:
            self.drain()
        return ticket.result(timeout=timeout)

    def drain(self) -> int:
        """Dispatch every pending request in the caller's thread and wait
        out the finisher backlog; returns the number of batches."""
        n = 0
        while True:
            with self._lock:
                group = self._batcher.take_group()
            if not group:
                self.flush()
                return n
            self._dispatch(group)
            n += 1

    def flush(self) -> None:
        """Block until every already-dispatched request has finished
        (the finisher queue is FIFO, so a barrier job suffices)."""
        self._finisher.submit(lambda: None).result()

    def pending(self) -> int:
        with self._lock:
            return len(self._batcher)

    # -- warmup ----------------------------------------------------------
    def warm_up(self, spec: ExperimentSpec) -> dict:
        """Build the bucket a spec lands in and build its runner (on the
        card: capture its CUDA graph) by priming it with an all-no-op batch
        (no request is served). Returns ``{"bucket", "already_warm",
        "compile_s"}``; after this, every dispatch of the bucket must be
        rebuild-free."""
        self._check_leader("warm_up")
        spec = spec.validate()
        shape = bucketize(spec, self.config)
        with self._dispatch_lock:
            bucket = self._buckets.peek(shape.bucket)
            if bucket is not None and bucket.is_warm():
                return {"bucket": bucket.key.label(), "already_warm": True,
                        "compile_s": bucket.compile_s}
            self.flush()  # no finisher work may overlap the capture
            # announced before the build, so every rank builds at once
            self._announce("warm", specs=[spec], shape=shape)
            bucket = self._bucket_for(spec, shape.bucket)
            self._prime(bucket)
            return {"bucket": bucket.key.label(), "already_warm": False,
                    "compile_s": bucket.compile_s}

    def _prime(self, bucket: "WarmBucket") -> None:
        """Build the bucket's runner (on the card: capture it) with an
        all-no-op batch."""
        slots = len(bucket.core.padded)
        noop = engine_lib.stack_params([
            engine_lib.no_op_params(engine_lib.index_params(bucket.core.params, i))
            for i in range(bucket.core.params.seed.shape[0])
        ])
        t0 = time.time()
        bucket.runner()(noop, bucket.init)
        bucket.compile_s = time.time() - t0
        self.metrics.on_batch(real=0, padded=slots, warm=False, chunks=1)

    # -- the mesh: rank 0 announces, the other ranks follow --------------
    def follow(self) -> int:
        """On a rank other than 0 of a mesh server: run every warm-up and
        dispatch rank 0 announces, in its order, until rank 0 calls
        :meth:`close`. Returns the number of dispatches and warm-ups run."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh "
                               "server; rank 0 serves")
        n = 0
        while True:
            msg = self._receive()
            if msg["op"] == "stop":
                return n
            if msg["op"] == "ping":
                continue
            with self._dispatch_lock:
                self.dispatch_log.append(_log_entry(msg))
                specs, shape = msg["specs"], msg["shape"]
                try:
                    if msg["op"] == "warm":
                        self._prime(self._bucket_for(specs[0], shape.bucket))
                    else:
                        self._run_group(specs, shape, self._pack(specs, shape.bucket))
                except Exception:  # noqa: BLE001 - rank 0 fails the request;
                    # its host builds are this rank's, so it failed too
                    self.metrics.on_fail(len(specs))
                    self.follow_errors.append(traceback.format_exc())
            n += 1

    def close(self) -> None:
        """On rank 0 of a mesh server: release the followers (their
        :meth:`follow` returns). The server serves nothing after it. A no-op
        on one device and on the followers."""
        if self.mesh is None or self.rank != 0 or self._closed:
            return
        with self._dispatch_lock:
            self._announce("stop")
            self._closed = True

    def _check_leader(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"{what}() runs on rank 0 of a mesh server; rank "
                               f"{self.rank} calls follow()")

    def _announce(self, op: str, **msg) -> None:
        """Rank 0 tells every rank of the mesh what to run next (under the
        dispatch lock). Nothing on one device."""
        if self.mesh is None:
            return
        if self._closed:
            raise ServeError("this mesh server is closed: its followers have left")
        msg = dict(op=op, **msg)
        dist.broadcast_object_list([msg], src=0, group=self.mesh.world_group)
        self._last_announce = time.monotonic()
        if op in ("warm", "dispatch"):
            self.dispatch_log.append(_log_entry(msg))

    def _receive(self) -> dict:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.mesh.world_group)
        return box[0]

    def _count_build(self, kind: str) -> None:
        self.mesh_builds[kind] += 1
        self.metrics.on_mesh_build(kind)

    # -- readout ---------------------------------------------------------
    def metrics_dict(self) -> dict:
        return self.metrics.to_dict(bucket_stats={
            "table": self._buckets.stats(),
            "resident": [k.label() for k in self._buckets],
            "evicted": list(self._evicted_labels),
        })

    # -- internals -------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopping and len(self._batcher) == 0:
                    self._cv.wait(timeout=0.1)
                    if self._ping_due():
                        break
                if self._stopping:
                    return
                idle = len(self._batcher) == 0
            if idle:
                # keep the followers' wait for the next announcement inside
                # the mesh's timeout
                with self._dispatch_lock:
                    if self._ping_due():
                        self._announce("ping")
                continue
            # Batching window: linger briefly so concurrent same-bucket
            # submissions share the dispatch instead of trickling.
            if self.config.max_wait_s > 0:
                time.sleep(self.config.max_wait_s)
            with self._lock:
                group = self._batcher.take_group()
            if group:
                self._dispatch(group)

    def _ping_due(self) -> bool:
        return (self.mesh is not None and not self._closed and
                time.monotonic() - self._last_announce > self.mesh.timeout_s / 4)

    def _pop(self, dataset: str):
        pop = self._pops.get(dataset)
        if pop is None:
            pop = get_epidemic(dataset).build()
            self._pops[dataset] = pop
        return pop

    def _bucket_for(self, spec: ExperimentSpec, key: BucketKey) -> WarmBucket:
        """Fetch (recency-bumping) or build the bucket for ``key``. Called
        under the dispatch lock only."""
        bucket = self._buckets.get(key)
        if bucket is not None:
            return bucket
        pop = self._pop(spec.dataset)
        # The template batch only supplies the structure (slot kinds,
        # width); every dispatch passes its own params.
        template = engine_lib.pad_batch(spec.build_batch(), key.b_bucket)
        # The week's host build (on a worker mesh: the plan and this rank's
        # tables) is one per dataset and block size, shared by the dataset's
        # buckets, which only read it.
        shared = (spec.dataset, key.block_size)
        core = engine_lib.EngineCore(
            pop, template,
            layout=self.layout,
            mesh=self.mesh,
            plan=self._plans.get(shared),
            week=self._weeks.get(shared),
            block_size=key.block_size,
            device=self.device,
            backend=ROUTES[key.backend],
            max_seed_per_day=key.seed_cap,
            max_runners=2,  # serving uses exactly one (chunk_days, ())
        )
        if shared not in self._weeks:
            self._weeks[shared] = core.week
            if self.mesh is not None:
                self._count_build("tables")
        if core.plan is not None and shared not in self._plans:
            self._plans[shared] = core.plan
            self._count_build("plan")
        bucket = WarmBucket(key, core, pop, self.config.chunk_days)
        self._buckets.put(key, bucket)
        return bucket

    def _pack(self, specs: list, key: BucketKey) -> "_Packed":
        """Pack the specs' scenarios into a dispatch of bucket ``key``:
        request scenarios in FIFO order, then no-op padding (to the bucket's
        width, then to a multiple of the scenario shards), built on the host
        (a bucket need not exist). These are the dispatch's host-side
        checks: the group's slot structure must be one, match a resident
        bucket's, and fit its width; rank 0 runs them before announcing."""
        pop = self._pop(specs[0].dataset)
        scen, cols, names = [], [], []
        for spec in specs:
            b = spec.build_batch()
            cols.append((len(scen), len(b)))
            names.append(b.names)
            scen.extend(b.scenarios)
        n_real = len(scen)
        if n_real > key.b_bucket:
            raise ServeError(f"dispatch of {n_real} scenarios exceeds bucket "
                             f"'{key.label()}' width {key.b_bucket}")
        shards = self.mesh.scenarios if self.layout in ("scenarios", "hybrid") else 1
        dispatch = engine_lib.pad_batch(
            engine_lib.pad_batch(ScenarioBatch(scenarios=tuple(scen)), key.b_bucket), shards)
        iv_slots, pa_slots, plist = engine_lib.build_batch_params(pop, dispatch,
                                                                  device=self.device)
        resident = self._buckets.peek(key)
        if resident is not None:
            _check_structure((iv_slots, pa_slots), resident)
        return _Packed((iv_slots, pa_slots), plist, cols, names, n_real)

    def _bucket_params(self, bucket: WarmBucket, packed: "_Packed"):
        """The packed dispatch's params on ``bucket``: person axes padded on
        a worker mesh, pad slots no-op, stacked, this rank's shard (the
        whole batch on one device)."""
        core = bucket.core
        _check_structure(packed.structure, bucket)
        plist = list(packed.plist)
        if core.plan is not None:  # worker-sharded layouts pad the person axes
            plist = [sd.pad_params(p, core.plan) for p in plist]
        for i in range(packed.n_real, len(plist)):
            plist[i] = engine_lib.no_op_params(plist[i])
        if len(plist) != len(core.padded):
            raise ServeError(
                f"dispatch width {len(plist)} != bucket width "
                f"{len(core.padded)}")
        return core.shard_params(engine_lib.stack_params(plist))

    def _dispatch(self, group: List[ServeRequest]) -> None:
        """Run one batched dispatch end to end. All device work happens
        here, serialized by the dispatch lock."""
        with self._dispatch_lock:
            now = time.time()
            for req in group:
                req.dispatched_at = now
            try:
                self._dispatch_inner(group)
            except BaseException as err:  # noqa: BLE001 - requests must resolve
                self.metrics.on_fail(len(group))
                for req in group:
                    req.fail(err)

    def _dispatch_inner(self, group: List[ServeRequest]) -> None:
        shape = group[0].shape
        specs = [req.spec for req in group]
        packed = self._pack(specs, shape.bucket)  # the host-side checks
        # announced before the bucket is built, so every rank builds at once
        self._announce("dispatch", specs=specs, shape=shape)
        chunk_days = self.config.chunk_days

        def stream(c: int, hist: dict, cols: list) -> None:
            day0 = c * chunk_days
            for req, (off, width) in zip(group, cols):
                take = min(req.spec.days, day0 + chunk_days) - day0
                if take > 0:
                    req.push_chunk(day0, take, {
                        k: v[:take, off:off + width] for k, v in hist.items()})

        bucket, hists, warm, wall = self._run_group(specs, shape, packed, stream)
        cols, names = packed.cols, packed.names
        full = {
            k: np.concatenate([h[k] for h in hists], axis=0)
            for k in hists[0]
        }
        # Per-request finishing (observable replay, summaries, RunResult
        # assembly) is off the day loop — hand it to the finisher thread so
        # the dispatch loop moves straight to the next group's device work.
        jobs = []
        for i, (req, (off, width)) in enumerate(zip(group, cols)):
            hist_r = {
                k: np.ascontiguousarray(v[:req.spec.days, off:off + width])
                for k, v in full.items()
            }
            jobs.append((req, hist_r, names[i], off))
        self._finisher.submit(self._finish_group, jobs, bucket, warm, wall,
                              len(group))

    def _run_group(self, specs: list, shape, packed: "_Packed", stream=None):
        """Run one packed dispatch of ``specs`` (under the dispatch lock, on
        every rank of a mesh): fetch or build its bucket, then
        ``shape.n_chunks`` runner calls, each chunk's host history passed to
        ``stream(c, hist, cols)``. Returns ``(bucket, hists, warm, wall)``.
        A warm bucket must build nothing: no runner build (a capture on the
        card), and on a mesh no plan, tables or group."""
        builds = sum(self.mesh_builds.values())
        bucket = self._bucket_for(specs[0], shape.bucket)
        params, cols, n_real = self._bucket_params(bucket, packed), packed.cols, packed.n_real
        warm = bucket.is_warm()
        runner = bucket.runner()
        if self.mesh is None and not runner.is_built(params, bucket.init):
            self.flush()  # this dispatch captures: no finisher work may overlap
        hists: List[dict] = []

        def run_chunks():
            state = bucket.init
            for c in range(shape.n_chunks):
                state, _, hist, _ = runner(params, state)
                hist = engine_lib.hist_to_numpy(hist)
                hists.append(hist)
                if stream is not None:
                    stream(c, hist, cols)

        t0 = time.time()
        try:
            if warm:
                # Steady state: the runner must not build. The sentinel
                # re-raises nothing mid-run — it checks at exit, so a trip
                # means the work finished but paid a hidden build.
                with capture.recompile_sentinel(runner):
                    run_chunks()
                if sum(self.mesh_builds.values()) != builds:
                    raise AssertionError(
                        f"mesh builds after warm-up: {dict(self.mesh_builds)}")
            else:
                run_chunks()  # the bucket's one legitimate build
        except AssertionError as err:
            self.metrics.on_recompile_violation()
            # Non-strict (or a follower, whose rank 0 fails the request):
            # the results are still valid (the dispatch ran to completion
            # before the check) — serve them, counted.
            if self.config.strict and self.rank == 0:
                raise ServeError(
                    f"steady-state recompile in bucket "
                    f"'{bucket.key.label()}': {err}") from err
        wall = time.time() - t0
        bucket.dispatches += 1
        self.metrics.on_batch(real=n_real, padded=len(bucket.core.padded) - n_real,
                              warm=warm, chunks=shape.n_chunks)
        return bucket, hists, warm, wall

    def _finish_group(self, jobs, bucket: WarmBucket, warm: bool,
                      wall: float, batch_requests: int) -> None:
        for req, hist_r, scenario_names, off in jobs:
            try:
                result = self._finish(req, bucket, hist_r, scenario_names,
                                      off, warm=warm, wall=wall,
                                      batch_requests=batch_requests)
            except BaseException as err:  # noqa: BLE001 - must resolve
                self.metrics.on_fail(1)
                req.fail(err)
                continue
            req.done_at = time.time()  # stamp before metrics + wakeup so
            # a caller unblocked by finish() reads its own completion.
            if req.ttfd_s is not None:
                self.metrics.on_first_day(req.ttfd_s)
            self.metrics.on_complete(req.latency_s, req.queue_wait_s)
            req.finish(result)

    def _finish(self, req: ServeRequest, bucket: WarmBucket, hist: dict,
                scenario_names, slot_offset: int, *, warm: bool,
                wall: float, batch_requests: int) -> RunResult:
        """Assemble the request's RunResult the way api.run does: replayed
        observables (the in-loop updates over the same history, on the same
        device => bitwise equal to in-loop), sweep summaries, provenance +
        ``served_from``."""
        spec = req.spec
        B = req.shape.b_request
        observables = obs_lib.make_observables(spec.observables)
        ctx = obs_lib.ObsContext(
            num_people=bucket.pop.num_people, num_scenarios=B,
            sweep_axes=_sweep_axes(spec, B), device=str(self.device),
        )
        carries, dailies = obs_lib.scan_history(observables, hist, ctx)
        obs = obs_lib.observables_to_numpy(
            obs_lib.finalize_all(observables, carries, dailies, ctx))
        summaries = summarize_sweep(hist, scenario_names,
                                    bucket.pop.num_people)
        core = bucket.core
        provenance = {
            "engine": f"serve[{core.layout}]",
            "layout": core.layout,
            "topology": type(core.topo).__name__,
            "num_people": int(bucket.pop.num_people),
            "mesh": {"workers": core.workers, "scenarios": core.scen_shards},
            "num_devices": 1 if self.mesh is None else self.mesh.size,  # ranks
            "dist_backend": None if self.mesh is None else self.mesh.backend,
            "jax_backend": str(self.device),  # the reference's key: the torch device
            "route": core.static.backend,
            "wall_s": round(req.latency_s or wall, 3),
            "run_wall_s": round(wall, 3),
            "chunks": req.shape.n_chunks,
            "chunk_days": self.config.chunk_days,
            "resumed_from_day": 0,
            "observables_in_scan": False,
            "core": engine_lib.CORE_VERSION,
            "served_from": {
                "bucket": bucket.key.label(),
                "b_bucket": bucket.key.b_bucket,
                "seed_cap": bucket.key.seed_cap,
                "slot_offset": int(slot_offset),
                "slots": int(B),
                "batch_requests": int(batch_requests),
                "warm": bool(warm),
                "chunk_days": self.config.chunk_days,
                "padded_days": req.shape.n_chunks * self.config.chunk_days,
                "dispatch_wall_s": round(wall, 3),
            },
        }
        if "teps" in obs:
            provenance["edges_total"] = float(obs["teps"]["edges_total"])
            provenance["teps"] = (
                float(obs["teps"]["edges_total"]) / max(wall, 1e-9))
        return RunResult(
            spec=spec,
            scenario_names=scenario_names,
            history=hist,
            observables=obs,
            summaries=summaries,
            provenance=provenance,
        )


def _serve_mesh(config: ServeConfig, layout: str):
    """The server's process mesh over the initialised group (None for the
    local layout), made once: ``workers`` / ``scen_shards`` above 1 size its
    axes, 1 leaves a one-axis layout the world size. Raises
    ``no_group_error`` outside a group of the mesh's size."""
    if layout == "local":
        return None
    W = config.workers if config.workers > 1 else None
    S = config.scen_shards if config.scen_shards > 1 else None
    if not (dist.is_available() and dist.is_initialized()):
        raise mesh_lib.no_group_error(W or 1, S or 1)
    if layout == "workers":
        return mesh_lib.make_worker_mesh(W)
    if layout == "scenarios":
        return mesh_lib.make_scenario_mesh(S)
    return mesh_lib.make_hybrid_mesh(config.workers, S)


class _Packed(NamedTuple):
    """A dispatch's host build (:meth:`SimulationServer._pack`)."""

    structure: tuple  # (classic slots, per-agent slots)
    plist: list  # SimParams per slot of the padded dispatch
    cols: list  # per request: (offset, width)
    names: list  # per request: its scenario names
    n_real: int


def _check_structure(structure: tuple, bucket: WarmBucket) -> None:
    core = bucket.core
    if structure != (core.iv_slots, core.pa_slots):
        raise ServeError(
            f"dispatch slot structure {structure[0] + structure[1]} does not "
            f"match bucket '{bucket.key.label()}' structure "
            f"{core.iv_slots + core.pa_slots}")


def _log_entry(msg: dict) -> tuple:
    """A dispatch-log line: (op, bucket, chunks, the specs as JSON)."""
    return (msg["op"], msg["shape"].bucket.label(), msg["shape"].n_chunks,
            tuple(s.to_json() for s in msg["specs"]))
