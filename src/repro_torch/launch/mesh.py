"""Process meshes for the epidemic engine on ``torch.distributed``.

The reference places its day loop on a named JAX device mesh with
``shard_map``; the port runs SPMD processes instead: one process per rank,
every rank calls the same entry point (``EngineCore`` with a mesh layout,
or ``repro_torch.api.run`` with a mesh spec) and every rank returns the
same result. Ranks form a ``workers x scenarios`` grid, rank ``r`` at
worker ``r // scenarios`` and scenario shard ``r % scenarios``, as the
reference reshapes its devices into its hybrid mesh:

  * :func:`make_worker_mesh`, :func:`make_scenario_mesh` and
    :func:`make_hybrid_mesh` build a :class:`WorkerMesh` over the process
    group that is already initialised: the ``workers`` subgroups (the ranks
    that share a scenario shard and split its people and locations) and the
    ``scenarios`` subgroups (the ranks that share a worker shard and split
    the batch). Every rank must call the same maker, since each subgroup is
    made by every rank;
  * :meth:`WorkerMesh.shrink` makes the survivors' mesh after a device loss
    (the elastic path of ``runtime/resilience.py``): the highest worker
    indices leave, the survivors get a world group and subgroups of their
    own, and every rank of the old mesh takes part in making them;
  * :func:`spawn` starts the ranks on one host for tests, smoke runs and the
    CLIs (``torch.multiprocessing`` with the ``spawn`` start method, the
    group initialised from a file under ``init_dir``, so concurrent callers
    never race for a TCP port); ``torchrun`` starts them on a cluster.

Two rules hold for every mesh. The backend (``gloo`` or ``nccl``) is the
caller's choice and is never swapped: if ``nccl`` is refused, the call
raises. Every group has a timeout: ``spawn`` initialises its group with one
(60 s by default), and joins its ranks within a wall limit, killing them
past it, so a hung collective is a failure and not a hung caller. A rank
that raises fails the whole ``spawn`` call with the rank's traceback.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
#: Default timeout of a group (its initialisation and every collective).
TIMEOUT_S = 60.0
#: Default wall limit of a whole :func:`spawn` call.
SPAWN_TIMEOUT_S = 900.0


@dataclasses.dataclass(frozen=True, eq=False)
class WorkerMesh:
    """This rank's place on a ``workers x scenarios`` process grid.

    ``axis_names`` names the sharded axes, the reference's mesh axes:
    ``("workers",)``, ``("scenarios",)`` or ``("workers", "scenarios")``.
    ``worker_group`` spans the ranks of this rank's scenario shard (None
    without a ``workers`` axis), ``scenario_group`` the ranks of its worker
    shard (None without a ``scenarios`` axis), ``world_group`` every rank
    of the mesh (None: the default group; a survivors' mesh, :meth:`shrink`,
    has its own). ``timeout_s`` is the timeout its groups were made with."""

    workers: int
    scenarios: int
    rank: int
    backend: str
    axis_names: tuple
    worker_group: Optional[object] = None
    scenario_group: Optional[object] = None
    world_group: Optional[object] = None
    timeout_s: float = TIMEOUT_S

    @property
    def size(self) -> int:
        return self.workers * self.scenarios

    @property
    def worker_index(self) -> int:
        return self.rank // self.scenarios

    @property
    def scenario_index(self) -> int:
        return self.rank % self.scenarios

    def shrink(self, workers_lost: int) -> Optional["WorkerMesh"]:
        """The survivors' mesh after the loss of the highest ``workers_lost``
        worker indices (with their whole rows of scenario shards on a hybrid
        grid), or None on a rank that leaves.

        Ranks sit worker-major, so the survivors are ranks ``0 ..
        (workers - workers_lost) * scenarios - 1``: rank 0 stays, and with it
        the snapshot writer. Every rank of this mesh must call ``shrink``
        with the same count, the leaving ranks included: each new group is
        made by every rank, in the same order (``torch.distributed`` names a
        group by how many were made before it), members and not. The new
        groups take this mesh's timeout."""
        new_w = self.workers - int(workers_lost)
        if not 1 <= new_w < self.workers:
            raise ValueError(f"a {self.workers}-worker mesh cannot lose {workers_lost} "
                             "worker(s) and keep at least one")
        timeout = datetime.timedelta(seconds=self.timeout_s)
        world = dist.new_group(list(range(new_w * self.scenarios)), timeout=timeout)
        wg, sg = _groups(new_w, self.scenarios, self.axis_names, self.rank, timeout)
        if self.rank >= new_w * self.scenarios:
            return None
        return dataclasses.replace(self, workers=new_w, worker_group=wg, scenario_group=sg,
                                   world_group=world)


def no_group_error(workers: int, scenarios: int) -> RuntimeError:
    """The error for a mesh asked for outside a fitting process group."""
    n = workers * scenarios
    have = (f"world size {dist.get_world_size()}" if dist.is_available()
            and dist.is_initialized() else "no initialised process group")
    return RuntimeError(
        f"a {workers} x {scenarios} (workers x scenarios) mesh runs one process "
        f"per rank, {n} in all, each calling the same entry point inside an "
        f"initialised torch.distributed process group of world size {n} "
        f"(here: {have}); start the ranks with repro_torch.launch.mesh.spawn "
        "or torchrun")


def _grid(workers: int, scenarios: int, axis_names: tuple,
          timeout_s: float) -> WorkerMesh:
    if workers < 1 or scenarios < 1:
        raise ValueError(f"mesh axes must be >= 1, got {workers} x {scenarios}")
    n = workers * scenarios
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != n:
        raise no_group_error(workers, scenarios)
    rank = dist.get_rank()
    wg, sg = _groups(workers, scenarios, axis_names, rank,
                     datetime.timedelta(seconds=timeout_s))
    return WorkerMesh(workers=workers, scenarios=scenarios, rank=rank,
                      backend=dist.get_backend(), axis_names=axis_names,
                      worker_group=wg, scenario_group=sg, timeout_s=timeout_s)


def _groups(workers: int, scenarios: int, axis_names: tuple, rank: int, timeout):
    """The ``workers`` and ``scenarios`` subgroups of a ``workers x
    scenarios`` grid over ranks ``0 .. workers * scenarios - 1``, and which
    of them ``rank`` belongs to (None for an axis it lacks, or outside the
    grid). Every rank makes every subgroup, in the same order."""
    wg = sg = None
    if "workers" in axis_names:
        for s in range(scenarios):
            g = dist.new_group([w * scenarios + s for w in range(workers)], timeout=timeout)
            if rank < workers * scenarios and rank % scenarios == s:
                wg = g
    if "scenarios" in axis_names:
        for w in range(workers):
            g = dist.new_group([w * scenarios + s for s in range(scenarios)], timeout=timeout)
            if rank // scenarios == w:
                sg = g
    return wg, sg


def make_worker_mesh(num_workers: Optional[int] = None, *,
                     timeout_s: float = TIMEOUT_S) -> WorkerMesh:
    """1-D mesh over every rank: people and locations of each scenario are
    sharded over ``num_workers`` (default: the world size) workers."""
    n = dist.get_world_size() if num_workers is None and dist.is_initialized() else num_workers
    return _grid(n or 1, 1, ("workers",), timeout_s)


def make_scenario_mesh(num_shards: Optional[int] = None, *,
                       timeout_s: float = TIMEOUT_S) -> WorkerMesh:
    """1-D mesh over every rank: the scenario batch is sharded over
    ``num_shards`` (default: the world size) ranks."""
    n = dist.get_world_size() if num_shards is None and dist.is_initialized() else num_shards
    return _grid(1, n or 1, ("scenarios",), timeout_s)


def make_hybrid_mesh(num_workers: int, num_scenarios: Optional[int] = None, *,
                     timeout_s: float = TIMEOUT_S) -> WorkerMesh:
    """2-D ``workers x scenarios`` mesh: each scenario shard's people and
    locations over ``num_workers`` ranks, the batch over ``num_scenarios``
    (default: world size // num_workers)."""
    if num_scenarios is None:
        if not dist.is_initialized():
            raise no_group_error(num_workers, 1)
        num_scenarios = max(1, dist.get_world_size() // num_workers)
    return _grid(num_workers, num_scenarios, ("workers", "scenarios"), timeout_s)


def join_torchrun(backend: str, device, *, timeout_s: float = TIMEOUT_S) -> None:
    """Initialise the process group of the ranks ``torchrun`` started (its
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), with
    ``timeout_s``; on CUDA the rank's current card is ``LOCAL_RANK %
    device_count``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s))


# ---------------------------------------------------------------------------
# starting ranks on one host
# ---------------------------------------------------------------------------


def _rank_main(rank, world_size, fn, args, backend, device, init_file,
               timeout_s, threads, results):
    """One rank: initialise the group, run ``fn(*args)``, report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":  # "cuda" alone: this rank's card, round robin
            torch.cuda.set_device(rank % torch.cuda.device_count()
                                  if dev.index is None else dev.index)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            # by value: the queue's own pickler would share tensor storage
            # with a process that is about to exit
            out = pickle.dumps(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable, world_size: int, *, backend: str, device, init_dir: str,
          args: tuple = (), timeout_s: float = TIMEOUT_S,
          wall_s: float = SPAWN_TIMEOUT_S, threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks of a fresh process group and
    return the ranks' results, in rank order.

    ``fn`` is a module-level function (it is pickled by name); it reads its
    rank from ``torch.distributed.get_rank()`` and makes its mesh with a
    maker of this module. ``backend`` is ``"gloo"`` or ``"nccl"`` (``nccl``
    needs a CUDA ``device``). ``device`` ``"cuda"`` gives rank r the card
    ``r % device_count`` as its current device; ``"cuda:i"`` puts every rank
    on card i, so several ranks on one card need ``gloo`` (NCCL refuses two
    ranks on one GPU).
    ``timeout_s`` is the group's timeout, ``wall_s`` the limit of the whole
    call; past it the ranks are killed and ``TimeoutError`` is raised. A
    rank that raises or dies fails the call (``RuntimeError`` with its
    traceback), and the other ranks are killed. ``threads`` sets each
    rank's intra-op thread count."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {device}")
    os.makedirs(init_dir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="pg-", dir=init_dir)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank-{rank}", args=(
        rank, world_size, fn, args, backend, str(device),
        os.path.join(run_dir, "init"), timeout_s, threads, results))
        for rank in range(world_size)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + wall_s
        while len(out) < world_size:  # drain before joining
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world_size} ranks over {backend} did not finish in "
                    f"{wall_s:.0f} s; ranks {sorted(set(range(world_size)) - set(out))} "
                    "were killed")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before returning a result")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:  # started
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    return [out[r] for r in range(world_size)]
