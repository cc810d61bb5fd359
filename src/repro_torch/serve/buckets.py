"""Shape buckets: normalizing heterogeneous specs onto a small executable
lattice (the port of the reference's ``repro.serve.buckets``).

The serving tier's economics rest on one fact about the engine: the
warm day-loop runner (on the card a captured CUDA graph) is shaped *only*
by a handful of static facts —
the dataset's padded person/location/visit axes, the batch's intervention
slot structure, the backend and its block size, the scenario-axis width B,
and the static seeding/testing top-k caps. Everything else (tau, seeds,
intervention on/off masks, seeding schedules) is a tensor the runner copies
in: one warm executable serves any request whose *statics* match.

So a :class:`BucketKey` is exactly that static tuple, with the two
request-varying axes quantized UP onto a small lattice:

- **B (scenario width)** → the smallest lattice width >= the request's
  batch. The lattice floor doubles as the cross-request batching width:
  two 2-scenario requests both land in the width-4 bucket and share one
  dispatch, padded slots running inert :func:`~repro_torch.engine.core.
  no_op_params`.
- **seeding cap** (``seed_per_day``) → the smallest lattice cap >= the
  request's. Quantizing the static top-k width up is bitwise-safe: the
  local topology's threshold ignores the hint entirely (full sort), and
  the worker-mesh topologies are exact whenever the hint covers the actual
  budget — which "quantize up" guarantees.
- **days** is *not* part of the executable identity at all: the server
  runs every request through fixed ``chunk_days`` chunks of the same
  warm runner and trims each request's history to its own length
  (the day loop is causal, so a prefix of a longer run is
  bitwise-identical to a shorter run). Days only group dispatches:
  requests batched together must want the same chunk count.

The person/location/visit axes need no lattice of their own here — they
are a pure function of ``(dataset, block_size, pack_visits)``, which the
fingerprint already pins.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.api.spec import ExperimentSpec

#: The layouts a bucket may be placed on (``EngineCore``'s): one device,
#: each bucket a captured CUDA graph, or a process mesh, where the runner
#: is the eager loop (a graph cannot hold the day's collectives) and every
#: rank runs each dispatch (``serve/server.py``).
LAYOUTS = ("local", "workers", "scenarios", "hybrid")


def quantize_up(value: int, lattice: Tuple[int, ...]) -> int:
    """The smallest lattice point >= ``value``; beyond the lattice, the
    next power of two (so oversized requests still get a stable, reusable
    bucket instead of an exact one-off width)."""
    if value < 1:
        raise ValueError(f"cannot bucket a size < 1, got {value}")
    for point in sorted(lattice):
        if value <= point:
            return int(point)
    return 1 << max(0, (value - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Capacity knobs for a :class:`~repro_torch.serve.server.SimulationServer`.

    ``b_lattice``'s smallest point is the default batching width — keep it
    >= the typical concurrent-request width so requests actually share
    dispatches. ``chunk_days`` is the streaming granularity AND the one
    day-count every runner is captured for. ``max_executables`` bounds
    the warm bucket table (LRU beyond it); ``strict`` makes any post-warmup
    rebuild (a capture on the card; on a mesh also a plan, per-rank tables
    or a process group) a request-failing error rather than just a counted
    one. ``layout`` places every bucket (:meth:`resolved_layout`);
    ``workers`` and ``scen_shards`` size a mesh layout's axes (1: the
    world size, for the layout's one axis)."""

    layout: str = "local"  # engine-core layout for every bucket
    workers: int = 1
    scen_shards: int = 1
    chunk_days: int = 8
    b_lattice: Tuple[int, ...] = (4, 8)
    seed_lattice: Tuple[int, ...] = (16, 64, 256)
    max_executables: int = 4
    max_wait_s: float = 0.002  # batching window: how long dispatch lingers
    #: for more same-bucket requests before running a partial batch.
    strict: bool = True

    def validate(self) -> "ServeConfig":
        if self.chunk_days < 1:
            raise ValueError("chunk_days must be >= 1")
        if not self.b_lattice or min(self.b_lattice) < 1:
            raise ValueError("b_lattice needs at least one width >= 1")
        if not self.seed_lattice or min(self.seed_lattice) < 1:
            raise ValueError("seed_lattice needs at least one cap >= 1")
        if self.max_executables < 1:
            raise ValueError("max_executables must be >= 1")
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout '{self.layout}'")
        if self.workers < 1 or self.scen_shards < 1:
            raise ValueError("workers and scen_shards must be >= 1")
        return self

    def resolved_layout(self) -> str:
        """The layout buckets are placed on: ``layout``, or for ``"local"``
        with ``workers`` or ``scen_shards`` above 1 the mesh layout those
        counts name."""
        if self.layout != "local":
            return self.layout
        if self.workers > 1:
            return "hybrid" if self.scen_shards > 1 else "workers"
        return "scenarios" if self.scen_shards > 1 else "local"


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Executable identity: everything static about a warm bucket.
    Hashable — it keys the server's BoundedLRU of warm cores."""

    dataset: str
    disease: str
    interventions: Tuple[str, ...]
    static_network: bool
    backend: str
    block_size: int
    pack_visits: bool
    b_bucket: int  # quantized scenario-axis width
    seed_cap: int  # quantized max seed_per_day (static top-k width)

    def label(self) -> str:
        """Compact human/JSON-friendly name for metrics and provenance."""
        iv = "+".join(self.interventions)
        return (f"{self.dataset}/{self.disease}/{iv}/{self.backend}"
                f"/B{self.b_bucket}/seed{self.seed_cap}"
                f"{'/static' if self.static_network else ''}")


@dataclasses.dataclass(frozen=True)
class RequestShape:
    """Where a request lands: its bucket plus the dispatch-grouping
    facts that are NOT executable identity. Requests batched into one
    dispatch must agree on the whole shape (same bucket => same warm
    runner; same ``n_chunks`` => same number of runner invocations)."""

    bucket: BucketKey
    n_chunks: int  # ceil(days / chunk_days)
    b_request: int  # the request's real scenario count (<= bucket.b_bucket)

    @property
    def padded_days(self) -> int:
        return self.n_chunks  # in chunk units; days = n_chunks * chunk_days


def bucketize(spec: ExperimentSpec, config: ServeConfig) -> RequestShape:
    """Normalize a validated spec onto the server's bucket lattice.

    Raises ``ValueError`` for specs the serving tier refuses: checkpoint/
    resilience policies (serving streams results, it does not snapshot)
    and pinned engines that fight the server's own placement.
    """
    if spec.checkpoint.directory is not None:
        raise ValueError(
            "serving refuses checkpointed specs — the server streams "
            "per-day stats instead of snapshotting; run it via api.run")
    if spec.resilience.enabled:
        raise ValueError(
            "serving refuses resilient specs — recovery policy belongs "
            "to batch runs; run it via api.run")
    if spec.engine != "auto":
        raise ValueError(
            f"serving refuses engine='{spec.engine}' — placement is the "
            "server's (ServeConfig.layout), pin layouts there instead")
    b_req = spec.num_scenarios
    fp = spec.compile_fingerprint()
    key = BucketKey(
        dataset=fp["dataset"],
        disease=fp["disease"],
        interventions=fp["interventions"],
        static_network=fp["static_network"],
        backend=fp["backend"],
        block_size=fp["block_size"],
        pack_visits=fp["pack_visits"],
        b_bucket=quantize_up(b_req, config.b_lattice),
        seed_cap=quantize_up(max(1, spec.seed_per_day), config.seed_lattice),
    )
    n_chunks = max(1, math.ceil(spec.days / config.chunk_days))
    return RequestShape(bucket=key, n_chunks=n_chunks, b_request=b_req)


def padded_days(shape: RequestShape, config: ServeConfig) -> int:
    """Total simulated days for a dispatch of this shape (>= spec.days;
    the surplus is trimmed from each request's history prefix)."""
    return shape.n_chunks * config.chunk_days
