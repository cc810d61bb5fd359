"""Capture-once serving tier: warm runner cache + request batching.

The port of the reference's ``repro.serve``. ``api.run(spec)`` runs the day
loop eagerly, ~900 host dispatches a day; interactive what-if traffic
cannot pay that. This package keeps warm runners *resident* — one
:class:`~repro_torch.serve.server.WarmBucket` per quantized shape bucket,
LRU-bounded, on the card a captured CUDA graph of ``chunk_days`` batched
days — and serves concurrent :class:`~repro_torch.api.spec.ExperimentSpec`
requests by packing them onto the scenario axis of an already-built
runner, bitwise equal to solo runs.

    from repro_torch.serve import ServeConfig, SimulationServer
    server = SimulationServer(ServeConfig(chunk_days=8))  # device="cpu" on request
    server.warm_up(spec)             # the one capture
    result = server.run(spec)        # graph replays, zero captures
    result.served_from["bucket"]
"""

from repro_torch.serve.batcher import (  # noqa: F401
    RequestBatcher,
    ServeError,
    ServeRequest,
    ServeTicket,
)
from repro_torch.serve.buckets import (  # noqa: F401
    BucketKey,
    RequestShape,
    ServeConfig,
    bucketize,
    quantize_up,
)
from repro_torch.serve.metrics import LatencyStat, ServeMetrics  # noqa: F401
from repro_torch.serve.server import SimulationServer, WarmBucket  # noqa: F401
