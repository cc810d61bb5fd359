"""Serving-tier telemetry: counters + latency reservoirs (the port of the
reference's ``repro.serve.metrics``, with the same ``to_dict`` keys).

Everything the acceptance targets are stated in lives here: time-to-
first-day percentiles (the interactive-latency number), specs/sec,
batch occupancy (real vs padded scenario slots), cold compiles (bucket
builds: on the card, a CUDA-graph capture) vs warm dispatches, a mesh
bucket's host builds (its plan, per-rank tables, process groups), bucket
evictions, and — the hard invariant — recompile violations: a runner
build observed by :class:`repro_torch.analysis.capture.recompile_sentinel`
*after* a bucket's warmup, which steady-state serving must never produce.

Thread-safe: the server mutates these from its dispatch thread while
clients read :meth:`ServeMetrics.to_dict` concurrently.
"""

from __future__ import annotations

import threading


class LatencyStat:
    """A bounded reservoir of latency samples with percentile readout.

    Keeps the most recent ``cap`` samples (enough for p99 at CI scale);
    count/total keep the lifetime mean honest even after wraparound.
    """

    def __init__(self, name: str, cap: int = 4096):
        self.name = name
        self.cap = cap
        self._samples: list = []
        self._next = 0  # ring index once the reservoir is full
        self.count = 0
        self.total = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if len(self._samples) < self.cap:
            self._samples.append(seconds)
        else:
            self._samples[self._next] = seconds
            self._next = (self._next + 1) % self.cap

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained samples (0 if none)."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "mean_s": (self.total / self.count) if self.count else 0.0,
            "p50_s": self.percentile(50),
            "p90_s": self.percentile(90),
            "p99_s": self.percentile(99),
            "max_s": max(self._samples) if self._samples else 0.0,
        }


class ServeMetrics:
    """The server's counter block. All mutation goes through methods that
    take the internal lock; ``to_dict`` snapshots under the same lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0  # refused at admission (validate/bucketize)
        self.batches = 0
        self.slots_real = 0  # scenario slots carrying a real request
        self.slots_padded = 0  # scenario slots running no_op_params
        self.chunks_run = 0
        self.cold_compiles = 0  # bucket warmups (runner builds: captures)
        self.warm_dispatches = 0  # batches served from a warm executable
        self.recompile_violations = 0  # sentinel trips: MUST stay 0
        # host builds of mesh buckets (plan, tables, groups): a cold bucket's
        # (and the server's group, once); a warm dispatch makes none
        self.mesh_builds: dict = {}
        self.ttfd = LatencyStat("time_to_first_day")
        self.latency = LatencyStat("request_latency")
        self.queue_wait = LatencyStat("queue_wait")

    # -- mutation hooks (called by the server) ---------------------------
    def on_submit(self, n: int = 1):
        with self._lock:
            self.submitted += n

    def on_reject(self):
        with self._lock:
            self.rejected += 1

    def on_batch(self, real: int, padded: int, warm: bool, chunks: int):
        with self._lock:
            self.batches += 1
            self.slots_real += real
            self.slots_padded += padded
            self.chunks_run += chunks
            if warm:
                self.warm_dispatches += 1
            else:
                self.cold_compiles += 1

    def on_first_day(self, seconds: float):
        with self._lock:
            self.ttfd.add(seconds)

    def on_complete(self, latency_s: float, queue_wait_s: float):
        with self._lock:
            self.completed += 1
            self.latency.add(latency_s)
            self.queue_wait.add(queue_wait_s)

    def on_fail(self, n: int = 1):
        with self._lock:
            self.failed += n

    def on_mesh_build(self, kind: str):
        with self._lock:
            self.mesh_builds[kind] = self.mesh_builds.get(kind, 0) + 1

    def on_recompile_violation(self):
        with self._lock:
            self.recompile_violations += 1

    # -- readout ---------------------------------------------------------
    def to_dict(self, bucket_stats: dict = None) -> dict:
        with self._lock:
            slots = self.slots_real + self.slots_padded
            d = {
                "requests": {
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "failed": self.failed,
                    "rejected": self.rejected,
                },
                "batches": {
                    "dispatched": self.batches,
                    "chunks_run": self.chunks_run,
                    "slots_real": self.slots_real,
                    "slots_padded": self.slots_padded,
                    "occupancy": (self.slots_real / slots) if slots else 0.0,
                    "requests_per_batch": (
                        self.completed / self.batches if self.batches else 0.0
                    ),
                },
                "executables": {
                    "cold_compiles": self.cold_compiles,
                    "warm_dispatches": self.warm_dispatches,
                    "recompile_violations": self.recompile_violations,
                    "mesh_builds": dict(self.mesh_builds),
                },
                "time_to_first_day": self.ttfd.to_dict(),
                "request_latency": self.latency.to_dict(),
                "queue_wait": self.queue_wait.to_dict(),
            }
        if bucket_stats is not None:
            d["buckets"] = bucket_stats
        return d
