"""Request admission + scenario-axis batch formation (the port of the
reference's ``repro.serve.batcher``).

A :class:`ServeRequest` is one admitted spec with its normalized
:class:`~repro_torch.serve.buckets.RequestShape`, a per-chunk stream queue, and
a completion event; :class:`ServeTicket` is the client-facing handle over
it. :class:`RequestBatcher` holds the FIFO of pending requests and forms
dispatch groups: the oldest pending request seeds a group, and younger
requests join it while they (a) land in the same bucket (same warm
runner), (b) want the same chunk count (same number of runner
invocations), and (c) fit in the bucket's remaining scenario slots.
FIFO-fair: a request is never passed over in favor of a younger one that
would fill the batch better — tail latency beats occupancy here.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import List, Optional

from repro_torch.api.spec import ExperimentSpec
from repro_torch.serve.buckets import RequestShape

_STREAM_END = object()


class ServeError(RuntimeError):
    """A request failed inside the serving tier (admission refusal is a
    plain ValueError at submit; this is a dispatch-time failure)."""


class ServeRequest:
    """Internal per-request record. The server fills it in; the ticket
    reads it out."""

    def __init__(self, spec: ExperimentSpec, shape: RequestShape):
        self.spec = spec
        self.shape = shape
        self.submitted_at = time.time()
        self.dispatched_at: Optional[float] = None
        self.first_day_at: Optional[float] = None
        self.done_at: Optional[float] = None
        self.result = None  # RunResult on success
        self.error: Optional[BaseException] = None
        self._stream: "queue.Queue" = queue.Queue()
        self._done = threading.Event()

    # -- producer side (server) -----------------------------------------
    def push_chunk(self, day_start: int, days: int, stats: dict) -> None:
        if self.first_day_at is None:
            self.first_day_at = time.time()
        self._stream.put({"day_start": day_start, "days": days,
                          "stats": stats})

    def finish(self, result) -> None:
        self.result = result
        if self.done_at is None:  # the finisher may stamp it pre-metrics
            self.done_at = time.time()
        self._stream.put(_STREAM_END)
        self._done.set()

    def fail(self, err: BaseException) -> None:
        self.error = err
        if self.done_at is None:
            self.done_at = time.time()
        self._stream.put(_STREAM_END)
        self._done.set()

    # -- timing readouts -------------------------------------------------
    @property
    def queue_wait_s(self) -> float:
        t = self.dispatched_at or self.done_at or time.time()
        return t - self.submitted_at

    @property
    def ttfd_s(self) -> Optional[float]:
        if self.first_day_at is None:
            return None
        return self.first_day_at - self.submitted_at

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_at is None:
            return None
        return self.done_at - self.submitted_at


class ServeTicket:
    """The client's handle on a submitted spec: stream per-chunk day
    stats as they leave the day loop, then collect the final RunResult."""

    def __init__(self, request: ServeRequest):
        self._req = request

    @property
    def shape(self) -> RequestShape:
        return self._req.shape

    def stream(self, timeout: Optional[float] = None):
        """Yield ``{"day_start", "days", "stats"}`` dicts per chunk, in
        day order, ending when the request completes (or fails — the
        failure surfaces in :meth:`result`, not mid-stream)."""
        while True:
            item = self._req._stream.get(timeout=timeout)
            if item is _STREAM_END:
                return
            yield item

    def result(self, timeout: Optional[float] = None):
        """Block for the RunResult; raises ServeError on dispatch
        failure, TimeoutError if the server doesn't finish in time."""
        if not self._req._done.wait(timeout=timeout):
            raise TimeoutError("serve request did not complete in time")
        if self._req.error is not None:
            raise ServeError(str(self._req.error)) from self._req.error
        return self._req.result

    def done(self) -> bool:
        return self._req._done.is_set()

    @property
    def ttfd_s(self) -> Optional[float]:
        return self._req.ttfd_s

    @property
    def latency_s(self) -> Optional[float]:
        return self._req.latency_s


class RequestBatcher:
    """FIFO pending queue + group formation. Not thread-safe by itself —
    the server serializes access under its own lock."""

    def __init__(self):
        self._pending: deque = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, request: ServeRequest) -> None:
        self._pending.append(request)

    def take_group(self) -> List[ServeRequest]:
        """Pop the next dispatch group: seeded by the oldest pending
        request, greedily joined (in FIFO order) by same-bucket,
        same-chunk-count requests while scenario slots remain. Returns
        [] when nothing is pending."""
        if not self._pending:
            return []
        seed = self._pending.popleft()
        group = [seed]
        capacity = seed.shape.bucket.b_bucket - seed.shape.b_request
        survivors = deque()
        while self._pending:
            req = self._pending.popleft()
            if (req.shape.bucket == seed.shape.bucket
                    and req.shape.n_chunks == seed.shape.n_chunks
                    and req.shape.b_request <= capacity):
                group.append(req)
                capacity -= req.shape.b_request
            else:
                survivors.append(req)
        self._pending = survivors
        return group
