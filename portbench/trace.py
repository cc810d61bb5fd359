"""A traced slice of a run: ``torch.profiler`` over the device and the host,
reduced to what the per-layer readers and the result line need.

:class:`Slice` profiles the code inside its ``with`` block. Afterwards it
holds the device's intervals (kernels, copies and fills) with their names,
the host's operator intervals, the slice's wall length, the union of the
device's busy time, and the ``breakdown`` of the result line: the device
operations that took most time and the longest idle gaps, each named by
what the host was doing when the gap began.
"""

from __future__ import annotations

import collections
import time

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Slice:
    """A profiled stretch of the run (host clock from ``__enter__`` to
    ``__exit__``; the device synchronised at both ends)."""

    def __init__(self, label: str):
        self.label = label
        self.device = []  # (start_ns, end_ns, name)
        self.host = []  # (start_ns, end_ns, name), host operators and spans
        self.window_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self._prof = profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._ns0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        _sync()
        self.window_s = time.perf_counter() - self._t0
        self._ns1 = time.time_ns()
        self._prof.__exit__(*exc)
        events = self._prof.profiler.kineto_results.events()
        # a host span is mirrored onto the device's timeline under its own
        # name: that is no device work
        spans = {ev.name() for ev in events if ev.is_user_annotation()}
        for ev in events:
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if str(ev.device_type()).endswith("CUDA"):  # kernels, copies, fills
                if ev.name() not in spans:
                    self.device.append((s, e, ev.name()))
            else:
                self.host.append((s, e, ev.name()))
        self.device.sort()
        self.host.sort()
        del self._prof
        return False

    # -- readings ---------------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union)."""
        total, cur_s, cur_e = 0, None, None
        for s, e, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def ops(self, name_part: str = "") -> list:
        """Device intervals whose name contains ``name_part``."""
        return [d for d in self.device if name_part in d[2]]

    def device_ops(self, top: int = 10) -> list:
        by_name = collections.Counter()
        for s, e, n in self.device:
            by_name[n[:120]] += (e - s) / 1e9
        return [[n, v] for n, v in by_name.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches with nothing on the device, inside the
        slice, each named by the innermost host operation or span running
        at its middle (``host`` if none)."""
        gaps, prev_end = [], self._ns0
        for s, e, _ in self.device:
            if s > prev_end:
                gaps.append((s - prev_end, prev_end))
            prev_end = max(prev_end, e)
        if self._ns1 > prev_end:
            gaps.append((self._ns1 - prev_end, prev_end))
        gaps.sort(reverse=True)
        out = []
        for length, begin in gaps[:top]:
            at, name = begin + length // 2, "host"
            for s, e, n in self.host:  # sorted by start: the last match is innermost
                if s > at:
                    break
                if e >= at:
                    name = n
            out.append([f"{self.label}: {name}"[:160], length / 1e9])
        return out
