"""Named spans along the study path, on the profiler's clock.

``with span("week.schedule"):`` marks a stretch of the program. While a
``torch.profiler`` records on this thread the span is a
``torch.profiler.record_function(name)``: it lands on the profiler's host
timeline, on the device trace's clock, nested as the code nests it, and the
profiler's own tables (``key_averages()``, the exported trace) hold its
count and times. Otherwise it is a shared null context: one read of the
profiler's flag, no ``record_function``, no allocation. The flag is the
thread's own, so a thread the profiler was not started on (the server's
dispatch thread) records nothing.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager marking ``name`` on the profiler's timeline; the
    shared null context while no profiler records on this thread."""
    return torch.profiler.record_function(name) if _profiling() else _OFF
