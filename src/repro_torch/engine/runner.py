"""A warm day-loop runner: on the card, a captured CUDA graph of the batched day.

The reference compiles its day loop into one XLA scan per ``(days,
observables)`` key (``repro.engine.core.EngineCore._runner``) and serves
every later call of the same argument shapes from that executable. The
port's counterpart is a :class:`DayRunner`: ``runner(params, state,
carries=())`` runs ``days`` days of :func:`repro_torch.engine.day.run_days`
and returns ``(final_state, carries, hist, dailies)``, ``hist`` the
(days, len(STAT_KEYS), B) history over every scenario slot.

What it builds depends on the device, and a build is made once per input
signature (the tree's structure and every tensor's shape, dtype and
device), as a jit cache holds one executable per signature:

  * **on ``cuda``** — a :class:`CapturedDays`: a ``torch.cuda.CUDAGraph``
    of the whole ``days``-day loop, with static input buffers (the stacked
    params, state and carries) and static outputs. A call copies the
    caller's tensors into the inputs with ``copy_``, replays the graph on
    the current stream (one graph launch in place of ~900 host dispatches
    a day) and returns clones of the outputs. A capture that fails raises:
    there is no eager fall back on the card;
  * **on the CPU** — the eager loop; the build records the signature only,
    so the count of builds means the same on both devices.

:meth:`DayRunner.cache_size` is that count: what
:class:`repro_torch.analysis.capture.recompile_sentinel` watches.

Everything the day loop reads as a Python value is frozen into a graph at
capture: the loop's Python branches read only ``EngineStatic`` and the day
count, and every value that varies by call (seeds, day, tau, seeding and
intervention numerics) is a tensor of ``SimParams``/``SimState``, so a
replay of a later chunk equals its eager run
(``tests/test_torch_gpu.py::test_captured_runner_equals_eager_run_days``).

The kernel wrappers (:data:`COUNTED`: the interaction kernels' and the
counter draw's) count their launches in Python, which runs at capture and
not at replay. So a capture's launches are taken off the
counters again (the capture ran nothing), and each replay adds them back:
the counts keep meaning kernels that ran, replayed days included.

A runner holds static buffers, so one thread at a time may call it. A
capture must not overlap CUDA work of another thread of the process (the
default ``capture_error_mode="global"`` refuses it); the serving tier
captures under its dispatch lock with its finisher drained.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.kernels.interactions import kernel as interactions
from repro_torch.kernels.rng import kernel as rng_kernel

#: The wrappers whose ``launches`` a replay adds to.
COUNTED = (*interactions.WRAPPERS, rng_kernel.uniform_cuda)


def flatten(tree):
    """``(tensors, structure)`` of a tree of dataclasses, dicts, tuples and
    lists over tensors; any other leaf is a constant of the structure."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return None
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return (type(x), tuple((f.name, walk(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)))
        if isinstance(x, dict):
            return (dict, tuple((k, walk(v)) for k, v in x.items()))
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(walk(v) for v in x))
        return ("const", x)

    return leaves, walk(tree)


def unflatten(structure, leaves):
    """The inverse of :func:`flatten`: ``leaves`` in the same order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, body = node
        if kind == "const":
            return body
        if kind is dict:
            return {k: build(v) for k, v in body}
        if kind in (tuple, list):
            return kind(build(v) for v in body)
        return kind(**{name: build(v) for name, v in body})

    return build(structure)


def signature(structure, leaves) -> tuple:
    """What a build is keyed by: the structure and each tensor's shape,
    dtype and device."""
    return structure, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def _launch_counts() -> dict:
    return {w: w.launches for w in COUNTED}


class CapturedDays:
    """One captured CUDA graph of ``fn`` over static copies of ``leaves``.

    Built by running ``fn`` once eagerly on a side stream (lazy
    initialisation: the kernel library's build and load, the allocator's
    first blocks), then capturing it. ``capture_s`` is the whole build's
    wall time, ``pool_bytes`` the memory the graph's private pool reserved
    (the day loop's temporaries and the static outputs), ``input_bytes``
    the static inputs', ``launches`` the kernel launches one replay makes,
    by wrapper (:data:`COUNTED`)."""

    def __init__(self, fn, structure, leaves):
        t0 = time.perf_counter()
        device = leaves[0].device
        self.inputs = [t.clone() for t in leaves]
        args = unflatten(structure, self.inputs)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            reserved = torch.cuda.memory_reserved(device)
            out = fn(*args)
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        # The capture launched nothing: take its counts off, add them per replay.
        self.launches = {}
        for w, n in before.items():
            if w.launches != n:
                self.launches[w] = w.launches - n
                w.launches = n
        self.outputs, self.out_structure = flatten(out)
        self.input_bytes = sum(t.numel() * t.element_size() for t in self.inputs)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, leaves):
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)
        self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n
        return unflatten(self.out_structure, [t.clone() for t in self.outputs])


class _Eager:
    """The CPU's build: the eager loop over the caller's tensors."""

    def __init__(self, fn, structure):
        self.fn, self.structure = fn, structure

    def __call__(self, leaves):
        return self.fn(*unflatten(self.structure, leaves))


class DayRunner:
    """``fn(params, state, carries) -> (state, carries, hist, dailies)``,
    built once per input signature: captured on ``cuda``, eager on the
    CPU (the module's docstring). With ``capture=False`` it is eager on the
    card too: a mesh's day issues collectives over ``torch.distributed``,
    which a CUDA graph cannot hold."""

    def __init__(self, fn, device: torch.device, *, capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = capture
        self._builds: dict = {}

    def cache_size(self) -> int:
        """Builds made so far (captures on the card): one per signature."""
        return len(self._builds)

    def builds(self) -> list:
        """The builds, oldest first (:class:`CapturedDays` on the card)."""
        return list(self._builds.values())

    def is_built(self, params, state, carries=()) -> bool:
        """Whether a call with these arguments replays without a build."""
        leaves, structure = flatten((params, state, carries))
        return signature(structure, leaves) in self._builds

    def __call__(self, params, state, carries=()):
        leaves, structure = flatten((params, state, carries))
        key = signature(structure, leaves)
        build = self._builds.get(key)
        if build is None:
            dev = self.device
            if any(t.device.type != dev.type or dev.index not in (None, t.device.index)
                   for t in leaves):
                raise ValueError(f"a runner on {self.device} takes tensors on that "
                                 "device only")
            if self.device.type == "cuda" and self.capture:
                build = CapturedDays(self.fn, structure, leaves)
            else:
                build = _Eager(self.fn, structure)
            self._builds[key] = build
        return build(leaves)
