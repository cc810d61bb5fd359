"""Level-2 determinism checks on what a function dispatches: the port's
counterpart of the reference's ``repro.analysis.hlo`` helpers
(``find_f64``, ``assert_no_f64``, ``collective_count``).

The reference traces a function to a jaxpr and reads every equation's
output dtypes. Torch runs eagerly, so the port records instead: the function
runs once under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
that sees every ATen op it issues — factory functions, ops inside Python
loops and inside the callee's callees included — and reads each op's
outputs. What the dispatcher does not see: a hand-written kernel launched
through ``ctypes`` (its buffers are made by ops that it does see) and host
numpy work.

The bug class is the reference's: a float64 value that leaks into float32
state and changes its rounding — a float64 numpy array taken in with
``torch.from_numpy``, or a constructor whose dtype follows
``torch.get_default_dtype()`` after some module called
``torch.set_default_dtype(torch.float64)`` (the static rule DET003 of
:mod:`repro_torch.analysis.lint` catches the constructors). The port carries
u32 hash words in int64 by design, so int64 is not a finding.

``collective_count`` reads the counters that the mesh topologies already
keep (``engine/topology.py``): the collectives a function issued, by kind.
``analysis/capture.py:recompile_sentinel`` is the third helper.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

_WIDE_DTYPES = (torch.float64, torch.complex128)


class _WideRecorder(TorchDispatchMode):
    """Records (op, output index, dtype) for every wide-dtype op output."""

    def __init__(self):
        super().__init__()
        self.leaks: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for i, t in enumerate(_pytree.tree_leaves(out)):
            if isinstance(t, torch.Tensor) and t.dtype in _WIDE_DTYPES:
                self.leaks.append((str(func), i, str(t.dtype).replace("torch.", "")))
        return out


def find_f64(fn, *args, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` once and return every ``(op, output
    index, dtype)`` whose output is float64 or complex128, in dispatch
    order. Empty: nothing ``fn`` dispatched was wide."""
    rec = _WideRecorder()
    with rec:
        fn(*args, **kwargs)
    return rec.leaks


def assert_no_f64(fn, *args, **kwargs) -> None:
    """Assert that no op ``fn`` dispatches outputs float64 or complex128."""
    leaks = find_f64(fn, *args, **kwargs)
    if leaks:
        head = ", ".join(f"{op}[{i}]:{d}" for op, i, d in leaks[:8])
        more = f" (+{len(leaks) - 8} more)" if len(leaks) > 8 else ""
        raise AssertionError(
            f"f64 leak: {len(leaks)} wide-dtype op output(s): {head}{more}")


def collective_count(topo, fn, *args, **kwargs) -> dict:
    """The collectives ``fn(*args, **kwargs)`` issued through ``topo`` (a
    mesh topology's counters, ``engine/topology.py``), by kind; ``{}`` on
    the local topology, which issues none. The counters keep counting."""
    counts = getattr(topo, "counts", None)
    if counts is None:
        fn(*args, **kwargs)
        return {}
    before = dict(counts)
    fn(*args, **kwargs)
    return {k: v - before.get(k, 0) for k, v in counts.items() if v != before.get(k, 0)}
