"""Per-rank cost of a function, read from what it dispatches (the
reference's ``repro/analysis/hlo.py``: ``collective_bytes`` and
``measure_compiled``).

The reference reads XLA's per-device artifacts of a compiled SPMD program:
its optimized HLO text for the collectives and its cost and memory analyses
for the rest. Eager torch compiles nothing, so the port runs the function
once under :class:`DispatchMeter`, a ``TorchDispatchMode`` that sees every
ATen op one rank runs. For an op on DTensors the mode returns
``NotImplemented``: DTensor then runs it on this rank's local shards, and
those local ops, with the functional collectives of DTensor's
redistributions, come back through the mode. So every count is *per rank*,
as the reference's, replicated work included; the ops that DTensor's
sharding propagation runs on fake tensors are not counted. On ``meta``
tensors (the dry run) nothing is computed and the counts are the same.

The reference's level-2 determinism helpers live elsewhere in the port:
``find_f64``, ``assert_no_f64`` and ``collective_count`` in
:mod:`repro_torch.analysis.dispatch`, ``recompile_sentinel`` in
:mod:`repro_torch.analysis.capture`.
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# op name -> (kind, index of the operand argument). Functional collectives
# (DTensor's redistributions, torch.distributed._functional_collectives)
# take their input first; the c10d ops of torch.distributed's calls take
# their outputs first, except those that work in place.
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "broadcast": ("broadcast", 0),
}
_C10D = {
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
    "send": ("collective-permute", 0),
}

#: Ops whose every output element costs one transcendental (XLA's count:
#: exp, log, tanh, rsqrt, sqrt, sin, cos, erf, logistic, power; a softmax,
#: SiLU or GELU as its one exp, logistic or erf/tanh per element).
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "rsqrt", "sqrt",
    "sin", "cos", "erf", "sigmoid", "pow", "silu", "gelu", "_softmax", "_log_softmax",
))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class DispatchMeter(TorchDispatchMode):
    """Counts what one rank dispatches while active (see the module
    docstring): matmul-class flops, bytes in and out of every op, the
    transcendentals, the collectives' operand bytes by kind, and the peak of
    the live tensors that the rank's ops made."""

    def __init__(self, keep=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.coll_bytes: dict = defaultdict(int)
        self.coll_count: dict = defaultdict(int)
        # storage -> [bytes, live tensors]; storages of ``keep`` (the
        # arguments) are never counted as made here
        self._keep = {_storage_key(_local(t)) for t in _tensors(keep)}
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on local shards, seen here
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's sharding propagation, not the rank's work
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = (_FUNCTIONAL if func.namespace == "_c10d_functional" else _C10D).get(name)
            if kind is not None:
                self.coll_bytes[kind[0]] += sum(_nbytes(t) for t in _tensors(args[kind[1]]))
                self.coll_count[kind[0]] += 1
            return out
        from torch.utils.flop_counter import flop_registry

        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        # a view or an in-place op's output holds an existing storage
        made = not (func.is_view or func._schema.is_mutable)
        for t in outs:
            self._track(t, made)
        return out

    def _track(self, t: torch.Tensor, made: bool) -> None:
        key = _storage_key(t)
        if key in self._keep:
            return
        entry = self._live.get(key)
        if entry is None:
            if not made:
                return  # a view of a tensor made before the meter
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def collectives(self) -> dict:
        return {
            "bytes": dict(self.coll_bytes),
            "count": dict(self.coll_count),
            "total_bytes": int(sum(self.coll_bytes.values())),
        }


def collective_bytes(fn, *args, **kwargs) -> dict:
    """Per-rank *operand* bytes by collective kind, and op counts, of one
    call ``fn(*args, **kwargs)`` (the reference's dict, from its post-SPMD
    HLO text): an all-gather counts its input shard, a reduce-scatter its
    full input, an all-reduce, all-to-all or send its input. The kinds are
    the reference's HLO names (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute`` for a send),
    and ``broadcast``."""
    with DispatchMeter(keep=(args, kwargs)) as meter:
        fn(*args, **kwargs)
    return meter.collectives()


def measure_compiled(fn, *args, **kwargs) -> dict:
    """One call ``fn(*args, **kwargs)``, measured per rank, under the keys
    of the reference's measurement of a compiled cell:

    * ``flops``: the flops of the ops torch's flop counter models
      (``torch.utils.flop_counter``: matmuls, convolutions, attention), on
      this rank's local shards; elementwise ops count none. A kernel
      launched outside the dispatcher (the flash kernel's ``ctypes`` launch)
      is not seen: callers add its analytic count.
    * ``bytes_accessed``: the sum of the input and output bytes of every
      ATen op the rank runs (views excluded). Eager torch fuses nothing, so
      this is what the rank moves through memory, an upper bound of what a
      fusing compiler would.
    * ``transcendentals``: output elements of the ops that compute one per
      element (exp, log, tanh, rsqrt, sqrt, sin, cos, erf, sigmoid, pow,
      softmax, SiLU, GELU).
    * ``memory``: ``argument_bytes`` and ``output_bytes``, the local shards'
      sizes of the arguments and of the result; ``temp_bytes``, the peak,
      taken after each op, of the storage held by live tensors that the
      rank's ops made (outputs included while they live; a tensor's storage
      counts from the op that made it until its last tensor is freed; this
      works on ``meta`` tensors, which have sizes and no data);
      ``generated_code_bytes`` 0: eager torch generates no code, its
      kernels are the library's and the port's prebuilt ones.
    * ``collectives``: :func:`collective_bytes`' dict, from the same call.
    """
    with DispatchMeter(keep=(args, kwargs)) as meter:
        out = fn(*args, **kwargs)
    return {
        "flops": float(meter.flops),
        "bytes_accessed": float(meter.bytes_accessed),
        "transcendentals": float(meter.transcendentals),
        "memory": {
            "argument_bytes": sum(_nbytes(_local(t)) for t in _tensors((args, kwargs))),
            "output_bytes": sum(_nbytes(_local(t)) for t in _tensors(out)),
            "temp_bytes": meter.peak_bytes,
            "generated_code_bytes": 0,
        },
        "collectives": meter.collectives(),
    }
