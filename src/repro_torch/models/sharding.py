"""Logical-axis sharding rules with the divisibility guard (the reference's
``repro/models/sharding.py``), on ``torch.distributed.tensor``.

Every parameter and activation of the language models is annotated with
*logical* axis names; a :class:`MeshRules` table maps them to mesh axes. A
:class:`PartitionSpec` (one entry per tensor dimension: None, a mesh axis
name, or a tuple of names) is the reference's ``jax.sharding.PartitionSpec``.
On a ``DeviceMesh`` whose dimension names are the mesh axes, a spec becomes
DTensor placements (:func:`placements`): each mesh dimension named by a
tensor dimension's entry shards that tensor dimension (``Shard(d)``), every
other mesh dimension replicates. A tuple entry such as ``("pod", "data")``
shards one tensor dimension over several mesh dimensions in mesh order,
DTensor's nesting order, which is the reference's for every default rule.

The guard: a logical dimension that does not divide by its mesh axes'
product, or a second use of a mesh axis within one spec, is dropped to
replicated and the event recorded in ``MeshRules.dropped``, as the
reference does (no padding of real head counts).

:meth:`MeshRules.for_mesh` and :meth:`MeshRules.spec` need only axis names
and sizes, so an :class:`AbstractMesh` (the counterpart of
``jax.sharding.AbstractMesh``) serves them; :meth:`MeshRules.sharding` and
:meth:`MeshRules.constraint` need a real ``DeviceMesh`` and raise without
one. ``constraint`` redistributes a DTensor to the spec's placements (the
reference's ``with_sharding_constraint``) and leaves a plain tensor as it
is: a computation on plain tensors is one device's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Axis = Union[str, tuple, None]

# Default logical->mesh mapping (the paper-faithful GSPMD baseline).
DEFAULT_RULES: dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "q_seq": None,  # query-seq sharding for attn when heads don't divide
    "embed": None,
    "embed_fsdp": "data",  # FSDP dim on params
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": None,  # experts use TP-within-expert on 'mlp' by default
    "expert_cap": None,
    "cache_seq": "model",  # decode KV caches shard the sequence dim
    "state": None,  # SSM state
    "lru": "model",  # RG-LRU width
    "conv": None,
    "frames": None,
    "layers": None,
    "patches": None,
}

#: The mesh axes that split the batch (``flash_sharded`` and the MoE's
#: ``shard_map`` dispatch run per shard of these), in mesh order.
DATA_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names (sharded over their product, major first). A tuple
    of one name is that name, as ``jax.sharding.PartitionSpec`` has it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks: enough for specs."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for sharding rules needs mesh_dim_names")
    return {n: mesh.size(i) for i, n in enumerate(names)}


def is_device_mesh(mesh) -> bool:
    return isinstance(mesh, DeviceMesh)


def placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on each mesh dimension that tensor dimension d's entry
    names, ``Replicate()`` on the others."""
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, v in enumerate(spec)
                    if v == name or (isinstance(v, tuple) and name in v)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the port's counterpart of
    ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


@dataclasses.dataclass
class MeshRules:
    mesh: object  # a DeviceMesh, or an AbstractMesh for specs alone
    rules: dict[str, Axis]
    dropped: list = dataclasses.field(default_factory=list)

    @classmethod
    def for_mesh(cls, mesh, overrides: Optional[dict] = None) -> "MeshRules":
        if is_device_mesh(mesh) and mesh.device_type == "cuda":
            blocking_collectives("CUDA")
        rules = dict(DEFAULT_RULES)
        if overrides:
            rules.update(overrides)
        # Prune mesh axes that don't exist (e.g. 'pod' on single-pod mesh).
        names = set(mesh_shape(mesh))

        def prune(v):
            if v is None:
                return None
            if isinstance(v, str):
                return v if v in names else None
            t = tuple(a for a in v if a in names)
            return t if t else None

        return cls(mesh=mesh, rules={k: prune(v) for k, v in rules.items()})

    def _axis_size(self, v: Axis) -> int:
        if v is None:
            return 1
        shape = mesh_shape(self.mesh)
        if isinstance(v, str):
            return shape[v]
        return math.prod(shape[a] for a in v)

    def spec(self, shape: tuple, axes: tuple) -> PartitionSpec:
        """PartitionSpec for `shape` with logical `axes`, guarding
        divisibility and duplicate mesh-axis use."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {axes} differ in rank")
        used: set[str] = set()
        out = []
        for dim, ax in zip(shape, axes):
            v = self.rules.get(ax) if ax is not None else None
            if v is not None:
                size = self._axis_size(v)
                mesh_axes = (v,) if isinstance(v, str) else tuple(v)
                if dim % size != 0:
                    self.dropped.append((axes, ax, dim, size, "indivisible"))
                    v = None
                elif any(m in used for m in mesh_axes):
                    self.dropped.append((axes, ax, dim, size, "duplicate"))
                    v = None
                else:
                    used.update(mesh_axes)
            out.append(v)
        return PartitionSpec(*out)

    def _device_mesh(self):
        if not is_device_mesh(self.mesh):
            raise TypeError(f"MeshRules on {self.mesh!r} give specs only: a sharding or a "
                            "constraint needs a torch DeviceMesh")
        return self.mesh

    def sharding(self, shape: tuple, axes: tuple) -> NamedSharding:
        return NamedSharding(self._device_mesh(), self.spec(shape, axes))

    def constraint(self, x, *axes):
        """Redistribute the activation ``x`` (a DTensor) to the spec of its
        logical ``axes``; a plain tensor is returned as it is."""
        mesh = self._device_mesh()
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh, placements(mesh, self.spec(tuple(x.shape), axes)))


@dataclasses.dataclass
class NullRules:
    """No-op rules for single-device smoke tests."""

    def spec(self, shape, axes) -> PartitionSpec:
        return PartitionSpec()

    def constraint(self, x, *axes):
        return x


def spec_tree(params_with_axes):
    """Split a tree (nested dicts) of (array_or_struct, axes) leaves into
    (arrays, axes) trees of the same structure."""
    is_leaf = lambda x: isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], tuple)

    def split(tree, i):
        if is_leaf(tree):
            return tree[i]
        return {k: split(v, i) for k, v in tree.items()}

    return split(params_with_axes, 0), split(params_with_axes, 1)


# ---------------------------------------------------------------------------
# helpers for the code that runs per shard (the reference's shard_map bodies)
# ---------------------------------------------------------------------------


def mesh_of(rules):
    """The ``DeviceMesh`` of ``rules``, or None (no rules, NullRules, or
    rules on an abstract mesh)."""
    mesh = getattr(rules, "mesh", None)
    return mesh if mesh is not None and is_device_mesh(mesh) else None


def data_axes(mesh) -> tuple:
    """The mesh's batch-splitting axes (:data:`DATA_AXES`), in mesh order."""
    return tuple(a for a in DATA_AXES if a in mesh_shape(mesh))


def data_size(mesh) -> int:
    """The product of the sizes of the mesh's data axes."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in data_axes(mesh))


def replicated(x):
    """The whole value of a DTensor on every rank, as a plain tensor
    (differentiable); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim).to_local()


def as_replicated(t, like):
    """The plain tensor ``t``, equal on every rank, as a replicated DTensor
    on ``like``'s mesh (``t`` itself when ``like`` is no DTensor)."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def reduce_partial(x):
    """A DTensor with its pending partial sums reduced (each ``Partial``
    placement made ``Replicate``); a plain tensor as it is."""
    if not isinstance(x, DTensor) or not any(pl.is_partial() for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if pl.is_partial() else pl
                                               for pl in x.placements))


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with dimension ``dim`` reshaped into ``sizes``. A DTensor's
    mesh dimensions that shard ``dim`` and do not divide ``sizes[0]`` are
    replicated first (DTensor cannot unflatten an uneven shard; the
    reference's GSPMD does the same). The gradient of that redistribution
    is made contiguous: its backward can move a shard from another,
    unevenly split dimension to ``dim`` (an all-to-all that pads, then
    narrows), and the op that produced ``x`` (a matmul) views it."""
    dim = dim % x.dim()
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = tuple(Replicate() if p.is_shard(dim) and sizes[0] % mesh.size(i) else p
                   for i, p in enumerate(x.placements))
        if pl != tuple(x.placements):
            if x.requires_grad:
                x.register_hook(contiguous_local)
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def contiguous_local(x):
    """The DTensor ``x`` with a contiguous local block (a copy where it is
    not; ``x`` itself where it is). ``DTensor.contiguous`` reads the global
    strides, which a redistribution leaves contiguous whatever its local
    block's are."""
    local = x.to_local()
    if local.is_contiguous():
        return x
    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements,
                              shape=x.shape, stride=x.stride(), run_check=False)


def whole_last(x):
    """A DTensor with its last dimension whole on every rank (a norm over a
    sharded row would leave an averaged partial sum, which DTensor's
    backward cannot turn into a summed one); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    pl = tuple(Replicate() if p.is_shard(last) or p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def batch_split(*ts) -> tuple:
    """DTensors placed with their leading (batch) dimension split over the
    mesh's data axes where it divides, every other dimension whole and no
    partial sum pending: the layout of the reference's ``shard_map`` bodies
    and one in which the attention einsums' batched products need no
    further redistribution (DTensor cannot flatten (batch, kv heads) when
    the heads are the sharded ones); contiguous. Plain tensors as they
    are."""
    out = []
    for t in ts:
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            manual, split = data_axes(mesh), t.shape[0] % data_size(mesh) == 0
            pl = tuple(Shard(0) if n in manual and split else Replicate()
                       for n in mesh.mesh_dim_names)
            t = t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
            t = t.contiguous()  # DTensor's einsum views its local blocks
        out.append(t)
    return tuple(out)


def merge_dims(x, dim: int):
    """``x`` with dimensions ``dim`` and ``dim + 1`` flattened into one. On
    a DTensor the backward splits the gradient with :func:`split_dim`, so
    that a gradient sharded unevenly over the merged dimension is
    replicated before DTensor unflattens it (heads that do not divide the
    model axis, with their head_dim, can come back so)."""
    dim = dim % x.dim()
    if not is_dtensor(x):
        return x.flatten(dim, dim + 1)
    return _MergeDims.apply(x, dim)


class _MergeDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None


def gather_rows(table, idx):
    """``table[idx]`` for a DTensor ``table`` (an embedding): every rank
    gathers the whole table and looks up its own block of ``idx`` (a
    DTensor, or a plain tensor alike on every rank); the rows are placed as
    ``idx`` is. DTensor's strategies for an index's backward (an
    accumulating index_put) and for ``F.embedding`` on a vocab-sharded table
    fail, so the lookup is local: its gradient is a partial sum over the
    mesh dimensions that split ``idx``, reduced back to the table's
    placements."""
    mesh = table.device_mesh
    placed = idx.placements if isinstance(idx, DTensor) else (Replicate(),) * mesh.ndim
    whole = table.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=tuple(Partial() if p.is_shard() else Replicate() for p in placed))
    rows = whole[idx.to_local() if isinstance(idx, DTensor) else idx]
    return DTensor.from_local(rows, mesh, placed, run_check=False)


def cumsum(x, dim: int):
    """``torch.cumsum``; on a DTensor with a backward that needs no flip
    (the reverse cumulative sum as the total less the cumulative sum plus
    the element: DTensor has no flip strategy in some torch releases)."""
    return _CumSum.apply(x, dim) if is_dtensor(x) else torch.cumsum(x, dim=dim)


class _CumSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return torch.cumsum(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.sum(dim=ctx.dim, keepdim=True) - torch.cumsum(g, dim=ctx.dim) + g, None


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


@contextlib.contextmanager
def replicate_plain(active: bool = True):
    """Within: a plain tensor that meets a DTensor in an op is taken as
    replicated (DTensor's implicit replication). The model builds such
    constants alike on every rank (positions, masks, rotary tables, the
    chunked softmax's running max and sum). The flag is thread-local state
    that autograd carries to its backward threads, so a backward (and a
    remat recomputation in it) started within sees it too; the previous
    value is restored on exit, so the contexts nest."""
    if not active:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    old = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = old


_BLOCKING: dict = {}


def blocking_collectives(dispatch_key: str) -> None:
    """Give DTensor's functional collectives on the tensors of
    ``dispatch_key`` ("CUDA") kernels that call the c10d collectives of the
    same names (blocking, as a c10d call without ``async_op``). Over gloo on CUDA tensors the functional
    ``all_gather_into_tensor`` kills its process (SIGSEGV on an H100 with
    torch 2.11; its kernel takes a coalesced path that gloo lacks for CUDA,
    as do ``reduce_scatter_tensor``'s and ``all_to_all_single``'s), while
    the c10d calls of the same collectives run:
    gloo stages CUDA tensors through host memory itself, as it does for the
    functional ``all_reduce``, which keeps its own kernel. The backend is
    not swapped and no tensor is moved by this code; over nccl the
    kernels give the same values, only without overlap. Installed once per
    process and key, by :meth:`MeshRules.for_mesh` on a CUDA mesh (the
    tests install them for "CPU" to hold them to the functional ones)."""
    if dispatch_key in _BLOCKING:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def all_gather_into_tensor(x, group_size, group_name):
        out = x.new_empty((x.shape[0] * group_size, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=_resolve_process_group(group_name))
        return out

    def reduce_scatter_tensor(x, reduce_op, group_size, group_name):
        out = x.new_empty((x.shape[0] // group_size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), op=ops[reduce_op.lower()],
                                   group=_resolve_process_group(group_name))
        return out

    def all_to_all_single(x, output_split_sizes, input_split_sizes, group_name):
        group = _resolve_process_group(group_name)
        rows = sum(output_split_sizes) if output_split_sizes else x.shape[0]
        out = x.new_empty((rows, *x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), output_split_sizes or None,
                               input_split_sizes or None, group=group)
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single):
        lib.impl(fn.__name__, fn, dispatch_key)
    _BLOCKING[dispatch_key] = lib  # the registrations live as long as the library
