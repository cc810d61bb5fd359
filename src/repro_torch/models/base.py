"""Parameter declaration for the language models.

Each model family declares its parameters once as a tree (nested dicts) of
``ParamSpec`` (shape + logical axes + init rule), as the reference's
``repro/models/base.py`` does. From it the port derives the concrete
parameters, a plain dict tree of tensors under the reference's names and
shapes, their abstract (``meta``) view for the dry run, the parameter count
and, through ``models/sharding.py``'s rules, each parameter's partition
spec.

Initialisation follows the reference's per-spec rule but draws from an
explicit ``torch.Generator``, so its values differ from ``jax.random``'s;
tests carry the reference's parameters across with :func:`params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "fanin"  # fanin | embed | zeros | ones | small
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict in sorted-key order (the order
    in which ``jax.tree`` flattens a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_unflatten(like, flat: dict, prefix=()):
    """A nested dict of ``like``'s structure holding ``flat[path]`` at each
    leaf's path (the paths of :func:`tree_leaves`)."""
    if isinstance(like, dict):
        return {k: tree_unflatten(v, flat, prefix + (k,)) for k, v in like.items()}
    return flat[prefix]


def _init_one(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    shape, dtype = spec.shape, getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "embed":
        scale = 0.02
    elif spec.init == "small":
        scale = 0.006
    else:
        # fanin: normal with 1/sqrt(fan_in); fan_in = the product of all
        # dims but the last, the leading stacked 'layers' dim excluded.
        dims = [d for d, a in zip(shape, spec.axes) if a != "layers"]
        fan_in = int(np.prod(dims[:-1])) if len(dims) > 1 else 1
        scale = 1.0 / max(math.sqrt(fan_in), 1.0)
    # detlint: ignore[DET001] — random weights from the caller's seeded
    # generator (the LM side-stack serves random weights); no simulation draw
    x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return x.mul_(scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_params(spec_tree, generator: torch.Generator, device):
    """Concrete parameters for ``spec_tree``, drawn leaf by leaf in
    sorted-key order from ``generator`` (which must live on ``device``)."""
    out: dict = {}
    for path, spec in tree_leaves(spec_tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_one(spec, generator, device)
    return out


def abstract_params(spec_tree):
    """The parameters' shapes and dtypes without storage: a ``meta`` tensor
    for every ``ParamSpec`` (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                                          device="meta"), spec_tree)


def param_partition_specs(spec_tree, rules):
    """The tree of ``rules.spec`` for every ``ParamSpec`` of ``spec_tree``,
    asked in sorted-key order (``jax.tree``'s), so that ``rules.dropped``
    lists the guard's events in the reference's order."""
    flat = {path: rules.spec(s.shape, s.axes) for path, s in tree_leaves(spec_tree)}
    return tree_unflatten(spec_tree, flat)


def param_count(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in tree_leaves(spec_tree))


def params_from_numpy(tree, device):
    """The reference's parameter tree, as numpy arrays (e.g. ``jax.tree.map(
    np.asarray, params)``), as the port's: the same nested names and shapes,
    each leaf a tensor of the same dtype on ``device``. Any dict tree of
    arrays carries across so; the reference's AdamW state ``{"mu", "nu",
    "step"}`` becomes the port's (float32 moments, a scalar int32 step)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def cast_floats(tree, dtype: torch.dtype):
    """Every float32 leaf cast to ``dtype`` (the reference's ``_cast``); a
    leaf that already has another dtype is returned as it is. Lists (a
    session's per-layer dicts) are walked like dicts."""
    if isinstance(tree, list):
        return [cast_floats(t, dtype) for t in tree]
    return tree_map(lambda a: cast_floats(a, dtype) if isinstance(a, list)
                else a.to(dtype) if a.dtype == torch.float32 else a, tree)
