"""Step functions and sharding assembly (the reference's
``launch/steps.py``): the training step, prefill and greedy decode, each
with optional sharding rules, and the train / prefill / decode shardings:
trees of ``models/sharding.py``'s ``NamedSharding`` (a ``DeviceMesh`` and a
spec). :func:`place` puts a tree of tensors onto the mesh by such a tree,
the counterpart of ``jit``'s ``in_shardings``."""

from __future__ import annotations

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import sharding as shard_lib
from repro_torch.models.base import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.sharding import NamedSharding, PartitionSpec as P
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def loss_and_grads(cfg: ModelConfig, params, batch, rules=None):
    """``forward_train``'s (loss, metrics), detached, and the gradients of
    the loss with respect to every leaf of ``params``, a tree of
    ``params``' structure (the reference's ``jax.value_and_grad``). A
    DTensor leaf's gradient is placed as the leaf is (a replicated
    parameter's partial sums are reduced), so it holds the whole
    gradient."""
    live = tree_map(lambda a: a.detach().requires_grad_(), params)
    paths, leaves = zip(*tree_leaves(live))
    # the backward, too, meets the forward's plain constants
    with torch.enable_grad(), shard_lib.replicate_plain(shard_lib.mesh_of(rules) is not None):
        loss, metrics = M.forward_train(cfg, live, batch, rules)
        # a leaf the loss does not reach gets zeros, as jax.grad gives
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    grads = [g.redistribute(a.device_mesh, a.placements) if shard_lib.is_dtensor(a) else g
             for a, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, dict(zip(paths, grads)))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, rules=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`loss_and_grads`, then :func:`adamw_update` (in place:
    the returned trees hold the caller's tensors, updated). ``metrics`` are
    ``forward_train``'s with the update's ``grad_norm`` and ``lr``."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(cfg, params, batch, rules)
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, rules=None):
    def prefill_step(params, batch):
        return M.forward_prefill(cfg, params, batch, rules)

    return prefill_step


def make_decode_step(cfg: ModelConfig, rules=None):
    def decode_step(params, cache, token, pos: int):
        logits, new_cache = M.decode_step(cfg, params, cache, token, pos, rules)
        # greedy next token (serving semantics); argmax takes the first
        # maximum, over the whole (on a mesh: gathered) vocabulary row
        next_tok = torch.argmax(shard_lib.whole_last(logits[:, -1, :]), dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache

    return decode_step


# ---------------------------------------------------------------------------
# Sharding assembly
# ---------------------------------------------------------------------------


def named(mesh, spec_tree):
    """The tree of ``NamedSharding(mesh, spec)`` for a tree of specs."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    return {k: named(mesh, v) for k, v in spec_tree.items()}


def train_shardings(cfg, shape, rules, mesh, max_target_positions=0):
    pspecs = M.param_partition_specs(cfg, rules, max_target_positions)
    opt_specs = {"mu": pspecs, "nu": pspecs, "step": P()}
    bspecs = M.batch_partition_specs(cfg, shape, rules)
    in_s = (named(mesh, pspecs), named(mesh, opt_specs), named(mesh, bspecs))
    out_s = (in_s[0], in_s[1], None)
    return in_s, out_s


def decode_shardings(cfg, shape, rules, mesh, cache, max_target_positions=0):
    pspecs = M.param_partition_specs(cfg, rules, max_target_positions)
    cspecs = M.cache_partition_specs(cfg, cache, rules)
    tok_spec = rules.spec((shape.global_batch, 1), ("batch", "seq"))
    in_s = (
        named(mesh, pspecs), named(mesh, cspecs),
        NamedSharding(mesh, tok_spec), NamedSharding(mesh, P()),
    )
    out_s = (NamedSharding(mesh, tok_spec), in_s[1])
    return in_s, out_s


def prefill_shardings(cfg, shape, rules, mesh, cache_abs, max_target_positions=0):
    pspecs = M.param_partition_specs(cfg, rules, max_target_positions)
    bspecs = M.batch_partition_specs(cfg, shape, rules)
    in_s = (named(mesh, pspecs), named(mesh, bspecs))
    return in_s, None


def place(tree, shardings):
    """Each leaf of ``tree`` (a tensor that every rank holds whole and
    alike) as a DTensor placed by the ``NamedSharding`` at its path in
    ``shardings``: each rank keeps its own block, with no collective. A
    leaf absent from ``shardings`` is an error."""
    if isinstance(shardings, NamedSharding):
        return distribute_tensor(tree, shardings.mesh, shardings.placements,
                                 src_data_rank=None)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    raise TypeError(f"no sharding for a leaf of type {type(tree).__name__}")


def abstract_opt_state(params_abs):
    """:func:`adamw_init` of abstract (``meta``) parameters: float32 ``mu``
    and ``nu`` of their shapes and a scalar int32 ``step``, on ``meta`` (the
    reference's ``jax.eval_shape(adamw_init, ...)``)."""
    return adamw_init(params_abs)
