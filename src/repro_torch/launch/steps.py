"""Step functions (the reference's ``launch/steps.py``): the training
step, prefill and greedy decode. The sharding helpers wait for the port's
LM sharding (ROADMAP queue 1 items 8 and 9)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.base import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_update


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``forward_train``'s (loss, metrics), detached, and the gradients of
    the loss with respect to every leaf of ``params``, a tree of
    ``params``' structure (the reference's ``jax.value_and_grad``)."""
    live = tree_map(lambda a: a.detach().requires_grad_(), params)
    paths, leaves = zip(*tree_leaves(live))
    with torch.enable_grad():
        loss, metrics = M.forward_train(cfg, live, batch)
        # a leaf the loss does not reach gets zeros, as jax.grad gives
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, dict(zip(paths, grads)))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`loss_and_grads`, then :func:`adamw_update` (in place:
    the returned trees hold the caller's tensors, updated). ``metrics`` are
    ``forward_train``'s with the update's ``grad_norm`` and ``lr``."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(cfg, params, batch)
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return M.forward_prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, token, pos: int):
        logits, new_cache = M.decode_step(cfg, params, cache, token, pos)
        # greedy next token (serving semantics); argmax takes the first maximum
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache

    return decode_step
