"""AdamW with float32 moments, global-norm clipping and decoupled weight
decay (the reference's ``optim/adamw.py``).

Parameters, gradients and moments are dict trees of tensors; leaves are
visited in sorted-key order, the reference's ``jax.tree`` order, so the
global norm sums the leaves in the reference's order. Moments are float32
and ``step`` is a scalar int32 tensor on the parameters' device.

The update works in place, leaf by leaf, under ``torch.no_grad()``: each
parameter and its two moments are overwritten with the reference's new
values (each product and sum rounded as the reference's expression rounds
it), and the only extra memory is two float32 temporaries the size of the
largest leaf. So an optimizer step at full width needs no second copy of
the parameters and moments. :func:`adamw_update` returns the same trees it
was given, now holding the new values, and a new ``step``.

Sharded trees (DTensor leaves, ``launch/steps.py:train_shardings``): each
gradient and moment is placed as its parameter is, so the update runs on
each rank's local blocks; the global norm is that of the whole leaves (each
leaf's sum of squares reduced over the mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models import sharding as shard_lib
from repro_torch.models.base import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable] = None  # step -> lr multiplier


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # a DTensor's placements
    device = next(tree_leaves(params))[1].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (sorted-key order) of each leaf's
    float32 sum of squares (a DTensor leaf's over its whole value)."""
    return torch.sqrt(sum(shard_lib.replicated(torch.sum(torch.square(x.float())))
                          for _, x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (params, state, {"grad_norm", "lr"}): ``params`` and the
    moments updated in place (see the module docstring), ``step`` + 1."""
    new_step = state["step"] + 1
    step = shard_lib.replicated(new_step)
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule else 1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    flat_g = dict(tree_leaves(grads))
    flat_mu, flat_nu = dict(tree_leaves(state["mu"])), dict(tree_leaves(state["nu"]))
    for path, p in tree_leaves(params):
        mu, nu, g = flat_mu[path], flat_nu[path], flat_g[path]
        if shard_lib.is_dtensor(p):
            if not p.placements == mu.placements == nu.placements == g.placements:
                raise ValueError(f"{'/'.join(path)}: parameter, moments and gradient placed "
                                 f"apart ({p.placements}, {mu.placements}, {nu.placements}, "
                                 f"{g.placements})")
            p, mu, nu, g = (t.to_local() for t in (p, mu, nu, g))
        g = g.float() * scale  # a new tensor: the caller's gradient stays
        t = (1 - b1) * g
        mu.mul_(b1).add_(t)  # b1 mu + (1 - b1) g
        torch.mul(g, 1 - b2, out=t).mul_(g)
        nu.mul_(b2).add_(t)  # b2 nu + (1 - b2) g g
        torch.div(nu, bc2, out=g).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
        torch.div(mu, bc1, out=t).div_(g)  # mhat / (sqrt(vhat) + eps)
        t.add_(torch.mul(p.float(), cfg.weight_decay, out=g)).mul_(lr)  # lr * delta
        if p.dtype == torch.float32:
            p.sub_(t)
        else:
            p.copy_((p.float() - t).to(p.dtype))
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": new_step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
