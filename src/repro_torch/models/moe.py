"""Mixture-of-Experts FFN with capacity-bucketed dispatch (the reference's
``repro/models/moe.py``).

Tokens are routed to a fixed-capacity per-expert bucket, processed as
dense per-expert products and combined back weighted by the router's
gates. An assignment's position within its expert counts the assignments
before it in token-major order (T * K), so which ones are dropped (over
capacity) is the reference's.

Three choices keep the port equal to the reference and deterministic:
- top-k: ``jax.lax.top_k`` breaks ties by the lower expert index; a stable
  descending sort does the same (``torch.topk`` on CUDA promises no order);
- positions: an integer cumsum over the one-hot assignments;
- dispatch: the kept assignments' (expert, slot) pairs are unique, so the
  buffer is written with a plain index write, not a float scatter-add; the
  dropped ones go to a spare slot ``C`` that is cut off (no host sync to
  select them).

Under sharding rules (DTensor activations) the routing, the buffer's
writes and the combine's reads run on the whole, replicated values (they
have no sharding strategy); the expert products run on the DTensors, with
the reference's constraints. ``moe_dispatch="shard_map"`` on a mesh with
data axes runs :func:`moe_ffn` on each data shard of the batch (capacity
from the shard's tokens), the expert weights sharded over ``model``, and
averages the auxiliary terms over the data axes: the reference's
``shard_map`` body.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import sharding as shard_lib


def capacity(cfg, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.experts_per_token * num_tokens
            / max(cfg.num_experts, 1))
    return max((c + 7) // 8 * 8, 8)


def route(router_logits, k: int):
    """(values, expert indices) of the ``k`` largest router logits per
    token, ties to the lower expert index (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(router_logits, dim=-1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def assign(router_logits, k: int, C: int):
    """The dispatch's routing: each token's ``k`` experts (``route``) and
    each assignment's position within its expert, counted in token-major
    order (T * k), kept where it is under the capacity ``C``. Returns
    (gate_v, gate_i (T, k), pos_in_e, keep (T * k,))."""
    gate_v, gate_i = route(router_logits, k)
    flat_e = gate_i.reshape(-1)
    onehot = F.one_hot(flat_e, router_logits.shape[-1])  # (T*K, E) int64
    pos_in_e = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    return gate_v, gate_i, pos_in_e, pos_in_e < C


def moe_ffn(x, p, cfg, rules=None):
    """x: (B, S, D) or (T, D). Returns (out of x's shape, aux dict)."""
    orig_shape = x.shape
    D = orig_shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, T)

    router_logits = (xt @ p["router"]).float()
    # the routing, the dispatch writes and the combine reads see whole values
    logits = shard_lib.replicated(router_logits)
    gate_v, gate_i, pos_in_e, keep = assign(logits, K, C)  # (T, K), (T*K,)
    gates = torch.softmax(gate_v, dim=-1).to(x.dtype)

    flat_e = gate_i.reshape(-1)  # (T*K,) token-major
    slot = torch.where(keep, pos_in_e, C)  # dropped -> the spare slot

    # each token's row K times (token-major), as a broadcast: its backward
    # sums the K copies in one reduction, with no atomic adds
    xl = shard_lib.replicated(xt)
    x_rep = xl[:, None].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=xl.device)
    buf[flat_e, slot] = x_rep
    h = shard_lib.as_replicated(buf[:, :C], x)
    if rules is not None:
        h = rules.constraint(h, "expert", "expert_cap", "embed")

    act = F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"])
    if rules is not None:
        act = rules.constraint(act, "expert", "expert_cap", "mlp")
    y = shard_lib.replicated(torch.bmm(act, p["w_down"]))  # (E, C, D)

    pos_c = torch.clamp(pos_in_e, max=C - 1)
    out_tok = y[flat_e, pos_c] * (gates.reshape(-1)[:, None] * keep[:, None].to(y.dtype))
    out = out_tok.reshape(T, K, D).sum(dim=1)

    aux = {
        "dropped_fraction": 1.0 - keep.float().mean(),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        # load-balance loss (Switch-style): E * sum_e f_e * p_e
        "load_balance": _load_balance_loss(logits, gate_i, E),
    }
    aux = {k: shard_lib.as_replicated(v, x) for k, v in aux.items()}
    return shard_lib.as_replicated(out, x).reshape(orig_shape), aux


def moe_ffn_dispatch(x, p, cfg, rules=None):
    """MoE with the dispatch strategy selected by ``cfg.moe_dispatch``:
    "pjit", or no mesh, or a mesh without data axes: :func:`moe_ffn` on the
    whole batch; "shard_map": :func:`moe_ffn` on each data shard of the
    batch, the auxiliary terms averaged over the data axes."""
    mesh = shard_lib.mesh_of(rules)
    if mesh is None or cfg.moe_dispatch != "shard_map":
        return moe_ffn(x, p, cfg, rules)
    manual = shard_lib.data_axes(mesh)
    if not manual:
        return moe_ffn(x, p, cfg, rules)
    return _moe_per_shard(x, p, cfg, mesh, manual)


def _moe_per_shard(x, p, cfg, mesh, manual):
    """The reference's ``shard_map`` body: the batch split over ``manual``,
    the model axis left to DTensor (the expert weights keep their ``model``
    sharding on the model submesh), ``pmean`` of the auxiliary terms. ``x``
    and the weights are DTensors (placed by ``launch/steps.py``'s
    shardings)."""
    names = mesh.mesh_dim_names
    if not isinstance(x, DTensor):
        raise TypeError("the shard_map MoE dispatch takes DTensors placed on the mesh, "
                        f"got {type(x).__name__}")
    dsize = shard_lib.data_size(mesh)
    if x.shape[0] % dsize:
        raise ValueError(f"the shard_map MoE splits the batch {x.shape[0]} over the data "
                         f"axes {manual} of size {dsize}: it must divide")
    split = tuple(Shard(0) if n in manual else Replicate() for n in names)
    rest = tuple(n for n in names if n not in manual)
    sub = mesh[rest] if rest else None

    def on_sub(t, placements, grad_placements=None):
        """This rank's local block of ``t`` (placed by ``placements``), as a
        DTensor on the submesh of the non-data axes."""
        lt = t.redistribute(mesh, placements).to_local(grad_placements=grad_placements)
        if sub is None:
            return lt
        return DTensor.from_local(lt, sub, tuple(pl_ for n, pl_ in zip(names, placements)
                                                 if n not in manual), run_check=False)

    xl = on_sub(x, split)
    pl = {}
    for k in ("router", "w_gate", "w_up", "w_down"):
        # replicated over the data axes, as the body's P() in_spec; each data
        # shard's gradient is a partial sum of the weight's
        keep = tuple(Replicate() if n in manual else pl_ for n, pl_ in zip(names, p[k].placements))
        pl[k] = on_sub(p[k], keep, tuple(Partial() if n in manual else pl_
                                         for n, pl_ in zip(names, keep)))
    out, aux = moe_ffn(xl, pl, cfg, None)
    out = DTensor.from_local(shard_lib.replicated(out), mesh, split, run_check=False)
    groups = [mesh.get_group(n) for n in manual]
    aux = {k: DTensor.from_local(_DataMean.apply(shard_lib.replicated(v), groups, dsize), mesh,
                                 (Replicate(),) * mesh.ndim, run_check=False)
           for k, v in aux.items()}
    return out, aux


class _DataMean(torch.autograd.Function):
    """The mean over the data shards of a value each holds (the reference's
    ``pmean``): summed over each data axis's group, divided by their number.
    The mean is replicated, so each shard's upstream gradient is the whole
    one, and the shard's own share of it is that over their number."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        y = x.clone()
        for group in groups:
            dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _load_balance_loss(router_logits, gate_i, E):
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    frac_tokens = F.one_hot(gate_i[:, 0], E).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)
