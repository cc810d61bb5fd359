"""Mixture-of-Experts FFN with capacity-bucketed dispatch (the reference's
``repro/models/moe.py`` on one device).

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def moe_ffn(x, p, cfg):
    """x: (B, S, D) or (T, D). Returns (out of x's shape, aux dict)."""
    orig_shape = x.shape
    D = orig_shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, T)

    router_logits = (xt @ p["router"]).float()
    gate_v, gate_i, pos_in_e, keep = assign(router_logits, K, C)  # (T, K), (T*K,)
    gates = torch.softmax(gate_v, dim=-1).to(x.dtype)

    flat_e = gate_i.reshape(-1)  # (T*K,) token-major
    slot = torch.where(keep, pos_in_e, C)  # dropped -> the spare slot

    # each token's row K times (token-major), as a broadcast: its backward
    # sums the K copies in one reduction, with no atomic adds
    x_rep = xt[:, None].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    buf[flat_e, slot] = x_rep
    h = buf[:, :C]

    act = F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"])
    y = torch.bmm(act, p["w_down"])  # (E, C, D)

    pos_c = torch.clamp(pos_in_e, max=C - 1)
    out_tok = y[flat_e, pos_c] * (gates.reshape(-1)[:, None] * keep[:, None].to(y.dtype))
    out = out_tok.reshape(T, K, D).sum(dim=1)

    aux = {
        "dropped_fraction": 1.0 - keep.float().mean(),
        "router_z": torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2),
        # load-balance loss (Switch-style): E * sum_e f_e * p_e
        "load_balance": _load_balance_loss(router_logits, gate_i, E),
    }
    return out.reshape(orig_shape), aux


def moe_ffn_dispatch(x, p, cfg):
    """The reference's dispatch selector without a mesh: the global
    dispatch above, whatever ``cfg.moe_dispatch`` says (the reference's
    ``shard_map`` variant needs a mesh; ROADMAP queue 1 item 8)."""
    return moe_ffn(x, p, cfg)


def _load_balance_loss(router_logits, gate_i, E):
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    frac_tokens = F.one_hot(gate_i[:, 0], E).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)
