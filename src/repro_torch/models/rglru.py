"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; the
reference's ``repro/models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    log_a_t = -c * softplus(Lambda) * r_t   # c = 8
    h_t = exp(log_a_t) * h_{t-1} + sqrt(1 - exp(2 log_a_t)) * (i_t * x_t)

The linear recurrence runs as a log-depth scan (Hillis-Steele doubling with
the reference's combine): ceil(log2 S) rounds of whole-tensor ops, not a
loop over S. The enclosing block is Griffin's: a GeLU gate branch times a
temporal-conv + RG-LRU branch, projected out.

A decode step's state is float32 while the activations may be bfloat16;
the products promote as ``jnp.einsum`` does (``layers.matmul``), so the
step's output is float32 there, as the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import matmul
from repro_torch.models.sharding import reduce_partial
from repro_torch.models.ssd import causal_conv1d, conv_decode_step

C_FACTOR = 8.0


def _gates(x, p):
    # a product over the sharded lru width is a partial sum: reduced before
    # the sharded bias (DTensor cannot turn the bias into a partial sum)
    r = torch.sigmoid(reduce_partial(matmul(x, p["w_a"])) + p["b_a"])
    i = torch.sigmoid(reduce_partial(matmul(x, p["w_x"])) + p["b_x"])
    log_a = -C_FACTOR * F.softplus(p["lam"]) * r  # (B, S, W)
    return log_a, i


def _beta(log_a):
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, by doubling.
    Returns (the running products of a, h)."""
    S = a.shape[1]
    d = 1
    while d < S:
        # combine((a1, h1) at t - d, (a2, h2) at t) = (a1 a2, a2 h1 + h2)
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return a, b


def rglru_scan(x, p, initial_state=None):
    """x: (B, S, W). Returns (h (B,S,W), final state (B,W))."""
    log_a, gate_i = _gates(x, p)
    a = torch.exp(log_a)
    gx = _beta(log_a) * (gate_i * x)
    a_s, h = linear_scan(a, gx)
    if initial_state is not None:
        h = h + a_s * initial_state[:, None, :]
    return h, h[:, -1, :]


def rglru_decode_step(x, p, state):
    """x: (B, W); state: (B, W)."""
    log_a, gate_i = _gates(x[:, None, :], p)
    log_a, gate_i = log_a[:, 0], gate_i[:, 0]
    h = torch.exp(log_a) * state + _beta(log_a) * (gate_i * x)
    return h, h


def recurrent_block(x, p, cfg, state=None, rules=None):
    """Griffin recurrent block, full-sequence. x: (B, S, D).
    Returns (out (B,S,D), (conv_tail, lru_state)); ``conv_tail`` is the last
    k - 1 *pre-conv* inputs."""
    y_gate = F.gelu(matmul(x, p["w_gelu"]), approximate="tanh")
    xl = matmul(x, p["w_lin"])
    if rules is not None:
        xl = rules.constraint(xl, "batch", "seq", "lru")
    xc = causal_conv1d(xl, p["conv_w"], p["conv_b"])
    h, lru_state = rglru_scan(xc, p, initial_state=state[1] if state else None)
    out = matmul(y_gate * h, p["w_out"])
    k = p["conv_w"].shape[0]
    return out, (xl[:, -(k - 1):, :], lru_state)


def recurrent_block_decode(x, p, state):
    """One-token decode. x: (B, 1, D); state = (conv_state (B,k-1,W),
    lru_state (B,W))."""
    conv_state, lru_state = state
    x0 = x[:, 0, :]
    y_gate = F.gelu(matmul(x0, p["w_gelu"]), approximate="tanh")
    xl = matmul(x0, p["w_lin"])
    xc, conv_state = conv_decode_step(xl, conv_state, p["conv_w"], p["conv_b"])
    h, lru_state = rglru_decode_step(xc, p, lru_state)
    out = matmul(y_gate * h, p["w_out"])
    return out[:, None, :], (conv_state, lru_state)
