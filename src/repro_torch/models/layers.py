"""Common layers: RMS norm, RoPE, the SwiGLU MLP, embeddings. Plain
functions on tensors, with the reference's (``repro/models/layers.py``)
precision: norms and rotary embeddings compute in float32 and cast back;
the products run in the input's dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight).to(dtype)


def rope_angles(positions, d_head: int, theta: float, ndim: int):
    """(sin, cos) of the rotary angles at ``positions`` (..., S), shaped to
    broadcast against an ``ndim``-dimensional (..., S, [n,] d_head) input;
    computed once and shared by every layer of a forward pass."""
    half = d_head // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    angles = positions.float()[..., None] * freq  # (..., S, half)
    while angles.dim() < ndim:
        angles = angles[..., None, :]  # broadcast over head dims
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """Rotate x (..., d_head) by precomputed angles, in float32, cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x: (..., S, n, d_head) or (..., S, d_head);
    positions: (..., S) absolute positions."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta, x.dim()))


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP. x: (B, S, D); w_gate/w_up: (D, F); w_down: (F, D)."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def embed(tokens, table):
    return table[tokens]


def unembed(x, table):
    """x: (B, S, D); table: (V, D) -> logits (B, S, V)."""
    return x @ table.t()
