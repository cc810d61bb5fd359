"""Common layers: norms, RoPE, MLPs, embeddings, sinusoidal positions.
Plain functions on tensors, with the reference's (``repro/models/layers.py``)
precision: norms and rotary embeddings compute in float32 and cast back;
the products run in the input's dtype.

``jnp.einsum`` promotes mixed operands (bfloat16 against float32 gives
float32); ``torch.matmul`` refuses them. :func:`matmul` promotes as the
reference does, so a decode step whose recurrent state is float32 (the
hybrid family's) follows the reference's dtypes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import gather_rows, is_dtensor, reduce_partial, whole_last


def matmul(a, b):
    """``a @ b`` in the promoted dtype of the two operands."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = whole_last(x).float()
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm in float32 with the population variance (``jnp.var``),
    cast back to x's dtype."""
    dtype = x.dtype
    x = whole_last(x).float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(dtype)


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


def swiglu(x, w_gate, w_up, w_down, rules=None):
    """SwiGLU MLP. x: (B, S, D); w_gate/w_up: (D, F); w_down: (F, D)."""
    h = F.silu(matmul(x, w_gate)) * matmul(x, w_up)
    if rules is not None:
        h = rules.constraint(h, "batch", "seq", "mlp")
    return matmul(h, w_down)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """GELU MLP with biases; the tanh approximation, ``jax.nn.gelu``'s
    default."""
    h = F.gelu(x @ w_in + b_in, approximate="tanh")
    return h @ w_out + b_out


def embed(tokens, table):
    """The rows of ``table`` at ``tokens`` (on a DTensor table,
    ``sharding.gather_rows``)."""
    return gather_rows(table, tokens) if is_dtensor(table) else table[tokens]


def unembed(x, table, rules=None):
    """x: (B, S, D); table: (V, D) -> logits (B, S, V)."""
    logits = matmul(x, table.t())
    if rules is not None:
        logits = rules.constraint(logits, "batch", "seq", "vocab")
    return logits


def sinusoidal_positions(length: int, dim: int, device=None):
    """(length, dim) float32: sin at even, cos at odd columns."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    rate = -torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device)) / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * rate)
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def cross_entropy_loss(logits, labels, mask=None):
    """Mean cross entropy over valid positions; logits (B, S, V), labels
    (B, S). The log-partition in float32, the gold logit by ``gather``
    (one index per row, so its backward adds at most one value into each
    element), and the masked mean with the count clamped at 1. On
    vocab-sharded DTensor logits the gather's partial sums are reduced
    before its last dimension is dropped."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = reduce_partial(torch.gather(logits, -1, labels[..., None].long()))[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
