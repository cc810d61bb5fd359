"""Plain PyTorch pair math for the interaction pass (Algorithm 1, reformulated).

For every ordered pair of visits (i, j) to the same location whose time
windows overlap for T_ij > 0 seconds:

  * the (unordered) pair makes *contact* with probability p_loc — one
    symmetric Bernoulli draw per (day, person-pair, location), counter-based;
  * a contact contributes propensity  T_ij * sus_val_i * inf_val_j  to row
    visit i (the global tau factor is applied by the caller — it is linear).

:func:`pair_tile_traced` is the one statement of the pair math in this
package; the CUDA kernels (``csrc/interactions.cu``) are its line-by-line
transcription. Row sums are taken **column-sequentially**:
``part = part + ((overlap * sus) * inf) * contact`` for j = 0, 1, ... in
float32 from 0.0. That is the port's single accumulation order, so the
kernels and this plain version agree bitwise. (The reference package sums a
row with XLA's reduction tree instead, so against it ``acc`` agrees only to
the last bits.)

Contact tracing is a second accumulator over the same pairs: a contact pair
whose column visit is a tracing source (``src_c > 0``, a person who tested
positive today) counts as one traced contact of the row visit.
"""

from __future__ import annotations

import torch

from repro_torch.core import rng


def contact_uniform(seed, day, pid_i, pid_j, loc):
    """Symmetric contact draw: same u for (i, j) and (j, i) at a location."""
    pmin = torch.minimum(pid_i, pid_j)
    pmax = torch.maximum(pid_i, pid_j)
    return rng.uniform(seed, rng.CONTACT, day, pmin, pmax, loc)


def pair_tile_traced(
    seed,
    day,
    pid_r, loc_r, start_r, end_r, p_r, sus_r,  # row side (..., R)
    pid_c, loc_c, start_c, end_c, inf_c,  # col side (..., C)
    src_c,  # col side: tracing-source weight (>0 for today's positives), or None
):
    """Row sums of one batch of (R, C) pair tiles.

    Row arrays are ``(..., R)``, column arrays ``(..., C)`` with the same
    leading batch shape. Returns ``(rho_rowsum (..., R) f32,
    contact_count_rowsum (..., R) int32, traced_rowsum (..., R) int32)``,
    each row summed over its C columns in column order. The traced count is
    the contact-count condition ``& src_c > 0``; with ``src_c=None`` it is
    None.
    """
    col = lambda a: a[..., None, :]
    row = lambda a: a[..., :, None]
    overlap = torch.clamp(
        torch.minimum(row(end_r), col(end_c))
        - torch.maximum(row(start_r), col(start_c)),
        min=0.0,
    )
    valid = (
        (row(pid_r) >= 0)
        & (col(pid_c) >= 0)
        & (row(loc_r) == col(loc_c))
        & (row(pid_r) != col(pid_c))
        & (overlap > 0.0)
    )
    u = contact_uniform(seed, day, row(pid_r), col(pid_c), row(loc_r))
    contact = valid & (u < row(p_r))
    rho = overlap * row(sus_r) * col(inf_c) * contact.to(torch.float32)
    pair = contact & (row(sus_r) > 0.0) & (col(inf_c) > 0.0)
    part = torch.zeros(rho.shape[:-1], dtype=torch.float32, device=rho.device)
    for j in range(rho.shape[-1]):
        part = part + rho[..., j]
    trc = None
    if src_c is not None:
        trc = (pair & (col(src_c) > 0.0)).sum(dim=-1, dtype=torch.int32)
    return part, pair.sum(dim=-1, dtype=torch.int32), trc


def pair_tile(seed, day, *rows_and_cols):
    """:func:`pair_tile_traced` without the tracing accumulator: returns
    ``(rho_rowsum, contact_count_rowsum)``."""
    return pair_tile_traced(seed, day, *rows_and_cols, None)[:2]


def interactions_dense(pid, loc, start, end, p_loc, sus_val, inf_val, seed, day):
    """Dense all-pairs oracle over one day's (V,) visits.
    Returns (acc (V,), contacts (V,))."""
    return pair_tile(
        seed, day,
        pid, loc, start, end, p_loc, sus_val,
        pid, loc, start, end, inf_val,
    )


def interactions_dense_traced(pid, loc, start, end, p_loc, sus_val, inf_val,
                              src_val, seed, day):
    """Dense oracle with the tracing accumulator.
    Returns (acc (V,), contacts (V,), traced (V,))."""
    return pair_tile_traced(
        seed, day,
        pid, loc, start, end, p_loc, sus_val,
        pid, loc, start, end, inf_val, src_val,
    )
