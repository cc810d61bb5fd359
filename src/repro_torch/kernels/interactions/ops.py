"""The interaction pass: short-circuit flags, schedule compaction, dispatch.

The reference (``repro.kernels.interactions.ops``) carries five backends;
this package carries the one the main path uses, the fused active-set pass
(reference backend ``pallas-compact``):

  1. per-block short-circuit flags (``col_has_infectious``,
     ``row_has_susceptible``) and the per-tile liveness predicate;
  2. compaction: a stable sort moves the live tiles to the schedule front in
     their original row-major order, with the live count ``n_live`` and the
     row-run starts of the compacted order — all device tensors, no host
     sync;
  3. the tile pass over the live prefix: the CUDA kernel for CUDA tensors,
     its plain PyTorch version for CPU tensors (``kernel.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.interactions import kernel as _kernel


def _block_any_positive(val, pid, num_blocks, block_size):
    flags = ((val > 0.0) & (pid >= 0)).reshape(num_blocks, block_size)
    return flags.any(dim=1).to(torch.int32)


def col_has_infectious(inf_val, pid, num_blocks, block_size):
    """Per column block: does any active visit carry infectivity today?"""
    return _block_any_positive(inf_val, pid, num_blocks, block_size)


def row_has_susceptible(sus_val, pid, num_blocks, block_size):
    """Per row block: does any active visit carry susceptibility today?"""
    return _block_any_positive(sus_val, pid, num_blocks, block_size)


def live_tiles(row_idx, col_idx, pair_active, col_has_inf, row_has_sus):
    """The per-tile liveness predicate: scheduled, not padding, and with
    both an infectious column block and a susceptible row block."""
    return (
        (pair_active == 1)
        & (col_has_inf[col_idx] > 0)
        & (row_has_sus[row_idx] > 0)
    )


def compact_schedule(row_idx, col_idx, pair_active, col_has_inf, row_has_sus):
    """Live tiles first, original order kept (stable sort on the dead flag).

    Returns int32 ``(rows_c, cols_c, row_start_c, n_live)``; ``n_live`` is a
    (1,) device tensor. Live tiles of one row block stay consecutive, so a
    change of row index marks the start of a row run."""
    live = live_tiles(row_idx, col_idx, pair_active, col_has_inf, row_has_sus)
    order = torch.sort(torch.where(live, 0, 1), stable=True).indices
    rows_c = row_idx[order].to(torch.int32)
    cols_c = col_idx[order].to(torch.int32)
    n_live = live.sum(dtype=torch.int32).reshape(1)
    prev = torch.cat([rows_c[:1] - 1, rows_c[:-1]])
    row_start_c = (rows_c != prev).to(torch.int32)
    return rows_c, cols_c, row_start_c, n_live


def interactions_compact_edges(
    pid, loc, start, end, p_loc, sus_val, inf_val,
    row_idx, col_idx, pair_active, col_has_inf, row_has_sus, meta,
    *,
    block_size: int,
):
    """The day's interaction pass over (V,) location-sorted visit slots.

    ``pid``/``loc`` int32 (pid -1 on inactive slots), ``start``/``end``/
    ``p_loc``/``sus_val``/``inf_val`` float32, the (NP,) block schedule,
    the (V // block_size,) flags and ``meta`` = int64 ``[seed, day]``.
    Returns ``(acc (V,) f32, cnt (V,) int32, edges () int64)``: per-visit
    propensity sums (before tau), per-visit contact counts, and their total,
    the traversed-edge count.

    CUDA tensors launch the CUDA kernel (which counts its launches in
    ``kernel.interactions_compact_cuda.launches``); CPU tensors run its
    plain version. There is no fallback: a launch either happens or raises.
    """
    rows_c, cols_c, row_start_c, n_live = compact_schedule(
        row_idx, col_idx, pair_active, col_has_inf, row_has_sus
    )
    args = (pid, loc, start, end, p_loc, sus_val, inf_val,
            rows_c, cols_c, row_start_c, n_live, col_has_inf, row_has_sus, meta)
    if pid.is_cuda:
        return _kernel.interactions_compact_cuda(*args, block_size=block_size)
    if pid.device.type != "cpu":
        raise ValueError(f"no interaction pass for device {pid.device}")
    return _kernel.interactions_compact_plain(*args, block_size=block_size)
