"""The interaction pass: short-circuit flags, schedule compaction, dispatch.

The reference (``repro.kernels.interactions.ops``) carries five backends;
this package carries the two whose TPU kernels it ports, under the
reference's names, so a backend name means the same run in both packages.
Each name identifies the reference Pallas kernel that the CUDA kernels
behind it replace:

  ``pallas-compact``  the fused active-set pass (reference ``_fused_kernel``):
      per-block short-circuit flags and the per-tile liveness predicate;
      compaction, a stable sort that moves the live tiles to the schedule
      front in their row-major order, with the live count ``n_live`` and
      the row-run starts of the compacted order (all device tensors, no
      host sync); then the tile pass over the live prefix, with an
      in-kernel traversed-edge counter.
  ``pallas``          the padded-schedule pass (reference ``_kernel``): no
      compaction, the tile pass walks the whole schedule and guards each
      tile; ``edges`` is ``cnt.sum()`` on the device, as in the reference,
      whose padded kernel has no edge counter.

Both take a keyword ``src_val`` (per-visit tracing-source weight, > 0 for
visits by people who tested positive today). With it the pass also returns
``trc``, the per-visit count of traced contacts, from the same tiles in the
same order. The two backends add the same live tiles of each row in the
same order, so their outputs are bitwise equal.

For CUDA tensors the wrappers launch the CUDA kernels (``kernel.py``,
each counting its launches); for CPU tensors they run the kernels' plain
PyTorch versions. There is no fallback: a launch either happens or raises.
All take the reference's arguments: the (V,) location-sorted visit arrays
``pid``/``loc`` int32 (pid -1 on inactive slots), ``start``/``end``/
``p_loc``/``sus_val``/``inf_val`` float32, the (NP,) block schedule
``row_idx``/``col_idx``/``row_start``/``pair_active``, the (V // b,) flags
and ``meta`` = int64 ``[seed, day]``.

**A batch of scenarios** goes through the same functions in one call (one
kernel launch): what varies by scenario gains a leading axis B, ``pid``,
``sus_val``, ``inf_val`` and ``src_val`` (B, V), the flags (B, V // b) and
``meta`` (B, 2), and so do the outputs (``edges`` (B,)); ``loc``,
``start``, ``end``, ``p_loc`` and the schedule come from the week and are
shared. Each scenario's outputs are bitwise those of its call alone.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.interactions import kernel as _kernel


def _block_any_positive(val, pid, num_blocks, block_size):
    flags = ((val > 0.0) & (pid >= 0)).reshape(*val.shape[:-1], num_blocks, block_size)
    return flags.any(dim=-1).to(torch.int32)


def col_has_infectious(inf_val, pid, num_blocks, block_size):
    """Per column block: does any active visit carry infectivity today?"""
    return _block_any_positive(inf_val, pid, num_blocks, block_size)


def row_has_susceptible(sus_val, pid, num_blocks, block_size):
    """Per row block: does any active visit carry susceptibility today?"""
    return _block_any_positive(sus_val, pid, num_blocks, block_size)


def live_tiles(row_idx, col_idx, pair_active, col_has_inf, row_has_sus):
    """The per-tile liveness predicate: scheduled, not padding, and with
    both an infectious column block and a susceptible row block. With
    (B, V // b) flags, a (B, NP) mask."""
    return (
        (pair_active == 1)
        & (col_has_inf[..., col_idx] > 0)
        & (row_has_sus[..., row_idx] > 0)
    )


def compact_schedule(row_idx, col_idx, pair_active, col_has_inf, row_has_sus):
    """Live tiles first, original order kept (stable sort on the dead flag).

    Returns int32 ``(rows_c, cols_c, row_start_c, n_live)``, ``n_live`` a
    (1,) device tensor; with (B, V // b) flags, one compacted schedule per
    scenario: (B, NP) and ``n_live`` (B,). Live tiles of one row block stay
    consecutive, so a change of row index marks the start of a row run."""
    live = live_tiles(row_idx, col_idx, pair_active, col_has_inf, row_has_sus)
    order = torch.sort(torch.where(live, 0, 1), dim=-1, stable=True).indices
    rows_c = row_idx[order].to(torch.int32)
    cols_c = col_idx[order].to(torch.int32)
    n_live = live.sum(dim=-1, dtype=torch.int32).reshape(-1)
    prev = torch.cat([rows_c[..., :1] - 1, rows_c[..., :-1]], dim=-1)
    row_start_c = (rows_c != prev).to(torch.int32)
    return rows_c, cols_c, row_start_c, n_live


def _device_kind(pid) -> str:
    if pid.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no interaction pass for device {pid.device}")
    return pid.device.type


def interactions_compact_edges(
    pid, loc, start, end, p_loc, sus_val, inf_val,
    row_idx, col_idx, row_start, pair_active, col_has_inf, row_has_sus, meta,
    *,
    block_size: int,
    src_val=None,
):
    """Backend ``pallas-compact``. Returns ``(acc (V,) f32, cnt (V,) int32,
    edges () int64)``: per-visit propensity sums (before tau), per-visit
    contact counts, and their total, the traversed-edge count; with
    ``src_val``, ``(acc, cnt, trc (V,) int32, edges)``; for a batch, each
    with the leading B. ``row_start`` is not read: compaction derives the
    run starts of its own order."""
    del row_start
    rows_c, cols_c, row_start_c, n_live = compact_schedule(
        row_idx, col_idx, pair_active, col_has_inf, row_has_sus
    )
    args = (pid, loc, start, end, p_loc, sus_val, inf_val,
            rows_c, cols_c, row_start_c, n_live, col_has_inf, row_has_sus, meta)
    if _device_kind(pid) == "cpu":
        return _kernel.interactions_compact_plain(*args, block_size=block_size,
                                                  src_val=src_val)
    if src_val is None:
        return _kernel.interactions_compact_cuda(*args, block_size=block_size)
    return _kernel.interactions_compact_traced_cuda(*args, src_val=src_val,
                                                    block_size=block_size)


def interactions_padded(
    pid, loc, start, end, p_loc, sus_val, inf_val,
    row_idx, col_idx, row_start, pair_active, col_has_inf, row_has_sus, meta,
    *,
    block_size: int,
    src_val=None,
):
    """Backend ``pallas``: the tile pass over the uncompacted schedule.
    Returns ``(acc, cnt)``, or ``(acc, cnt, trc)`` with ``src_val``."""
    args = (pid, loc, start, end, p_loc, sus_val, inf_val,
            row_idx, col_idx, row_start, pair_active, col_has_inf, row_has_sus, meta)
    if _device_kind(pid) == "cpu":
        return _kernel.interactions_padded_plain(*args, block_size=block_size,
                                                 src_val=src_val)
    if src_val is None:
        return _kernel.interactions_padded_cuda(*args, block_size=block_size)
    return _kernel.interactions_padded_traced_cuda(*args, src_val=src_val,
                                                   block_size=block_size)


BACKENDS = ("pallas-compact", "pallas")


def check_backend(backend: str) -> None:
    """Raise unless ``backend`` names a backend of this package."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown interaction backend {backend!r}; have {BACKENDS}")


def interactions_auto_edges(*args, backend: str, block_size: int):
    """The untraced pass on ``backend``; returns ``(acc, cnt, edges)``."""
    check_backend(backend)
    if backend == "pallas-compact":
        return interactions_compact_edges(*args, block_size=block_size)
    acc, cnt = interactions_padded(*args, block_size=block_size)
    return acc, cnt, cnt.sum(dim=-1, dtype=torch.int64)


def interactions_auto_traced(*args, backend: str, block_size: int, src_val):
    """The traced pass on ``backend``; returns ``(acc, cnt, edges, trc)``,
    the reference's order."""
    check_backend(backend)
    if backend == "pallas-compact":
        acc, cnt, trc, edges = interactions_compact_edges(
            *args, block_size=block_size, src_val=src_val)
        return acc, cnt, edges, trc
    acc, cnt, trc = interactions_padded(*args, block_size=block_size, src_val=src_val)
    return acc, cnt, cnt.sum(dim=-1, dtype=torch.int64), trc
