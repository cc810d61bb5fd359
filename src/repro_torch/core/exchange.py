"""Capacity-bucketed dispatch/combine exchange (the port of the reference's
``repro.core.exchange``).

Loimos's visit-message exchange is a scatter over a bipartite graph: values
held by *people partitions* must reach the *location partitions* that own
each visit, and exposure results must flow back. The SPMD form is a
**static-routed, capacity-bucketed all_to_all**: routing is known from the
(static) visit schedule, and each (src, dst) worker pair exchanges a buffer
of fixed capacity C (the most visits between any pair, rounded up), so the
buffers' shapes never depend on the day's data.

:func:`build_exchange_plan` is the reference's host plan, array for array.
The port moves the values with gathers through tables built from it on the
host (``core/simulator_dist.py:rank_tables``), never with a float
scatter-add:

  * :func:`dispatch` — person channels into the send buffer (a gather by
    ``send`` index), one ``all_to_all``, then each visit slot takes its one
    buffer slot (a gather by ``recv`` index: a slot is filled at most once,
    so this is a copy);
  * :func:`combine` — per-visit values into the send buffer (a gather by
    visit index), one ``all_to_all``, then each owner-local person folds its
    received values **in a fixed order**, one column of its ``fold`` table at
    a time — the order of the local layout's person-slot table
    (``core/interactions.py:person_slot_table``), so the sums are bitwise the
    local layout's.

Index tables point one past the end for padding, at a zero row appended to
the gathered tensor. The collective itself is the caller's ``all_to_all``
(``engine/topology.py:MeshTopology``), which counts it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static routing for one day-of-week on a W-worker mesh.

    Per-worker arrays (leading axis W = worker that owns them):
      send_idx[w]  (W, C): source-local person index to place in the buffer
                   slot (dst, c); -1 = padding.
      recv_slot[w] (W, C): destination-local *visit* index that buffer slot
                   (src, c) fills; -1 = padding.
    """

    num_workers: int
    capacity: int
    send_idx: np.ndarray  # (W, W, C) int32 [owner=src]
    recv_slot: np.ndarray  # (W, W, C) int32 [owner=dst]

    @property
    def bytes_per_channel(self) -> int:
        return self.num_workers * self.num_workers * self.capacity * 4


def build_exchange_plan(
    visit_person_local: np.ndarray,  # (W, Vw) global person id per local visit, -1 pad
    person_owner: np.ndarray,  # (P,) int32 worker owning each person
    person_local_index: np.ndarray,  # (P,) int32 index within owner's shard
    capacity_multiple: int = 8,
) -> ExchangePlan:
    """Host-side plan construction from the partitioned visit schedule
    (sort + prefix ranks, O(R log R) for R routes)."""
    W, Vw = visit_person_local.shape
    dst = np.repeat(np.arange(W, dtype=np.int64), Vw)
    v_local = np.tile(np.arange(Vw, dtype=np.int64), W)
    pids = visit_person_local.reshape(-1)
    valid = pids >= 0
    dst, v_local, pids = dst[valid], v_local[valid], pids[valid]
    src = person_owner[pids].astype(np.int64)
    p_local = person_local_index[pids].astype(np.int64)

    # Rank within each (src, dst) bucket via sorted prefix counting.
    key = src * W + dst
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    change = np.flatnonzero(np.diff(key_s)) + 1
    starts = np.concatenate([[0], change])
    run_ids = np.searchsorted(change, np.arange(len(key_s)), side="right")
    run_starts = starts[run_ids]
    rank_s = np.arange(len(key_s)) - run_starts
    rank = np.empty_like(rank_s)
    rank[order] = rank_s

    counts = np.bincount(key, minlength=W * W)
    cap = int(counts.max()) if len(key) else 1
    cap = int(np.ceil(max(cap, 1) / capacity_multiple) * capacity_multiple)

    send_idx = np.full((W, W, cap), -1, np.int32)
    recv_slot = np.full((W, W, cap), -1, np.int32)
    send_idx[src, dst, rank] = p_local
    recv_slot[dst, src, rank] = v_local
    return ExchangePlan(W, cap, send_idx, recv_slot)


def _with_zero_row(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with one zero slice appended along ``dim`` (the padding target
    of the index tables)."""
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def dispatch(all_to_all, route: dict, chans: torch.Tensor) -> torch.Tensor:
    """Person partition -> location partition (visit messages).

    ``chans`` (B, Pw, ch) this worker's people; ``route["dsend"]`` (W, C)
    person rows per send slot, ``route["drecv"]`` (Vw,) the received slot
    per local visit (padding: one past the end). Returns (B, Vw, ch), zeros
    in slots no person fills."""
    B, _, ch = chans.shape
    W, C = route["dsend"].shape
    send = _with_zero_row(chans, 1)[:, route["dsend"]]  # (B, W, C, ch)
    recv = all_to_all(send.transpose(0, 1).contiguous())  # (W, B, C, ch) by source
    recv = recv.transpose(0, 1).reshape(B, W * C, ch)
    return _with_zero_row(recv, 1)[:, route["drecv"]]


def combine(all_to_all, route: dict, active: torch.Tensor, accs: torch.Tensor) -> torch.Tensor:
    """Location partition -> person partition (exposure messages), the
    adjoint of :func:`dispatch`: (B, Vw, ch) per-visit values (inactive
    visits add 0.0) -> (B, Pw, ch) per-person sums. ``route["csend"]`` (W, C)
    is the visit per send slot, ``route["fold"]`` (Pw, K) each person's
    received slots in the local layout's order. The sum is one column of
    ``fold`` at a time, from 0.0: the local combine's order."""
    B, _, ch = accs.shape
    W, C = route["csend"].shape
    vals = _with_zero_row(torch.where(active[..., None], accs, 0.0), 1)
    recv = all_to_all(vals[:, route["csend"]].transpose(0, 1).contiguous())
    recv = _with_zero_row(recv.transpose(0, 1).reshape(B, W * C, ch), 1)
    per_person = recv[:, route["fold"]]  # (B, Pw, K, ch)
    out = torch.zeros((B, per_person.shape[1], ch), dtype=accs.dtype, device=accs.device)
    for k in range(per_person.shape[2]):
        out = out + per_person[:, :, k]
    return out
