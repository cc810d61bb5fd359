"""Where the day loop runs: the single-device placement.

The reference writes its day step once against a Topology protocol and
places it on a local device, a worker mesh or a scenario mesh. This package
has the local placement only. Its three collectives:

  * ``dispatch`` routes per-person channels to visit slots: a gather by
    person id, masked by the ``pid >= 0`` padding sentinel;
  * ``combine`` is its adjoint, per-visit propensities summed back to their
    people. It is a **fixed-order** sum with no float atomics: each person's
    visit slots come from a table built on the host with the week (ascending
    slot order, ``core/interactions.py:person_slot_table``) and are added one
    column at a time, so the result is bitwise the same on CPU and GPU and
    from run to run;
  * ``seed_threshold``, the k-th smallest seeding draw: a full sort indexed
    by a device tensor, so no host sync.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LocalTopology:
    """Single-device placement: every collective is local."""

    def dispatch(self, pid, chans):
        """``chans`` (P, ch) -> (V, ch), zeros in padding slots."""
        return chans[pid.clamp(min=0)] * (pid >= 0)[:, None]

    def combine(self, slots, active, acc):
        """(V,) per-visit values -> (P,) per-person sums over ``slots``, the
        day's (P, K) slot table padded with V. Inactive slots add 0.0."""
        vals = torch.cat([torch.where(active, acc, 0.0), acc.new_zeros(1)])
        per_person = vals[slots]
        out = torch.zeros(slots.shape[:1], dtype=acc.dtype, device=acc.device)
        for k in range(slots.shape[1]):
            out = out + per_person[:, k]
        return out

    def seed_threshold(self, u, seed_per_day, num_people: int):
        """The k-th smallest entry of ``u``, k = min(seed_per_day, P)."""
        k = (torch.clamp(seed_per_day, max=num_people) - 1).clamp(min=0)
        return torch.sort(u).values.index_select(0, k.reshape(1))[0]
