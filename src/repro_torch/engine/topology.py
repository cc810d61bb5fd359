"""Where the day loop runs: the single-device placement of a scenario batch.

The reference writes its day step once against a Topology protocol and
places it on a local device, a worker mesh or a scenario mesh. This package
has the local placement only. Every value carries the batch's leading
scenario axis B; what comes from the week (person ids, the slot table) is
shared by all scenarios. Its collectives and order statistics:

  * ``dispatch`` routes per-person channels to visit slots: a gather by
    person id, masked by the ``pid >= 0`` padding sentinel;
  * ``combine`` is its adjoint, per-visit propensities summed back to their
    people. It is a **fixed-order** sum with no float atomics: each person's
    visit slots come from a table built on the host with the week (ascending
    slot order, ``core/interactions.py:person_slot_table``) and are added one
    column at a time, so the result is bitwise the same on CPU and GPU,
    from run to run, and for a scenario alone or in any batch;
  * ``combine_many`` folds several channels at once (exposure and traced
    contacts) in that same order;
  * ``seed_threshold``, the k-th smallest seeding draw, and
    ``rank_threshold``, the testing budget's k-th smallest (score, person)
    pair: a sort of each scenario's row, picked by a device index, so no
    host sync.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LocalTopology:
    """Single-device placement: every collective is local."""

    def dispatch(self, pid, chans):
        """``chans`` (B, P, ch) -> (B, V, ch) by the shared (V,) ``pid``,
        zeros in padding slots."""
        return chans[:, pid.clamp(min=0)] * (pid >= 0)[:, None]

    def combine(self, slots, active, acc):
        """(B, V) per-visit values -> (B, P) per-person sums over ``slots``,
        the day's shared (P, K) slot table padded with V. Inactive slots
        add 0.0."""
        return self.combine_many(slots, active, acc[..., None])[..., 0]

    def combine_many(self, slots, active, accs):
        """Channel-stacked :meth:`combine`: (B, V, C) -> (B, P, C). Every
        channel folds in the same slot order, so channel 0 is bitwise the
        single-channel combine of ``accs[..., 0]``."""
        B, _, C = accs.shape
        vals = torch.cat([torch.where(active[..., None], accs, 0.0),
                          accs.new_zeros((B, 1, C))], dim=1)
        per_person = vals[:, slots]  # (B, P, K, C)
        out = torch.zeros((B, slots.shape[0], C), dtype=accs.dtype, device=accs.device)
        for k in range(slots.shape[1]):
            out = out + per_person[:, :, k]
        return out

    def seed_threshold(self, u, seed_per_day, num_people: int):
        """Per scenario, the k-th smallest entry of its row of ``u`` (B, P),
        k = min(seed_per_day, P): a (B,) tensor."""
        k = (torch.clamp(seed_per_day, max=num_people) - 1).clamp(min=0)
        return torch.sort(u, dim=-1).values.gather(1, k[:, None].long())[:, 0]

    def rank_threshold(self, score, gpid, k, num_people: int):
        """Per scenario, the k-th smallest ``(score, gpid)`` pair of its row,
        lexicographically: (B,) ``(T, G)`` such that exactly
        ``min(k, count(score < 4.0))`` entries of the row satisfy
        ``score < T or (score == T and gpid <= G)``. Here ``gpid`` (P,) is
        ``arange(P)``, already ascending, so a stable sort of each row on
        ``score`` is the lexicographic order. The pick is a device index:
        no sync."""
        order = torch.sort(score, dim=-1, stable=True).indices
        idx = (torch.clamp(k, max=num_people) - 1).clamp(0, score.shape[-1] - 1)
        pick = order.gather(1, idx[:, None].long())
        return score.gather(1, pick)[:, 0], gpid[pick[:, 0]]
