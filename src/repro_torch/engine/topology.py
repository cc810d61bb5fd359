"""Where the day loop runs: the placements of a scenario batch.

The reference writes its day step once against a Topology protocol and
places it on a local device, a worker mesh, a scenario mesh or both; so does
the port (``engine/day.py``), over ``torch.distributed`` process groups
(``launch/mesh.py``) in place of named JAX mesh axes. Every value carries
the batch's leading scenario axis B; what comes from the week (person ids,
the exchange tables) is shared by all scenarios. A topology answers:

  * ``gpid`` — the global ids of this shard's people;
  * ``day_route`` / ``dispatch`` / ``combine`` / ``combine_many`` — the
    visit and exposure exchange. Locally ``dispatch`` is a gather by person
    id, masked by the ``pid >= 0`` padding sentinel, and ``combine`` its
    adjoint, a **fixed-order** sum with no float atomics: each person's
    visit slots come from a table built on the host with the week (ascending
    slot order, ``core/interactions.py:person_slot_table``) and are added one
    column at a time, so the result is bitwise the same on CPU and GPU,
    from run to run, and for a scenario alone or in any batch. On a worker
    mesh they are the capacity-bucketed ``all_to_all`` of
    ``core/exchange.py``, whose combine folds in that same local order;
  * ``seed_threshold`` — the k-th smallest seeding draw, and
    ``rank_threshold`` — the testing budget's k-th smallest (score, person)
    pair: locally a sort of each scenario's row, picked by a device index
    (no host sync); on a worker mesh the union of per-worker candidates,
    gathered and re-ranked, which holds the global k-th element, so the
    result is bitwise the local one;
  * ``psum`` — the day's integer statistics summed over the workers, in one
    ``all_reduce`` (the reference issues one psum per statistic; integer
    sums are exact either way);
  * ``scen_gather`` — the day's statistics of the whole batch from this
    rank's slice of it, so the history and the in-loop observables are the
    same on every rank and bitwise the local run's.

The mesh topologies issue one fixed schedule of collectives per day,
whatever the data, and count them by kind and bytes (:attr:`counts`,
:attr:`bytes_sent`). Both backends are given the tensors where they live
(gloo takes CUDA tensors for these three collectives).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import exchange as ex_lib


@dataclasses.dataclass(frozen=True)
class LocalTopology:
    """Single-device placement: every collective is local."""

    def gpid(self, num_people: int, device) -> torch.Tensor:
        """Global ids of this shard's people: here, all of them."""
        return torch.arange(num_people, dtype=torch.int64, device=device)

    def day_route(self, take):
        """The day's exchange tables from the week (``take(key)`` reads a
        key at the day of the week): the combine's (P, K) slot table."""
        return take("slots")

    def dispatch(self, pid, chans, route=None):
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

    def psum(self, stats: dict) -> dict:
        """The day's (B,) integer statistics summed over workers: one worker."""
        return stats

    def scen_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """(K, B_local) day statistics -> the whole batch's: all of it."""
        return rows


class _Collectives:
    """Counted collectives over a :class:`~repro_torch.launch.mesh.WorkerMesh`."""

    def __init__(self, mesh, *, seed_topk: int = 1, test_topk: int = 1):
        self.mesh = mesh
        self.seed_topk = seed_topk  # per-worker candidates of the seeding draw
        self.test_topk = test_topk  # per-worker candidates of the test budget
        #: collectives issued, by kind, and the bytes this rank sent in them
        self.counts = collections.Counter()
        self.bytes_sent = collections.Counter()

    def reset_counts(self) -> None:
        self.counts.clear()
        self.bytes_sent.clear()

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.counts[kind] += 1
        self.bytes_sent[kind] += x.numel() * x.element_size()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Dim 0 of ``x`` (W, ...) goes to worker i; the result's dim 0 is
        by source worker."""
        self._count("all_to_all", x)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.mesh.worker_group)
        return out

    def all_gather(self, x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
        """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
        order."""
        self._count("all_gather", x)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def _scen_gather(self, rows: torch.Tensor) -> torch.Tensor:
        return self.all_gather(rows, self.mesh.scenario_group, self.mesh.scenarios, dim=-1)


class MeshTopology(_Collectives):
    """People and locations sharded over the mesh's workers: the exchange is
    the capacity-bucketed ``all_to_all``, the order statistics gather
    per-worker candidates, the statistics are summed in one ``all_reduce``.
    A day issues 2 ``all_to_all``, 1 ``all_gather`` (seeding), 1
    ``all_reduce`` and 1 more ``all_gather`` per test-trace-isolate slot."""

    def gpid(self, num_people: int, device) -> torch.Tensor:
        """``w * Pw + arange(Pw)`` for this worker ``w``'s ``Pw`` people."""
        return (self.mesh.worker_index * num_people
                + torch.arange(num_people, dtype=torch.int64, device=device))

    def day_route(self, take) -> dict:
        return {k: take(k) for k in ("dsend", "drecv", "csend", "fold")}

    def dispatch(self, pid, chans, route):
        return ex_lib.dispatch(self.all_to_all, route, chans)

    def combine(self, route, active, acc):
        return self.combine_many(route, active, acc[..., None])[..., 0]

    def combine_many(self, route, active, accs):
        return ex_lib.combine(self.all_to_all, route, active, accs)

    def seed_threshold(self, u, seed_per_day, num_people: int):
        # The union of every worker's seed_topk smallest draws holds the
        # global k-th smallest (seed_topk >= min(seed_per_day, Pw)), so the
        # pick is bitwise the local full sort's.
        small = torch.topk(u, min(self.seed_topk, u.shape[-1]), dim=-1,
                           largest=False, sorted=True).values
        union = torch.sort(self.all_gather(small, self.mesh.worker_group,
                                            self.mesh.workers, dim=-1), dim=-1).values
        k = (torch.clamp(seed_per_day, max=num_people) - 1).clamp(0, union.shape[-1] - 1)
        return union.gather(1, k[:, None].long())[:, 0]

    def rank_threshold(self, score, gpid, k, num_people: int):
        # Per-worker lexicographic candidates (a stable sort on score of
        # ascending gpid), gathered in worker order, which is ascending gpid
        # again, so a stable sort of the union is the global (score, gpid)
        # order and holds the global k-th pair (test_topk >= min(k, Pw)).
        # Score bits and gpid travel in one int64 gather.
        top = torch.sort(score, dim=-1, stable=True).indices[:, :self.test_topk]
        cand = torch.stack([score.gather(1, top).view(torch.int32).to(torch.int64),
                            gpid[top]])
        union = self.all_gather(cand, self.mesh.worker_group, self.mesh.workers, dim=-1)
        u_score = union[0].to(torch.int32).view(torch.float32)
        order = torch.sort(u_score, dim=-1, stable=True).indices
        idx = (torch.clamp(k, max=num_people) - 1).clamp(0, u_score.shape[-1] - 1)
        pick = order.gather(1, idx[:, None].long())
        return u_score.gather(1, pick)[:, 0], union[1].gather(1, pick)[:, 0]

    def psum(self, stats: dict) -> dict:
        x = torch.stack(list(stats.values()))
        self._count("all_reduce", x)
        dist.all_reduce(x, group=self.mesh.worker_group)
        return dict(zip(stats, x.unbind(0)))

    def scen_gather(self, rows: torch.Tensor) -> torch.Tensor:
        return rows


class ScenarioTopology(_Collectives):
    """The scenario batch sharded over the mesh's scenario shards; people stay
    local. Scenarios are independent, so the day needs one collective: the
    ``all_gather`` of the day's statistics."""

    gpid = LocalTopology.gpid
    day_route = LocalTopology.day_route
    dispatch = LocalTopology.dispatch
    combine = LocalTopology.combine
    combine_many = LocalTopology.combine_many
    seed_threshold = LocalTopology.seed_threshold
    rank_threshold = LocalTopology.rank_threshold
    psum = LocalTopology.psum

    def scen_gather(self, rows: torch.Tensor) -> torch.Tensor:
        return self._scen_gather(rows)


class ProductTopology(MeshTopology):
    """workers x scenarios: the worker collectives of :class:`MeshTopology`
    plus the scenario gather (the hybrid placement)."""

    def scen_gather(self, rows: torch.Tensor) -> torch.Tensor:
        return self._scen_gather(rows)


def make_topology(mesh=None, **kw):
    """The placement of a :class:`~repro_torch.launch.mesh.WorkerMesh` (None:
    local) by its named axes; ``kw`` go to the mesh topologies."""
    if mesh is None:
        return LocalTopology()
    cls = {("workers",): MeshTopology, ("scenarios",): ScenarioTopology,
           ("workers", "scenarios"): ProductTopology}[tuple(mesh.axis_names)]
    return cls(mesh, **kw)
