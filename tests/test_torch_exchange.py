"""The worker partition and its exchange, in one process, and the process
launcher (``launch/mesh.py:spawn``).

* The host plans are the reference's byte for byte:
  ``core/exchange.py:build_exchange_plan`` on random routes and
  ``core/simulator_dist.py:build_dist_plan`` on twin-1200 for W = 1, 2 and 4,
  balanced and naive, packed and not.
* Each rank's gather tables route every visit from exactly one buffer slot
  and fold each person's visits in ascending local slot.
* What makes a mesh bitwise equal to the local layout, checked before any
  process runs: every visit's interaction sums on its worker (the plain
  versions of both kernels) equal the local layout's, and the exchange's
  dispatch and combine, run by W threads standing in for the ranks, equal
  the local gather and fixed-order combine.
* ``spawn`` returns the ranks' results in rank order, fails when a rank
  raises, fails a hung collective within the group's timeout and a hung
  rank within its wall limit; a mesh asked for outside a fitting process
  group raises, naming ``spawn`` and ``torchrun``.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import exchange as j_ex
from repro.core import simulator_dist as j_sd
from repro.data import digital_twin_population as j_twin
from repro_torch import api
from repro_torch.core import exchange as t_ex
from repro_torch.core import interactions as inter_lib
from repro_torch.core import simulator_dist as t_sd
from repro_torch.data import digital_twin_population as t_twin
from repro_torch.engine import EngineCore
from repro_torch.engine import core as core_lib
from repro_torch.engine.topology import LocalTopology
from repro_torch.kernels.interactions import ops as iops
from repro_torch.launch import mesh as mesh_lib

PLAN_FIELDS = ("num_workers", "people_per_worker", "num_people", "locs_per_worker",
               "visits_per_worker", "pairs_per_worker", "block_size", "week_pid",
               "week_loc", "week_start", "week_end", "week_p", "row_idx", "col_idx",
               "row_start", "pair_active", "send_idx", "recv_slot", "capacity",
               "loc_partition")
B = 128


@pytest.fixture(scope="module")
def pops():
    return j_twin(1200, seed=1, name="t"), t_twin(1200, seed=1, name="t")


@pytest.fixture(scope="module")
def plans(pops):
    """The port's packed, balanced plans of twin-1200 by worker count."""
    return {W: t_sd.build_dist_plan(pops[1], W, B) for W in (1, 2, 4)}


def _same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_exchange_plan_is_the_reference_byte_for_byte(W):
    rs = np.random.default_rng(W)
    P, Vw = 97, 40
    person = rs.integers(-1, P, (W, Vw)).astype(np.int32)  # -1: padding slots
    owner = (np.arange(P) * W // P).astype(np.int32)
    local = np.zeros(P, np.int32)
    for w in range(W):
        local[owner == w] = np.arange((owner == w).sum())
    a = j_ex.build_exchange_plan(person, owner, local)
    b = t_ex.build_exchange_plan(person, owner, local)
    for f in ("num_workers", "capacity", "send_idx", "recv_slot"):
        _same(getattr(a, f), getattr(b, f), f)
    assert a.bytes_per_channel == b.bytes_per_channel


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("balanced", [True, False], ids=["balanced", "naive"])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_dist_plan_is_the_reference_byte_for_byte(pops, W, balanced, pack):
    a = j_sd.build_dist_plan(pops[0], W, B, balanced, pack)
    b = t_sd.build_dist_plan(pops[1], W, B, balanced, pack)
    for f in PLAN_FIELDS:
        _same(getattr(a, f), getattr(b, f), f)
    # the visit ids name the same people, and the local layout is the
    # one core/interactions.py builds
    week = inter_lib.build_week_data(pops[1], B)
    for d, day in enumerate(pops[1].week):
        vid = b.week_vid[d]
        assert np.array_equal(np.where(vid >= 0, day.person[np.maximum(vid, 0)], -1),
                              b.week_pid[d])
        lv = b.local_vid[d]
        assert np.array_equal(np.where(lv >= 0, day.person[np.maximum(lv, 0)], -1),
                              week.pid[d][:len(lv)])
        assert (week.pid[d][len(lv):] == -1).all()
        assert np.array_equal(lv[b.local_slot[d]], np.arange(day.num_real))


@pytest.mark.parametrize("W", [1, 2, 4])
def test_rank_tables_route_every_visit_once(plans, W):
    plan = plans[W]
    C, Pw, Vw = plan.capacity, plan.people_per_worker, plan.visits_per_worker
    for w in range(W):
        t = t_sd.rank_tables(plan, w)
        for d in range(7):
            pid = plan.week_pid[d, w]
            real = np.flatnonzero(pid >= 0)
            # dispatch: each real visit takes one received slot, of its person
            src = t["drecv"][d]
            assert (src[pid < 0] == W * C).all() and (src[real] < W * C).all()
            assert len(np.unique(src[real])) == len(real)
            s, c = src[real] // C, src[real] % C
            person = plan.send_idx[d, s, w, c]
            assert np.array_equal(s * Pw + person, pid[real])
            assert np.array_equal(np.where(plan.send_idx[d, w] >= 0, plan.send_idx[d, w], Pw),
                                  t["dsend"][d])
            assert np.array_equal(np.where(plan.recv_slot[d, w] >= 0, plan.recv_slot[d, w], Vw),
                                  t["csend"][d])
            # combine: each person's entries are its visits, ascending local slot
            fold = t["fold"][d]
            for p in range(0, Pw, 37):
                entries = fold[p][fold[p] < W * C]
                dst, c = entries // C, entries % C
                assert (plan.send_idx[d, w, dst, c] == p).all()
                vids = plan.week_vid[d, dst, plan.recv_slot[d, dst, w, c]]
                slots = plan.local_slot[d][vids]
                assert (np.diff(slots) > 0).all()
                gp = w * Pw + p
                if gp < plan.num_people:
                    assert len(entries) == (plan.week_pid[d] == gp).sum()


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("dataset", ["twin-1200", "twin-2k"])
def test_every_location_run_folds_as_in_the_local_layout(W, dataset):
    """Occupancy packing cuts each run into blocks at the same places on a
    worker as in the local layout, so per-visit interaction sums can match."""
    pop = (t_twin(1200, seed=1, name="t") if dataset == "twin-1200"
           else t_twin(2000, seed=0, name="twin-2k"))
    assert t_sd.fold_mismatches(t_sd.build_dist_plan(pop, W, B), pop) == 0


def test_the_fold_check_sees_runs_cut_elsewhere(pops):
    """Unpacked, a worker's runs start at other offsets than the local
    layout's packed ones, and the check counts them."""
    plan = t_sd.build_dist_plan(pops[1], 2, B, pack=False)
    assert t_sd.fold_mismatches(plan, pops[1]) > 0


def _visit_values(pop, seed):
    rs = np.random.default_rng(seed)
    P = pop.num_people
    sus = np.where(rs.random(P) < 0.7, rs.uniform(0.1, 1, P), 0).astype(np.float32)
    inf = np.where(rs.random(P) < 0.3, rs.uniform(0.1, 1, P), 0).astype(np.float32)
    src = np.where((inf > 0) & (rs.random(P) < 0.4), 1.0, 0.0).astype(np.float32)
    return sus, inf, src


def _pass(pid, loc, start, end, p, row, col, rs, pa, vals, backend):
    """The interaction pass's plain version on one layout of one day."""
    sus, inf, src = (torch.as_tensor(np.where(pid >= 0, v[np.maximum(pid, 0)], 0.0))
                     for v in vals)
    pid_t = torch.as_tensor(pid)
    nb = len(pid) // B
    args = [torch.as_tensor(a) for a in (loc, start, end, p)]
    return iops.interactions_auto_traced(
        pid_t, *args, sus, inf, *(torch.as_tensor(a) for a in (row, col, rs, pa)),
        iops.col_has_infectious(inf, pid_t, nb, B), iops.row_has_susceptible(sus, pid_t, nb, B),
        torch.tensor([11, 3]), backend=backend, block_size=B, src_val=src)


@pytest.mark.parametrize("backend", iops.BACKENDS)
@pytest.mark.parametrize("W", [2, 4])
def test_interaction_sums_per_visit_equal_local(pops, plans, W, backend):
    """Every visit's acc, cnt and trc on its worker (through the wrapper's
    plain version) are bitwise the local layout's, before anything relies
    on it."""
    pop, plan = pops[1], plans[W]
    local = inter_lib.build_week_data(pop, B)
    vals = _visit_values(pop, W)
    for d in (0, 3):
        lp = pop.contact_prob[local.loc[d]]
        acc, cnt, _, trc = _pass(local.pid[d], local.loc[d], local.start[d], local.end[d], lp,
                                 local.row_idx[d], local.col_idx[d], local.row_start[d],
                                 local.pair_active[d], vals, backend)
        assert float(acc.sum()) > 0 and int(trc.sum()) > 0
        n = len(plan.local_vid[d])
        by_vid = {k: v[:n][plan.local_slot[d]] for k, v in
                  (("acc", acc.numpy()), ("cnt", cnt.numpy()), ("trc", trc.numpy()))}
        for w in range(W):
            a = [getattr(plan, f)[d, w] for f in ("week_pid", "week_loc", "week_start",
                                                  "week_end", "week_p", "row_idx", "col_idx",
                                                  "row_start", "pair_active")]
            wacc, wcnt, _, wtrc = _pass(*a, vals, backend)
            vid = plan.week_vid[d, w]
            real = vid >= 0
            for k, v in (("acc", wacc), ("cnt", wcnt), ("trc", wtrc)):
                got = v.numpy()[real]
                want = by_vid[k][vid[real]]
                assert got.tobytes() == want.tobytes(), (d, w, k)


class _ThreadGroup:
    """W threads standing in for the ranks of a worker group: each
    ``all_to_all`` posts this rank's buffer and, once all have, takes slice
    ``rank`` of every rank's."""

    def __init__(self, W):
        self.W, self.bufs, self.barrier = W, [None] * W, threading.Barrier(W)

    def all_to_all(self, rank):
        def exchange(x):
            self.bufs[rank] = x
            self.barrier.wait()
            out = torch.stack([self.bufs[src][rank] for src in range(self.W)])
            self.barrier.wait()
            return out
        return exchange


@pytest.mark.parametrize("W", [1, 2, 4])
def test_exchange_by_threads_equals_local_dispatch_and_combine(pops, plans, W):
    pop, plan = pops[1], plans[W]
    P, Pw, Bn, ch = pop.num_people, plan.people_per_worker, 2, 3
    rs = np.random.default_rng(W)
    chans = torch.as_tensor(rs.random((Bn, W * Pw, ch)).astype(np.float32))
    local = core_lib.local_week_arrays(pop, inter_lib.build_week_data(pop, B), device="cpu")
    topo, group = LocalTopology(), _ThreadGroup(W)
    for d in (1, 5):
        pid = local["pid"][d]
        want_v = topo.dispatch(pid, chans[:, :P])
        active = torch.as_tensor(rs.random((Bn, len(pid))) < 0.8)
        accs = torch.as_tensor(rs.random((Bn, len(pid), ch)).astype(np.float32))
        want_p = topo.combine_many(local["slots"][d], active, accs)
        got, errors = {}, []

        def rank(w):
            try:
                t = {k: torch.as_tensor(v[d]) for k, v in t_sd.rank_tables(plan, w).items()}
                vv = t_ex.dispatch(group.all_to_all(w), t, chans[:, w * Pw:(w + 1) * Pw])
                vid = plan.week_vid[d, w]
                slot = torch.as_tensor(plan.local_slot[d][np.maximum(vid, 0)])
                real = torch.as_tensor(vid >= 0)
                w_active = torch.where(real, active[:, slot], False)
                w_accs = accs[:, slot]
                got[w] = (vv, real, slot, t_ex.combine(group.all_to_all(w), t, w_active, w_accs))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
                group.barrier.abort()

        threads = [threading.Thread(target=rank, args=(w,)) for w in range(W)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors and len(got) == W, errors
        for w, (vv, real, slot, pp) in got.items():
            # dispatch: each real visit carries its person's channels exactly
            assert torch.equal(vv[:, real], want_v[:, slot[real]])
            assert not vv[:, ~real].any()
            # combine: each real person's sums are the local fold's, bitwise
            lo, hi = w * Pw, min((w + 1) * Pw, P)
            assert torch.equal(pp[:, :hi - lo], want_p[:, lo:hi])
            assert not pp[:, hi - lo:].any()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _rank_sum(x):
    t = torch.tensor([dist.get_rank() + x])
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), int(t)


def _rank_raises():
    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    return dist.get_rank()


def _rank_skips_collective():
    if dist.get_rank() == 1:
        time.sleep(120)  # never joins the all_reduce
    t = torch.zeros(1)
    dist.all_reduce(t)


def _rank_sleeps():
    time.sleep(120)


SPAWN = dict(backend="gloo", device="cpu", threads=1)


def test_spawn_returns_rank_results_in_order(tmp_path):
    out = mesh_lib.spawn(_rank_sum, 3, init_dir=str(tmp_path), args=(10,), **SPAWN)
    assert out == [(0, 3, 33), (1, 3, 33), (2, 3, 33)]


def test_spawn_fails_when_a_rank_raises(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one gives up"):
        mesh_lib.spawn(_rank_raises, 2, init_dir=str(tmp_path), **SPAWN)


def test_spawn_fails_a_hung_collective_within_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        mesh_lib.spawn(_rank_skips_collective, 2, init_dir=str(tmp_path), timeout_s=5.0,
                       wall_s=100.0, **SPAWN)
    assert time.monotonic() - t0 < 60.0


def test_spawn_kills_ranks_past_its_wall_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        mesh_lib.spawn(_rank_sleeps, 2, init_dir=str(tmp_path), wall_s=8.0, **SPAWN)
    assert time.monotonic() - t0 < 60.0


def test_spawn_refuses_nccl_without_a_card_device(tmp_path):
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        mesh_lib.spawn(_rank_sum, 2, backend="nccl", device="cpu", init_dir=str(tmp_path))
    with pytest.raises(ValueError, match="backend must be one of"):
        mesh_lib.spawn(_rank_sum, 2, backend="mpi", device="cpu", init_dir=str(tmp_path))


@pytest.mark.parametrize("what", ["mesh", "core", "api"])
def test_a_mesh_outside_a_process_group_names_spawn_and_torchrun(pops, what):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="launch.mesh.spawn or torchrun"):
        if what == "mesh":
            mesh_lib.make_hybrid_mesh(2, 2)
        elif what == "core":
            from repro_torch.core import disease
            EngineCore.single(pops[1], disease.covid_model(), device="cpu", layout="workers",
                              workers=2)
        else:
            api.run(api.ExperimentSpec(days=3).with_overrides(workers=2),
                    population=pops[1], device="cpu")
