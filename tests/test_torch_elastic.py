"""Elastic shrink of a ``torch.distributed`` mesh and the mesh's straggler
vote, on gloo ranks on the CPU (the port of the reference's
``tests/test_resilience.py::test_device_loss_elastic_shrink`` and
``test_engine_adopt_state_repads_person_axis``).

A ``device_loss`` chaos event fires on every rank at day 6 of a 12-day run
checkpointed every 3 days. The ranks of the highest worker index retire
(their ``api.run`` returns an empty history, marked ``retired_at_day``), the
survivors rebuild on one worker fewer and resume from the day-6 snapshot.
The survivors' result is bitwise the uninterrupted local run, and the
report reads as the reference's test expects. Cases: engine ``dist``
W = 2 -> 1, engine ``hybrid`` 2 x 1 -> 1 x 1 (the reference's case) and
2 x 2 -> 1 x 2 (four ranks, a three-scenario batch padded to the shards).

The straggler vote: with ``repartition_on_straggler`` on a mesh, one rank
slowed by a ``slow`` event and the other deaf to it (a straggler factor it
never reaches) still repartition on the same day, and the run stays
bitwise.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api.spec import ResilienceSpec
from repro_torch.data import digital_twin_population
from repro_torch.engine.core import EngineCore, PERSON_STATE_FIELDS
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import ChaosEvent, ChaosSchedule

DAYS, EVERY, LOSS_DAY = 12, 3, 6
OBSERVABLES = ("daily_new_infections", "attack_rate", "peak_day", "ensemble_mean_ci")
SPAWN = dict(backend="gloo", device="cpu", threads=1, timeout_s=60.0, wall_s=600.0)
#: engine -> (mesh, replicates) of the spawned shrink cases
SHRINKS = {"dist": (dict(workers=2), 1), "hybrid": (dict(workers=2), 2),
           "hybrid-2x2": (dict(workers=2, scenarios=2), 3)}


def _spec(replicates, **kw):
    return api.ExperimentSpec(dataset="twin-2k", days=DAYS, tau=2e-5, interventions=("none",),
                              replicates=replicates, observables=OBSERVABLES
                              ).with_overrides(**kw)


def _loss():
    return ChaosSchedule((ChaosEvent("device_loss", day=LOSS_DAY, workers_lost=1),))


def _shrunk(pop, root, case):
    """One rank of a shrink case: the resilient study under the loss."""
    mesh, replicates = SHRINKS[case]
    spec = _spec(replicates, ckpt_dir=os.path.join(root, case), ckpt_every=EVERY,
                 resilient=True, **mesh)
    return api.run(spec, population=pop, device="cpu", chaos=_loss())


def _adopt(pop):
    """The reference's adopt test on the mesh: a W = 2 state (the person axis
    padded to 402) 5 days in, adopted by a W = 1 core on the survivors' mesh
    (rank 0) after ``WorkerMesh.shrink``."""
    batch = _spec(1).build_batch()
    m2 = mesh_lib.make_worker_mesh(2)
    core2 = EngineCore(pop, batch, layout="workers", mesh=m2, device="cpu")
    st2, _ = core2.run(5)
    m1 = m2.shrink(1)
    if m1 is None:
        return None
    core1 = EngineCore(pop, batch, layout="workers", mesh=m1, device="cpu")
    adopted, tmpl = core1.adopt_state(st2), core1.full_init_state()
    return {f: (getattr(st2, f).numpy(), getattr(adopted, f).numpy(),
                tuple(getattr(tmpl, f).shape)) for f in PERSON_STATE_FIELDS}


def _straggle(pop, root):
    """Rank 1 is slowed at day 8 (a 2-day chunk takes well under 0.5 s
    here); rank 0 never flags a chunk itself (factor 1e6)."""
    rank = torch.distributed.get_rank()
    spec = _spec(1, workers=2, ckpt_dir=os.path.join(root, "straggle"), ckpt_every=2)
    spec = dataclasses.replace(spec, resilience=ResilienceSpec(
        enabled=True, repartition_on_straggler=True,
        straggler_factor=3.0 if rank == 1 else 1e6))
    chaos = ChaosSchedule((ChaosEvent("slow", day=8, sleep_s=2.5),) if rank == 1 else ())
    return api.run(spec, population=pop, device="cpu", chaos=chaos)


def _two_ranks(pop, root):
    out = {case: _shrunk(pop, root, case) for case in ("dist", "hybrid")}
    out["adopt"] = _adopt(pop)
    out["straggle"] = _straggle(pop, root)
    return out


def _four_ranks(pop, root):
    return {"hybrid-2x2": _shrunk(pop, root, "hybrid-2x2")}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pop():
    pop = digital_twin_population(401, seed=11, name="elastic")
    assert pop.num_people % 2 == 1  # W = 2 pads the person axis
    return pop


@pytest.fixture(scope="module")
def local(pop):
    """The uninterrupted one-device runs each shrink is held to."""
    return {r: api.run(_spec(r), population=pop, device="cpu") for r in (1, 2, 3)}


@pytest.fixture(scope="module")
def two(pop, tmp_path_factory):
    return mesh_lib.spawn(_two_ranks, 2, init_dir=str(tmp_path_factory.mktemp("pg2")),
                          args=(pop, str(tmp_path_factory.mktemp("ck2"))), **SPAWN)


@pytest.fixture(scope="module")
def four(pop, tmp_path_factory):
    return mesh_lib.spawn(_four_ranks, 4, init_dir=str(tmp_path_factory.mktemp("pg4")),
                          args=(pop, str(tmp_path_factory.mktemp("ck4"))), **SPAWN)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _assert_bitwise(ref, res):
    assert set(ref.history) == set(res.history)
    for k in ref.history:
        np.testing.assert_array_equal(ref.history[k], res.history[k],
                                      err_msg=f"history[{k}] diverged")
    assert set(ref.observables) == set(res.observables)
    for k in ref.observables:
        got, want = _leaves(res.observables[k]), _leaves(ref.observables[k])
        assert len(got) == len(want) > 0, k
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), k


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,spawned,survivors", [
    ("dist", "two", 1), ("hybrid", "two", 1), ("hybrid-2x2", "four", 2)])
def test_device_loss_elastic_shrink(request, local, case, spawned, survivors):
    ranks = [r[case] for r in request.getfixturevalue(spawned)]
    replicates = SHRINKS[case][1]
    for rank, res in enumerate(ranks):
        rep = res.provenance["resilience"]
        # every rank records the loss
        assert rep["device_losses"] == [{"workers_before": 2, "workers_after": 1}]
        assert rep["final_workers"] == 1
        assert rep["final_layout"] == ("workers" if case == "dist" else "hybrid")
        if rank < survivors:
            _assert_bitwise(local[replicates], res)
            assert "retired_at_day" not in rep
            assert res.provenance["resumed_from_day"] == LOSS_DAY
            assert res.provenance["final_mesh"]["workers"] == 1
            (shrink,) = res.provenance["elastic"]
            assert shrink["workers_before"] == 2 and shrink["workers_after"] == 1
            assert shrink["rebuild_s"] >= shrink["plan_and_tables_s"] > 0
            # the run's collectives continue across the rebuild: the days
            # before the loss on W = 2 and the days after it on W = 1
            assert res.provenance["collectives"]["all_to_all"] == 2 * DAYS
        else:
            assert res.provenance["retired"] and res.history == {}
            assert rep["retired_at_day"] == LOSS_DAY
    # the survivors all return the same result
    for res in ranks[1:survivors]:
        _assert_bitwise(ranks[0], res)


def test_engine_adopt_state_repads_person_axis(pop, two):
    """``EngineCore.adopt_state`` re-partitions person-axis leaves from the
    2-worker padded layout onto 1 worker, keeping every real person."""
    assert two[1]["adopt"] is None  # rank 1 left the shrunk mesh
    P = pop.num_people
    for f, (old, new, shape) in two[0]["adopt"].items():
        assert old.shape[-1] == P + 1 and new.shape == shape and shape[-1] == P, f
        np.testing.assert_array_equal(new.reshape(-1)[:P], old.reshape(-1)[:P], err_msg=f)


def test_mesh_straggler_vote_repartitions_every_rank_on_the_same_day(local, two):
    r0, r1 = (r["straggle"] for r in two)
    rep0, rep1 = r0.provenance["resilience"], r1.provenance["resilience"]
    # only the slowed rank flagged a chunk itself; the vote moved both
    assert rep0["straggler_events"] == [] and rep1["straggler_events"]
    assert rep1["straggler_events"][0]["day"] == 10  # the slowed chunk's end
    assert rep0["faults"] == rep1["faults"]
    assert rep0["repartitions"] == rep1["repartitions"] >= 1
    assert {"kind": "repartition", "day": 10} in rep0["faults"]
    assert rep0["restarts"] == rep1["restarts"] == 0
    _assert_bitwise(local[1], r0)
    _assert_bitwise(local[1], r1)
