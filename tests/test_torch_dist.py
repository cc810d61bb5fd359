"""The port's mesh layouts (``workers``, ``scenarios``, ``hybrid``) and mesh
engines (``dist``, ``sharded``, ``hybrid``) on gloo ranks on the CPU, each
bitwise equal to the port's local run.

Ranks are processes started by ``repro_torch.launch.mesh.spawn``: two spawns
(2 and 4 ranks) per session, each running many cases and returning their
results (numpy) to this process, where the tests compare them with local
runs, and the W = 2 history with the reference's local history up to the
first in-band decision (``tests/test_torch_slice.py``). Cases:

  * a 1,201-person twin (so W = 2 and 4 pad the person axis), 15 days, the
    reference's four interventions (``tests/test_dist.py:IVS_SRC``), W = 2
    and 4, both backends: history and final state (the real people of the
    worker-padded state) bitwise;
  * test-trace-isolate with tracing on W = 2 and 4;
  * ``scenarios`` with S = 2 and 4 and ``hybrid`` 2 x 2 on a three-scenario
    ensemble (padded to the shards with inert scenarios): every column and
    every final state bitwise its local column;
  * ``api.run`` with engines ``dist``, ``sharded`` and ``hybrid`` (and a
    pinned ``dist`` with B > 1, which runs the scenarios one after another)
    against ``single`` / ``ensemble``: histories and observables bitwise;
  * checkpoints: ``api.run`` on ``dist`` chunked and resumed from a prefix,
    bitwise; a snapshot written on W = 2 resumed under ``local``, and one
    written under ``local`` resumed on W = 2 (``run_chunked`` with the same
    resume key: ``api.run``'s key names the mesh, as the reference's does);
  * the collective schedule per layout over 3 and 6 days (pinned per day);
  * the seeding and test-budget thresholds against the local sort and
    lexsort, on scores with ties;
  * the CLIs' ``--workers`` / ``--scenarios``: ranks spawned, rank 0's
    summaries printed once, equal to the one-device run's.

The reference is imported inside the tests that use it, so the ranks, which
import this module to find their functions, do not import JAX.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import observables as obs_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import disease, interventions as iv, transmission
from repro_torch.core import simulator as sim_lib
from repro_torch.data import digital_twin_population
from repro_torch.engine import core as core_lib
from repro_torch.engine.core import EngineCore, PERSON_STATE_FIELDS
from repro_torch.engine.topology import LocalTopology, MeshTopology
from repro_torch.launch import mesh as mesh_lib

DAYS, TAU = 15, 2e-5
PEOPLE = 1201  # W = 2 and 4 pad the person axis (to 1,202 and 1,204)
BACKENDS = ("pallas-compact", "pallas")
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(sim_lib.SimState))
CK_EVERY, CK_PREFIX = 5, 10
SPAWN = dict(backend="gloo", device="cpu", threads=1, timeout_s=60.0, wall_s=600.0)


def _ivs():
    """tests/test_dist.py:IVS_SRC: every action kind, both trigger families."""
    return [
        iv.Intervention("vax", iv.DayRange(3), iv.RandomFraction(0.3, salt=9), iv.Vaccinate(0.8)),
        iv.Intervention("schools", iv.CaseThreshold(on=30, off=10), iv.LocTypeIs(2),
                        iv.CloseLocations()),
        iv.Intervention("masks", iv.CaseThreshold(on=60), iv.Everyone(),
                        iv.ScaleInfectivity(0.5)),
        iv.Intervention("iso", iv.DayRange(5, 9), iv.RandomFraction(0.2, salt=4), iv.Isolate()),
    ]


CASES = {  # name -> EngineCore.single keywords
    "ivs": lambda: dict(interventions=_ivs(), seed=3),
    "tti": lambda: dict(interventions=[iv.TestTraceIsolate(
        "tti", tests_per_day=15, start_day=3, isolation_days=6, trace=True,
        trace_isolation_days=9)], iv_enabled=[True], seed=7, seed_per_day=4),
}


def _single(pop, case, backend, **kw):
    return EngineCore.single(pop, disease.covid_model(), transmission.TransmissionModel(tau=TAU),
                             device="cpu", backend=backend, **CASES[case](), **kw)


def _ensemble(preset):
    """Three replicates of ``preset`` (not a multiple of 2 or 4 shards: pad
    slots run too)."""
    return api.ExperimentSpec(dataset="twin-2k", tau=TAU, interventions=(preset,),
                              replicates=3).build_batch()


def _spec(**kw):
    """A three-replicate twin study (``kw`` through ``with_overrides``)."""
    return api.ExperimentSpec(dataset="twin-2k", days=DAYS, tau=TAU,
                              replicates=3).with_overrides(**kw)


def _np(state):
    return {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}


def _result(r):
    """What the tests compare of a RunResult (its wall times vary)."""
    keep = ("engine", "layout", "dist_backend", "num_devices", "observables_in_scan",
            "chunks", "resumed_from_day")
    return {"history": r.history, "observables": r.observables,
            "provenance": {k: r.provenance[k] for k in keep}}


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def _counts(core, days):
    """Collectives per day by kind over ``days`` days of ``core.run_days``."""
    core.topo.reset_counts()
    core.run_days(days)
    return {k: v / days for k, v in core.topo.counts.items()}


def _thresholds(mesh, seed):
    """The mesh's seeding and test-budget thresholds on random scores with
    ties, for 3 scenarios of 37 people (pads at 2.0 / 4.0 as in the day)."""
    rs = np.random.default_rng(seed)
    W, P, B = mesh.workers, 37, 3
    Pw = -(-P // W)
    u = np.full((B, W * Pw), 2.0, np.float32)
    u[:, :P] = np.round(rs.random((B, P)), 1)  # ties
    score = np.full((B, W * Pw), 4.0, np.float32)
    score[:, :P] = np.where(rs.random((B, P)) < 0.5, np.round(rs.random((B, P)), 1) + 2.0, 4.0)
    spd = torch.tensor([1, 5, 40])
    k = torch.tensor([3, 10, 60])
    topo = MeshTopology(mesh, seed_topk=min(40, Pw), test_topk=min(60, Pw))
    w = mesh.worker_index
    sl = slice(w * Pw, (w + 1) * Pw)
    gpid = topo.gpid(Pw, "cpu")
    seed_t = topo.seed_threshold(torch.as_tensor(u[:, sl]), spd, P)
    T, G = topo.rank_threshold(torch.as_tensor(score[:, sl]), gpid, k, P)
    return dict(u=u[:, :P], score=score[:, :P], spd=spd, k=k, seed=seed_t, T=T, G=G)


def _engine_cases(pop, layout, W, backends, cases, **kw):
    out = {}
    for backend in backends:
        for case in cases:
            core = _single(pop, case, backend, layout=layout, **kw)
            f, h = core.run1(DAYS)
            out[(layout, W, case, backend)] = (_np(f), h, core.plan_build_s)
    return out


def _ensemble_cases(pop, layout, tag, preset="none", backend="pallas-compact", **kw):
    core = EngineCore(pop, _ensemble(preset), device="cpu", backend=backend, layout=layout,
                      **kw)
    f, h = core.run(DAYS)
    return {(layout, tag): (_np(f), h)}


def _two_ranks(pop, ck_root):
    """Everything the 2-rank mesh runs (the ``workers`` layout W = 2, the
    ``scenarios`` layout S = 2, engines ``dist`` and ``sharded``)."""
    out = _engine_cases(pop, "workers", 2, BACKENDS, ("ivs", "tti"))
    out.update(_ensemble_cases(pop, "scenarios", 2))
    out.update(_ensemble_cases(pop, "scenarios", "2/tti", preset="tti", backend="pallas"))
    # the collective schedule: per day, fixed, whatever the day count
    mesh_w = mesh_lib.make_worker_mesh(2)
    for case in ("ivs", "tti"):
        core = _single(pop, case, "pallas-compact", layout="workers", mesh=mesh_w)
        out[("counts", "workers", case)] = [_counts(core, d) for d in (3, 6)]
    core = EngineCore(pop, _ensemble("none"), device="cpu", layout="scenarios")
    out[("counts", "scenarios")] = [_counts(core, d) for d in (3, 6)]
    out[("thresholds", 2)] = _thresholds(mesh_w, 0)
    # the engines
    for engine, kw in (("dist", dict(replicates=1, workers=2)),
                       ("sharded", dict(scenarios=2)),
                       ("dist-seq", dict(engine="dist", workers=2))):
        out[("api", engine)] = _result(api.run(_spec(**kw), population=pop, device="cpu"))
    # checkpoints: a chunked dist study, then a prefix resumed
    ck = dict(replicates=1, workers=2, ckpt_every=CK_EVERY)
    out[("api", "dist-chunked")] = _result(api.run(
        _spec(ckpt_dir=os.path.join(ck_root, "dist"), **ck), population=pop, device="cpu"))
    pre = os.path.join(ck_root, "prefix")
    api.run(_spec(days=CK_PREFIX, ckpt_dir=pre, **ck), population=pop, device="cpu")
    out[("api", "dist-resumed")] = _result(api.run(_spec(ckpt_dir=pre, **ck), population=pop,
                                                   device="cpu"))
    # across layouts: a W = 2 snapshot at day CK_PREFIX for local to resume,
    # and the local snapshot (written before the spawn) resumed on W = 2
    obs = obs_lib.make_observables(("attack_rate",))
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=1, device="cpu")
    key = {"cross": "layouts"}
    driver = core_lib.CoreDriver(_single(pop, "ivs", "pallas-compact", layout="workers",
                                         mesh=mesh_w), obs)
    core_lib.run_chunked(driver, CK_PREFIX, obs, ctx, every=CK_EVERY, resume_key=key,
                         manager=CheckpointManager(os.path.join(ck_root, "from-mesh")))
    out[("resumed-on-mesh",)] = _resume_on_mesh(pop, ck_root, mesh_w)
    return out


def _resume_on_mesh(pop, ck_root, mesh):
    """The local snapshot of day CK_PREFIX (written before the spawn, a copy
    per mesh) resumed on ``mesh`` to DAYS."""
    obs = obs_lib.make_observables(("attack_rate",))
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=1, device="cpu")
    driver = core_lib.CoreDriver(_single(pop, "ivs", "pallas-compact", layout="workers",
                                         mesh=mesh), obs)
    st, h, *_, resumed, _ = core_lib.run_chunked(
        driver, DAYS, obs, ctx, every=CK_EVERY, resume_key={"cross": "layouts"},
        manager=CheckpointManager(os.path.join(ck_root, f"from-local-{mesh.workers}")))
    return _np(st), h, resumed


def _four_ranks(pop, ck_root):
    """Everything the 4-rank mesh runs (W = 4, S = 4, hybrid 2 x 2)."""
    out = _engine_cases(pop, "workers", 4, BACKENDS, ("ivs",))
    out[("resumed-on-mesh",)] = _resume_on_mesh(pop, ck_root, mesh_lib.make_worker_mesh(4))
    out.update(_engine_cases(pop, "workers", 4, ("pallas",), ("tti",)))
    out.update(_ensemble_cases(pop, "scenarios", 4))
    out.update(_ensemble_cases(pop, "hybrid", "2x2", workers=2, scen_shards=2))
    out.update(_ensemble_cases(pop, "hybrid", "2x2/tti", preset="tti", backend="pallas",
                               workers=2, scen_shards=2))
    hybrid = mesh_lib.make_hybrid_mesh(2, 2)
    core = EngineCore(pop, _ensemble("none"), device="cpu", layout="hybrid", mesh=hybrid)
    out[("counts", "hybrid")] = [_counts(core, d) for d in (3, 6)]
    out[("thresholds", 4)] = _thresholds(mesh_lib.make_worker_mesh(4), 1)
    for engine, kw in (("hybrid", dict(workers=2, scenarios=2)), ("sharded-4", dict(scenarios=4))):
        out[("api", engine)] = _result(api.run(_spec(**kw), population=pop, device="cpu"))
    return out


# ---------------------------------------------------------------------------
# fixtures: local references and the two spawns
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pop():
    pop = digital_twin_population(PEOPLE, seed=1, name="twin-1201")
    assert pop.num_people == PEOPLE
    return pop


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the CPU at once, and torch's thread pools oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ck_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh-ckpt"))


@pytest.fixture(scope="module")
def local(pop, ck_root):
    """The local runs every mesh case is held to, and the local snapshot at
    day CK_PREFIX that the 2-rank mesh resumes."""
    out = {}
    for case in CASES:
        for backend in BACKENDS:
            f, h = _single(pop, case, backend).run1(DAYS)
            out[(case, backend)] = (_np(f), h)
    for preset, backend in (("none", "pallas-compact"), ("tti", "pallas")):
        f, h = EngineCore(pop, _ensemble(preset), device="cpu", backend=backend).run(DAYS)
        out[("ensemble", preset)] = (_np(f), h)
    for engine, kw in (("single", dict(replicates=1)), ("ensemble", {})):
        out[("api", engine)] = _result(api.run(_spec(**kw), population=pop, device="cpu"))
    obs = obs_lib.make_observables(("attack_rate",))
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=1, device="cpu")
    driver = core_lib.CoreDriver(_single(pop, "ivs", "pallas-compact"), obs)
    snap = os.path.join(ck_root, "from-local")
    core_lib.run_chunked(driver, CK_PREFIX, obs, ctx, every=CK_EVERY,
                         resume_key={"cross": "layouts"}, manager=CheckpointManager(snap))
    for W in (2, 4):  # each mesh resumes (and writes on) its own copy
        shutil.copytree(snap, f"{snap}-{W}")
    return out


@pytest.fixture(scope="module")
def two(pop, local, ck_root, tmp_path_factory):
    del local  # its snapshot must exist before the ranks start
    init = str(tmp_path_factory.mktemp("pg2"))
    res = mesh_lib.spawn(_two_ranks, 2, init_dir=init, args=(pop, ck_root), **SPAWN)
    return res


@pytest.fixture(scope="module")
def four(pop, local, ck_root, tmp_path_factory):
    del local  # its snapshot must exist before the ranks start
    init = str(tmp_path_factory.mktemp("pg4"))
    return mesh_lib.spawn(_four_ranks, 4, init_dir=init, args=(pop, ck_root), **SPAWN)


def _same_state(real: dict, padded: dict, num_people: int, what: str):
    for f in STATE_FIELDS:
        got = padded[f][..., :num_people] if f in PERSON_STATE_FIELDS else padded[f]
        assert got.dtype == real[f].dtype and np.array_equal(got, real[f]), f"{what}: {f}"


def _same_hist(a: dict, b: dict, what: str):
    for k in sim_lib.STAT_KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: '{k}'")


def _same_tree(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same_tree(a[k], b[k], f"{what}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _all_ranks(res, key):
    """``key``'s result, checked the same on every rank."""
    first = res[0][key]
    for r in res[1:]:
        _same_tree({"x": r[key][1]} if isinstance(r[key], tuple) else r[key],
                   {"x": first[1]} if isinstance(first, tuple) else first, str(key))
    return first


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_two_workers_equal_local(pop, local, two, case, backend):
    f, h, build_s = _all_ranks(two, ("workers", 2, case, backend))
    real_f, real_h = local[(case, backend)]
    _same_hist(h, real_h, f"W=2 {case} {backend}")
    for r in two:  # every rank holds the whole final state
        _same_state(real_f, r[("workers", 2, case, backend)][0], pop.num_people,
                    f"W=2 {case} {backend}")
    assert build_s > 0.0
    if case == "tti":
        assert h["tests_used"].sum() > 0 and h["traced"].sum() > 0


@pytest.mark.parametrize("case,backend", [("ivs", "pallas-compact"), ("ivs", "pallas"),
                                          ("tti", "pallas")])
def test_four_workers_equal_local(pop, local, four, case, backend):
    f, h, _ = _all_ranks(four, ("workers", 4, case, backend))
    real_f, real_h = local[(case, backend)]
    _same_hist(h, real_h, f"W=4 {case} {backend}")
    _same_state(real_f, f, pop.num_people, f"W=4 {case} {backend}")


@pytest.mark.parametrize("spawned,key,preset", [
    ("two", ("scenarios", 2), "none"),
    ("two", ("scenarios", "2/tti"), "tti"),
    ("four", ("scenarios", 4), "none"),
    ("four", ("hybrid", "2x2"), "none"),
    ("four", ("hybrid", "2x2/tti"), "tti"),
], ids=["S=2", "S=2-tti-pallas", "S=4", "hybrid-2x2", "hybrid-2x2-tti-pallas"])
def test_scenario_shards_equal_local_columns(request, pop, local, spawned, key, preset):
    res = request.getfixturevalue(spawned)
    f, h = _all_ranks(res, key)
    real_f, real_h = local[("ensemble", preset)]
    assert h["cumulative"].shape == (DAYS, 3)  # pad slots never surface
    _same_hist(h, real_h, str(key))
    _same_state(real_f, f, pop.num_people, str(key))


@pytest.mark.parametrize("spawned,engine,against", [
    ("two", "dist", "single"), ("two", "sharded", "ensemble"),
    ("two", "dist-seq", "ensemble"), ("four", "hybrid", "ensemble"),
    ("four", "sharded-4", "ensemble")])
def test_api_mesh_engines_equal_local(request, local, spawned, engine, against):
    res = request.getfixturevalue(spawned)
    got, want = _all_ranks(res, ("api", engine)), local[("api", against)]
    _same_tree(got["history"], want["history"], f"{engine} history")
    _same_tree(got["observables"], want["observables"], f"{engine} observables")
    prov = got["provenance"]
    layout = {"dist": "workers", "dist-seq": "workers", "sharded": "scenarios",
              "sharded-4": "scenarios", "hybrid": "hybrid"}[engine]
    assert prov["layout"] == layout and prov["dist_backend"] == "gloo"
    assert prov["observables_in_scan"] == (engine != "dist-seq")
    assert prov["num_devices"] == (2 if spawned == "two" else 4)


def test_api_dist_chunked_and_resumed_equal_unchunked(local, two):
    want = local[("api", "single")]
    chunked = _all_ranks(two, ("api", "dist-chunked"))
    resumed = _all_ranks(two, ("api", "dist-resumed"))
    for got, what in ((chunked, "chunked"), (resumed, "resumed")):
        _same_tree(got["history"], want["history"], f"{what} history")
        _same_tree(got["observables"], want["observables"], f"{what} observables")
    assert chunked["provenance"]["chunks"] == DAYS // CK_EVERY
    assert resumed["provenance"]["resumed_from_day"] == CK_PREFIX


def test_mesh_snapshot_resumes_under_local(pop, local, two, ck_root):
    """W = 2 wrote day CK_PREFIX (rank 0 alone, the person axis padded to
    W * Pw); the local layout resumes it to DAYS, bitwise."""
    del two  # its snapshot
    mgr = CheckpointManager(os.path.join(ck_root, "from-mesh"))
    assert mgr.latest_valid_step() == CK_PREFIX
    obs = obs_lib.make_observables(("attack_rate",))
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=1, device="cpu")
    driver = core_lib.CoreDriver(_single(pop, "ivs", "pallas-compact"), obs)
    st, h, *_, resumed, _ = core_lib.run_chunked(driver, DAYS, obs, ctx, every=CK_EVERY,
                                                 resume_key={"cross": "layouts"}, manager=mgr)
    assert resumed == CK_PREFIX
    real_f, real_h = local[("ivs", "pallas-compact")]
    _same_hist({k: v[:, 0] for k, v in h.items()}, real_h, "resumed under local")
    _same_state(real_f, {f: v[0] for f, v in _np(st).items()}, pop.num_people,
                "resumed under local")


@pytest.mark.parametrize("spawned", ["two", "four"])
def test_local_snapshot_resumes_on_the_mesh(request, pop, local, spawned):
    """The local snapshot (person axis P) resumed on W = 2 and 4 (padded to
    W * Pw > P), bitwise."""
    st, h, resumed = _all_ranks(request.getfixturevalue(spawned), ("resumed-on-mesh",))
    assert resumed == CK_PREFIX
    assert st["health"].shape[-1] > pop.num_people
    real_f, real_h = local[("ivs", "pallas-compact")]
    _same_hist({k: v[:, 0] for k, v in h.items()}, real_h, f"resumed on {spawned} workers")
    _same_state(real_f, {f: v[0] for f, v in st.items()}, pop.num_people,
                f"resumed on {spawned} workers")


@pytest.mark.parametrize("spawned,key,per_day", [
    # The reference's workers day: all_to_all 2, all_gather 1, psum 5. The
    # port sums the day's statistics in one all_reduce (integer sums are
    # exact in any grouping), so it issues all_reduce 1.
    ("two", ("counts", "workers", "ivs"), {"all_to_all": 2, "all_gather": 1, "all_reduce": 1}),
    # one more all_gather for the test budget's candidates (score and gpid
    # travel together; the reference gathers them apart)
    ("two", ("counts", "workers", "tti"), {"all_to_all": 2, "all_gather": 2, "all_reduce": 1}),
    # the day's statistics of the whole batch, for the history and observables
    ("two", ("counts", "scenarios"), {"all_gather": 1}),
    ("four", ("counts", "hybrid"), {"all_to_all": 2, "all_gather": 2, "all_reduce": 1}),
], ids=["workers", "workers-tti", "scenarios", "hybrid"])
def test_collective_schedule_pinned_per_layout(request, spawned, key, per_day):
    for rank in request.getfixturevalue(spawned):
        three, six = rank[key]
        assert three == six == per_day, (key, three, six)


@pytest.mark.parametrize("spawned", ["two", "four"])
def test_thresholds_equal_local_sort_and_lexsort(request, spawned):
    topo = LocalTopology()
    for rank in request.getfixturevalue(spawned):
        t = rank[("thresholds", 2 if spawned == "two" else 4)]
        P = t["u"].shape[1]
        seed = topo.seed_threshold(torch.as_tensor(t["u"]), t["spd"], P)
        T, G = topo.rank_threshold(torch.as_tensor(t["score"]), torch.arange(P), t["k"], P)
        assert torch.equal(t["seed"], seed)
        assert torch.equal(t["T"], T) and torch.equal(t["G"], G)
        # the local pick is numpy's lexsort's
        for b in range(3):
            order = np.lexsort((np.arange(P), t["score"][b]))
            pick = order[min(int(t["k"][b]), P) - 1]
            assert (float(T[b]), int(G[b])) == (float(t["score"][b][pick]), pick)


def test_two_workers_match_the_reference_before_the_band(pop, two):
    """The port's local path is held to the reference (test_torch_slice.py)
    and the reference's mesh to its local run (tests/test_dist.py); so the
    port's W = 2 history equals the reference's local history on every day
    before the first in-band decision."""
    from repro.core import disease as j_disease
    from repro.core import transmission as j_tx
    from repro.core import interventions as j_iv
    from repro.data import digital_twin_population as j_twin
    from repro.engine import EngineCore as JCore
    from test_torch_slice import _stepped

    jivs = [
        j_iv.Intervention("vax", j_iv.DayRange(3), j_iv.RandomFraction(0.3, salt=9),
                          j_iv.Vaccinate(0.8)),
        j_iv.Intervention("schools", j_iv.CaseThreshold(on=30, off=10), j_iv.LocTypeIs(2),
                          j_iv.CloseLocations()),
        j_iv.Intervention("masks", j_iv.CaseThreshold(on=60), j_iv.Everyone(),
                          j_iv.ScaleInfectivity(0.5)),
        j_iv.Intervention("iso", j_iv.DayRange(5, 9), j_iv.RandomFraction(0.2, salt=4),
                          j_iv.Isolate()),
    ]
    jcore = JCore.single(j_twin(PEOPLE, seed=1, name="t"), j_disease.covid_model(),
                         j_tx.TransmissionModel(tau=TAU), interventions=jivs, seed=3,
                         backend="compact")
    _, jh = jcore.run1(DAYS)
    _, band_day = _stepped(_single(pop, "ivs", "pallas-compact"), DAYS)
    limit = DAYS if band_day is None else band_day
    _, h, _ = two[0][("workers", 2, "ivs", "pallas-compact")]
    print(f"W=2 against the reference: first in-band decision on day {band_day}")
    for k in sim_lib.STAT_KEYS:
        np.testing.assert_array_equal(h[k][:limit], np.asarray(jh[k][:limit], np.int64),
                                      err_msg=f"'{k}' before day {limit}")


@pytest.mark.parametrize("flags", [["--workers", "2"], ["--scenarios", "2", "--replicates", "3"]],
                         ids=["dist", "sharded"])
def test_cli_spawns_the_ranks_and_prints_once(capsys, flags):
    """``launch/simulate.py`` and ``launch/sweep.py`` with a mesh flag start
    the ranks (gloo, one process each) and print rank 0's result once, the
    same summaries as the one-device run."""
    from repro_torch.launch import simulate, sweep

    cli = simulate if flags[0] == "--workers" else sweep
    base = ["--dataset", "twin-2k", "--days", "6", "--device", "cpu", "--interventions", "none"]
    cli.main(base + flags)
    mesh_out = capsys.readouterr().out
    cli.main(base + flags[2:])
    local_out = capsys.readouterr().out
    rows = lambda out: [line for line in out.splitlines() if line.startswith(('{"scenario"', "| "))]
    assert rows(mesh_out) and rows(mesh_out) == rows(local_out)
    assert mesh_out.count("dataset=twin-2k") == 1
    assert ("engine=dist" if cli is simulate else "engine=sharded") in mesh_out
