"""Serving on a mesh, and the reference's pure distributed day, on gloo ranks
on the CPU.

One spawn of two ranks (``repro_torch.launch.mesh.spawn``) runs, in order:

  * ``dist_run_scan`` on a W = 2 worker mesh (``core/simulator_dist.py``'s
    views over ``MeshTopology``), against ``EngineCore``'s ``workers``
    layout of the same scenario;
  * a :class:`~repro_torch.serve.SimulationServer` on each of the layouts
    ``workers`` (W = 2) and ``scenarios`` (S = 2): every rank constructs
    it, rank 0 warms two buckets (untraced ``pallas-compact``, traced
    ``pallas`` under test-trace-isolate) and serves four requests of 1-3
    scenarios and 7-14 days from two client threads, while rank 1
    follows; then every request again through ``api.run`` on the same
    mesh (a B = 1 request on the scenario mesh runs ``single``: one
    scenario cannot be split over scenario shards).

The parent holds every served result bitwise to its solo run on the mesh
and to its local ``api.run`` (history and observables), the ranks'
dispatch logs equal, and no build after the warm-ups (no runner build, and
no plan, per-rank tables or process group). A rank that hangs fails the
spawn at its wall limit; a collective that hangs fails at the group's
timeout. The hybrid layout (four ranks) runs on the card only
(``chip_smoke.py`` phase 4g (e)).
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.launch import mesh as mesh_lib

SPAWN = dict(backend="gloo", device="cpu", threads=1, timeout_s=60.0, wall_s=600.0)
TAU = 2e-5
CHUNK = 5
LAYOUTS = {"workers": dict(workers=2), "scenarios": dict(scen_shards=2)}
DIST_DAYS = 12


def _requests():
    """Two buckets (by interventions and backend), each with requests of
    two chunk counts; between them the untraced and traced passes."""
    base = dict(dataset="twin-2k", tau=TAU)
    rows = ((12, ("none",), "pallas-compact", 1, 0), (9, ("none",), "pallas-compact", 2, 5),
            (7, ("tti",), "pallas", 1, 7), (14, ("tti",), "pallas", 3, 2))
    return [api.ExperimentSpec(name=f"r{i}", days=d, interventions=iv, backend=b,
                               replicates=r, seed=s, **base)
            for i, (d, iv, b, r, s) in enumerate(rows)]


def _on_mesh(spec, layout: str):
    """``spec`` for ``api.run`` on the same mesh as the ``layout`` server."""
    if layout == "workers":
        return spec.with_overrides(workers=2)
    return spec.with_overrides(scenarios=2) if spec.num_scenarios > 1 else spec


def _kept(r):
    return {"history": r.history, "observables": r.observables,
            "summaries": r.summaries}


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def _dist_scan():
    """dist_run_scan on W = 2 against the engine's workers layout."""
    import torch.distributed as dist

    from repro_torch.core import disease, interventions as iv, transmission
    from repro_torch.core import simulator_dist as sd
    from repro_torch.data import digital_twin_population
    from repro_torch.engine import EngineCore
    from repro_torch.engine.core import index_params

    pop = digital_twin_population(1201, seed=1, name="twin-1201")  # W = 2 pads the people
    ivs = [iv.Intervention("masks", iv.CaseThreshold(on=60), iv.Everyone(),
                           iv.ScaleInfectivity(0.5)),
           iv.Intervention("iso", iv.DayRange(5, 9), iv.RandomFraction(0.2, salt=4),
                           iv.Isolate())]
    mesh = mesh_lib.make_worker_mesh(2)
    out = {}
    for backend in ("pallas-compact", "pallas"):
        core = EngineCore.single(pop, disease.covid_model(), transmission.TransmissionModel(tau=TAU),
                                 interventions=ivs, seed=3, device="cpu", backend=backend,
                                 layout="workers", mesh=mesh)
        final, hist = core.run1(DIST_DAYS)
        plan, w = core.plan, mesh.worker_index
        static = sd.make_dist_static(plan, pop.num_locations, core.iv_slots, backend=backend)
        state = sd.local_shard(sd.dist_init_state(disease.covid_model(), plan, len(core.iv_slots),
                                                  device="cpu"), plan, w)
        params = index_params(core.params, 0)  # this rank's shard
        fs, hs = sd.dist_run_scan(static, mesh, core.week, params, state, DIST_DAYS)
        gathered = {f: torch.cat(_gather(getattr(fs, f), mesh)) for f in ("health", "dwell")}
        out[backend] = dict(
            hist={k: v.numpy() for k, v in hs.items()}, engine_hist=hist,
            final={f: gathered[f][:pop.num_people].numpy() for f in gathered},
            engine_final={f: getattr(final, f)[:pop.num_people].numpy()
                          for f in ("health", "dwell")},
            cumulative=(int(fs.cumulative), int(final.cumulative)))
    dist.barrier()
    return out


def _gather(x, mesh):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(mesh.workers)]
    dist.all_gather(parts, x.contiguous(), group=mesh.worker_group)
    return parts


def _serve(layout: str):
    """One mesh server: warm-ups, four requests from two clients on rank 0
    (rank 1 follows), the close, then every request solo on the mesh."""
    import torch.distributed as dist

    from repro_torch.serve import ServeConfig, SimulationServer

    specs = _requests()
    server = SimulationServer(ServeConfig(layout=layout, chunk_days=CHUNK, b_lattice=(4,),
                                          **LAYOUTS[layout]), device="cpu")
    out = {"rank": dist.get_rank()}
    if server.rank == 0:
        for spec in (specs[0], specs[2]):
            assert not server.warm_up(spec)["already_warm"]
        out["builds_warm"] = dict(server.mesh_builds)
        results = [None] * len(specs)

        def client(k):
            for i in range(k, len(specs), 2):
                results[i] = server.submit(specs[i]).result(timeout=300)

        with server:
            threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
        server.close()
        out["served"] = [_kept(r) for r in results]
        out["warm"] = [r.served_from["warm"] for r in results]
        out["provenance"] = results[0].provenance
    else:
        out["followed"] = server.follow()
    assert not server.follow_errors, server.follow_errors
    out["builds"] = dict(server.mesh_builds)
    out["executables"] = server.metrics_dict()["executables"]
    out["log"] = server.dispatch_log
    out["solo"] = [_kept(api.run(_on_mesh(s, layout), device="cpu")) for s in specs]
    return out


def _ranks():
    return {"dist": _dist_scan(), **{layout: _serve(layout) for layout in LAYOUTS}}


# ---------------------------------------------------------------------------
# fixtures and tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return mesh_lib.spawn(_ranks, 2, init_dir=str(tmp_path_factory.mktemp("pg")), **SPAWN)


@pytest.fixture(scope="module")
def local():
    return [_kept(api.run(s, device="cpu")) for s in _requests()]


def _same(a: dict, b: dict, what: str):
    for k in b["history"]:
        np.testing.assert_array_equal(a["history"][k], b["history"][k],
                                      err_msg=f"{what}: history '{k}'")
    for name, obs in b["observables"].items():
        for k, v in obs.items():
            w = a["observables"][name][k]
            if isinstance(v, dict):
                for x in v:
                    np.testing.assert_array_equal(w[x], v[x], err_msg=f"{what}: {name}.{k}")
            else:
                np.testing.assert_array_equal(np.asarray(w), np.asarray(v),
                                              err_msg=f"{what}: {name}.{k}")
    assert a["summaries"] == b["summaries"], what


@pytest.mark.parametrize("backend", ["pallas-compact", "pallas"])
def test_dist_run_scan_equals_the_workers_layout(ranks, backend):
    for rank, res in enumerate(ranks):
        r = res["dist"][backend]
        for k, v in r["engine_hist"].items():
            np.testing.assert_array_equal(r["hist"][k], v, err_msg=f"rank {rank} '{k}'")
        for f, v in r["engine_final"].items():
            np.testing.assert_array_equal(r["final"][f], v, err_msg=f"rank {rank} '{f}'")
        assert r["cumulative"][0] == r["cumulative"][1] > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_served_equals_solo_on_the_mesh_and_local(ranks, local, layout):
    res = ranks[0][layout]
    assert all(res["warm"])
    prov = res["provenance"]
    assert prov["engine"] == f"serve[{layout}]" and prov["layout"] == layout
    assert prov["num_devices"] == 2 and prov["dist_backend"] == "gloo"
    assert prov["mesh"] == ({"workers": 2, "scenarios": 1} if layout == "workers"
                            else {"workers": 1, "scenarios": 2})
    for i, (served, solo, loc) in enumerate(zip(res["served"], res["solo"], local)):
        _same(served, solo, f"{layout} request {i} against its solo run on the mesh")
        _same(served, loc, f"{layout} request {i} against its local run")
    for rank_res in ranks:  # every rank's solo run is the same
        for a, b in zip(rank_res[layout]["solo"], res["solo"]):
            _same(a, b, f"{layout} solo runs across ranks")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_logged_the_same_dispatches(ranks, layout):
    logs = [r[layout]["log"] for r in ranks]
    assert logs[0] == logs[1]
    assert [e[0] for e in logs[0]].count("warm") == 2
    assert [e[0] for e in logs[0]].count("dispatch") == ranks[1][layout]["followed"] - 2 >= 3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero_builds_after_warm_up(ranks, layout):
    leader = ranks[0][layout]
    assert leader["builds"] == leader["builds_warm"]
    # one plan and one set of per-rank tables (or local week), shared by both
    # buckets of the dataset
    want = {"groups": 1, "tables": 1, **({"plan": 1} if layout == "workers" else {})}
    for r in ranks:
        assert r[layout]["builds"] == want
        ex = r[layout]["executables"]
        assert ex["recompile_violations"] == 0 and ex["cold_compiles"] == 2
        assert ex["mesh_builds"] == want
