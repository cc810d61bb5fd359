"""The port's study front door, ``repro_torch.api.run(spec)``, against the
reference's ``repro.api``.

* Specs: ``to_dict()`` equals the reference's for the same arguments, and a
  spec file (JSON or TOML) written for the reference loads in the port.
* Histories: the port's ``api.run`` (plain path on the CPU) against the
  reference's ``api.run`` on its ``compact`` backend, scenario by scenario,
  equal on every day before the scenario's first in-band decision
  (``test_torch_slice.py:_stepped``'s rule: ``exp`` and ``log`` differ by an
  ulp between torch and XLA), with final attack rates within 5 points.
* Observables: against numpy on the port's own history, at
  ``tests/test_api.py``'s tolerances; and, **inside the port**, in-loop
  against the post-run replay bitwise. No observable is held bitwise
  against the reference's (ROADMAP queue 3, item 2).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro import api as j_api
from repro_torch import api as t_api
from repro_torch.analysis.report import summarize_result
from repro_torch.api import observables as obs_lib
from repro_torch.configs import get_epidemic
from repro_torch.core import simulator
from repro_torch.engine.core import EngineCore
from repro_torch.launch import sweep
from repro_torch.runtime import ChaosSchedule

from test_torch_slice import _stepped

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "experiment.toml")


@pytest.fixture(scope="module")
def pop():
    return get_epidemic("twin-2k").build()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the CPU at once, and torch's thread pools oversubscribe the
    cores (the twin-2k shapes here gain little from more threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(lib, **kw):
    base = dict(dataset="twin-2k", days=8, tau=2e-5,
                interventions=("none", "school-closure"), replicates=1)
    base.update(kw)
    return lib.ExperimentSpec(**base).validate()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


SPEC_ARGS = [
    {},
    dict(tau_scales=(1.0, 0.8), replicates=2, backend="compact", seed=4,
         observables=("attack_rate", "sobol_first_order")),
    dict(interventions=("tti", "lockdown"), backend="pallas", static_network=True,
         mesh=dict(workers=2, scenarios=2), checkpoint=dict(directory="/tmp/x", every=25),
         resilience=dict(enabled=True, max_restarts=5), engine="hybrid", block_size=64),
]


def _build(lib, kw):
    kw = dict(kw)
    for field, cls in (("mesh", "MeshSpec"), ("checkpoint", "CheckpointSpec"),
                       ("resilience", "ResilienceSpec")):
        if field in kw:
            kw[field] = getattr(lib, cls)(**kw[field])
    return _spec(lib, **kw)


@pytest.mark.parametrize("kw", SPEC_ARGS, ids=["default", "sweep", "everything"])
def test_spec_dict_equals_the_reference(kw, tmp_path):
    j, t = _build(j_api, kw), _build(t_api, kw)
    assert t.to_dict() == j.to_dict()
    assert t.num_scenarios == j.num_scenarios
    path = str(tmp_path / "spec.json")
    j.save(path)  # written by the reference, read by the port
    assert t_api.ExperimentSpec.from_file(path) == t
    assert t_api.ExperimentSpec.from_json(t.to_json()) == t


def test_reference_toml_loads_unchanged():
    j = j_api.ExperimentSpec.from_file(EXAMPLE)
    t = t_api.ExperimentSpec.from_file(EXAMPLE)
    assert t.to_dict() == j.to_dict() and t.num_scenarios == 12
    over = t.with_overrides(days=None, workers=2, ckpt_dir="/tmp/y", backend="compact")
    assert over.to_dict() == j.with_overrides(days=None, workers=2, ckpt_dir="/tmp/y",
                                              backend="compact").to_dict()
    with pytest.raises(ValueError, match="unknown ExperimentSpec field"):
        t_api.ExperimentSpec.from_dict({"dataset": "twin-2k", "dayz": 3})
    for bad, match in ((dict(interventions=("no-such",)), "intervention preset"),
                       (dict(dataset="no-such"), "dataset"),
                       (dict(observables=("no-such",)), "observable"),
                       (dict(engine="no-such"), "engine"), (dict(backend="no-such"), "backend")):
        with pytest.raises(ValueError, match=match):
            _spec(t_api, **bad)


def test_run_matches_the_reference_run(pop):
    """B = 4 (none / vax-seniors x 2 replicates), 20 days: each scenario's
    history equals the reference's before its first in-band decision."""
    days = 20
    kw = dict(days=days, interventions=("none", "vax-seniors"), replicates=2)
    spec = _spec(t_api, **kw)
    t = t_api.run(spec, population=pop, device="cpu")
    j = j_api.run(_spec(j_api, backend="compact", **kw), population=pop)
    assert t.provenance["engine"] == "ensemble" and t.provenance["route"] == "pallas-compact"
    assert t.scenario_names == j.scenario_names
    compared = 0
    for i, scen in enumerate(spec.build_batch()):
        _, band_day = _stepped(EngineCore(pop, [scen], device="cpu"), days)
        limit = days if band_day is None else band_day
        compared += limit
        for k in simulator.STAT_KEYS:
            np.testing.assert_array_equal(
                t.history[k][:limit, i], np.asarray(j.history[k][:limit, i], np.int64),
                err_msg=f"{scen.name} '{k}' before day {limit}")
        ar = [100.0 * r.history["cumulative"][-1, i] / pop.num_people for r in (t, j)]
        assert abs(ar[0] - ar[1]) <= 5.0, (scen.name, ar)
    print(f"compared {compared} scenario-days of {4 * days}")
    assert compared >= days  # the band leaves something to compare


def test_observables_match_numpy(pop):
    """tests/test_api.py's checks and tolerances, on the port's own history."""
    spec = _spec(t_api, replicates=3, interventions=("none",))
    r = t_api.run(spec, population=pop, device="cpu")
    assert r.provenance["observables_in_scan"] is True
    hist, B = r.history, r.num_scenarios
    np.testing.assert_array_equal(r.observables["attack_rate"]["cumulative"],
                                  hist["cumulative"][-1])
    np.testing.assert_allclose(r.observables["attack_rate"]["attack_rate"],
                               hist["cumulative"][-1].astype(np.float32) / pop.num_people,
                               rtol=1e-6)
    np.testing.assert_array_equal(r.observables["peak_day"]["peak_day"],
                                  np.argmax(hist["infectious"], axis=0))
    np.testing.assert_array_equal(r.observables["peak_day"]["peak_infectious"],
                                  hist["infectious"].max(axis=0))
    np.testing.assert_array_equal(r.observables["daily_new_infections"]["daily"],
                                  hist["new_infections"])
    np.testing.assert_array_equal(r.observables["teps"]["daily"], hist["contacts"])
    assert int(r.observables["teps"]["edges_total"]) == int(hist["contacts"].sum())
    x = hist["new_infections"].astype(np.float32)
    m = x.mean(axis=1)
    sem = x.std(axis=1, ddof=1) / np.sqrt(B)
    band = r.observables["ensemble_mean_ci"]["new_infections"]
    np.testing.assert_allclose(band["mean"], m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(band["lo"], m - 1.96 * sem, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(band["hi"], m + 1.96 * sem, rtol=1e-5, atol=1e-4)


def test_in_loop_observables_equal_the_replay_bitwise(pop):
    """Inside the port: the in-loop observables equal observe_history's
    replay bitwise, and a pinned single engine (one scenario at a time,
    observables replayed) equals the ensemble bitwise, history and all."""
    names = tuple(obs_lib.OBSERVABLES)
    spec = _spec(t_api, interventions=("none", "tti"), replicates=2, days=10,
                 observables=names)
    r = t_api.run(spec, population=pop, device="cpu")
    obs = obs_lib.make_observables(names)
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=4,
                             sweep_axes=(("interventions", (0, 0, 1, 1)),
                                         ("replicates", (0, 1, 0, 1))), device="cpu")
    replay = obs_lib.observables_to_numpy(obs_lib.observe_history(obs, r.history, ctx))
    seq = t_api.run(spec.with_overrides(engine="single"), population=pop, device="cpu")
    assert seq.provenance["observables_in_scan"] is False
    for k in simulator.STAT_KEYS:
        np.testing.assert_array_equal(seq.history[k], r.history[k], err_msg=k)
    for name in names:
        for other in (replay, seq.observables):
            got, want = _leaves(other[name]), _leaves(r.observables[name])
            assert len(got) == len(want) > 0, name
            for a, b in zip(want, got):
                assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), name
    assert r.observables["tests_used"]["tests_total"].sum() > 0


def test_sobol_first_order_matches_numpy(pop):
    spec = _spec(t_api, interventions=("none", "school-closure"), tau_scales=(1.0, 0.7),
                 replicates=2, days=10, observables=("attack_rate", "sobol_first_order"))
    r = t_api.run(spec, population=pop, device="cpu")
    y = r.history["cumulative"][-1].astype(np.float32)
    B = y.shape[0]
    assert B == 8
    mu, var = y.mean(), y.var()
    idx = np.arange(B)
    levels = {"interventions": idx // 4, "tau_scales": (idx // 2) % 2, "replicates": idx % 2}
    got = r.observables["sobol_first_order"]
    np.testing.assert_allclose(got["variance"], var, rtol=1e-5)
    for axis, g in levels.items():
        gmeans = np.array([y[g == lv].mean() for lv in range(2)])
        cnts = np.array([(g == lv).sum() for lv in range(2)], np.float32)
        s1_ref = float((cnts * (gmeans - mu) ** 2).sum() / B / var)
        np.testing.assert_allclose(got["S1"][axis], s1_ref, rtol=1e-4, err_msg=axis)


def test_unported_engines_and_policies_raise(pop, tmp_path):
    """The mesh engines raise outside a process group of the mesh's size,
    naming how to start the ranks (they run on gloo ranks in
    test_torch_dist.py); checkpoints, the resilient loop and chaos= run,
    equal to the plain run."""
    two = _spec(t_api, replicates=2)
    for kw in (dict(engine="dist"), dict(engine="hybrid"), dict(scenarios=2),
               dict(workers=2)):
        with pytest.raises(RuntimeError, match="launch.mesh.spawn or torchrun"):
            t_api.run(two.with_overrides(**kw), population=pop, device="cpu")
    plain = t_api.run(two, population=pop, device="cpu")
    for i, (kw, chaos) in enumerate(((dict(ckpt_every=3), None),
                                     (dict(ckpt_every=3, resilient=True), None),
                                     (dict(), ChaosSchedule(())))):
        r = t_api.run(two.with_overrides(ckpt_dir=str(tmp_path / str(i)), **kw),
                      population=pop, device="cpu", chaos=chaos)
        assert r.provenance["chunk_days"] == kw.get("ckpt_every", 50)
        assert ("resilience" in r.provenance) == (i > 0)
        for k in plain.history:
            np.testing.assert_array_equal(r.history[k], plain.history[k], err_msg=k)
    with pytest.raises(ValueError, match="resilient"):
        t_api.run(two, population=pop, device="cpu", chaos=ChaosSchedule(()))
    if not torch.cuda.is_available():  # the card by default, never a silent CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_api.run(two, population=pop)


def test_run_result_json_roundtrip_and_report(pop, tmp_path):
    r = t_api.run(_spec(t_api, days=5), population=pop, device="cpu")
    assert r.history["cumulative"].shape == (5, 2)
    prov = r.provenance
    assert set(prov) >= {"engine", "layout", "topology", "num_people", "mesh", "num_devices",
                         "jax_backend", "wall_s", "run_wall_s", "chunks", "chunk_days",
                         "resumed_from_day", "observables_in_scan", "core"}
    assert prov["num_devices"] == 1 and prov["jax_backend"] == "cpu"
    path = str(tmp_path / "result.json")
    r.save(path)
    back = t_api.RunResult.load(path)
    assert back.spec == r.spec and back.scenario_names == r.scenario_names
    np.testing.assert_array_equal(back.history["cumulative"], r.history["cumulative"])
    assert summarize_result(back) == r.summaries
    back.observables = {}
    assert summarize_result(back) == r.summaries
    one = t_api.run(_spec(t_api, interventions=("none",), days=4), population=pop,
                    device="cpu")
    assert one.provenance["engine"] == "single"
    assert one.history["cumulative"].shape == (4, 1)


def test_sweep_cli_and_run_file(capsys):
    sweep.main(["--dataset", "twin-2k", "--days", "6", "--interventions", "none,lockdown",
                "--replicates", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("dataset=twin-2k engine=ensemble scenarios=4 days=6")
    assert json.loads(out[-1])["scenarios"] == 4
    r = t_api.run_file(EXAMPLE, days=3, replicates=1, tau_scales=(1.0,), device="cpu")
    assert r.spec.days == 3 and r.num_scenarios == 3
    assert r.history["cumulative"].shape == (3, 3)
