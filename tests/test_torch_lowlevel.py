"""The reference's lower-level epidemic entry points in the port, on the CPU.

Mirrors ``tests/test_{simulator,disease,interventions,contact}.py`` on
twin-2k against ``repro``, whose interaction pass runs on its ``compact``
backend (its own tests hold it bitwise to ``pallas-compact``, and it is far
faster than Pallas interpret mode). The tolerance classes are the
ROADMAP's (test_torch_day.py): masks, integers and the counter RNG's
decisions are exact; the exposure ``A`` is held to rtol 1e-5 (f32 sum
order); infection decisions agree wherever ``|u - exp(-A)| > 2**-20``;
dwell draws go through ``log`` and are held to rtol 1e-6; histories are
equal up to the first in-band decision (test_torch_slice.py:_stepped).

Inside the port the views are bitwise: ``run_eager``, ``run_scan`` and
``day_step`` equal ``EngineCore.run1`` on both backends. The
``dist_*_specs`` trees equal the reference's ``PartitionSpec`` trees entry
for entry. ``dist_day_step`` on a mesh: tests/test_torch_serve_mesh.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.analysis import report as j_report
from repro.configs.presets import INTERVENTION_PRESETS as J_PRESETS
from repro.core import contact as j_contact
from repro.core import disease as j_disease
from repro.core import interventions as j_iv
from repro.core import simulator as j_sim
from repro.core import simulator_dist as j_sd
from repro.core import transmission as j_tx
from repro.data import digital_twin_population as j_twin
from repro.engine import EngineCore as JCore
from repro.engine import core as j_engine
from repro_torch import api as t_api
from repro_torch.analysis import report as t_report
from repro_torch.configs.presets import INTERVENTION_PRESETS as T_PRESETS
from repro_torch.core import contact as t_contact
from repro_torch.core import disease as t_disease
from repro_torch.core import interventions as t_iv
from repro_torch.core import rng as t_rng
from repro_torch.core import simulator as t_sim
from repro_torch.core import simulator_dist as t_sd
from repro_torch.core import transmission as t_tx
from repro_torch.data import digital_twin_population as t_twin
from repro_torch.engine import EngineCore as TCore
from repro_torch.engine import core as t_engine
from repro_torch.engine.core import stack_params

from test_torch_slice import _stepped

TAU, SEED, WARM_DAYS, DAYS = 2e-5, 3, 16, 12
BAND = 2.0**-20
STATE_FIELDS = ("health", "dwell", "cumulative", "iv_active", "vaccinated", "tested",
                "traced", "isolated_until")


@pytest.fixture(scope="module")
def pops():
    return j_twin(2000, seed=0, name="twin-2k"), t_twin(2000, seed=0, name="twin-2k")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs several
    workers on the CPU at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return dataclasses.asdict(jax.device_get(tree))


def _cores(pops, preset, seed=SEED, backend="pallas-compact"):
    jpop, tpop = pops
    jcore = JCore.single(jpop, j_disease.covid_model(), j_tx.TransmissionModel(tau=TAU),
                         interventions=J_PRESETS[preset], seed=seed, backend="compact")
    tcore = TCore.single(tpop, t_disease.covid_model(), t_tx.TransmissionModel(tau=TAU),
                         interventions=T_PRESETS[preset], seed=seed, device="cpu",
                         backend=backend)
    return jcore, tcore


def _in_band(params, state, A_ref, A_port):
    """People whose infection decision lies in the exp band for either A."""
    u = t_rng.uniform(params.seed, t_rng.INFECT, state.day,
                      torch.arange(state.health.shape[0])).numpy().astype(np.float64)
    sus = params.sus_table[state.health.long()].numpy() > 0
    near = lambda A: np.abs(u - np.exp(-np.asarray(A, np.float64))) <= BAND
    return sus & ((A_ref > 0) | (A_port > 0)) & (near(A_ref) | near(A_port))


# ---------------------------------------------------------------------------
# transmission, contact
# ---------------------------------------------------------------------------


def test_pair_propensity_and_infection_probability():
    rs = np.random.default_rng(0)
    overlap, sus, inf = (rs.uniform(0, 3600, 4096).astype(np.float32),
                         rs.uniform(0, 2, 4096).astype(np.float32),
                         rs.uniform(0, 2, 4096).astype(np.float32))
    for tm in (t_tx.TransmissionModel(), t_tx.TransmissionModel(tau=2e-5, time_unit=60.0)):
        jtm = j_tx.TransmissionModel(tau=tm.tau, time_unit=tm.time_unit)
        want = np.asarray(j_tx.pair_propensity(jtm, overlap, sus, inf))
        got = t_tx.pair_propensity(tm, *map(torch.as_tensor, (overlap, sus, inf)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    A = rs.exponential(0.5, 4096).astype(np.float32)
    A[:64] = 0.0
    got = t_tx.infection_probability(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_tx.infection_probability(A)),
                               rtol=1e-6, atol=1e-7)
    assert (got[:64] == 0.0).all()


@pytest.mark.parametrize("trial", range(3))
def test_max_occupancy_oracle_matches_reference_and_fast(trial):
    rs = np.random.default_rng(trial)
    L, V = 20, 300
    loc = rs.integers(0, L, V)
    start = np.round(rs.uniform(0, 100, V)).astype(np.float32)  # ties
    end = (start + np.round(rs.uniform(1, 50, V))).astype(np.float32)
    slow = t_contact.max_occupancy_from_visits(L, loc, start, end)
    np.testing.assert_array_equal(slow, j_contact.max_occupancy_from_visits(L, loc, start, end))
    np.testing.assert_array_equal(slow, t_contact.max_occupancy_fast(L, loc, start, end))
    touching = t_contact.max_occupancy_from_visits(
        1, np.array([0, 0]), np.array([0.0, 10.0], np.float32),
        np.array([10.0, 20.0], np.float32))
    assert touching[0] == 1


# ---------------------------------------------------------------------------
# disease
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["covid", "sir", "seir"])
@pytest.mark.parametrize("k", [10, 50])
def test_seed_infections_matches_reference(name, k):
    tm, jm = (getattr(lib, f"{name}_model")() for lib in (t_disease, j_disease))
    state, dwell = t_disease.initial_health(tm, 500, device="cpu")
    jstate, jdwell = j_disease.initial_health(jm, 500)
    got_h, got_d = t_disease.seed_infections(tm, state, dwell, k, 1, 0)
    want_h, want_d = j_disease.seed_infections(jm, jstate, jdwell, k, 1, 0)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert int((got_h == tm.entry_state).sum()) == k
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=0)
    nobody, _ = t_disease.seed_infections(tm, state, dwell, 0, 1, 0)
    assert torch.equal(nobody, state)


def test_update_health_matches_reference():
    tm, jm = t_disease.covid_model(), j_disease.covid_model()
    rs = np.random.default_rng(1)
    P = 4000
    health = rs.integers(0, tm.num_states, P).astype(np.int32)
    dwell = np.where(rs.random(P) < 0.5, 0.5, rs.uniform(1.5, 9, P)).astype(np.float32)
    new = rs.random(P) < 0.3
    for seed, day in ((0, 0), (3, 11), (12345, 200)):
        got_h, got_d = t_disease.update_health(tm, torch.as_tensor(health),
                                               torch.as_tensor(dwell), torch.as_tensor(new),
                                               seed, day)
        want_h, want_d = j_disease.update_health(jm, health, dwell, new, seed, day)
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=0)


def test_progression_reaches_recovered():
    m = t_disease.covid_model()
    P = 200
    state, dwell = t_disease.initial_health(m, P, device="cpu")
    state, dwell = t_disease.seed_infections(m, state, dwell, 50, 1, 0)
    for day in range(1, 60):
        state, dwell = t_disease.update_health(m, state, dwell,
                                               torch.zeros(P, dtype=torch.bool), 1, day)
    final = np.bincount(state.numpy(), minlength=m.num_states)
    assert final[m.state_index("R")] == 50  # everyone seeded eventually recovers
    assert final[m.initial_state] == P - 50  # no spontaneous infections


# ---------------------------------------------------------------------------
# interventions, object form
# ---------------------------------------------------------------------------


def _all_kinds(lib):
    return [
        lib.Intervention("vax", lib.DayRange(3), lib.RandomFraction(0.3, salt=9),
                         lib.Vaccinate(0.8)),
        lib.Intervention("schools", lib.CaseThreshold(on=30, off=10), lib.LocTypeIs(2),
                         lib.CloseLocations()),
        lib.Intervention("masks", lib.CaseThreshold(on=60), lib.Everyone(),
                         lib.ScaleInfectivity(0.5)),
        lib.Intervention("iso", lib.DayRange(5, 9), lib.RandomFraction(0.2, salt=4),
                         lib.Isolate()),
        lib.Intervention("careful", lib.DayRange(0), lib.AgeGroupIs(1),
                         lib.ScaleSusceptibility(0.7)),
    ]


def test_object_interventions_match_reference_and_stacked(pops):
    jpop, tpop = pops
    jc = j_iv.compile_interventions(_all_kinds(j_iv), jpop, 5)
    tc = t_iv.compile_interventions(_all_kinds(t_iv), tpop, 5, device="cpu")
    for a, b in zip(jc, tc):
        assert (a.name, repr(a.trigger), repr(a.action)) == (b.name, repr(b.trigger),
                                                             repr(b.action))
        np.testing.assert_array_equal(b.people.numpy(), np.asarray(a.people))
        np.testing.assert_array_equal(b.locations.numpy(), np.asarray(a.locations))
    P, L = tpop.num_people, tpop.num_locations
    slots, _, params = t_iv.compile_iv_params(_all_kinds(t_iv), tpop, 5, device="cpu")
    rs = np.random.default_rng(2)
    for _ in range(4):
        active = rs.random(len(tc)) < 0.6
        vacc = rs.random(P) < 0.1
        got = t_iv.apply_interventions(tc, torch.as_tensor(active), torch.as_tensor(vacc), P, L)
        want = j_iv.apply_interventions(jc, active, vacc, P, L)
        stacked = t_iv.apply_iv_params(slots, stack_params([params]),
                                       torch.as_tensor(active)[None],
                                       torch.as_tensor(vacc)[None], P, L)
        for g, w, s in zip(got, want, stacked):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert torch.equal(g, s[0])
        for day, infectious in ((2, 10), (4, 45), (6, 70), (12, 5)):
            stats = {"infectious": torch.tensor(infectious), "cumulative": torch.tensor(99)}
            jstats = {k: np.int32(v) for k, v in stats.items()}
            got_t = t_iv.evaluate_triggers(tc, torch.tensor(day), stats,
                                           torch.as_tensor(active))
            want_t = j_iv.evaluate_triggers(jc, np.int32(day), jstats, active)
            np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
            stacked_t = t_iv.evaluate_iv_triggers(
                slots, stack_params([params]), torch.tensor([day]),
                {k: v[None] for k, v in stats.items()}, torch.as_tensor(active)[None])
            assert torch.equal(got_t, stacked_t[0])
    dup = _all_kinds(t_iv)[:1] * 2
    with pytest.raises(ValueError, match="duplicate intervention name"):
        t_iv.compile_interventions(dup, tpop, 0, device="cpu")


# ---------------------------------------------------------------------------
# the three phases and day_exposure against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["none", "vax-seniors", "lockdown"])
def test_phases_match_reference(pops, preset):
    jcore, tcore = _cores(pops, preset)
    jstate, _ = jcore.run1(WARM_DAYS)
    tstate = t_sim.state_from_numpy(_np(jstate), device="cpu")
    js, jw, jcp, jp = j_sim.legacy_parts(jcore)
    ts, tw, tcp, tp = t_sim.legacy_parts(tcore)
    assert (ts.num_people, ts.num_locations) == (js.num_people, js.num_locations)
    assert [dataclasses.asdict(s) for s in ts.iv_slots] == \
        [dataclasses.asdict(s) for s in js.iv_slots]

    jv = j_sim.phase_visits(js, jp, jstate)
    tv = t_sim.phase_visits(ts, tp, tstate)
    for name, a, b in zip(("visit_ok", "loc_open", "person_sus", "person_inf", "vaccinated"),
                          jv, tv):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)

    jA, jc = j_sim.phase_interact(js, jw, jcp, jp, jstate, *jv[:4])
    tA, tc = t_sim.phase_interact(ts, tw, tcp, tp, tstate, *tv[:4])
    jA = np.asarray(jA)
    assert tc.dtype == torch.int64 and int(tc) == int(jc) > 0
    np.testing.assert_allclose(tA.numpy(), jA, rtol=1e-5, atol=0)

    # the update from the reference's own exposure
    jnew, jstats = j_sim.phase_update(js, jp, jstate, jA, jc, jv[4])
    tnew, tstats = t_sim.phase_update(ts, tp, tstate, torch.tensor(jA), tc, tv[4])
    out = ~_in_band(tp, tstate, jA, jA)
    np.testing.assert_array_equal(tnew.health.numpy()[out], np.asarray(jnew.health)[out])
    np.testing.assert_allclose(tnew.dwell.numpy()[out], np.asarray(jnew.dwell)[out],
                               rtol=1e-6, atol=0)
    for f in ("day", "vaccinated", "iv_active", "tested", "traced", "isolated_until"):
        np.testing.assert_array_equal(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                      err_msg=f)
    for k in ("day", "contacts", "edges", "tests_used", "isolated", "traced"):
        assert int(tstats[k]) == int(jstats[k]), k
    for k in ("new_infections", "infectious", "susceptible", "cumulative"):
        assert abs(int(tstats[k]) - int(jstats[k])) <= int((~out).sum()), k


@pytest.mark.parametrize("weekly", [False, True])
def test_day_exposure_matches_reference(pops, weekly):
    """``day_exposure`` called directly, with the contact hash keyed by the
    absolute day or, as on a static network, by the day of the week."""
    jcore, tcore = _cores(pops, "none")
    jstate, _ = jcore.run1(WARM_DAYS)
    js, jw, jcp, jp = j_sim.legacy_parts(jcore)
    ts, tw, tcp, tp = t_sim.legacy_parts(tcore)
    ok, lo, ps, pi, _ = j_sim.phase_visits(js, jp, jstate)
    dow = WARM_DAYS % 7
    cday = dow if weekly else WARM_DAYS
    from repro.core import interactions as j_inter
    from repro_torch.core import interactions as t_inter

    jA, jc = j_inter.day_exposure(jw, dow, js.num_people, ps, pi, jcp, ok, lo, jp.tau_eff,
                                  jp.seed, cday, backend="compact")
    t = lambda x: torch.as_tensor(np.asarray(x))
    tA, tc = t_inter.day_exposure(tw, dow, ts.num_people, t(ps), t(pi), tcp, t(ok), t(lo),
                                  tp.tau_eff, tp.seed, cday, backend="pallas-compact")
    assert int(tc) == int(jc) > 0
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-5, atol=0)


def test_history_matches_reference_before_the_band(pops):
    jcore, tcore = _cores(pops, "none")
    _, jh = jcore.run1(20)
    _, th, times = t_sim.run_eager(tcore, 20)
    _, band_day = _stepped(tcore, 20)
    limit = 20 if band_day is None else band_day
    for k in t_sim.STAT_KEYS:
        np.testing.assert_array_equal(th[k][:limit], np.asarray(jh[k][:limit], np.int64),
                                      err_msg=f"'{k}' before day {limit}")
    assert t_sim.attack_rate(th) == float(th["cumulative"][-1])
    assert abs(t_sim.attack_rate(th) - j_sim.attack_rate(jh)) <= 0.05 * tcore.pop.num_people


# ---------------------------------------------------------------------------
# inside the port: the views are the engine, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,preset", [("pallas-compact", "none"), ("pallas", "none"),
                                            ("pallas-compact", "lockdown"),
                                            ("pallas", "vax-seniors")])
def test_views_equal_engine_bitwise(pops, backend, preset):
    _, tcore = _cores(pops, preset, backend=backend)
    final, hist = tcore.run1(DAYS)
    st, he, times = t_sim.run_eager(tcore, DAYS)
    static, week, cp, params = t_sim.legacy_parts(tcore)
    assert static.backend == backend
    # run_scan over all days but the last, then day_step for the last one
    mid, hs = t_sim.run_scan(static, week, cp, params, tcore.init_state1(), DAYS - 1)
    last, stats = t_sim.day_step(static, week, cp, params, mid)
    for k in t_sim.STAT_KEYS:
        np.testing.assert_array_equal(he[k], hist[k], err_msg=f"run_eager {k}")
        np.testing.assert_array_equal(hs[k].numpy(), hist[k][:-1], err_msg=f"run_scan {k}")
        assert int(stats[k]) == int(hist[k][-1]), f"day_step {k}"
    for f in STATE_FIELDS:
        for name, got in (("run_eager", st), ("run_scan + day_step", last)):
            assert torch.equal(getattr(got, f), getattr(final, f)), f"{name} {f}"
    assert set(times) == {"visits", "interact", "update"}
    assert all(v.shape == (DAYS,) and (v >= 0).all() for v in times.values())
    assert np.array_equal(he["edges"], he["contacts"])


def test_legacy_parts_needs_a_one_scenario_local_core(pops):
    _, tpop = pops
    batch = t_api.ExperimentSpec(dataset="twin-2k", replicates=2).build_batch()
    with pytest.raises(ValueError, match="B=1 local EngineCore"):
        t_sim.legacy_parts(TCore(tpop, batch, device="cpu"))


# ---------------------------------------------------------------------------
# the mesh's names and partition specs; the report CLI
# ---------------------------------------------------------------------------


def test_axis_names_and_dist_specs_match_reference():
    assert (t_engine.WORKER_AXIS, t_engine.SCENARIO_AXIS) == (j_engine.WORKER_AXIS,
                                                               j_engine.SCENARIO_AXIS)
    assert t_sd.AXIS == j_sd.AXIS and t_sd.STAT_KEYS == j_sd.STAT_KEYS
    for batch_axis in (None, "scenarios"):
        for got, want in ((t_sd.dist_param_specs(batch_axis), j_sd.dist_param_specs(batch_axis)),
                          (t_sd.dist_state_specs(batch_axis), j_sd.dist_state_specs(batch_axis))):
            g, w = dataclasses.asdict(got), dataclasses.asdict(want)

            def walk(a, b, path):
                if isinstance(b, dict):
                    assert set(a) == set(b), path
                    for k in b:
                        walk(a[k], b[k], f"{path}.{k}")
                else:
                    assert a == tuple(b), (path, a, b)

            walk(g, w, type(got).__name__)
    # the dist static of a plan, field for field
    assert [f.name for f in dataclasses.fields(t_sd.DistStatic)] == \
        [f.name for f in dataclasses.fields(j_sd.DistStatic)]


def test_report_renders_a_result(pops, tmp_path, capsys):
    _, tpop = pops
    spec = t_api.ExperimentSpec(dataset="twin-2k", days=6, replicates=2, tau=TAU)
    path = str(tmp_path / "run.json")
    result = t_api.run(spec, population=tpop, device="cpu")
    result.save(path)
    assert t_report.main(["--result", path]) == 0
    out = capsys.readouterr().out
    assert "| scenario | attack % |" in out and "| day | mean new_infections |" in out
    assert all(f"| {name} |" in out for name in result.scenario_names)
    # the dry-run tables render now (an empty directory: the headers alone)
    assert t_report.main(["--section", "dryrun", "--dir", str(tmp_path)]) == 0
    assert "### Dry-run status (compile proof per cell)" in capsys.readouterr().out
    assert callable(j_report.main)
