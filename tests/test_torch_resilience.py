"""Checkpointed, resumable and self-healing study runs in the port, against
the reference's ``tests/test_resilience.py`` bar.

* Port against reference: the invariant guards give the reference's
  violation lists on the same numpy states; ``ChaosSchedule.random`` draws
  the reference's events and ``_damage_newest`` damages the same bytes; a
  checkpointed ``api.run`` equals the reference's checkpointed ``api.run``
  before each scenario's first in-band decision (``test_torch_slice.py``'s
  ``_stepped`` rule); under the same chaos schedule the port's recovery
  report has the reference's restarts, fault kinds, quarantined snapshots
  and resume day.
* Inside the port, bitwise: resumes (engines ``single`` and ``ensemble``),
  recovery from ``raise``, ``nan``, ``corrupt`` and ``truncate``, the
  straggler repartition; and the refusals (no checkpoint directory, an
  incompatible spec, a manifest without ``core``, a reference-written
  checkpoint, a wrong leaf dtype, a device loss on one worker); the CLI.
"""

import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.core import simulator as j_sim
from repro.data import digital_twin_population as j_twin
from repro.runtime import chaos as j_chaos
from repro.runtime import guards as j_guards
from repro_torch import api
from repro_torch.api.spec import ResilienceSpec
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager, leaf_digest
from repro_torch.core import simulator as sim_lib
from repro_torch.data import digital_twin_population
from repro_torch.engine import core as core_lib
from repro_torch.engine.core import EngineCore, ResumeKeyError
from repro_torch.launch import simulate
from repro_torch.runtime import (
    ChaosError,
    ChaosEvent,
    ChaosSchedule,
    DeviceLossError,
    GuardContext,
    InvariantViolation,
)
from repro_torch.runtime import chaos as chaos_lib
from repro_torch.runtime.guards import check_state

from test_torch_slice import _stepped

DAYS, EVERY = 12, 3
OBSERVABLES = ("daily_new_infections", "attack_rate", "peak_day", "ensemble_mean_ci")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the CPU at once, and torch's thread pools oversubscribe the
    cores (the shapes here gain little from more threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pop():
    return digital_twin_population(400, seed=11, name="res")


@pytest.fixture(scope="module")
def jpop():
    return j_twin(400, seed=11, name="res")


def _spec(lib=api, **kw):
    base = dict(dataset="twin-2k", days=DAYS, tau=2e-5, interventions=("none",),
                replicates=2, observables=OBSERVABLES)
    base.update(kw)
    return lib.ExperimentSpec(**base)


def _ck(spec, path, **kw):
    return spec.with_overrides(ckpt_dir=str(path), ckpt_every=EVERY, **kw)


@pytest.fixture(scope="module")
def reference(pop):
    """The fault-free, unchunked port run every recovered run must match
    bitwise."""
    return api.run(_spec(), population=pop, device="cpu")


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
# port against reference: guards, chaos schedules, checkpointed runs, reports
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mid_state(pop):
    """A stacked B = 2 state 10 days in (TTI, so isolation is in use), as
    host numpy leaves."""
    spec = _spec(interventions=("tti",), days=10)
    core = EngineCore(pop, spec.build_batch(), device="cpu")
    st = core.run_days(10)[0]
    return {f.name: getattr(st, f.name).numpy().copy() for f in dataclasses.fields(st)}


def _set(a, idx, v):
    a = a.copy()
    a[idx] = v
    return a


GUARD_CASES = {
    "healthy": ({}, None),
    "bad-health": ({"health": lambda a: _set(_set(a, (0, 3), 99), (1, 7), -2)}, None),
    "negative-counters": ({"cumulative": lambda a: _set(a, 1, -4),
                           "day": lambda a: _set(a, 0, -1)}, None),
    "negative-isolation": ({"isolated_until": lambda a: _set(a, (1, 5), -3)}, None),
    "nan": ({"dwell": lambda a: _set(a, (0, 0), np.nan)}, None),
    "inf-and-nan": ({"dwell": lambda a: _set(_set(a, (1, 9), np.inf), (0, 2), np.nan)}, None),
    "cumulative-decreasing": ({"cumulative": lambda a: a - 1}, "prev"),
    "isolation-backwards": ({"isolated_until": lambda a: _set(a, (0, slice(0, 7)), 0)}, "prev"),
    "everything": ({"health": lambda a: _set(a, (0, 1), 50), "cumulative": lambda a: a - 5,
                    "dwell": lambda a: _set(a, (1, 1), np.nan),
                    "isolated_until": lambda a: _set(a, (1, slice(0, 5)), -1)}, "prev"),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guards_give_the_reference_violations(mid_state, case):
    """Both packages' check_state on the same numpy state (and the same
    previous-boundary baselines): the same violation strings, in order."""
    edits, use_prev = GUARD_CASES[case]
    s = {k: (edits[k](v) if k in edits else v) for k, v in mid_state.items()}
    if use_prev:  # the baselines: iso windows extended so they can move back
        mid_state = dict(mid_state, isolated_until=np.maximum(mid_state["isolated_until"], 4))
        s.setdefault("isolated_until", mid_state["isolated_until"])
    prev = {k: mid_state[k] for k in ("cumulative", "isolated_until")} if use_prev else None
    n = 9
    want = j_guards.check_state(j_sim.SimState(**s), num_states=n, prev=prev)
    got = check_state(sim_lib.SimState(**{k: torch.as_tensor(v) for k, v in s.items()}),
                      num_states=n,
                      prev=None if prev is None else {k: torch.as_tensor(v)
                                                      for k, v in prev.items()})
    assert got == want
    assert (got == []) == (case == "healthy")


def test_guard_context_monotonicity(mid_state):
    st = sim_lib.SimState(**{k: torch.as_tensor(v) for k, v in mid_state.items()})
    g = GuardContext(num_states=9)
    g.check(st)  # establishes the baseline
    shrunk = dataclasses.replace(st, isolated_until=st.isolated_until - 5)
    with pytest.raises(InvariantViolation, match="isolated_until"):
        g.check(shrunk)
    g.reset(st)  # rebase (restore semantics): the same state is fine again
    g.check(st)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2024])
def test_chaos_schedule_random_equals_the_reference(seed):
    for days, every, kinds, n in ((60, 10, chaos_lib.KINDS, 3), (200, 50, ("raise", "nan"), 2),
                                  (12, 3, ("corrupt", "truncate", "slow"), 5), (5, 10, ("raise",), 3)):
        got = ChaosSchedule.random(seed, days, every, kinds=kinds, n_events=n).events
        want = j_chaos.ChaosSchedule.random(seed, days, every, kinds=kinds, n_events=n).events
        assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]


def test_chaos_events_fire_once_and_nan_poisons_a_copy():
    sched = ChaosSchedule((ChaosEvent("raise", day=5), ChaosEvent("nan", day=5)))
    with pytest.raises(ChaosError):
        sched.before_chunk(5)
    sched.before_chunk(5)  # one-shot: the replayed boundary is quiet
    st = sim_lib.SimState(**{f.name: torch.ones((2, 3)) for f in dataclasses.fields(sim_lib.SimState)})
    poisoned = sched.poison_state(5, st)
    assert torch.isnan(poisoned.dwell[0, 0]) and torch.isfinite(poisoned.dwell.view(-1)[1:]).all()
    assert torch.equal(st.dwell, torch.ones((2, 3)))  # the live tensor is untouched
    assert sched.poison_state(5, st) is st
    assert sched.log == [("raise", 5), ("nan", 5)]
    with pytest.raises(ValueError, match="chaos kind"):
        ChaosEvent("meteor", day=1)


@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_damage_newest_equals_the_reference(tmp_path, kind):
    mgr = CheckpointManager(str(tmp_path / "a"))
    tree = {"big": np.arange(300, dtype=np.int64), "small": np.ones(3, np.float32)}
    mgr.save(1, tree, blocking=True)
    mgr.save(2, tree, blocking=True)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    chaos_lib._damage_newest(mgr, ChaosEvent(kind, day=2))
    j_chaos._damage_newest(CheckpointManager(str(tmp_path / "b")), j_chaos.ChaosEvent(kind, day=2))
    for name in ("big.npy", "small.npy"):
        a, b = (open(tmp_path / d / f"step-{2:010d}" / name, "rb").read() for d in "ab")
        assert a == b, name
    assert mgr.verify(2) and not mgr.verify(1)


def test_checkpointed_run_matches_the_reference(pop, jpop, tmp_path):
    """B = 2, 12 days, every 3: the port's checkpointed run and the
    reference's, each scenario equal on every day before its first in-band
    decision; each package's snapshot carries its own package's key."""
    t = api.run(_ck(_spec(), tmp_path / "t"), population=pop, device="cpu")
    j = j_api.run(_ck(_spec(j_api, backend="compact"), tmp_path / "j"), population=jpop)
    assert t.provenance["chunks"] == j.provenance["chunks"] == DAYS // EVERY
    assert t.provenance["chunk_days"] == j.provenance["chunk_days"] == EVERY
    compared = 0
    for i, scen in enumerate(_spec().build_batch()):
        _, band_day = _stepped(EngineCore(pop, [scen], device="cpu"), DAYS)
        limit = DAYS if band_day is None else band_day
        compared += limit
        for k in sim_lib.STAT_KEYS:
            np.testing.assert_array_equal(
                t.history[k][:limit, i], np.asarray(j.history[k][:limit, i], np.int64),
                err_msg=f"{scen.name} '{k}' before day {limit}")
    assert compared >= DAYS
    tk = CheckpointManager(str(tmp_path / "t")).manifest(DAYS)["extra"]["resume_key"]
    jk = CheckpointManager(str(tmp_path / "j")).manifest(DAYS)["extra"]["resume_key"]
    assert tk.pop("package") == "repro_torch" and tk.pop("device") == "cpu"
    assert (tk.pop("backend"), jk.pop("backend")) == ("jnp", "compact")
    assert tk == jk  # the rest of the key is the reference's


REPORT_SCHEDULES = {
    "raise": (ChaosEvent("raise", day=6),),
    "nan": (ChaosEvent("nan", day=6),),
    "corrupt-then-raise": (ChaosEvent("corrupt", day=6), ChaosEvent("raise", day=9)),
    "truncate-nan": (ChaosEvent("truncate", day=3), ChaosEvent("nan", day=9)),
}


@pytest.mark.parametrize("name", list(REPORT_SCHEDULES))
def test_recovery_report_equals_the_reference(pop, jpop, tmp_path, name):
    evs = REPORT_SCHEDULES[name]
    t = api.run(_ck(_spec(), tmp_path / "t", resilient=True), population=pop, device="cpu",
                chaos=ChaosSchedule(evs))
    j = j_api.run(_ck(_spec(j_api, backend="compact"), tmp_path / "j", resilient=True),
                  population=jpop,
                  chaos=j_chaos.ChaosSchedule(tuple(j_chaos.ChaosEvent(**dataclasses.asdict(e))
                                                    for e in evs)))
    tr, jr = t.provenance["resilience"], j.provenance["resilience"]
    assert set(tr) == set(jr)
    for k in ("restarts", "chunks_replayed", "snapshots_quarantined", "repartitions",
              "device_losses", "final_workers", "final_layout"):
        assert tr[k] == jr[k], k
    assert [f["kind"] for f in tr["faults"]] == [f["kind"] for f in jr["faults"]]
    assert tr["guard_violations"] == jr["guard_violations"]
    assert t.provenance["resumed_from_day"] == j.provenance["resumed_from_day"]
    assert tr["restarts"] >= 1


# ---------------------------------------------------------------------------
# inside the port, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,replicates", [("auto", 2), ("single", 2), ("auto", 1)],
                         ids=["ensemble", "single-sequential", "single"])
def test_resume_bitwise_and_second_resume_is_a_no_op(pop, tmp_path, engine, replicates):
    ref = api.run(_spec(engine=engine, replicates=replicates), population=pop, device="cpu")
    first = api.run(_ck(_spec(engine=engine, replicates=replicates, days=5), tmp_path),
                    population=pop, device="cpu")
    assert first.provenance["chunks"] == 2  # days 0-3, 3-5
    res = api.run(_ck(_spec(engine=engine, replicates=replicates), tmp_path), population=pop,
                  device="cpu")
    assert res.provenance["resumed_from_day"] == 5 and res.provenance["chunks"] == 3
    assert res.provenance["engine"] == ref.provenance["engine"]
    _assert_bitwise(ref, res)
    again = api.run(_ck(_spec(engine=engine, replicates=replicates), tmp_path),
                    population=pop, device="cpu")
    assert again.provenance["resumed_from_day"] == DAYS and again.provenance["chunks"] == 0
    _assert_bitwise(ref, again)


@pytest.mark.parametrize("kind", ["raise", "nan", "corrupt", "truncate"])
def test_chaos_recovery_bitwise(pop, reference, tmp_path, kind):
    res = api.run(_ck(_spec(), tmp_path, resilient=True), population=pop, device="cpu",
                  chaos=ChaosSchedule((ChaosEvent(kind, day=6),)))
    _assert_bitwise(reference, res)
    rep = res.provenance["resilience"]
    assert rep["restarts"] == 1 and rep["faults"]
    assert rep["chunks_replayed"] == (0 if kind == "raise" else 1)
    if kind in ("corrupt", "truncate"):
        assert rep["snapshots_quarantined"] >= 1
        assert os.path.isdir(os.path.join(str(tmp_path), "quarantine"))
        assert res.provenance["resumed_from_day"] == 3  # fell back past day 6
    if kind == "nan":
        assert any("non-finite" in v for v in rep["guard_violations"])
        mgr = CheckpointManager(str(tmp_path))  # the poison never reached disk
        for step in mgr.all_steps():
            for k, v in mgr.restore_flat(step).items():
                if np.issubdtype(v.dtype, np.floating):
                    assert np.all(np.isfinite(v)), f"step {step} leaf {k}"


def test_chaos_recovery_sequential_engine(pop, reference, tmp_path):
    res = api.run(_ck(_spec(engine="single"), tmp_path, resilient=True), population=pop,
                  device="cpu", chaos=ChaosSchedule((ChaosEvent("nan", day=6),)))
    _assert_bitwise(reference, res)
    assert res.provenance["resilience"]["restarts"] == 1


class _ChunkClock:
    """A stand-in for the ``time`` module of the chunk loop and the chaos
    schedule: ``perf_counter`` advances a fixed tick per call and ``sleep``
    advances it by its argument, so a chunk's timed section lasts exactly
    one tick plus the chaos sleep, whatever the machine's load. Every other
    attribute is the real module's."""

    TICK = 0.1

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += self.TICK
        return self.now

    def sleep(self, s):
        self.now += s

    def __getattr__(self, name):
        return getattr(time, name)


def test_straggler_detection_and_repartition(pop, reference, tmp_path, monkeypatch):
    """A chunk slowed well past 3x the median (each 2-day chunk takes one
    0.1 s tick of the chunk clock, the slowed one 2.5 s more) is flagged and
    rebuilds the driver once; the run stays bitwise. The clock is the test's
    own, so a loaded machine cannot add or hide a straggler."""
    clock = _ChunkClock()
    monkeypatch.setattr(core_lib, "time", clock)
    monkeypatch.setattr(chaos_lib, "time", clock)
    spec = _spec().with_overrides(ckpt_dir=str(tmp_path), ckpt_every=2)
    spec = dataclasses.replace(spec, resilience=ResilienceSpec(
        enabled=True, repartition_on_straggler=True, straggler_factor=3.0))
    calls = []
    res = api.run(spec, population=pop, device="cpu",
                  chaos=ChaosSchedule((ChaosEvent("slow", day=8, sleep_s=2.5),)),
                  on_straggler=lambda day, dt, med: calls.append((day, dt, med)))
    _assert_bitwise(reference, res)
    rep = res.provenance["resilience"]
    assert rep["straggler_events"] and calls
    assert rep["straggler_events"][0]["day"] == 10  # the slowed chunk's end
    assert rep["repartitions"] == 1  # rebuilt once, then the window resets
    assert rep["restarts"] == 0  # a repartition is not a failure


def test_restart_cap_exhausted(pop, tmp_path):
    with pytest.raises(ChaosError):
        api.run(_ck(_spec(), tmp_path, resilient=True, max_restarts=0), population=pop,
                device="cpu", chaos=ChaosSchedule((ChaosEvent("raise", day=6),)))


def test_resume_falls_back_past_corrupt_newest(pop, reference, tmp_path):
    """Offline corruption of the newest snapshot: a plain resume quarantines
    it and restarts from the next-older valid step."""
    api.run(_ck(_spec(days=6), tmp_path), population=pop, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3, 6]
    chaos_lib._damage_newest(mgr, ChaosEvent("truncate", day=6))
    res = api.run(_ck(_spec(), tmp_path), population=pop, device="cpu")
    assert res.provenance["resumed_from_day"] == 3
    assert os.path.isdir(os.path.join(str(tmp_path), "quarantine", f"step-{6:010d}"))
    _assert_bitwise(reference, res)


def _rewrite_manifest(path, step, edit):
    mpath = os.path.join(str(path), f"step-{step:010d}", "manifest.json")
    with open(mpath) as f:
        meta = json.load(f)
    edit(meta)
    with open(mpath, "w") as f:
        json.dump(meta, f)


def _no_core(meta):
    del meta["extra"]["resume_key"]["core"]


def _no_key(meta):
    meta["extra"] = {}


@pytest.mark.parametrize("case", ["other-tau", "other-device", "no-core", "no-key",
                                  "beyond-days", "reference-written"])
def test_incompatible_checkpoints_are_refused(pop, jpop, tmp_path, case):
    if case == "reference-written":
        j_api.run(_ck(_spec(j_api, days=6), tmp_path), population=jpop)
    else:
        api.run(_ck(_spec(days=6), tmp_path), population=pop, device="cpu")
    spec = _ck(_spec(), tmp_path)
    match = "incompatible spec or engine generation"
    if case == "other-tau":
        spec = spec.with_overrides(tau=3e-5)
    elif case == "other-device":
        _rewrite_manifest(tmp_path, 6, lambda m: m["extra"]["resume_key"].update(device="cuda"))
    elif case == "no-core":
        _rewrite_manifest(tmp_path, 6, _no_core)
    elif case == "no-key":
        _rewrite_manifest(tmp_path, 6, _no_key)
        match = "no resume_key"
    elif case == "beyond-days":
        spec = _ck(_spec(days=4), tmp_path)
        match = "beyond spec.days=4"
    with pytest.raises(ResumeKeyError, match=match):
        api.run(spec, population=pop, device="cpu")
    with pytest.raises(ResumeKeyError, match=match):  # never retried as a fault
        api.run(spec.with_overrides(resilient=True), population=pop, device="cpu")


def test_port_written_checkpoint_is_refused_by_the_reference(pop, jpop, tmp_path):
    api.run(_ck(_spec(days=6), tmp_path), population=pop, device="cpu")
    with pytest.raises(ValueError, match="incompatible spec or engine generation"):
        j_api.run(_ck(_spec(j_api), tmp_path), population=jpop)


def test_wrong_leaf_dtype_is_refused(pop, tmp_path):
    """A snapshot that passes its integrity checks but holds state/health
    as int64 (the engine's is int32): refused, never cast."""
    api.run(_ck(_spec(days=6), tmp_path), population=pop, device="cpu")
    path = os.path.join(str(tmp_path), f"step-{6:010d}", "state__health.npy")
    health = np.load(path).astype(np.int64)
    np.save(path, health)
    _rewrite_manifest(tmp_path, 6, lambda m: m["leaves"]["state/health"].update(
        dtype="int64", sha256=leaf_digest(health)))
    assert CheckpointManager(str(tmp_path)).verify(6) == []
    with pytest.raises(CheckpointCorruptionError, match="'state/health' has dtype torch.int64"):
        api.run(_ck(_spec(), tmp_path), population=pop, device="cpu")


def test_resilience_refusals(pop, tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        _spec(resilience=ResilienceSpec(enabled=True)).validate()
    with pytest.raises(ValueError, match="resilient"):
        api.run(_spec(), population=pop, device="cpu",
                chaos=ChaosSchedule((ChaosEvent("raise", day=6),)))
    # one worker: no device to drop, so the loss re-raises (the reference's rule)
    with pytest.raises(DeviceLossError):
        api.run(_ck(_spec(), tmp_path, resilient=True), population=pop, device="cpu",
                chaos=ChaosSchedule((ChaosEvent("device_loss", day=6),)))


def test_simulate_cli_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--dataset", "twin-2k", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--device", "cpu"]
    simulate.main(args + ["--days", "6"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["resumed_from_day"] is None and first["chunks"] == 2
    simulate.main(args + ["--days", "9", "--resilient"])
    out = capsys.readouterr().out.strip().splitlines()
    last, rep = json.loads(out[-2]), json.loads(out[-1])
    assert last["resumed_from_day"] == 6 and last["chunks"] == 1
    assert rep["resilience"]["restarts"] == 0 and rep["resilience"]["final_workers"] == 1
