"""The port's checkpoint manager, engine restore and runtime helpers, against
the reference's ``repro.checkpoint`` and ``repro.runtime``.

* The manager: the reference's manager tests, run on the port's (round
  trip, retention, async save, digests, corrupt / truncated / missing leaf,
  shape and dtype against the manifest, legacy manifest, writer exception,
  readers joining the writer); and the on-disk format both ways — a
  snapshot written by either package's manager restores through the other
  with equal leaves, digests and manifest.
* The engine's restore: ``state_from_flat`` puts every leaf back with the
  dtype and shape of ``init_state()`` or raises; ``adopt_state`` re-pads a
  person axis written for more workers; a run restarted from a snapshot is
  bitwise the uninterrupted one.
* ``runtime/elastic.py`` and ``runtime/fault.py`` against the reference's
  on the same numpy inputs.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import flatten_tree as j_flatten
from repro.checkpoint import leaf_digest as j_leaf_digest
from repro.runtime import FaultConfig as JFaultConfig
from repro.runtime import FaultTolerantLoop as JLoop
from repro.runtime.elastic import plan_elastic_rescale as j_plan
from repro.runtime.elastic import repartition_person_array as j_repartition
from repro_torch.checkpoint import (
    CheckpointCorruptionError,
    CheckpointManager,
    flatten_tree,
    leaf_digest,
)
from repro_torch.core import disease, transmission
from repro_torch.core import simulator as sim_lib
from repro_torch.data import digital_twin_population
from repro_torch.engine.core import EngineCore, state_from_flat, state_to_tree
from repro_torch.runtime import FaultConfig, FaultTolerantLoop
from repro_torch.runtime.elastic import plan_elastic_rescale, repartition_person_array


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the CPU at once, and torch's thread pools oversubscribe the
    cores (the shapes here gain little from more threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree():
    return {"a": torch.arange(12, dtype=torch.int32),
            "b": torch.linspace(0.0, 1.0, 400, dtype=torch.float32).reshape(20, 20)}


def _leaf_path(mgr, step, key):
    return os.path.join(mgr.directory, f"step-{step:010d}", key.replace("/", "__") + ".npy")


# ---------------------------------------------------------------------------
# the manager (the reference's tests, on the port's manager)
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(10, dtype=torch.int32),
            "nested": {"b": torch.ones((3, 4), dtype=torch.float32) * 2.5},
            "seq": (torch.zeros(2, dtype=torch.int64), torch.ones(1, dtype=torch.bool))}
    mgr.save(7, tree, extra={"note": "x"}, blocking=True)
    assert mgr.all_steps() == [7]
    out = mgr.restore(tree)
    assert set(out) == set(tree) and isinstance(out["seq"], tuple)
    for k, v in flatten_tree(tree).items():
        got = flatten_tree(out)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert mgr.manifest()["extra"]["note"] == "x"


def test_restore_refuses_a_template_of_another_shape_or_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.arange(4, dtype=torch.int32)}, blocking=True)
    with pytest.raises(CheckpointCorruptionError, match="'ghost'"):
        mgr.restore({"a": torch.zeros(4, dtype=torch.int32),
                     "ghost": torch.zeros(2)}, 1)
    for like in (torch.zeros(5, dtype=torch.int32), torch.zeros(4, dtype=torch.int64)):
        with pytest.raises(ValueError, match="a: checkpoint"):
            mgr.restore({"a": like}, 1)


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(3)}, blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_async_save_copies_to_the_host_before_returning(tmp_path):
    """save() copies in the caller's thread: overwriting the tensor right
    after save() returns does not reach the snapshot."""
    mgr = CheckpointManager(str(tmp_path))
    x = torch.arange(5, dtype=torch.int32)
    mgr.save(1, {"x": x})
    x.fill_(-1)
    mgr.wait()
    assert mgr.latest_step() == 1
    np.testing.assert_array_equal(mgr.restore_flat(1)["x"], np.arange(5))


def test_manifest_carries_leaf_digests(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(), blocking=True)
    leaves = mgr.manifest(3)["leaves"]
    assert set(leaves) == {"a", "b"}
    assert leaves["a"]["shape"] == [12] and leaves["a"]["dtype"] == "int32"
    assert leaves["b"]["sha256"] == leaf_digest(np.load(_leaf_path(mgr, 3, "b")))


def _flip(path):
    with open(path, "r+b") as f:  # flip trailing payload bytes
        f.seek(os.path.getsize(path) - 8)
        chunk = f.read(4)
        f.seek(os.path.getsize(path) - 8)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("damage,leaf,match", [
    (_flip, "b", "'b' failed its SHA-256"),
    (_truncate, "b", "'b' is unreadable"),
    (os.remove, "a", "'a' is missing"),
], ids=["corrupt", "truncated", "missing"])
def test_damaged_leaf_detected_and_named(tmp_path, damage, leaf, match):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    damage(_leaf_path(mgr, 1, leaf))
    assert any(f"'{leaf}'" in p for p in mgr.verify(1))
    with pytest.raises(CheckpointCorruptionError, match=match):
        mgr.restore_flat(1)


def test_shape_dtype_validated_against_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    np.save(_leaf_path(mgr, 1, "a"), np.zeros((3, 3), np.int32))
    with pytest.raises(CheckpointCorruptionError, match="'a' has shape"):
        mgr.restore_flat(1)
    np.save(_leaf_path(mgr, 1, "a"), np.zeros(12, np.float64))
    with pytest.raises(CheckpointCorruptionError, match="'a' has dtype"):
        mgr.restore_flat(1)


def test_latest_valid_step_quarantines_and_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    mgr.save(2, _tree(), blocking=True)
    with open(_leaf_path(mgr, 2, "b"), "r+b") as f:
        f.truncate(10)
    assert mgr.latest_valid_step() == 1
    assert mgr.quarantined_steps == [2]
    assert mgr.all_steps() == [1]  # the corrupt snapshot was moved aside
    assert os.path.isdir(os.path.join(str(tmp_path), "quarantine", f"step-{2:010d}"))


def test_legacy_manifest_without_digests_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    mpath = os.path.join(mgr.directory, f"step-{1:010d}", "manifest.json")
    with open(mpath) as f:
        meta = json.load(f)
    for entry in meta["leaves"].values():  # pre-integrity checkpoint format
        del entry["sha256"]
    with open(mpath, "w") as f:
        json.dump(meta, f)
    np.testing.assert_array_equal(mgr.restore_flat(1)["a"], np.arange(12))


def test_async_writer_exception_surfaces(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    os.rmdir(mgr.directory)
    with open(mgr.directory, "w") as f:  # the writer's makedirs will fail
        f.write("not a directory")
    mgr.save(1, {"x": torch.zeros(3)})  # non-blocking: the error lands in the writer
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        mgr.wait()
    mgr.wait()  # surfaced once, then cleared


def test_readers_join_inflight_writer(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree())  # async
    assert mgr.latest_step() == 5  # wait()s internally, never races
    assert mgr.latest_valid_step() == 5


# ---------------------------------------------------------------------------
# the on-disk format, both ways
# ---------------------------------------------------------------------------


def _mixed_tree():
    """A snapshot's shape: a scalar day, state-like leaves of every dtype
    the engine writes, a history dict, and a nested sequence."""
    rs = np.random.default_rng(5)
    return {
        "day": np.asarray(9, np.int32),
        "state": {"health": rs.integers(0, 7, (2, 50)).astype(np.int32),
                  "dwell": rs.random((2, 50)).astype(np.float32),
                  "cumulative": np.array([3, 4], np.int64),
                  "vaccinated": rs.random((2, 50)) < 0.3},
        "hist": {"new_infections": rs.integers(0, 9, (9, 2)).astype(np.int64)},
        "seq": [np.arange(3, dtype=np.int32), np.ones(2, np.float32)],
    }


@pytest.mark.parametrize("arr", [
    np.arange(10, dtype=np.int32), np.ones((3, 4), bool), np.asarray(5, np.int32),
    np.zeros((2, 0), np.float32), np.arange(12, dtype=np.int64).reshape(3, 4).T,
    np.linspace(0, 1, 21, dtype=np.float32)[::2],
], ids=["int32", "bool", "scalar", "empty", "transposed", "strided"])
def test_leaf_digest_equals_the_reference(arr):
    assert leaf_digest(arr) == j_leaf_digest(arr)


def test_flatten_tree_keys_equal_the_reference():
    tree = _mixed_tree()
    state = sim_lib.SimState(**{f.name: torch.zeros(1) for f in dataclasses.fields(sim_lib.SimState)})
    assert list(flatten_tree(tree)) == list(j_flatten(tree))
    assert list(flatten_tree({"s": state_to_tree(state)})) == list(
        j_flatten({"s": {k: np.zeros(1) for k in state_to_tree(state)}}))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_restores_across_packages(tmp_path, writer):
    """A snapshot written by either package's manager: the same files, and
    the other manager verifies it and restores equal leaves; digests and
    manifests equal those of the same tree written by the reader."""
    tree = _mixed_tree()
    torch_tree = {k: v for k, v in tree.items()}
    torch_tree["state"] = {k: torch.as_tensor(v) for k, v in tree["state"].items()}
    mk = {"reference": JManager, "port": CheckpointManager}
    other = "port" if writer == "reference" else "reference"
    w = mk[writer](str(tmp_path / "w"))
    w.save(9, torch_tree if writer == "port" else tree, extra={"resume_key": {"a": 1}},
           blocking=True)
    mk[other](str(tmp_path / "o")).save(9, tree if writer == "port" else torch_tree,
                                       extra={"resume_key": {"a": 1}}, blocking=True)
    r = mk[other](str(tmp_path / "w"))
    assert r.all_steps() == [9] and r.verify(9) == []
    assert sorted(os.listdir(tmp_path / "w" / f"step-{9:010d}")) == sorted(
        os.listdir(tmp_path / "o" / f"step-{9:010d}"))
    flat = r.restore_flat(9)
    want = j_flatten(tree)
    assert list(flat) == list(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and np.array_equal(flat[k], v), k
    mw, mo = r.manifest(9), mk[other](str(tmp_path / "o")).manifest(9)
    assert set(mw) == set(mo) == {"step", "time", "extra", "leaves"}
    assert mw["leaves"] == mo["leaves"] and mw["extra"] == mo["extra"] and mw["step"] == 9
    if other == "port":  # the port's restore onto a template of tensors
        like = {"state": {k: torch.zeros_like(v) for k, v in torch_tree["state"].items()}}
        got = r.restore(like, 9)
        for k, v in torch_tree["state"].items():
            assert torch.equal(got["state"][k], v), k


# ---------------------------------------------------------------------------
# the engine's restore
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def core():
    pop = digital_twin_population(800, seed=4, name="ck")
    return EngineCore.single(pop, disease.covid_model(),
                             transmission.TransmissionModel(tau=2e-5), seed=9, device="cpu")


def _flat(state):
    return {f"state/{k}": v.numpy() for k, v in state_to_tree(state).items()}


def test_sim_restart_bitwise(core, tmp_path):
    """A state written at day 12 and restored from disk continues bitwise
    as the uninterrupted 20-day run."""
    mgr = CheckpointManager(str(tmp_path))
    st, _, h1, _ = core.run_days(12)
    mgr.save(12, {"state": state_to_tree(st)}, blocking=True)
    restored = state_from_flat(mgr.restore_flat(12), core.init_state())
    for f in state_to_tree(st):
        assert getattr(restored, f).dtype == getattr(st, f).dtype
    _, _, h_res, _ = core.run_days(8, state=restored)
    _, _, h_full, _ = core.run_days(20)
    assert torch.equal(torch.cat([h1, h_res]), h_full)


@pytest.mark.parametrize("leaf,bad,match", [
    ("day", lambda v: v.astype(np.int32), "'state/day' has dtype"),
    ("cumulative", lambda v: v.astype(np.int32), "'state/cumulative' has dtype"),
    ("health", lambda v: v.astype(np.int64), "'state/health' has dtype"),
    ("dwell", lambda v: v.astype(np.float64), "'state/dwell' has dtype"),
    ("health", lambda v: np.concatenate([v, v]), "'state/health' has shape"),
    ("iv_active", lambda v: np.zeros((len(v), v.shape[1] + 2), v.dtype),
     "'state/iv_active' has shape"),
    ("tested", None, "'state/tested' is not in the checkpoint"),
], ids=["day-int32", "cumulative-int32", "health-int64", "dwell-f64", "two-scenarios",
        "iv-slots", "missing"])
def test_state_from_flat_refuses_another_dtype_or_shape(core, leaf, bad, match):
    """Every leaf comes back with init_state()'s dtype and shape, or the
    restore raises: nothing is cast (the reference's day and cumulative are
    int32, the port's int64)."""
    flat = _flat(core.init_state())
    if bad is None:
        del flat[f"state/{leaf}"]
    else:
        flat[f"state/{leaf}"] = bad(flat[f"state/{leaf}"])
    with pytest.raises(CheckpointCorruptionError, match=match):
        state_from_flat(flat, core.init_state())


def test_adopt_state_repads_a_person_axis_written_for_more_workers(core):
    """A state whose person leaves are padded for 3 workers restores and
    re-homes onto the core's one-worker axis, every real person kept; a
    state already in layout passes through untouched."""
    st = core.run_days(5)[0]
    P = core.pop.num_people
    flat = _flat(st)
    for f in ("health", "dwell", "vaccinated", "tested", "traced", "isolated_until"):
        v = flat[f"state/{f}"]
        flat[f"state/{f}"] = np.stack([
            repartition_person_array(v[i], P, 3, fill=v[i, -1]).reshape(-1) for i in range(len(v))])
        assert flat[f"state/{f}"].shape[-1] > P
    adopted = core.adopt_state(state_from_flat(flat, core.init_state()))
    for f, v in state_to_tree(st).items():
        got = getattr(adopted, f)
        assert got.dtype == v.dtype and torch.equal(got, v), f
    assert core.adopt_state(st).health is st.health


def test_fault_loop_recovers_bitwise(core, tmp_path):
    """The step loop around the port's engine: failures injected at days 5
    and 11 restore and replay, and the final state equals the
    uninterrupted run's."""
    mgr = CheckpointManager(str(tmp_path))
    state0 = core.init_state()
    mgr.save(0, {"state": state_to_tree(state0)}, blocking=True)
    failed = set()

    def injector(step):
        if step in (5, 11) and step not in failed:
            failed.add(step)
            raise RuntimeError(f"injected node failure at day {step}")

    def restore_fn():
        step = mgr.latest_step()
        return step, state_from_flat(mgr.restore_flat(step), core.init_state())

    loop = FaultTolerantLoop(
        lambda st: core.run_days(1, state=st)[0],
        lambda step, st: mgr.save(step, {"state": state_to_tree(st)}, blocking=True),
        restore_fn, FaultConfig(checkpoint_interval=4, max_restarts=5),
        fault_injector=injector)
    final_step, final = loop.run(state0, 0, 16)
    assert final_step == 16 and loop.stats.restarts == 2
    ref = core.run_days(16)[0]
    for f, v in state_to_tree(ref).items():
        assert torch.equal(getattr(final, f), v), f


# ---------------------------------------------------------------------------
# runtime/fault.py and runtime/elastic.py against the reference
# ---------------------------------------------------------------------------


def _drive(loop_cls, cfg_cls, fail_at, slow_at):
    """Both packages' loops on one numpy step: a counter vector that a
    failure rolls back to the last snapshot. Returns (final, stats dict)."""
    snaps = {0: np.zeros(3, np.int64)}
    failed = set()

    def step_fn(x):
        time.sleep(0.05 if int(x[0]) in slow_at else 0.001)
        return x + np.array([1, 2, 3])

    def injector(step):
        if step in fail_at and step not in failed:
            failed.add(step)
            raise RuntimeError(f"injected failure at step {step}")

    def restore_fn():
        s = max(snaps)
        return s, snaps[s].copy()

    loop = loop_cls(step_fn, lambda s, x: snaps.__setitem__(s, x.copy()), restore_fn,
                    cfg_cls(checkpoint_interval=4, max_restarts=5, straggler_window=10,
                            straggler_factor=3.0),
                    fault_injector=injector)
    step, final = loop.run(np.zeros(3, np.int64), 0, 30)
    return step, final, dataclasses.asdict(loop.stats)


def test_fault_loop_equals_the_reference():
    """The same step, failures and straggler through both loops: the same
    final state and the reference's LoopStats, straggler detected."""
    out = {name: _drive(loop, cfg, fail_at={5, 11, 22}, slow_at={25})
           for name, loop, cfg in (("port", FaultTolerantLoop, FaultConfig),
                                   ("ref", JLoop, JFaultConfig))}
    (ps, pf, pst), (js, jf, jst) = out["port"], out["ref"]
    assert ps == js == 30 and np.array_equal(pf, jf) and np.array_equal(pf, 30 * np.array([1, 2, 3]))
    for k in ("steps_run", "restarts", "checkpoints"):
        assert pst[k] == jst[k], k
    assert pst["restarts"] == 3 and len(pst["step_times"]) == len(jst["step_times"])
    assert pst["straggler_events"] >= 1 and jst["straggler_events"] >= 1


@pytest.mark.parametrize("old_w,new_w", [(1, 1), (1, 3), (2, 5), (3, 4), (4, 3), (5, 1), (7, 2)])
@pytest.mark.parametrize("P", [10, 23])
def test_elastic_helpers_equal_the_reference(P, old_w, new_w):
    assert plan_elastic_rescale(P, old_w, new_w) == j_plan(P, old_w, new_w)
    pw = -(-P // old_w)
    arr = np.random.default_rng(P).integers(0, 100, old_w * pw).reshape(old_w, pw)
    for fill in (0, -1):
        got = repartition_person_array(arr, P, new_w, fill=fill)
        want = np.asarray(j_repartition(arr, P, new_w, fill=fill))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    back = repartition_person_array(repartition_person_array(arr, P, new_w), P, old_w)
    np.testing.assert_array_equal(back.reshape(-1)[:P], arr.reshape(-1)[:P])
