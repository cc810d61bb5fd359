"""The port's spans (``repro_torch.runtime.spans``): off without a profiler
(the shared null context, no ``record_function``, no CUDA event, the same
history), on under ``torch.profiler`` (the names on the profiler's
timeline, nested as the code nests them, with the counts and host times the
profiler keeps), and nothing recorded on a thread the profiler was not
started on. The ``gpu``-marked tests run on the card: the day's spans
mirrored onto the device's timeline with no device operation added, and a
warmed server bucket capturing as many graphs under the profiler as without.

    PYTHONPATH=src python -m pytest -q tests/test_torch_spans.py
"""

import collections
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api
from repro_torch.configs import get_epidemic
from repro_torch.runtime import spans

DAYS = 5
#: Each span's nearest enclosing span in an ``api.run`` of a classic preset
#: (None: the run's top level). ``rng.hash`` sits in every phase that draws;
#: in ``day.interactions`` only on the CPU, whose plain pass hashes each pair.
PARENTS = {
    "run.batch": {None}, "run.params": {None}, "week": {None}, "run.days": {None},
    "run.finalize": {None},
    "week.pack": {"week"}, "week.schedule": {"week"}, "week.stack": {"week"},
    "week.slot_table": {"week"}, "week.upload": {"week"},
    "day": {"run.days"}, "run.host_copy": {"run.days"},
    **{f"day.{p}": {"day"} for p in ("interventions", "dispatch", "interactions", "combine",
                                     "infect", "seed", "health", "stats", "observe")},
    "rng.hash": {"day.interventions", "day.interactions", "day.infect", "day.seed",
                 "day.health"},
}
#: Each name's children whose host time it holds.
CHILDREN = {
    "week": ("week.pack", "week.schedule", "week.stack", "week.slot_table", "week.upload"),
    "day": tuple(n for n in PARENTS if n.startswith("day.")),
    "run.days": ("day", "run.host_copy"),
}


@pytest.fixture(scope="module")
def pop():
    return get_epidemic("twin-2k").build()


def _spec(**kw):
    return api.ExperimentSpec(days=DAYS, replicates=2, tau=4e-5,
                              interventions=("none", "lockdown"), **kw)


def _profiled(spec, pop, device="cpu"):
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=activities) as prof:
        res = api.run(spec, population=pop, device=device)
    return res, prof


@pytest.fixture(scope="module")
def traced(pop):
    return _profiled(_spec(), pop)


def _spans(prof):
    """The profiler's host events of the spans (on a CUDA run the profiler
    also mirrors each onto the device's timeline)."""
    return [ev for ev in prof.events()
            if ev.name in PARENTS and ev.device_type == torch.autograd.DeviceType.CPU]


def _count(prof):
    return collections.Counter(ev.name for ev in _spans(prof))


def _host_us(prof):
    total = collections.Counter()
    for ev in _spans(prof):
        total[ev.name] += ev.time_range.elapsed_us()
    return total


def _enclosing(ev, names):
    p = ev.cpu_parent
    while p is not None and p.name not in names:
        p = p.cpu_parent
    return None if p is None else p.name


def test_off_without_a_profiler_and_the_same_history(pop, traced):
    assert not torch.autograd._profiler_enabled()
    res = api.run(_spec(), population=pop, device="cpu")
    on, _ = traced
    assert set(res.history) == set(on.history)
    for k in res.history:
        np.testing.assert_array_equal(res.history[k], on.history[k])
        assert res.history[k].dtype == on.history[k].dtype


def test_off_creates_no_record_function_and_no_event(pop, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("created while no profiler is on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert spans.span("a") is spans.span("b")
    res = api.run(_spec(), population=pop, device="cpu")
    assert res.history["new_infections"].shape == (DAYS, 4)


def test_on_names_nest_as_the_code_does(traced):
    _, prof = traced
    seen = _count(prof)
    assert set(seen) == set(PARENTS)
    for ev in _spans(prof):
        parent = _enclosing(ev, PARENTS)
        assert parent in PARENTS[ev.name], (ev.name, parent)


def test_on_counts_a_day_a_week_build_and_four_hashes_a_day(traced):
    _, prof = traced
    n = _count(prof)
    assert n["day"] == DAYS
    assert all(n[c] == DAYS for c in CHILDREN["day"])
    assert n["week"] == n["week.upload"] == 1 and n["week.schedule"] == 14
    assert n["run.days"] == n["run.batch"] == n["run.params"] == n["run.finalize"] == 1
    outside = [ev for ev in prof.events() if ev.name == "rng.hash"
               and _enclosing(ev, PARENTS) != "day.interactions"]
    assert len(outside) == 4 * DAYS  # infection, seed choice, transition, dwell


def test_on_parents_hold_their_childrens_host_time(traced):
    host = _host_us(traced[1])
    for parent, children in CHILDREN.items():
        assert host[parent] >= sum(host[c] for c in children), parent
    assert sum(host[n] for n in PARENTS["rng.hash"]) >= host["rng.hash"]
    assert all(host[n] > 0 for n in PARENTS)


def test_a_thread_without_a_recorder_records_nothing():
    """The profiler records on the thread it was started on; another thread
    (the server's dispatch thread) gets the null context."""
    got = {}

    def other():
        got["span"] = spans.span("elsewhere")
        with got["span"]:
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("here"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    assert got["span"] is spans.span("elsewhere")  # the shared null context
    names = {ev.name for ev in prof.events()}
    assert "here" in names and "elsewhere" not in names


def test_recordings_nest_and_restore():
    """Spans nest under the profiler, and are the null context again once
    it stops."""
    off = spans.span("z")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.span("x") is not off
        with spans.span("x"):
            with spans.span("y"):
                pass
    assert spans.span("w") is off
    (y,) = [ev for ev in prof.events() if ev.name == "y"]
    assert y.cpu_parent is not None and y.cpu_parent.name == "x"


# ---- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device's timeline is the card's")
    return torch.device("cuda")


def _device_events(prof):
    """(annotations, operations): the spans mirrored onto the device's
    timeline by name, with their device seconds; the device's kernels,
    copies and fills."""
    marks, ops = collections.defaultdict(list), []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            if ev.name() in PARENTS:
                marks[ev.name()].append(ev.duration_ns() / 1e9)
            else:
                ops.append(ev.name())
    return marks, ops


@pytest.mark.gpu
def test_device_times_on_the_card(cuda, pop, monkeypatch):
    api.run(_spec(), population=pop, device="cuda")  # the kernels' build
    res, prof = _profiled(_spec(), pop, device="cuda")
    marks, ops = _device_events(prof)
    for n in ("day", "rng.hash", *CHILDREN["day"]):
        assert marks[n] and sum(marks[n]) > 0, n
    assert _count(prof)["rng.hash"] == 4 * DAYS  # the kernel hashes its own pairs
    assert sum(marks["rng.hash"]) <= sum(marks["day"])
    # the spans add no device operation
    monkeypatch.setattr(spans, "_profiling", lambda: False)
    bare, bare_prof = _profiled(_spec(), pop, device="cuda")
    assert not _count(bare_prof)
    assert collections.Counter(_device_events(bare_prof)[1]) == collections.Counter(ops)
    plain = api.run(_spec(), population=pop, device="cuda")
    for k in plain.history:
        np.testing.assert_array_equal(plain.history[k], res.history[k])
        np.testing.assert_array_equal(plain.history[k], bare.history[k])


@pytest.mark.gpu
def test_a_warmed_bucket_captures_as_many_graphs_under_the_profiler(cuda, pop):
    from repro_torch.engine import EngineCore
    from repro_torch.serve import ServeConfig, SimulationServer

    def warm(profiled):
        server = SimulationServer(ServeConfig(chunk_days=4, b_lattice=(8,)))
        server._pops["twin-2k"] = pop
        spec = api.ExperimentSpec(dataset="twin-2k", days=8, tau=2e-5)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                server.warm_up(spec)
        else:
            server.warm_up(spec)
        (key,) = list(server._buckets)
        return len(server._buckets.peek(key).runner().builds())

    assert warm(True) == warm(False) == 1
    # spans inside a capture stay on the host, and replays stay whole
    core = EngineCore(pop, _spec().build_batch(), device=cuda)
    eager = core.run_days(4)[2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner = core.runner_fn(4)
        hist = runner(core.params, core.init_state())[2]
        torch.cuda.synchronize()
    assert runner.cache_size() == 1 and torch.equal(hist, eager)
    assert _count(prof)["day"] == 8  # the eager warm-up's 4 and the capture's 4
