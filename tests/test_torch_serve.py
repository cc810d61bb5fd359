"""The port's serving tier, ``repro_torch.serve``, on the CPU.

* Against the reference's ``repro.serve``, held exactly: ``quantize_up`` on
  the lattice, ``compile_fingerprint`` and ``bucketize`` (the
  ``BucketKey`` as a dict), and the batcher's FIFO groups over one request
  sequence; a served result of the port against a served result of
  ``repro.serve.SimulationServer``, equal on every scenario-day before the
  scenario's first in-band decision (``test_torch_slice.py:_stepped``'s
  rule, as in ``test_torch_api.py``), with final attack rates within 5
  points.
* The port alone, the counterparts of ``tests/test_serve.py``: a served
  result bitwise equal to a solo ``repro_torch.api.run`` (history,
  observables, summaries), across padding amounts and for mixed requests
  in one dispatch; streamed chunks equal to the final history; zero runner
  builds after ``warm_up``; LRU eviction and rewarm; strict mode on a
  sentinel trip; background-thread serving; the HTTP front; and
  ``serve_sim --check --device cpu``.
* ``EngineCore.runner_fn`` on the CPU equal to ``run_days`` bitwise over
  three chunks, and the runner cache and sentinel.

On the card the runner is a captured CUDA graph: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phase 4f hold it there.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import serve as j_serve
from repro_torch import api as t_api
from repro_torch import serve as t_serve
from repro_torch.analysis.capture import recompile_sentinel
from repro_torch.configs import get_epidemic
from repro_torch.core import simulator
from repro_torch.engine.core import EngineCore, hist_to_numpy, tree_map
from repro_torch.launch import serve_sim

from test_torch_slice import _stepped


@pytest.fixture(scope="module")
def pop():
    return get_epidemic("twin-2k").build()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs several
    workers on the CPU at once; see test_torch_api.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(lib=t_api, **kw):
    base = dict(dataset="twin-2k", days=6, tau=2e-5,
                interventions=("none", "school-closure"), replicates=1)
    base.update(kw)
    return lib.ExperimentSpec(**base).validate()


def _server(pop, **cfg):
    """A CPU server with the test population pre-seeded."""
    server = t_serve.SimulationServer(t_serve.ServeConfig(**cfg), device="cpu")
    server._pops["twin-2k"] = pop
    return server


def _solo(spec, pop):
    return t_api.run(spec, population=pop, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _assert_result_equal(solo, served):
    """Bitwise equality of everything a client consumes. Provenance differs
    on purpose (``served_from``)."""
    assert solo.scenario_names == served.scenario_names
    assert set(solo.history) == set(served.history)
    for k in solo.history:
        np.testing.assert_array_equal(solo.history[k], served.history[k],
                                      err_msg=f"history[{k}]")
    assert sorted(solo.observables) == sorted(served.observables)
    for name in solo.observables:
        a, b = _leaves(solo.observables[name]), _leaves(served.observables[name])
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), name
    assert solo.summaries == served.summaries


# ---------------------------------------------------------------------------
# against the reference: lattice, buckets, fingerprints, batcher groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lattice", [(4, 8), (2, 4, 8), (16, 64, 256), (3,), (8, 2)])
def test_quantize_up_equals_the_reference(lattice):
    for value in range(1, 600, 7):
        assert t_serve.quantize_up(value, lattice) == j_serve.quantize_up(value, lattice)
    for lib in (t_serve, j_serve):
        with pytest.raises(ValueError):
            lib.quantize_up(0, lattice)


BUCKET_CASES = [
    {},
    dict(seed=99, tau=3e-5, replicates=2),
    dict(days=40),
    dict(interventions=("none",)),
    dict(interventions=("tti", "lockdown"), backend="pallas", static_network=True,
         block_size=64, replicates=3, seed_per_day=70),
    dict(tau_scales=(1.0, 0.8), replicates=5, backend="compact", seed_per_day=300),
]


@pytest.mark.parametrize("kw", BUCKET_CASES)
@pytest.mark.parametrize("cfg", [{}, dict(b_lattice=(2, 4, 8), chunk_days=3),
                                 dict(b_lattice=(16,), seed_lattice=(8,), chunk_days=7)])
def test_fingerprint_and_bucketize_equal_the_reference(kw, cfg):
    t, j = _spec(t_api, **kw), _spec(j_api, **kw)
    assert t.compile_fingerprint() == j.compile_fingerprint()
    ts = t_serve.bucketize(t, t_serve.ServeConfig(**cfg))
    js = j_serve.bucketize(j, j_serve.ServeConfig(**cfg))
    assert dataclasses.asdict(ts.bucket) == dataclasses.asdict(js.bucket)
    assert ts.bucket.label() == js.bucket.label()
    assert (ts.n_chunks, ts.b_request) == (js.n_chunks, js.b_request)


def test_batcher_groups_equal_the_reference():
    """One request sequence through both batchers: the same FIFO groups."""
    seq = [dict(seed=1), dict(seed=2), dict(seed=3, replicates=2), dict(seed=4, days=40),
           dict(seed=5, interventions=("none",)), dict(seed=6), dict(seed=7, days=40),
           dict(seed=8, replicates=3), dict(seed=9), dict(seed=10, interventions=("none",))]
    groups = {}
    for lib, api in ((t_serve, t_api), (j_serve, j_api)):
        cfg = lib.ServeConfig(b_lattice=(4, 8))
        batcher = lib.RequestBatcher()
        reqs = []
        for kw in seq:
            spec = _spec(api, **kw)
            reqs.append(lib.ServeRequest(spec, lib.bucketize(spec, cfg)))
            batcher.add(reqs[-1])
        out = []
        while group := batcher.take_group():
            out.append([reqs.index(r) for r in group])
        groups[lib] = out
    assert groups[t_serve] == groups[j_serve]
    assert len(groups[t_serve]) > 3


def test_served_result_matches_the_reference_server(pop):
    """The port's server (CPU) against the reference's, the same spec in a
    B = 4 bucket over 3-day chunks: each scenario's history equal before its
    first in-band decision, attack rates within 5 points."""
    days = 9
    kw = dict(days=days, interventions=("none", "vax-seniors"), replicates=2, seed=3)
    t = _server(pop, chunk_days=3, b_lattice=(4,)).run(_spec(t_api, **kw))
    jserver = j_serve.SimulationServer(j_serve.ServeConfig(chunk_days=3, b_lattice=(4,)))
    jserver._pops["twin-2k"] = pop
    j = jserver.run(_spec(j_api, backend="compact", **kw))
    assert t.scenario_names == j.scenario_names
    assert t.served_from.keys() == j.served_from.keys()
    for key in ("b_bucket", "slots", "slot_offset", "padded_days", "chunk_days"):
        assert t.served_from[key] == j.served_from[key], key
    compared = 0
    for i, scen in enumerate(_spec(t_api, **kw).build_batch()):
        _, band_day = _stepped(EngineCore(pop, [scen], device="cpu"), days)
        limit = days if band_day is None else band_day
        compared += limit
        for k in simulator.STAT_KEYS:
            np.testing.assert_array_equal(
                t.history[k][:limit, i], np.asarray(j.history[k][:limit, i], np.int64),
                err_msg=f"{scen.name} '{k}' before day {limit}")
        ar = [100.0 * r.history["cumulative"][-1, i] / pop.num_people for r in (t, j)]
        assert abs(ar[0] - ar[1]) <= 5.0, (scen.name, ar)
    assert compared >= days  # the band leaves something to compare


# ---------------------------------------------------------------------------
# the port alone: bucket normalization and the batcher
# ---------------------------------------------------------------------------


def test_quantize_up_lattice():
    assert t_serve.quantize_up(1, (4, 8)) == 4
    assert t_serve.quantize_up(4, (4, 8)) == 4
    assert t_serve.quantize_up(5, (4, 8)) == 8
    # beyond the lattice: next power of two, stable across nearby sizes
    assert t_serve.quantize_up(9, (4, 8)) == 16
    assert t_serve.quantize_up(16, (4, 8)) == 16
    with pytest.raises(ValueError):
        t_serve.quantize_up(0, (4,))


def test_bucketize_traced_values_share_buckets():
    cfg = t_serve.ServeConfig()
    a = t_serve.bucketize(_spec(seed=1), cfg)
    b = t_serve.bucketize(_spec(seed=99, tau=3e-5, replicates=2), cfg)
    # seeds/tau are tensors, replicates 1->2 stays under the width floor
    assert a.bucket == b.bucket
    assert a.b_request == 2 and b.b_request == 4
    # days is dispatch grouping, NOT executable identity
    c = t_serve.bucketize(_spec(days=40), cfg)
    assert c.bucket == a.bucket and c.n_chunks != a.n_chunks
    # the interventions *tuple* is executable identity (slot structure)
    d = t_serve.bucketize(_spec(interventions=("none",)), cfg)
    assert d.bucket != a.bucket


def test_bucketize_refuses_unservable_specs(pop):
    server = _server(pop)
    with pytest.raises(ValueError, match="checkpoint"):
        server.submit(_spec(checkpoint=t_api.CheckpointSpec(directory="/tmp/nope")))
    with pytest.raises(ValueError, match="engine"):
        server.submit(_spec(engine="ensemble"))
    assert server.metrics_dict()["requests"]["rejected"] == 2


@pytest.mark.parametrize("cfg", [dict(layout="workers"), dict(layout="hybrid"),
                                 dict(workers=2), dict(scen_shards=2)])
def test_serve_config_refuses_meshes(cfg):
    with pytest.raises(NotImplementedError, match="serving on a mesh is ROADMAP queue 1 item 8"):
        t_serve.ServeConfig(**cfg).validate()
    with pytest.raises(ValueError, match="unknown layout"):
        t_serve.ServeConfig(layout="no-such").validate()


def test_batcher_groups_fifo_by_shape_and_capacity():
    cfg = t_serve.ServeConfig(b_lattice=(4,))
    batcher = t_serve.RequestBatcher()
    req = lambda spec: t_serve.ServeRequest(spec, t_serve.bucketize(spec, cfg))
    r1 = req(_spec(seed=1))  # B=2
    r2 = req(_spec(seed=2))  # B=2, same bucket -> joins
    r3 = req(_spec(seed=3, replicates=2))  # B=4, no room -> next group
    r4 = req(_spec(seed=4, days=40))  # other chunk count -> own group
    for r in (r1, r2, r3, r4):
        batcher.add(r)
    assert batcher.take_group() == [r1, r2]
    assert batcher.take_group() == [r3]
    assert batcher.take_group() == [r4]
    assert batcher.take_group() == []


# ---------------------------------------------------------------------------
# the bitwise contract
# ---------------------------------------------------------------------------


def test_served_bitwise_equals_solo_run(pop):
    spec = _spec(seed=5)
    solo = _solo(spec, pop)
    served = _server(pop, chunk_days=4, b_lattice=(4,)).run(spec)
    _assert_result_equal(solo, served)
    sf = served.served_from
    assert sf["b_bucket"] == 4 and sf["slots"] == 2  # 2 real + 2 no-op pad
    assert sf["padded_days"] == 8 and spec.days == 6  # trimmed prefix
    assert served.provenance["jax_backend"] == "cpu"
    assert solo.served_from is None


def test_served_bitwise_across_padding_amounts(pop):
    """The same spec through buckets of different widths (different no-op
    padding) and chunk sizes: all bitwise equal to the solo run."""
    spec = _spec(seed=6)
    solo = _solo(spec, pop)
    for b_lattice, chunk_days in (((2,), 3), ((4,), 2), ((8,), 6)):
        served = _server(pop, chunk_days=chunk_days, b_lattice=b_lattice).run(spec)
        assert served.served_from["b_bucket"] == b_lattice[0]
        _assert_result_equal(solo, served)


def test_batched_mixed_requests_bitwise(pop):
    """Heterogeneous requests share one dispatch (one runner, packed
    scenario slots), and each comes back bitwise equal to its solo run."""
    s1 = _spec(seed=11)
    s2 = _spec(seed=42, tau=2.6e-5, replicates=2)  # B=4, other values
    solo1, solo2 = _solo(s1, pop), _solo(s2, pop)
    server = _server(pop, chunk_days=3, b_lattice=(8,))
    t1, t2 = server.submit(s1), server.submit(s2)
    server.drain()
    r1, r2 = t1.result(timeout=60), t2.result(timeout=60)
    assert r1.served_from["batch_requests"] == r2.served_from["batch_requests"] == 2
    assert r1.served_from["slot_offset"] == 0 and r2.served_from["slot_offset"] == 2
    assert server.metrics_dict()["batches"]["dispatched"] == 1
    _assert_result_equal(solo1, r1)
    _assert_result_equal(solo2, r2)


def test_streaming_chunks_match_final_history(pop):
    spec = _spec(seed=7, days=7)
    server = _server(pop, chunk_days=3, b_lattice=(2,))
    ticket = server.submit(spec)
    server.drain()
    chunks = list(ticket.stream(timeout=60))
    result = ticket.result(timeout=60)
    assert [c["day_start"] for c in chunks] == [0, 3, 6]
    assert sum(c["days"] for c in chunks) == spec.days  # trimmed last chunk
    for c in chunks:
        lo, hi = c["day_start"], c["day_start"] + c["days"]
        for k, v in c["stats"].items():
            np.testing.assert_array_equal(v, result.history[k][lo:hi])


# ---------------------------------------------------------------------------
# zero builds in steady state + the bucket budget
# ---------------------------------------------------------------------------


def test_zero_recompiles_after_warmup(pop):
    server = _server(pop, chunk_days=3, b_lattice=(4,))
    info = server.warm_up(_spec())
    assert not info["already_warm"]
    assert server.warm_up(_spec(seed=9))["already_warm"]
    for i, s in enumerate([
        _spec(seed=1), _spec(seed=2, tau=3e-5), _spec(seed=3, replicates=2),
        _spec(seed=4, days=9), _spec(seed=5, days=3),
    ]):
        served = server.run(s)
        assert served.served_from["warm"], f"request {i} missed the cache"
    ex = server.metrics_dict()["executables"]
    assert ex["recompile_violations"] == 0
    assert ex["cold_compiles"] == 1  # the warmup, nothing else
    assert ex["warm_dispatches"] == 5
    (bucket,) = [server._buckets.peek(k) for k in server._buckets]
    assert bucket.runner().cache_size() == 1  # one build, every dispatch after it


def test_bucket_lru_eviction_and_rewarm(pop):
    server = _server(pop, chunk_days=3, b_lattice=(2,), max_executables=1)
    a, b = _spec(seed=1), _spec(seed=2, interventions=("none",))
    server.run(a)  # cold: bucket A
    server.run(b)  # cold: bucket B evicts A
    stats = server.metrics_dict()["buckets"]
    assert stats["table"]["size"] == 1 and stats["table"]["evictions"] == 1
    assert len(stats["evicted"]) == 1
    served = server.run(a)  # A must build again
    assert not served.served_from["warm"]
    assert server.metrics_dict()["executables"]["cold_compiles"] == 3


def test_strict_mode_fails_on_sentinel_trip(pop, monkeypatch):
    """A steady-state build is a hard error under strict (the default) and
    a counted-but-served event otherwise."""
    from repro_torch.serve import server as server_mod

    class TrippingSentinel:
        def __init__(self, fn, allow=0):
            pass

        def __enter__(self):
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                raise AssertionError("recompile sentinel: runner cache grew")
            return False

    monkeypatch.setattr(server_mod.capture, "recompile_sentinel", TrippingSentinel)
    strict = _server(pop, chunk_days=3, b_lattice=(2,))
    strict.warm_up(_spec())
    with pytest.raises(t_serve.ServeError, match="recompile"):
        strict.run(_spec(seed=1))
    m = strict.metrics_dict()
    assert m["executables"]["recompile_violations"] == 1
    assert m["requests"]["failed"] == 1

    lax_srv = _server(pop, chunk_days=3, b_lattice=(2,), strict=False)
    lax_srv.warm_up(_spec())
    assert lax_srv.run(_spec(seed=1)) is not None  # served anyway, counted
    assert lax_srv.metrics_dict()["executables"]["recompile_violations"] == 1


def test_background_thread_serving(pop):
    """submit() under a running dispatch thread resolves tickets without an
    explicit drain."""
    server = _server(pop, chunk_days=3, b_lattice=(4,))
    server.warm_up(_spec())
    with server:
        tickets = [server.submit(_spec(seed=i + 1)) for i in range(4)]
        results = [t.result(timeout=120) for t in tickets]
    assert all(r.served_from["warm"] for r in results)
    m = server.metrics_dict()
    assert m["requests"]["completed"] == 4
    assert m["executables"]["recompile_violations"] == 0


# ---------------------------------------------------------------------------
# front ends: HTTP and the load generator
# ---------------------------------------------------------------------------


def test_http_front_run_and_metrics(pop):
    server = _server(pop, chunk_days=3, b_lattice=(2,))
    server.warm_up(_spec())
    httpd = serve_sim.make_http_server(server, 0)  # ephemeral port
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    server.start()
    try:
        spec = _spec(seed=8)
        solo = _solo(spec, pop)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/run", data=spec.to_json().encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            payload = json.load(resp)
        for k in solo.history:
            np.testing.assert_array_equal(solo.history[k], np.asarray(payload["history"][k]))
        assert payload["provenance"]["served_from"]["warm"]

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            metrics = json.load(resp)
        assert metrics["requests"]["completed"] == 1
        assert metrics["executables"]["recompile_violations"] == 0

        bad = urllib.request.Request(f"http://127.0.0.1:{port}/run",
                                     data=json.dumps({"dataset": "no-such"}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()


def test_serve_sim_check_on_the_cpu(capsys):
    serve_sim.main(["--dataset", "twin-2k", "--days", "4", "--requests", "4",
                    "--concurrency", "2", "--chunk-days", "2", "--check",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "check OK" in out
    report = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert report["requests"]["completed"] == 4
    assert report["executables"]["recompile_violations"] == 0


# ---------------------------------------------------------------------------
# the engine's runner cache
# ---------------------------------------------------------------------------


def test_runner_fn_equals_run_days_over_three_chunks(pop):
    """Three calls of one 3-day runner, each from the last one's final
    state, equal one 9-day eager run bitwise (history and final state)."""
    batch = _spec(interventions=("none", "lockdown", "tti"), replicates=1).build_batch()
    core = EngineCore(pop, batch, device="cpu")
    final, _, hist, _ = core.run_days(9)
    runner = core.runner_fn(3)
    state, hists = core.init_state(), []
    for _ in range(3):
        state, _, h, _ = runner(core.params, state)
        hists.append(h)
    assert runner.cache_size() == 1
    assert torch.equal(torch.cat(hists), hist)
    same = tree_map(lambda a, b: torch.equal(a, b), final, state)
    assert all(dataclasses.asdict(same).values())
    assert hist_to_numpy(hist)["tests_used"].sum() > 0  # the TTI slot ran


def test_runner_cache_bounded_lru_and_sentinel(pop):
    core = EngineCore(pop, _spec(replicates=2).build_batch(), device="cpu",
                      max_runners=2)  # B = 4
    params, state = core.params, core.init_state()
    r1 = core.runner_fn(1)
    assert not core.runner_cached(1)  # resident, not built yet
    r1(params, state)
    core.runner_fn(2)(params, state)
    assert core.runner_cached(1) and core.runner_cached(2)
    assert core.runner_fn(1) is r1  # a recency-bumping hit
    core.runner_fn(3)  # evicts (2,), the least recently used
    assert core.runner_cached(1) and not core.runner_cached(2)
    stats = core.runner_cache_stats()
    assert stats["size"] == 2 and stats["max_entries"] == 2
    assert stats["evictions"] == 1 and stats["hits"] == 1

    with recompile_sentinel(r1):
        r1(params, state)
        r1(params, core.init_state())
    first = lambda n: (tree_map(lambda t: t[:n], params), tree_map(lambda t: t[:n], state))
    with pytest.raises(AssertionError, match="recompile sentinel"):
        with recompile_sentinel(r1):
            r1(*first(2))  # a new shape: a build
    assert r1.cache_size() == 2
    with recompile_sentinel(r1, allow=1):
        r1(*first(1))
    assert r1.cache_size() == 3
    bench = core.bench_fn(2)
    assert int(bench()[0]) == 2
