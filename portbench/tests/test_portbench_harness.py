"""The harness: every cell found by name, the benchmark file within its
limits, the result line's keys, no JAX loaded, a tiny run on the CPU."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness, run
from portbench import twin as twin_lib

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[g]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_allowed_characters(group):
    for x in BENCH[group]:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
        if group == "metrics" or "better" in x:
            assert x["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in x:
                assert NAME.match(x[key])
        for key in x.get("reduced", []):
            assert NAME.match(key)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    w, config, traffic = harness.resolve(cell)
    assert config["name"] == w["config"]
    assert harness.loop(traffic).__name__ == "portbench." + traffic["kind"]
    for key in next(c for c in BENCH["configs"] if c["name"] == w["config"])["reduced"]:
        assert key in config["reduced"]
    reports = [m for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)]
    assert reports, "every cell reports a per-layer metric"
    e2e = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert {m["moves"] for m in reports} <= e2e


@pytest.mark.parametrize("metric", PER_LAYER)
def test_every_metric_has_a_reader(metric):
    path = os.path.join(harness.HERE, "metrics", metric + ".py")
    assert os.path.exists(path)
    assert harness.read_metric(metric, {"kind": "none", "trace": None}) is None


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_twin_holds_the_published_density(config):
    """The twin's visits a person a week and locations a person are those
    of the published twin the configuration names."""
    cfg = harness.load_json(harness.HERE, "configs", config + ".json")
    pub, params = cfg["published"], cfg["twin"]
    want_visits = pub["visits_per_week"] / pub["num_people"]
    want_locations = pub["num_locations"] / pub["num_people"]
    assert params["visits_per_person_week"] == pytest.approx(want_visits, rel=1e-3)
    assert params["locations_per_person"] == pytest.approx(want_locations, rel=1e-3)
    tw = twin_lib.generate(params, name=config)
    assert tw.visits_per_week / tw.num_people == pytest.approx(want_visits, rel=0.01)
    assert tw.num_locations / tw.num_people == pytest.approx(want_locations, rel=0.01)
    for key, cut in cfg["reduced"].items():
        assert pub[key] == cut["published"] and params[key] == cut["here"]


def test_config_files_are_the_benchmarks():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.load(open(os.path.join(harness.ROOT, c["file"])))["name"] == c["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_parses_with_the_result_keys(cell, tiny, capsys):
    out = run.main(["--workload", cell, "--seed", "2147483650", "--seconds", "4"],
                   device="cpu", hooks=tiny(cell))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    parsed = json.loads(line)
    assert parsed == out
    assert list(parsed) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert parsed["correct"] is True and parsed["failed"] == 0
    want = {m["name"] for m in harness.metric_names(cell, False)}
    assert set(parsed["metrics"]) == want
    for v in parsed["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(parsed["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_tiny_run_has_a_breakdown(tiny, capsys):
    cell = "md-covid.study-b256"
    out = run.main(["--workload", cell, "--seed", "3", "--seconds", "1", "--trace", "1"],
                   device="cpu", hooks=tiny(cell))
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["metrics"]) <= set(PER_LAYER)


def test_nothing_loaded_is_jax_or_the_jax_package():
    """A whole run in a fresh process, then its modules' top-level names."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{os.path.join(harness.ROOT, 'src')!r}, {harness.ROOT!r}]\n"
        "sys.path.insert(0, %r)\n" % os.path.dirname(__file__)
        + "from conftest import TINY_STUDY\n"
        "from portbench import run, harness\n"
        f"run.main(['--workload', {CELLS[0]!r}, '--seed', '5', '--seconds', '1'],"
        " device='cpu', hooks=TINY_STUDY)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps({'bad': harness.forbidden_modules(),"
        " 'torch_port': 'repro_torch' in tops}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "torch_port": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.api", sys)
    assert "repro" in harness.forbidden_modules()


def test_refuses_to_run_without_a_card():
    """The command exits with a non-zero code and prints no result line
    where no card is visible."""
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "portbench", "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "portbench", "run.py"), "--workload",
         CELLS[0], "--seed", "2147483651", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
