"""detlint for the port (``repro_torch.analysis.lint``) and its Level-2
dispatch helpers (``repro_torch.analysis.dispatch``), against the bar of the
reference's ``tests/test_detlint.py``: a bad and a good snippet per rule
(kept here as strings and written to ``tmp_path``), pragmas in Python and
CUDA, baselines, the JSON report, the CLI's exit codes and relax profiles,
the port's own tree clean with no baseline, and no float64 op in a day of
either interaction route.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis.dispatch import assert_no_f64, collective_count, find_f64
from repro_torch.analysis.lint import (
    LintConfig,
    apply_baseline,
    load_baseline,
    render_json,
    rule_catalog,
    run_lint,
    write_baseline,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RULES = tuple(sorted(rule_catalog()))

#: DET002's bad snippet cross-checks against a declared registry.
TEST_STREAMS = {"CONTACT": 0x01, "INFECT": 0x02, "DWELL": 0x04}

# ---------------------------------------------------------------------------
# the rule corpus: {rule: (bad files, good files)}, each {name: source}
# ---------------------------------------------------------------------------

CORPUS = {
    "DET001": ({"det001_bad.py": """\
        import random
        import numpy as np
        import torch

        def draw(n):
            a = torch.rand(n)
            b = torch.randn(n, 3)
            g = torch.Generator()
            torch.manual_seed(0)
            x = torch.zeros(n, dtype=torch.float32).uniform_()
            return a, b, g, x, np.random.default_rng(0).random(n), random.random()
        """}, {"det001_good.py": """\
        import torch
        from repro_torch.core import rng

        def draw(seed, day, pid):
            g = None  # type: torch.Generator
            return rng.uniform(seed, rng.INFECT, day, pid), g
        """}),
    "DET002": ({"det002_bad.py": """\
        from repro_torch.core import rng

        def draws(seed, day, pid):
            a = rng.uniform(seed, 0x09, day, pid)
            b = rng.uniform(seed)
            c = rng.uniform(seed, rng.UNREGISTERED, day, pid)
            return a, b, c
        """}, {"det002_good.py": """\
        from repro_torch.core import rng

        def draws(seed, day, pid, cum):
            a = rng.uniform(seed, rng.INFECT, day, pid)
            b = rng.np_uniform(seed, int(rng.CONTACT), day, pid)
            c = rng.categorical(cum, seed, rng.DWELL, day, pid)
            return a, b, c
        """}),
    "DET003": ({"det003_bad.py": """\
        import torch

        def build(n):
            a = torch.zeros(n)
            b = torch.full((n,), 0.5)
            c = torch.tensor([0.5, 1.0])
            d = torch.arange(0.0, 1.0, 0.25)
            e = torch.linspace(0, 1, n)
            return a, b, c, d, e
        """}, {"det003_good.py": """\
        import numpy as np
        import torch

        def build(n, x):
            a = torch.zeros(n, dtype=torch.float32)
            b = torch.full((n,), 0.5, dtype=torch.float32)
            c = torch.tensor([0.5, 1.0], dtype=torch.float32)
            d = torch.arange(n)
            e = torch.zeros_like(x)
            f = torch.as_tensor(np.zeros(3, np.float32))
            g = torch.tensor([1, 2])
            return a, b, c, d, e, f, g
        """}),
    "DET004": ({"det004_bad.py": """\
        import torch
        import torch.distributed as dist

        def day_totals(contacts, group, topo):
            total = contacts.sum(dtype=torch.int32)
            dist.all_reduce(total, group=group)
            n = contacts.sum().to(torch.int32)
            dist.all_reduce(n)
            return total, n, topo.psum(contacts.sum().int())
        """}, {"det004_good.py": """\
        import torch
        import torch.distributed as dist

        def day_totals(contacts, infected, group, topo):
            total = contacts.sum()
            dist.all_reduce(total, group=group)
            k = (infected > 0).sum(dtype=torch.int32)
            dist.all_reduce(k)
            return topo.psum({"n": total}), k
        """}),
    "DET005": ({"scatter.cu": """\
        __global__ void scatter(const int* idx, const float* val, float* out, int n) {
          int i = blockIdx.x * blockDim.x + threadIdx.x;
          if (i < n) atomicAdd(&out[idx[i]], val[i]);
          if (i < n) out[i] = __expf(val[i]);
        }
        __device__ float cas_add(float* addr, float v) {
          unsigned int* p = (unsigned int*)addr;
          unsigned int old = *p, assumed;
          do {
            assumed = old;
            old = atomicCAS(p, assumed, __float_as_uint(v + __uint_as_float(assumed)));
          } while (assumed != old);
          return __uint_as_float(old);
        }
        """, "det005_bad.py": """\
        import torch
        from repro_torch.kernels import build as build_lib

        NVCC_FLAGS = (*build_lib.BASE_FLAGS, "--use_fast_math")

        def launch(n, device):
            out = torch.empty((n,), dtype=torch.float32, device=device)
            build_lib.build("scatter.cu", NVCC_FLAGS)
            return out
        """}, {"count.cu": """\
        // one integer atomic per thread; not __expf: the plain version's exp
        __global__ void count(const int* idx, unsigned long long* edges, float* out, int n) {
          int i = blockIdx.x * blockDim.x + threadIdx.x;
          if (i < n) atomicAdd(edges, 1ull);
          if (i < n) out[i] = expf(__fmul_rn(2.0f, (float)idx[i]));
        }
        """, "det005_good.py": """\
        import torch
        from repro_torch.kernels import build as build_lib

        NVCC_FLAGS = (*build_lib.BASE_FLAGS, "--fmad=false")

        def launch(n, device):
            out = torch.zeros((n,), dtype=torch.float32, device=device)
            build_lib.build("count.cu", NVCC_FLAGS)
            return out
        """}),
    "DET006": ({"det006_bad.py": """\
        import os
        import time

        from repro_torch.engine.runner import DayRunner

        def day_step(state, params):
            t0 = time.perf_counter()
            if os.environ.get("FAST"):
                state = state + 1
            for k in {"a", "b"}:
                state = state + len(k)
            return state, t0, hash("x") + id(state)

        def make_runner():
            def loop(params, state):
                return state, time.time()
            return DayRunner(loop, "cpu")
        """}, {"det006_good.py": """\
        import time

        def day_step(state, params):
            for k in sorted({"a", "b"}):
                state = state + len(k)
            return state

        def host_build():
            return time.perf_counter()
        """}),
}

#: how many findings each bad snippet gives
BAD_COUNTS = {"DET001": 8, "DET002": 3, "DET003": 5, "DET004": 3, "DET005": 6, "DET006": 6}


def _write(root, files):
    for name, src in files.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def lint_paths(paths, **kw):
    findings, errors = run_lint([str(p) for p in paths], LintConfig(**kw))
    assert not errors, errors
    return findings


def lint_snippet(tmp_path, rule, which, **kw):
    root = tmp_path / f"{rule.lower()}_{which}"
    _write(root, CORPUS[rule][0 if which == "bad" else 1])
    return lint_paths([root], **kw)


def test_rule_catalog_is_the_det_family():
    assert RULES == ("DET001", "DET002", "DET003", "DET004", "DET005", "DET006")


@pytest.mark.parametrize("rule", RULES)
def test_bad_snippet_triggers_exactly_its_rule(tmp_path, rule):
    findings = lint_snippet(tmp_path, rule, "bad", streams=TEST_STREAMS)
    assert findings, f"{rule} bad snippet produced no findings"
    assert {f.rule for f in findings} == {rule}, findings
    assert len(findings) == BAD_COUNTS[rule], findings


@pytest.mark.parametrize("rule", RULES)
def test_good_snippet_is_clean(tmp_path, rule):
    assert lint_snippet(tmp_path, rule, "good", streams=TEST_STREAMS) == []


def test_det002_registry_modes(tmp_path):
    # Without a registry the literal/missing-arg findings still fire, but
    # the undeclared-constant check (needs the declared set) stays quiet.
    assert len(lint_snippet(tmp_path, "DET002", "bad", streams={})) == 2
    full = lint_snippet(tmp_path, "DET002", "bad", streams=TEST_STREAMS)
    assert len(full) == 3 and any("UNREGISTERED" in f.message for f in full)


def test_det002_scrapes_the_port_registry_and_flags_duplicate_ids(tmp_path):
    _write(tmp_path, {"core/rng.py": """\
        CONTACT = 0x01
        INFECT = 0x01
        _PRIVATE = 0x01
        """, "use.py": """\
        from repro_torch.core import rng

        def f(seed, day, pid):
            return rng.uniform(seed, rng.DWELL, day, pid)
        """})
    findings = lint_paths([tmp_path])
    assert [f.rule for f in findings] == ["DET002", "DET002"]
    dup, undeclared = sorted(findings, key=lambda f: f.path)
    assert "CONTACT" in dup.message and "INFECT" in dup.message
    assert "_PRIVATE" not in dup.message  # underscore names are not streams
    assert "'DWELL'" in undeclared.message  # checked against the scraped registry


def test_det005_reads_only_code_in_cuda_sources(tmp_path):
    _write(tmp_path, {"k.cu": """\
        /* __expf( in a block comment, atomicAdd(&f, 1.0f) too */
        const char* s = "__logf(";
        __global__ void k(float* out) { out[0] = 0.0f; }
        """})
    assert lint_paths([tmp_path]) == []


# ---------------------------------------------------------------------------
# pragmas
# ---------------------------------------------------------------------------


def _lint_source(tmp_path, source, name="snippet.py", **kw):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return lint_paths([p], **kw)


def test_pragma_same_line(tmp_path):
    assert _lint_source(tmp_path, """\
        import random  # detlint: ignore[DET001] — test fixture
    """) == []


def test_pragma_comment_line_above(tmp_path):
    assert _lint_source(tmp_path, """\
        # detlint: ignore[DET001] — host-side helper
        import random
    """) == []


def test_pragma_multi_comment_justification(tmp_path):
    assert _lint_source(tmp_path, """\
        # detlint: ignore[DET001] — host-side builder: deterministic
        # via the explicit seed; draws no simulation randomness.
        import random
    """) == []


def test_pragma_wildcard_and_wrong_rule(tmp_path):
    assert _lint_source(tmp_path, """\
        import random  # detlint: ignore[*]
    """) == []
    findings = _lint_source(tmp_path, """\
        import random  # detlint: ignore[DET003]
    """)
    assert [f.rule for f in findings] == ["DET001"]


def test_pragma_skip_file(tmp_path):
    assert _lint_source(tmp_path, """\
        # detlint: skip-file — generated fixture
        import random
        import torch
        x = torch.zeros(4)
    """) == []


def test_cuda_pragmas(tmp_path):
    src = """\
        __global__ void k(const float* v, float* out) {
          // detlint: ignore[DET005] — a test of the pragma
          out[0] = __expf(v[0]);
          out[1] = __logf(v[1]);  // detlint: ignore[DET005]
          out[2] = __powf(v[2], 2.0f);
        }
        """
    findings = _lint_source(tmp_path, src, name="k.cu")
    assert [(f.rule, f.line) for f in findings] == [("DET005", 5)]
    assert _lint_source(tmp_path, "// detlint: skip-file\n" + textwrap.dedent(src),
                        name="k.cu") == []


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    findings = lint_snippet(tmp_path, "DET001", "bad")
    bl_path = tmp_path / "baseline.json"
    write_baseline(str(bl_path), findings)
    new, suppressed = apply_baseline(findings, load_baseline(str(bl_path)))
    assert new == [] and len(suppressed) == len(findings)


def test_baseline_keys_are_line_number_free(tmp_path):
    findings = lint_snippet(tmp_path, "DET001", "bad")
    bl_path = tmp_path / "baseline.json"
    write_baseline(str(bl_path), findings)
    data = json.loads(bl_path.read_text())
    assert data["version"] == 1
    for key in data["suppress"]:
        rule, path, _ = key.split("::", 2)
        assert rule in RULES and path.endswith("det001_bad.py")
    # moving the code down a few lines keeps every key
    p = tmp_path / "det001_bad" / "det001_bad.py"
    p.write_text("\n\n\n" + p.read_text())
    moved = lint_paths([p])
    new, suppressed = apply_baseline(moved, load_baseline(str(bl_path)))
    assert new == [] and len(suppressed) == len(findings)


def test_baseline_catches_new_findings(tmp_path):
    f1 = lint_snippet(tmp_path, "DET001", "bad")
    bl_path = tmp_path / "baseline.json"
    write_baseline(str(bl_path), f1[:1])
    new, suppressed = apply_baseline(f1, load_baseline(str(bl_path)))
    assert len(suppressed) == 1 and len(new) == len(f1) - 1


def test_baseline_missing_file_is_empty():
    assert load_baseline(None) == {}
    assert load_baseline("/nonexistent/baseline.json") == {}


def test_baseline_rejects_foreign_json(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"not": "a baseline"}')
    with pytest.raises(ValueError):
        load_baseline(str(p))


# ---------------------------------------------------------------------------
# JSON report + CLI contract
# ---------------------------------------------------------------------------


def test_json_report_schema(tmp_path):
    findings = lint_snippet(tmp_path, "DET003", "bad")
    report = render_json(findings, [], [])
    assert set(report) == {"version", "tool", "findings", "suppressed", "errors", "counts",
                           "exit_code"}
    assert report["tool"] == "detlint" and report["version"] == 1
    assert report["exit_code"] == 1
    assert report["counts"] == {"DET003": len(findings)}
    for f in report["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message"}
    assert render_json([], [], [])["exit_code"] == 0


def _run_cli(*args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_cli_exit_codes(tmp_path):
    _write(tmp_path / "bad", CORPUS["DET006"][0])
    _write(tmp_path / "good", CORPUS["DET006"][1])
    assert _run_cli(str(tmp_path / "bad")).returncode == 1
    assert _run_cli(str(tmp_path / "good")).returncode == 0
    assert _run_cli().returncode == 2  # no paths
    assert _run_cli("--rules", "DET999", str(tmp_path / "good")).returncode == 2


def test_cli_list_rules():
    res = _run_cli("--list-rules")
    assert res.returncode == 0
    for rule in RULES:
        assert rule in res.stdout


def test_cli_json_and_baseline_workflow(tmp_path):
    _write(tmp_path / "src", CORPUS["DET004"][0])
    bad = str(tmp_path / "src")
    report_path = tmp_path / "report.json"
    res = _run_cli(bad, "--json", str(report_path))
    assert res.returncode == 1
    report = json.loads(report_path.read_text())
    assert report["counts"] == {"DET004": 3}
    bl = tmp_path / "baseline.json"
    assert _run_cli(bad, "--write-baseline", str(bl)).returncode == 0
    assert _run_cli(bad, "--baseline", str(bl)).returncode == 0


# ---------------------------------------------------------------------------
# the port's own tree is clean, with no baseline
# ---------------------------------------------------------------------------


def test_port_tree_is_detlint_clean():
    findings, errors = run_lint([os.path.join(REPO, "src", "repro_torch"),
                                 os.path.join(REPO, "chip_smoke.py")], LintConfig())
    assert not errors, errors
    assert findings == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in findings)


def test_cli_on_the_port_tree_exits_0_with_no_baseline():
    res = _run_cli("src/repro_torch", "chip_smoke.py")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "detlint: 0 finding(s)" in res.stdout


def test_port_tree_reads_both_languages():
    """The walk takes the CUDA sources with the Python ones: a fast-math
    intrinsic added to a copy of the interaction kernel is found."""
    src = open(os.path.join(REPO, "src", "repro_torch", "csrc", "interactions.cu")).read()
    assert "__expf" not in src
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "interactions.cu"), "w") as f:
            f.write(src + "\n__device__ float f(float x) { return __expf(x); }\n")
        findings, _ = run_lint([d], LintConfig())
    assert [f.rule for f in findings] == ["DET005"]


# ---------------------------------------------------------------------------
# per-directory relax profiles
# ---------------------------------------------------------------------------


def test_relax_drops_rule_under_prefix_only(tmp_path):
    for sub in ("tests", "src"):
        d = tmp_path / sub
        d.mkdir()
        (d / "mod.py").write_text("import random\n")
    findings = lint_paths([tmp_path], relax=((f"{tmp_path}/tests/", ("DET001",)),))
    assert [f.rule for f in findings] == ["DET001"]
    assert findings[0].path.endswith("src/mod.py")


def test_relax_is_per_rule_not_blanket(tmp_path):
    d = tmp_path / "tests"
    d.mkdir()
    (d / "mod.py").write_text("import random\nimport torch\nx = torch.zeros(4)\n")
    findings = lint_paths([tmp_path], relax=((f"{tmp_path}/tests/", ("DET001",)),))
    assert [f.rule for f in findings] == ["DET003"]
    assert lint_paths([tmp_path], relax=((f"{tmp_path}/tests/", ("*",)),)) == []


def test_cli_relax_flag(tmp_path):
    d = tmp_path / "tests"
    d.mkdir()
    (d / "mod.py").write_text("import random\n")
    target = str(tmp_path)
    assert _run_cli(target).returncode == 1
    assert _run_cli("--relax", f"{target}/:DET001", target).returncode == 0
    assert _run_cli("--relax", "no-colon", target).returncode == 2
    assert _run_cli("--relax", "tests/:DET999", target).returncode == 2


# ---------------------------------------------------------------------------
# Level 2: the dispatch helpers
# ---------------------------------------------------------------------------


def test_find_f64_clean_on_pinned_fn():
    def f(x):
        for _ in range(3):
            x = x * torch.tensor(1.5, dtype=torch.float32) + 0.25
        return x.sum()

    assert find_f64(f, torch.ones(4, dtype=torch.float32)) == []
    assert_no_f64(f, torch.ones(4, dtype=torch.float32))


def test_find_f64_catches_promotion_leak():
    def leaky(x):
        return x * torch.from_numpy(np.array([2.0]))  # a float64 numpy array

    leaks = find_f64(leaky, torch.ones(4, dtype=torch.float32))
    assert leaks and all(d == "float64" for _, _, d in leaks)
    assert any("mul" in op for op, _, _ in leaks)
    with pytest.raises(AssertionError, match="f64 leak"):
        assert_no_f64(leaky, torch.ones(4, dtype=torch.float32))


def test_find_f64_catches_a_changed_default_dtype():
    """DET003's bug class at run time: an unpinned constructor after
    ``torch.set_default_dtype(torch.float64)``."""
    def build(n):
        return torch.zeros(n) + torch.ones(n, dtype=torch.float32)

    was = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        leaks = find_f64(build, 3)
    finally:
        torch.set_default_dtype(was)
    assert {op.split(".")[1] for op, _, _ in leaks} >= {"zeros", "add"}
    assert find_f64(build, 3) == []


def test_find_f64_sees_ops_inside_a_loop_body():
    def f(x):
        for i in range(4):
            x = x + (x.double() if i == 2 else x) * 0  # f64 only on one trip
        return x

    leaks = find_f64(f, torch.ones(3, dtype=torch.float32))
    assert leaks and {d for _, _, d in leaks} == {"float64"}


def test_collective_count_reads_the_topology_counters():
    from repro_torch.engine.topology import LocalTopology

    class Counted:  # a mesh topology's counter surface
        def __init__(self):
            import collections

            self.counts = collections.Counter({"all_gather": 5})

        def psum(self):
            self.counts["all_reduce"] += 1

    topo = Counted()
    assert collective_count(topo, lambda: (topo.psum(), topo.psum())) == {"all_reduce": 2}
    assert collective_count(LocalTopology(), lambda: None) == {}


@pytest.fixture(scope="module")
def tiny_pop():
    from repro_torch.data import digital_twin_population

    return digital_twin_population(300, seed=7, name="detlint-x64")


@pytest.mark.parametrize("preset", ["none", "tti"])
@pytest.mark.parametrize("backend", ["pallas-compact", "pallas"])
def test_day_step_has_no_f64_ops(tiny_pop, backend, preset):
    from repro_torch import api
    from repro_torch.engine import day as day_lib
    from repro_torch.engine.core import EngineCore

    batch = api.ExperimentSpec(dataset="twin-2k", tau=2e-5, interventions=(preset,),
                               replicates=2).build_batch()
    core = EngineCore(tiny_pop, batch, device="cpu", backend=backend)
    state = core.run_days(4)[0]  # a few days in: infections under way
    assert_no_f64(day_lib.day_step, core.topo, core.static, core.week, core.params, state)
