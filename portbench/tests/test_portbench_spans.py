"""The readers of the program's spans: each on a synthetic run with its span
on the trace's host timeline, without it, and without a trace; the day
loop's idle share with busy intervals across the ``run.days`` edges, over
the untraced loop's length; a tiny traced study on the CPU, whose trace
carries the host spans and no device operation."""

import pytest

from portbench import harness, run
from portbench.trace import Slice

READERS = ["week_build_s.study", "day_loop_idle_share.study"]
DAYS = 200
#: the untraced studies' day loop, s; the trace's clock is in ns
LOOP_S = 1e-6


def _trace(device=(), host=()):
    t = Slice("study")
    t.device, t.host, t.window_s = list(device), list(host), 1.0
    return t


def _run(trace=True, untraced=1, **kw):
    studies = [{"wall_s": 5.0, "run_wall_s": 4.0}]
    studies += [{"wall_s": 5.0, "run_wall_s": LOOP_S}] * untraced
    return {"kind": "study", "studies": studies, "days": DAYS, "scenarios": 256,
            "trace": _trace(**kw) if trace else None}


HOST = [(0, 3000, "api.run"), (10, 90, "week"), (20, 60, "week.pack"),
        (100, 1100, "run.days"), (150, 160, "day")]
DEVICE = [(50, 200, "a"),  # straddles the loop's start: 100 of it inside
          (150, 300, "b"),  # overlaps a: the union counts 100..300
          (500, 600, "c"),
          (1000, 1500, "d"),  # straddles the loop's end: 100 inside
          (1600, 1700, "e")]  # after the loop: not counted


def test_week_build_reads_the_week_span():
    assert harness.read_metric("week_build_s.study", _run(host=HOST)) == pytest.approx(80e-9)
    two = HOST + [(2000, 2500, "week")]  # a run that builds twice
    assert harness.read_metric("week_build_s.study", _run(host=two)) == pytest.approx(580e-9)


@pytest.mark.parametrize("case", ["no spans", "no trace"])
@pytest.mark.parametrize("metric", READERS)
def test_readers_read_nothing_where_the_program_has_no_spans(metric, case):
    r = (_run(device=DEVICE, host=[(0, 3000, "api.run")]) if case == "no spans"
         else _run(trace=False))
    assert harness.read_metric(metric, r) is None


def test_day_loop_idle_share_clips_to_the_loop():
    busy = (300 - 100) + (600 - 500) + (1100 - 1000)
    r = _run(device=DEVICE, host=HOST)
    assert harness.read_metric("day_loop_idle_share.study", r) == pytest.approx(
        1 - busy / 1000)
    covered = _run(device=[(0, 5000, "x")], host=HOST)
    assert harness.read_metric("day_loop_idle_share.study", covered) == pytest.approx(0.0)


def test_day_loop_idle_share_takes_the_untraced_loops_length():
    """The profiled loop's own length (1,000 ns here) is not the
    denominator: the mean of the untraced studies' loops is."""
    r = _run(device=DEVICE, host=HOST, untraced=2)
    r["studies"][2] = {"wall_s": 5.0, "run_wall_s": 3 * LOOP_S}  # mean 2,000 ns
    assert harness.read_metric("day_loop_idle_share.study", r) == pytest.approx(1 - 400 / 2000)


@pytest.mark.parametrize("case", ["one study", "no device"])
def test_day_loop_idle_share_needs_an_untraced_loop_and_the_device(case):
    r = (_run(device=DEVICE, host=HOST, untraced=0) if case == "one study"
         else _run(host=HOST))
    assert harness.read_metric("day_loop_idle_share.study", r) is None


def test_tiny_traced_study_reads_the_week_and_no_device_time(tiny, capsys):
    cell = "md-covid.study-b256"
    out = run.main(["--workload", cell, "--seed", "2147483653", "--seconds", "1",
                    "--trace", "1"], device="cpu", hooks=tiny(cell))
    assert out["correct"] is True
    assert out["metrics"]["week_build_s.study"]["value"] > 0
    assert "day_loop_idle_share.study" not in out["metrics"]
