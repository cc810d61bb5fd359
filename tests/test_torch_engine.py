"""The port's engine front door: device default, what it refuses, the run
entry points and the CLI (both interaction backends, a TTI preset)."""

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_epidemic
from repro_torch.configs.sweep import Scenario
from repro_torch.core import disease, transmission
from repro_torch.core.interactions import build_week_data
from repro_torch.engine import EngineCore, hist_to_numpy
from repro_torch.engine.day import STAT_KEYS
from repro_torch.launch import simulate


@pytest.fixture(scope="module")
def pop():
    return get_epidemic("twin-2k").build()


def test_device_defaults_to_cuda(pop):
    if torch.cuda.is_available():
        core = EngineCore.single(pop, disease.covid_model())
        assert core.device.type == "cuda"
    else:  # no silent CPU fall back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EngineCore.single(pop, disease.covid_model())


def test_core_uploads_the_packed_week_once(pop):
    core = EngineCore(pop, Scenario(name="s", disease=disease.covid_model()),
                      block_size=64, device="cpu")
    week = build_week_data(pop, 64)
    assert set(core.week) == {"pid", "loc", "start", "end", "p", "row", "col",
                              "rs", "pa", "slots"}
    assert all(t.device == core.device for t in core.week.values())
    np.testing.assert_array_equal(core.week["pid"].numpy(), week.pid)
    np.testing.assert_array_equal(core.week["row"].numpy(), week.row_idx)
    np.testing.assert_array_equal(core.week["rs"].numpy(), week.row_start)
    np.testing.assert_array_equal(core.week["p"].numpy(),
                                  pop.contact_prob[week.loc])
    assert not hasattr(core, "week_data")


def test_run_days_keeps_history_on_device_and_run1_matches(pop):
    core = EngineCore.single(pop, disease.covid_model(),
                             transmission.TransmissionModel(tau=2e-5), device="cpu")
    final, hist = core.run_days(6)
    assert isinstance(hist, torch.Tensor) and hist.shape == (6, len(STAT_KEYS))
    assert hist.dtype == torch.int64 and int(final.day) == 6
    final1, h1 = core.run1(6)
    as_np = hist_to_numpy(hist)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(as_np[k], h1[k])
    np.testing.assert_array_equal(h1["day"], np.arange(6))
    np.testing.assert_array_equal(h1["edges"], h1["contacts"])
    assert h1["cumulative"][-1] >= 10 * 6  # seeding ran
    assert torch.equal(final.health, final1.health)


def test_cli_prints_the_reference_summary_fields(capsys):
    from repro.analysis.report import summarize_sweep

    simulate.main(["--dataset", "twin-2k", "--days", "4", "--device", "cpu",
                   "--interventions", "vax-seniors"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("dataset=twin-2k engine=single device=cpu")
    row = json.loads(lines[1])
    fake = {k: np.ones((4, 1), np.int64) for k in ("cumulative", "infectious", "contacts")}
    assert set(row) == set(summarize_sweep(fake, ["x"], 10)[0])
    assert row["scenario"] == "vax-seniors" and row["cumulative"] > 0


def test_core_refuses_an_unknown_backend(pop):
    with pytest.raises(ValueError, match="unknown interaction backend"):
        EngineCore.single(pop, disease.covid_model(), device="cpu", backend="compact")


@pytest.mark.parametrize("backend", ["pallas-compact", "pallas"])
def test_cli_runs_tti_on_either_backend(capsys, backend):
    simulate.main(["--dataset", "twin-2k", "--days", "8", "--device", "cpu",
                   "--interventions", "tti", "--backend", backend])
    lines = capsys.readouterr().out.strip().splitlines()
    assert f"backend={backend}" in lines[0]
    row = json.loads(lines[1])
    assert row["scenario"] == "tti" and row["cumulative"] > 0
