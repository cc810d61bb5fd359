"""``correct`` can come out false: the control (the reference a precision
below, in the program's place) fails, and so does a run whose timed path
is broken underneath, for each fault a cell can have. The cells run on one
chip, so no fault of an exchange between chips applies."""

import pytest
import torch

from portbench import calibrate, run
from repro_torch.api import observables as obs_lib
from repro_torch.engine import day as day_lib


@pytest.mark.parametrize("cell", ["md-covid.study-b256"])
def test_control_fails_and_the_program_holds(cell, tiny, capsys):
    lines = calibrate.main(["--workload", cell, "--seeds", "11,12,13", "--seconds", "5"],
                           device="cpu", hooks=tiny(cell))
    _, _, traffic = run.harness.resolve(cell)
    limits = traffic["limits"]
    for line in lines:
        assert all(v <= limits.get(k, 0) for k, v in line["program"].items()), line
        assert any(v > limits[k] for k, v in line["control"].items()), line


def _step_returns_its_state(monkeypatch):
    update = day_lib.update

    def broken(topo, static, params, state, ex):
        _, stats = update(topo, static, params, state, ex)
        return state, stats

    monkeypatch.setattr(day_lib, "update", broken)


def _half_the_batch(monkeypatch):
    """The exposure pass leaves out every other scenario of the batch (half
    of it), and the ensemble mean is taken over the first half alone."""
    interact = day_lib.interact

    def broken(topo, static, take, chans, loc_open, seed, contact_day, tau):
        A, cnt, edges, trc = interact(topo, static, take, chans, loc_open, seed,
                                      contact_day, tau)
        A = A.clone()
        A[1::2] = 0.0
        return A, cnt, edges, trc

    update = obs_lib.EnsembleMeanCI.update

    def mean_of_half(self, carry, stats):
        return update(self, carry, {k: v[: (v.shape[0] + 1) // 2] for k, v in stats.items()})

    monkeypatch.setattr(day_lib, "interact", broken)
    monkeypatch.setattr(obs_lib.EnsembleMeanCI, "update", mean_of_half)


def _answer_altered(monkeypatch):
    """Day 3's count of new infections, off by one in every scenario, where
    the day produces it."""
    update = day_lib.update

    def broken(topo, static, params, state, ex):
        new_state, stats = update(topo, static, params, state, ex)
        stats["new_infections"] = stats["new_infections"] + (stats["day"] == 3).to(torch.int64)
        return new_state, stats

    monkeypatch.setattr(day_lib, "update", broken)


@pytest.mark.parametrize("cell", ["md-covid.study-b256"])
@pytest.mark.parametrize("fault", [_step_returns_its_state, _half_the_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny, monkeypatch, capsys):
    fault(monkeypatch)
    out = run.main(["--workload", cell, "--seed", "2147483653", "--seconds", "4"],
                   device="cpu", hooks=tiny(cell))
    assert out["correct"] is False, out["checks"]
