"""The slice end to end: 30 days of twin-2k, and 25 days of twin-2k under
test-trace-isolate (with and without tracing), port against reference; and
the port's two interaction backends against each other, bitwise.

The reference runs ``EngineCore.single(..., backend="compact")``, which its
own tests hold bitwise equal to ``pallas-compact`` and which is far faster
than 30 days of Pallas interpret mode. The port runs ``EngineCore.single``
on the CPU (its plain path). Two tolerance classes apply (see
test_torch_day.py): integer and mask quantities are exact, while ``exp`` and
``log`` may differ by an ulp between torch and XLA. So the histories must be
equal on every day before the first *in-band* decision — an infection draw
with ``|u - exp(-A)| <= 2**-20``, or a dwell draw within rtol 1e-5 of a
whole number of days (which decides the day its transition fires) — which
the test locates and prints; the final attack rates must agree within 5
percentage points.
"""

import numpy as np
import pytest
import torch

from repro.configs.presets import INTERVENTION_PRESETS as J_PRESETS
from repro.core import disease as j_disease
from repro.core import interventions as j_iv
from repro.core import transmission as j_tx
from repro.data import digital_twin_population as j_twin
from repro.engine import EngineCore as JCore
from repro_torch.configs.presets import INTERVENTION_PRESETS as T_PRESETS
from repro_torch.core import disease as t_disease
from repro_torch.core import interventions as t_iv
from repro_torch.core import rng as t_rng
from repro_torch.core import transmission as t_tx
from repro_torch.data import digital_twin_population as t_twin
from repro_torch.engine import EngineCore as TCore
from repro_torch.engine import day as t_day

DAYS, TAU = 30, 2e-5
TTI_DAYS = 25
BAND = 2.0**-20
DWELL_RTOL = 1e-5


@pytest.fixture(scope="module")
def pops():
    return j_twin(2000, seed=0, name="twin-2k"), t_twin(2000, seed=0, name="twin-2k")


def _stepped(core, days=DAYS):
    """The port's run one day at a time through its two phases (on its batch
    of one), with the first day that holds an in-band decision. Returns
    (hist, band_day)."""
    state, rows, band_day = core.init_state(), [], None
    p = core.params
    pid = torch.arange(core.pop.num_people)
    seed, day = p.seed[:, None], None
    for d in range(days):
        ex = t_day.exposure(core.topo, core.static, core.week, p, state)
        new, stats = t_day.update(core.topo, core.static, p, state, ex)
        A = ex.A
        day = state.day[:, None]
        if band_day is None:
            # infection: u against exp(-A) for the exposed susceptibles
            u = t_rng.uniform(seed, t_rng.INFECT, day, pid)
            sus = p.sus_table.gather(1, state.health.long()) > 0
            inf_band = sus & (A > 0) & ((u.double() - torch.exp(-A.double())).abs() <= BAND)
            # dwell: a fresh draw within rtol of a whole day decides, days
            # later, on which day the timed transition fires
            mean = p.dwell_mean.gather(1, new.health.long())
            raw = t_rng.exponential(mean, seed, t_rng.DWELL, day, pid)
            whole = raw.round()
            dwell_band = ((new.health != state.health) & (mean < 1e9) & (whole >= 1)
                          & ((raw - whole).abs() <= DWELL_RTOL * whole))
            if bool(inf_band.any() | dwell_band.any()):
                band_day = d
        state = new
        rows.append([int(stats[k]) for k in t_day.STAT_KEYS])
    h = np.asarray(rows)
    return {k: h[:, i] for i, k in enumerate(t_day.STAT_KEYS)}, band_day


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("preset", ["none", "vax-seniors"])
def test_thirty_days_match_reference(pops, preset, seed):
    jpop, tpop = pops
    jcore = JCore.single(jpop, j_disease.covid_model(), j_tx.TransmissionModel(tau=TAU),
                         interventions=J_PRESETS[preset], seed=seed, backend="compact")
    _, jh = jcore.run1(DAYS)
    tcore = TCore.single(tpop, t_disease.covid_model(), t_tx.TransmissionModel(tau=TAU),
                         interventions=T_PRESETS[preset], seed=seed, device="cpu")
    _, th = tcore.run1(DAYS)
    stepped, band_day = _stepped(tcore)
    for k in t_day.STAT_KEYS:  # run1 == the day-by-day phases, bitwise
        np.testing.assert_array_equal(stepped[k], th[k], err_msg=k)

    diff = [d for d in range(DAYS)
            if any(int(jh[k][d]) != int(th[k][d]) for k in t_day.STAT_KEYS)]
    first_diff = diff[0] if diff else None
    print(f"{preset} seed {seed}: first in-band decision on day {band_day}, "
          f"first differing day {first_diff}")
    limit = DAYS if band_day is None else band_day
    for k in t_day.STAT_KEYS:
        np.testing.assert_array_equal(
            th[k][:limit], np.asarray(jh[k][:limit], np.int64),
            err_msg=f"{preset} seed {seed} '{k}' before day {limit}")
    assert np.array_equal(th["edges"], th["contacts"])
    ar_j = 100.0 * int(jh["cumulative"][-1]) / jpop.num_people
    ar_t = 100.0 * int(th["cumulative"][-1]) / tpop.num_people
    assert abs(ar_j - ar_t) <= 5.0, (ar_j, ar_t)


def _tti(lib, trace):
    """The reference test's TTI slot (tests/test_engine.py:tti_kw)."""
    return [lib.TestTraceIsolate("tti", tests_per_day=15, start_day=3, isolation_days=6,
                                 trace=trace, trace_isolation_days=9)]


def _tti_kw(lib, trace):
    return dict(interventions=_tti(lib, trace), iv_enabled=[True], seed=7, seed_per_day=4)


@pytest.mark.parametrize("trace", [True, False])
def test_tti_days_match_reference(pops, trace):
    jpop, tpop = pops
    jcore = JCore.single(jpop, j_disease.covid_model(), j_tx.TransmissionModel(tau=TAU),
                         backend="compact", **_tti_kw(j_iv, trace))
    _, jh = jcore.run1(TTI_DAYS)
    tcore = TCore.single(tpop, t_disease.covid_model(), t_tx.TransmissionModel(tau=TAU),
                         device="cpu", **_tti_kw(t_iv, trace))
    _, th = tcore.run1(TTI_DAYS)
    stepped, band_day = _stepped(tcore, TTI_DAYS)
    for k in t_day.STAT_KEYS:  # run1 == the day-by-day phases, bitwise
        np.testing.assert_array_equal(stepped[k], th[k], err_msg=k)
    diff = [d for d in range(TTI_DAYS)
            if any(int(jh[k][d]) != int(th[k][d]) for k in t_day.STAT_KEYS)]
    print(f"tti trace={trace}: first in-band decision on day {band_day}, "
          f"first differing day {diff[0] if diff else None}")
    limit = TTI_DAYS if band_day is None else band_day
    for k in t_day.STAT_KEYS:
        np.testing.assert_array_equal(
            th[k][:limit], np.asarray(jh[k][:limit], np.int64),
            err_msg=f"tti trace={trace} '{k}' before day {limit}")
    # the run exercises every per-agent pathway
    assert th["tests_used"].sum() > 0 and th["isolated"].sum() > 0
    assert (th["traced"].sum() > 0) == trace
    assert (th["tests_used"] <= 15).all()
    assert np.array_equal(th["edges"], th["contacts"])
    ar_j = 100.0 * int(jh["cumulative"][-1]) / jpop.num_people
    ar_t = 100.0 * int(th["cumulative"][-1]) / tpop.num_people
    assert abs(ar_j - ar_t) <= 5.0, (ar_j, ar_t)


def test_tti_backends_bitwise(pops):
    """The port's two interaction backends give one TTI run, bit for bit."""
    _, tpop = pops
    runs = {}
    for backend in ("pallas-compact", "pallas"):
        core = TCore.single(tpop, t_disease.covid_model(), t_tx.TransmissionModel(tau=TAU),
                            device="cpu", backend=backend, **_tti_kw(t_iv, True))
        final, _, hist, _ = core.run_days(TTI_DAYS)
        runs[backend] = final, hist
    (fa, ha), (fb, hb) = runs.values()
    assert torch.equal(ha, hb)
    for f in ("health", "dwell", "cumulative", "tested", "traced", "isolated_until"):
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f
