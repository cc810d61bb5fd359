"""The port's EpiHiper-style static-network oracle (``repro_torch.core.
baseline``) against the reference's (``repro.core.baseline``), and the port's
``static_network=True`` engine mode against the oracle (the reference's
``tests/test_baseline.py`` case: Watts–Strogatz 500, 30 days, SIR, tau
1.5e-5, seed 4, two seeds a day for five days)."""

import numpy as np
import pytest

from repro_torch.core import baseline, disease, transmission
from repro_torch.data import watts_strogatz_population
from repro_torch.engine.core import EngineCore

DAYS, SEED, TAU = 30, 4, 1.5e-5


@pytest.fixture(scope="module")
def pop():
    return watts_strogatz_population(500, 120, seed=9, name="bl")


@pytest.fixture(scope="module")
def jpop():
    from repro.data import watts_strogatz_population as j_ws

    return j_ws(500, 120, seed=9, name="bl")


@pytest.fixture(scope="module")
def net(pop):
    return baseline.precompute_contact_network(pop, seed=SEED)


@pytest.fixture(scope="module")
def oracle(pop, net):
    return baseline.run_sir_on_network(pop, net, transmission.TransmissionModel(tau=TAU), DAYS,
                                       SEED, seed_per_day=2, seed_days=5, recovery_days=7.0)


def test_network_precompute_symmetric(net):
    for dow in range(7):
        assert len(net.src[dow]) == len(net.dst[dow]) == len(net.duration[dow]) > 0
        assert (net.duration[dow] > 0).all()
        # ordered pairs: every edge is listed both ways, with one duration
        fwd = sorted(zip(net.src[dow], net.dst[dow], net.duration[dow]))
        back = sorted(zip(net.dst[dow], net.src[dow], net.duration[dow]))
        assert fwd == back


@pytest.mark.parametrize("seed", [SEED, 11])
def test_network_equals_the_reference_edge_for_edge(pop, jpop, seed):
    from repro.core import baseline as j_baseline

    for d, jd in zip(pop.week, jpop.week):  # the same population
        for f in ("loc", "person", "start", "end"):
            np.testing.assert_array_equal(getattr(d, f), getattr(jd, f))
    np.testing.assert_array_equal(pop.contact_prob, jpop.contact_prob)
    net = baseline.precompute_contact_network(pop, seed=seed)
    jnet = j_baseline.precompute_contact_network(jpop, seed=seed)
    for dow in range(7):
        for f in ("src", "dst", "duration"):
            a, b = getattr(net, f)[dow], getattr(jnet, f)[dow]
            assert a.dtype == b.dtype and np.array_equal(a, b), (dow, f)


def test_oracle_history_equals_the_reference(pop, jpop, oracle):
    from repro.core import baseline as j_baseline
    from repro.core import transmission as j_tx

    jnet = j_baseline.precompute_contact_network(jpop, seed=SEED)
    want = j_baseline.run_sir_on_network(jpop, jnet, j_tx.TransmissionModel(tau=TAU), DAYS,
                                         SEED, seed_per_day=2, seed_days=5, recovery_days=7.0)
    assert set(oracle) == set(want) == {"cumulative", "infectious"}
    for k in want:
        np.testing.assert_array_equal(oracle[k], want[k], err_msg=k)
    assert oracle["cumulative"][-1] > 10  # the epidemic spreads past its seeds


@pytest.mark.parametrize("backend", ["pallas-compact", "pallas"])
def test_static_mode_matches_edge_list_oracle(pop, oracle, backend):
    """The engine with ``static_network=True`` gives the oracle's epidemic
    (same seeds, same transmission model) on every day."""
    core = EngineCore.single(pop, disease.sir_model(7.0), transmission.TransmissionModel(tau=TAU),
                             seed=SEED, static_network=True, seed_per_day=2, seed_days=5,
                             device="cpu", backend=backend)
    _, hist = core.run1(DAYS)
    np.testing.assert_array_equal(hist["cumulative"], oracle["cumulative"])
    np.testing.assert_array_equal(hist["infectious"], oracle["infectious"])


def test_dynamic_mode_is_not_the_static_network(pop, oracle):
    """The check has teeth: the dynamic contact network (keyed by the
    absolute day) gives another epidemic than the weekly static one."""
    core = EngineCore.single(pop, disease.sir_model(7.0), transmission.TransmissionModel(tau=TAU),
                             seed=SEED, static_network=False, seed_per_day=2, seed_days=5,
                             device="cpu")
    _, hist = core.run1(DAYS)
    assert not np.array_equal(hist["cumulative"], oracle["cumulative"])


def test_margins_leave_the_history_alone(pop, net, oracle):
    """``margins=True`` adds the per-day decision margins and changes
    nothing else; the WS-500 case stays clear of the float32 band, which is
    why its static-mode run equals the oracle on every day."""
    got = baseline.run_sir_on_network(pop, net, transmission.TransmissionModel(tau=TAU), DAYS,
                                      SEED, seed_per_day=2, seed_days=5, recovery_days=7.0,
                                      margins=True)
    for k in oracle:
        np.testing.assert_array_equal(got[k], oracle[k])
    assert got["infect_margin"].shape == got["dwell_margin"].shape == (DAYS,)
    assert np.isfinite(got["infect_margin"]).any() and np.isfinite(got["dwell_margin"]).any()
    assert got["infect_margin"].min() > 1e-5 and got["dwell_margin"].min() > 1e-6
