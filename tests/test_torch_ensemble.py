"""The port's scenario batches: B scenarios in one batched day loop.

Every check here is bitwise and inside the port (plain PyTorch path on the
CPU): each scenario column of an ensemble equals the port's own batch-of-one
run of that scenario (untraced and test-trace-isolate, on both interaction
routes), the sequential driver equals the ensemble, pad slots are inert and
never reach the history, and a batch whose scenarios differ in slot
structure is refused.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import observables as obs_lib
from repro_torch.configs import INTERVENTION_PRESETS, get_epidemic
from repro_torch.configs.sweep import Scenario, ScenarioBatch
from repro_torch.core import disease, interventions as iv
from repro_torch.core import simulator as sim_lib
from repro_torch.engine import core as core_lib
from repro_torch.engine.core import EngineCore
from repro_torch.kernels.interactions import kernel as t_kernel

TAU = 2e-5
STATE_FIELDS = ("day", "health", "dwell", "cumulative", "iv_active", "vaccinated",
                "tested", "traced", "isolated_until")


@pytest.fixture(scope="module")
def pop():
    return get_epidemic("twin-2k").build()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the CPU at once, and torch's thread pools oversubscribe the
    cores (the twin-2k shapes here gain little from more threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(ivs, taus=(TAU,), seeds=(0, 1)):
    return ScenarioBatch.from_product(
        interventions={n: INTERVENTION_PRESETS[n] for n in ivs},
        tau=list(taus), seeds=list(seeds))


CASES = {
    # (batch, days, backend): lockdown triggers at 500 infectious, inside 20 days
    "untraced-replicates": (lambda: _batch(("none", "lockdown")), 20, "pallas-compact"),
    "untraced-tau": (lambda: _batch(("none", "lockdown"), taus=(TAU, 0.6 * TAU), seeds=(3,)),
                     20, "pallas-compact"),
    "tti-compact": (lambda: _batch(("tti",)), 20, "pallas-compact"),
    "tti-padded": (lambda: _batch(("tti",)), 20, "pallas"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ensemble_columns_equal_their_batch_of_one(pop, case):
    make, days, backend = CASES[case]
    batch = make()
    assert len(batch) == (2 if case.startswith("tti") else 4)
    core = EngineCore(pop, batch, device="cpu", backend=backend)
    final, _, hist, _ = core.run_days(days)
    assert hist.shape == (days, len(sim_lib.STAT_KEYS), len(batch))
    for i, scen in enumerate(batch):
        one = EngineCore(pop, [scen], device="cpu", backend=backend)
        f1, _, h1, _ = one.run_days(days)
        assert torch.equal(h1[..., 0], hist[..., i]), scen.name
        for f in STATE_FIELDS:
            assert torch.equal(getattr(f1, f)[0], getattr(final, f)[i]), (scen.name, f)
    h = hist.numpy()
    assert (h[:, 5] == h[:, 6]).all()  # contacts == edges, every scenario
    if case.startswith("untraced"):
        # the lockdown slot fired, so its columns part from the baseline's
        assert bool((hist[..., 2:] != hist[..., :2]).any())
    else:
        assert h[:, 7].sum() > 0 and h[:, 9].sum() > 0  # tests used, people traced


def test_sequential_driver_equals_the_ensemble(pop):
    core = EngineCore(pop, _batch(("none", "lockdown")), device="cpu")
    obs = obs_lib.make_observables(["attack_rate", "ensemble_mean_ci"])
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=4, device="cpu")
    ens = core_lib.run_chunked(core_lib.CoreDriver(core, obs), 14, obs, ctx)
    seq = core_lib.run_chunked(core_lib.SequentialDriver(core), 14, obs, ctx)
    (fa, ha, *_), (fb, hb, cb, db, *_) = ens, seq
    assert cb is None and db is None  # the sequential driver streams nothing
    for k in sim_lib.STAT_KEYS:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f


def test_pad_slots_are_inert(pop, monkeypatch):
    """A batch of 4 padded to 6 (pad_batch(., 3)) with no-op params: the pad
    slots seed and infect nobody, reach the interaction pass with no live
    tile, and never reach the history or the observables; the real columns
    equal the unpadded run's."""
    batch = _batch(("none", "lockdown"))
    padded = core_lib.pad_batch(batch, 3)
    assert len(padded) == 6 and padded.names[4:] == ("__pad0", "__pad1")
    assert core_lib.pad_batch(padded, 3) is padded
    core = EngineCore(pop, batch, device="cpu")
    slots, pa_slots, params = core_lib.build_batch_params(pop, padded, device="cpu")
    assert slots == core.iv_slots and pa_slots == core.pa_slots
    params[4:] = [core_lib.no_op_params(p) for p in params[4:]]
    state = core_lib.stack_params([core_lib.index_params(core.init_state(), 0)] * 6)
    n_live = []
    plain = t_kernel.interactions_compact_plain

    def recording(*args, **kw):
        if args[0].dim() == 2:  # the batch's call, not its per-scenario ones
            n_live.append(args[10].clone())
        return plain(*args, **kw)

    monkeypatch.setattr(t_kernel, "interactions_compact_plain", recording)
    obs = obs_lib.make_observables(["attack_rate"])
    ctx = obs_lib.ObsContext(num_people=pop.num_people, num_scenarios=4, device="cpu")
    days = 10
    final, carries, hist, dailies = core.run_days(
        days, params=core_lib.stack_params(params), state=state,
        observables=obs, carries=obs_lib.init_carries(obs, ctx))
    assert len(n_live) == days and all(n.shape == (6,) for n in n_live)
    assert all(int(n[4:].sum()) == 0 for n in n_live)
    assert any(int(n[:4].min()) > 0 for n in n_live)
    assert final.cumulative[4:].tolist() == [0, 0]
    assert hist.shape == (days, len(sim_lib.STAT_KEYS), 4)
    assert carries[0].shape == (4,)
    monkeypatch.setattr(t_kernel, "interactions_compact_plain", plain)
    _, _, real, _ = core.run_days(days)
    assert torch.equal(real, hist)


def test_mixed_slot_structure_is_refused(pop):
    covid = disease.covid_model()
    tti = tuple(INTERVENTION_PRESETS["tti"])
    with pytest.raises(ValueError, match="slot"):
        ScenarioBatch.from_scenarios([Scenario(name="none", disease=covid),
                                      Scenario(name="tti", disease=covid, interventions=tti)])
    with pytest.raises(ValueError, match="states"):
        ScenarioBatch.from_scenarios([Scenario(name="a", disease=covid),
                                      Scenario(name="b", disease=disease.sir_model())])
    # one slot each, of different families: the engine refuses the batch
    lockdown = tuple(INTERVENTION_PRESETS["lockdown"])
    mixed = ScenarioBatch.from_scenarios([
        Scenario(name="lockdown", disease=covid, interventions=lockdown),
        Scenario(name="tti", disease=covid, interventions=tti)])
    with pytest.raises(ValueError, match="intervention structure"):
        EngineCore(pop, mixed, device="cpu")
    vax = iv.Intervention("v", iv.DayRange(0), iv.Everyone(), iv.Vaccinate(0.5))
    two_vax = ScenarioBatch.from_product(
        interventions={"a": [vax], "b": [iv.Intervention("w", iv.DayRange(0), iv.Everyone(),
                                                         iv.Vaccinate(0.9))]})
    with pytest.raises(ValueError, match="Vaccinate"):
        EngineCore(pop, two_vax, device="cpu")


def test_from_product_order_and_stack_roundtrip(pop):
    batch = _batch(("none", "lockdown"), taus=(TAU, 0.5 * TAU), seeds=(0, 1))
    assert batch.names == ("none/tau=2e-05/s0", "none/tau=2e-05/s1",
                           "none/tau=1e-05/s0", "none/tau=1e-05/s1",
                           "lockdown/tau=2e-05/s0", "lockdown/tau=2e-05/s1",
                           "lockdown/tau=1e-05/s0", "lockdown/tau=1e-05/s1")
    assert [s.iv_enabled for s in batch][::4] == [(False,), (True,)]
    core = EngineCore(pop, batch, device="cpu")
    assert core.params.beta_sus.shape == (8, pop.num_people)
    for i, s in enumerate(batch):
        p = core.scenario_params(i)
        assert int(p.seed) == s.seed
        assert bool(p.iv.enabled[0]) == s.iv_enabled[0]
    again = core_lib.stack_params([core.scenario_params(i) for i in range(8)])
    assert torch.equal(again.iv.people, core.params.iv.people)
    with pytest.raises(RuntimeError, match="launch.mesh.spawn or torchrun"):
        EngineCore(pop, batch, device="cpu", layout="scenarios")  # no process group
