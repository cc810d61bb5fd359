"""One simulated day, port against reference, from one mid-epidemic state.

The reference runs twin-2k for 16 days; its state, params and week arrays
are carried into the port (``state_from_numpy``, ``params_from_numpy``,
``week_from_numpy``), and both packages step one more day.

Tolerances: per-visit dispatch values, masks and the integer ``contacts``/
``edges`` are exact; the exposure ``A`` is held to rtol 1e-5 (f32 sum order
in the tile pass, see test_torch_interactions.py); infection decisions must
agree wherever ``|u - exp(-A)| > 2**-20`` (``exp`` differs by an ulp between
torch and XLA); dwell draws go through ``log`` and are held to rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.presets import INTERVENTION_PRESETS as J_PRESETS
from repro.core import disease as j_disease
from repro.core import interventions as j_iv
from repro.core import transmission as j_tx
from repro.data import digital_twin_population as j_twin
from repro.engine import EngineCore as JCore
from repro.engine import day as j_day
from repro.engine.core import index_params
from repro.kernels.interactions import ops as j_ops
from repro_torch.configs.presets import INTERVENTION_PRESETS as T_PRESETS
from repro_torch.core import disease as t_disease
from repro_torch.core import interactions as t_inter
from repro_torch.core import interventions as t_iv
from repro_torch.core import rng as t_rng
from repro_torch.core import simulator as t_sim
from repro_torch.core import transmission as t_tx
from repro_torch.data import digital_twin_population as t_twin
from repro_torch.engine import EngineCore as TCore
from repro_torch.engine import day as t_day
from repro_torch.kernels.interactions import kernel as t_kernel

TAU, SEED, WARM_DAYS = 2e-5, 3, 16
BAND = 2.0**-20


@pytest.fixture(scope="module")
def pops():
    return j_twin(2000, seed=0, name="twin-2k"), t_twin(2000, seed=0, name="twin-2k")


def _np(tree):
    return dataclasses.asdict(jax.device_get(tree))


def _carried(pops, preset):
    """(reference core, its params & mid-epidemic state, the port's core,
    and the same params/state/week carried into the port)."""
    jpop, tpop = pops
    jcore = JCore.single(jpop, j_disease.covid_model(), j_tx.TransmissionModel(tau=TAU),
                         interventions=J_PRESETS[preset], seed=SEED, backend="compact")
    jstate, _ = jcore.run1(WARM_DAYS)
    jparams = index_params(jcore.params, 0)
    tcore = TCore.single(tpop, t_disease.covid_model(), t_tx.TransmissionModel(tau=TAU),
                         interventions=T_PRESETS[preset], seed=SEED, device="cpu")
    carried = (
        t_sim.params_from_numpy(_np(jparams), device="cpu"),
        t_sim.state_from_numpy(_np(jstate), device="cpu"),
        t_inter.week_from_numpy(jax.device_get(jcore.week), jpop.num_people,
                                 device="cpu"),
    )
    return jcore, jparams, jstate, tcore, carried


def _j_visits(jcore, p, s):
    P, L = jcore.pop.num_people, jcore.pop.num_locations
    take = lambda k: jcore.week[k][s.day % 7]
    pid, loc = take("pid"), take("loc")
    ok, lo, sm, im, vacc = j_iv.apply_iv_params(jcore.iv_slots, p.iv, s.iv_active,
                                                s.vaccinated, P, L)
    chans = jnp.stack([p.sus_table[s.health] * p.beta_sus * sm,
                       p.inf_table[s.health] * p.beta_inf * im,
                       ok.astype(jnp.float32)], -1)
    vv = jcore.topo.dispatch(None, pid, chans)
    active = (pid >= 0) & (vv[:, 2] > 0.0) & lo[jnp.minimum(loc, L - 1)]
    eff = jnp.where(active, pid, -1)
    sus_v, inf_v = vv[:, 0] * active, vv[:, 1] * active
    nb = pid.shape[0] // 128
    acc, cnt, edges = j_ops.interactions_auto_edges(
        eff, loc, take("start"), take("end"), take("p"), sus_v, inf_v,
        take("row"), take("col"), take("rs"), take("pa"),
        j_ops.col_has_infectious(inf_v, eff, nb, 128),
        j_ops.row_has_susceptible(sus_v, eff, nb, 128),
        jnp.stack([p.seed.astype(jnp.uint32), s.day.astype(jnp.uint32)]),
        block_size=128, backend="compact",
    )
    A = jcore.topo.combine(None, pid, active, acc, P) * p.tau_eff
    return {k: np.asarray(v) for k, v in dict(
        sus_v=sus_v, inf_v=inf_v, active=active, cnt=cnt, edges=edges, A=A,
        vaccinated=vacc).items()}


def _t_visits(tcore, p, s, week):
    P, L = tcore.pop.num_people, tcore.pop.num_locations
    take = lambda k: week[k][int(s.day) % 7]
    pid, loc = take("pid"), take("loc")
    ok, lo, sm, im, vacc = t_iv.apply_iv_params(tcore.iv_slots, p.iv, s.iv_active,
                                                s.vaccinated, P, L)
    chans = torch.stack([p.sus_table[s.health] * p.beta_sus * sm,
                         p.inf_table[s.health] * p.beta_inf * im, ok.float()], -1)
    vv = tcore.topo.dispatch(pid, chans)
    active = (pid >= 0) & (vv[:, 2] > 0.0) & lo[loc.clamp(max=L - 1)]
    A, cnt, edges, vacc2 = t_day.exposure(tcore.topo, tcore.static, week, p, s)
    assert torch.equal(vacc, vacc2)
    return {k: v.numpy() for k, v in dict(
        sus_v=vv[:, 0] * active, inf_v=vv[:, 1] * active, active=active, cnt=cnt,
        edges=edges, A=A, vaccinated=vacc).items()}


@pytest.mark.parametrize("preset", ["none", "vax-seniors"])
def test_one_day_matches_reference(pops, preset):
    jcore, jparams, jstate, tcore, (tparams, tstate, tweek) = _carried(pops, preset)
    # carried params/week equal the port's own
    for f in ("seed", "tau_eff", "beta_sus", "beta_inf", "cum_trans", "entry_state"):
        assert torch.equal(getattr(tparams, f), getattr(tcore.params, f)), f
    for f in ("people", "factor", "day_start"):
        assert torch.equal(getattr(tparams.iv, f), getattr(tcore.params.iv, f)), f
    for k in tcore.week:
        assert torch.equal(tweek[k], tcore.week[k]), k
    if preset == "vax-seniors":
        assert bool(tstate.iv_active[0])  # DayRange(14) is active on day 16

    jv = _j_visits(jcore, jparams, jstate)
    tv = _t_visits(tcore, tparams, tstate, tweek)
    for k in ("sus_v", "inf_v", "active", "cnt", "vaccinated"):
        np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
    assert int(tv["edges"]) == int(jv["edges"]) == int(jv["cnt"].sum()) > 0
    np.testing.assert_allclose(tv["A"], jv["A"], rtol=1e-5, atol=0)

    # the whole step, both packages
    jnew, jstats = jax.jit(lambda p, s: j_day.day_step(
        jcore.topo, jcore.static, None, jcore.week, p, s))(jparams, jstate)
    launches = t_kernel.interactions_compact_cuda.launches
    tnew, tstats = t_day.day_step(tcore.topo, tcore.static, tweek, tparams, tstate)
    assert t_kernel.interactions_compact_cuda.launches == launches  # CPU: plain path
    u = t_rng.uniform(tparams.seed, t_rng.INFECT, tstate.day,
                      torch.arange(tcore.pop.num_people)).numpy()
    susceptible = tparams.sus_table[tstate.health].numpy() > 0
    exposed = (jv["A"] > 0) | (tv["A"] > 0)
    in_band = susceptible & exposed & (
        (np.abs(u - np.exp(-jv["A"].astype(np.float64))) <= BAND)
        | (np.abs(u - np.exp(-tv["A"].astype(np.float64))) <= BAND))
    out = ~in_band
    jh, th = np.asarray(jnew.health), tnew.health.numpy()
    np.testing.assert_array_equal(th[out], jh[out])
    np.testing.assert_allclose(tnew.dwell.numpy()[out], np.asarray(jnew.dwell)[out],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tnew.vaccinated.numpy(), np.asarray(jnew.vaccinated))
    np.testing.assert_array_equal(tnew.iv_active.numpy(), np.asarray(jnew.iv_active))
    for k in ("day", "contacts", "edges", "tests_used", "isolated", "traced"):
        assert int(tstats[k]) == int(jstats[k]), k
    for k in ("new_infections", "infectious", "susceptible"):
        assert abs(int(tstats[k]) - int(jstats[k])) <= int(in_band.sum()), k
    print(f"{preset}: {int(in_band.sum())} in-band infection decisions")
