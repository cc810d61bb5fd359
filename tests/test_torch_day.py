"""One simulated day, port against reference, from one mid-epidemic state.

The reference runs twin-2k for 16 days, with no intervention, a classic one,
or a test-trace-isolate preset (whose state then holds people tested,
traced and isolated); its state, params and week arrays
are carried into the port (``state_from_numpy``, ``params_from_numpy``,
``week_from_numpy``; params and state as the port's batch of one), and both
packages step one more day.

Tolerances: per-visit dispatch values, masks, the per-agent state and the
integer ``contacts``/``edges``/traced-contact counts are exact; the exposure ``A`` is held to rtol 1e-5 (f32 sum order
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
from repro_torch.engine.core import stack_params
from repro_torch.kernels.interactions import kernel as t_kernel

WRAPPERS = (t_kernel.interactions_compact_cuda, t_kernel.interactions_compact_traced_cuda,
            t_kernel.interactions_padded_cuda, t_kernel.interactions_padded_traced_cuda)

TAU, SEED, WARM_DAYS = 2e-5, 3, 16
BAND = 2.0**-20


@pytest.fixture(scope="module")
def pops():
    return j_twin(2000, seed=0, name="twin-2k"), t_twin(2000, seed=0, name="twin-2k")


def _np(tree):
    return dataclasses.asdict(jax.device_get(tree))


def _carried(pops, preset):
    """(reference core, its params & mid-epidemic state, the port's core,
    and the same params/state/week carried into the port, params and state
    as a batch of one)."""
    jpop, tpop = pops
    jcore = JCore.single(jpop, j_disease.covid_model(), j_tx.TransmissionModel(tau=TAU),
                         interventions=J_PRESETS[preset], seed=SEED, backend="compact")
    jstate, _ = jcore.run1(WARM_DAYS)
    jparams = index_params(jcore.params, 0)
    tcore = TCore.single(tpop, t_disease.covid_model(), t_tx.TransmissionModel(tau=TAU),
                         interventions=T_PRESETS[preset], seed=SEED, device="cpu")
    carried = (
        stack_params([t_sim.params_from_numpy(_np(jparams), device="cpu")]),
        stack_params([t_sim.state_from_numpy(_np(jstate), device="cpu")]),
        t_inter.week_from_numpy(jax.device_get(jcore.week), jpop.num_people,
                                 device="cpu"),
    )
    return jcore, jparams, jstate, tcore, carried


def _j_visits(jcore, p, s, jnew):
    """The reference's phases 1-4 by hand; the day's positives (per-agent
    slots) are read off its next state: those it tested today who were
    infectious."""
    P, L = jcore.pop.num_people, jcore.pop.num_locations
    take = lambda k: jcore.week[k][s.day % 7]
    pid, loc = take("pid"), take("loc")
    ok, lo, sm, im, vacc = j_iv.apply_iv_params(jcore.iv_slots, p.iv, s.iv_active,
                                                s.vaccinated, P, L)
    tracing = any(ps.trace for ps in jcore.pa_slots)
    if jcore.pa_slots:
        ok = ok & ~(s.day < s.isolated_until)
    chans = [p.sus_table[s.health] * p.beta_sus * sm,
             p.inf_table[s.health] * p.beta_inf * im, ok.astype(jnp.float32)]
    if tracing:
        positives = jnew.tested & ~s.tested & (p.inf_table[s.health] > 0.0)
        chans.append(positives.astype(jnp.float32))
    vv = jcore.topo.dispatch(None, pid, jnp.stack(chans, -1))
    active = (pid >= 0) & (vv[:, 2] > 0.0) & lo[jnp.minimum(loc, L - 1)]
    eff = jnp.where(active, pid, -1)
    sus_v, inf_v = vv[:, 0] * active, vv[:, 1] * active
    nb = pid.shape[0] // 128
    args = (eff, loc, take("start"), take("end"), take("p"), sus_v, inf_v,
            take("row"), take("col"), take("rs"), take("pa"),
            j_ops.col_has_infectious(inf_v, eff, nb, 128),
            j_ops.row_has_susceptible(sus_v, eff, nb, 128),
            jnp.stack([p.seed.astype(jnp.uint32), s.day.astype(jnp.uint32)]))
    out = dict(sus_v=sus_v, inf_v=inf_v, active=active, vaccinated=vacc)
    if tracing:
        acc, cnt, edges, trc = j_ops.interactions_auto_traced(
            *args, block_size=128, backend="compact", src_val=vv[:, 3] * active)
        both = jcore.topo.combine_many(
            None, pid, active, jnp.stack([acc, trc.astype(jnp.float32)], -1), P)
        out.update(A=both[:, 0] * p.tau_eff, trc_p=both[:, 1])
    else:
        acc, cnt, edges = j_ops.interactions_auto_edges(
            *args, block_size=128, backend="compact")
        out["A"] = jcore.topo.combine(None, pid, active, acc, P) * p.tau_eff
    out.update(cnt=cnt, edges=edges)
    return {k: np.asarray(v) for k, v in out.items()}


def _t_visits(tcore, p, s, week):
    """The port's phases 1-4 by hand on its batch of one, returned for
    scenario 0."""
    P, L = tcore.pop.num_people, tcore.pop.num_locations
    take = lambda k: week[k][int(s.day[0]) % 7]
    pid, loc = take("pid"), take("loc")
    ok, lo, sm, im, vacc = t_iv.apply_iv_params(tcore.iv_slots, p.iv, s.iv_active,
                                                s.vaccinated, P, L)
    if tcore.pa_slots:
        ok = ok & ~(s.day[:, None] < s.isolated_until)
    look = lambda table: table.gather(1, s.health.long())
    chans = torch.stack([look(p.sus_table) * p.beta_sus * sm,
                         look(p.inf_table) * p.beta_inf * im, ok.float()], -1)
    vv = tcore.topo.dispatch(pid, chans)
    active = (pid >= 0) & (vv[..., 2] > 0.0) & lo[:, loc.clamp(max=L - 1)]
    ex = t_day.exposure(tcore.topo, tcore.static, week, p, s)
    assert torch.equal(vacc, ex.vaccinated)
    out = dict(sus_v=vv[..., 0] * active, inf_v=vv[..., 1] * active, active=active,
               cnt=ex.cnt, edges=ex.edges, A=ex.A, vaccinated=vacc)
    if ex.trc_p is not None:
        out["trc_p"] = ex.trc_p
    return {k: v[0].numpy() for k, v in out.items()}, ex


@pytest.mark.parametrize("preset", ["none", "vax-seniors", "tti", "tti-no-trace"])
def test_one_day_matches_reference(pops, preset):
    jcore, jparams, jstate, tcore, (tparams, tstate, tweek) = _carried(pops, preset)
    # carried params/week equal the port's own
    for f in ("seed", "tau_eff", "beta_sus", "beta_inf", "cum_trans", "entry_state",
              "sym_table"):
        assert torch.equal(getattr(tparams, f), getattr(tcore.params, f)), f
    for f in ("people", "factor", "day_start", "pa_enabled", "pa_tests", "pa_people"):
        assert torch.equal(getattr(tparams.iv, f), getattr(tcore.params.iv, f)), f
    for k in tcore.week:
        assert torch.equal(tweek[k], tcore.week[k]), k
    if preset == "vax-seniors":
        assert bool(tstate.iv_active[0, 0])  # DayRange(14) is active on day 16
    if preset.startswith("tti"):  # a state with live per-agent fields
        assert bool(tstate.tested.any())
        assert bool((tstate.isolated_until > tstate.day).any())
        assert bool(tstate.traced.any()) == (preset == "tti")

    # the whole step, both packages
    jnew, jstats = jax.jit(lambda p, s: j_day.day_step(
        jcore.topo, jcore.static, None, jcore.week, p, s))(jparams, jstate)
    launches = [w.launches for w in WRAPPERS]
    tnew, tstats = t_day.day_step(tcore.topo, tcore.static, tweek, tparams, tstate)
    assert [w.launches for w in WRAPPERS] == launches  # CPU: plain path

    jv = _j_visits(jcore, jparams, jstate, jnew)
    tv, ex = _t_visits(tcore, tparams, tstate, tweek)
    for k in ("sus_v", "inf_v", "active", "cnt", "vaccinated"):
        np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
    assert int(tv["edges"]) == int(jv["edges"]) == int(jv["cnt"].sum()) > 0
    np.testing.assert_allclose(tv["A"], jv["A"], rtol=1e-5, atol=0)
    assert ("trc_p" in tv) == ("trc_p" in jv) == (preset == "tti")
    if preset == "tti":
        np.testing.assert_array_equal(tv["trc_p"], jv["trc_p"])
        assert tv["trc_p"].sum() > 0
    # the take masks: the port's per-slot takes are the reference's newly tested
    if preset.startswith("tti"):
        newly_tested = np.asarray(jnew.tested & ~jstate.tested)
        np.testing.assert_array_equal(ex.takes[0][0].numpy(), newly_tested)
        assert newly_tested.any()

    u = t_rng.uniform(tparams.seed[0], t_rng.INFECT, tstate.day[0],
                      torch.arange(tcore.pop.num_people)).numpy()
    susceptible = tparams.sus_table[0][tstate.health[0]].numpy() > 0
    exposed = (jv["A"] > 0) | (tv["A"] > 0)
    in_band = susceptible & exposed & (
        (np.abs(u - np.exp(-jv["A"].astype(np.float64))) <= BAND)
        | (np.abs(u - np.exp(-tv["A"].astype(np.float64))) <= BAND))
    out = ~in_band
    jh, th = np.asarray(jnew.health), tnew.health[0].numpy()
    np.testing.assert_array_equal(th[out], jh[out])
    np.testing.assert_allclose(tnew.dwell[0].numpy()[out], np.asarray(jnew.dwell)[out],
                               rtol=1e-6, atol=0)
    for f in ("vaccinated", "iv_active", "tested", "traced", "isolated_until"):
        np.testing.assert_array_equal(getattr(tnew, f)[0].numpy(),
                                      np.asarray(getattr(jnew, f)), err_msg=f)
    for k in ("day", "contacts", "edges", "tests_used", "isolated", "traced"):
        assert int(tstats[k]) == int(jstats[k]), k
    if preset == "tti":
        assert min(int(tstats[k]) for k in ("tests_used", "isolated", "traced")) > 0
    for k in ("new_infections", "infectious", "susceptible"):
        assert abs(int(tstats[k]) - int(jstats[k])) <= int(in_band.sum()), k
    print(f"{preset}: {int(in_band.sum())} in-band infection decisions")
