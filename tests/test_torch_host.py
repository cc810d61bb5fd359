"""The port's host layer against the reference's: population generators,
the stacked week schedule and intervention compilation give identical
arrays, and the combine's person-slot table lists exactly each person's
visit slots in ascending order."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.presets import INTERVENTION_PRESETS as J_PRESETS
from repro.core import interactions as j_inter
from repro.core import interventions as j_iv
from repro.data import digital_twin_population as j_twin
from repro.data import grid_population as j_grid
from repro.data import watts_strogatz_population as j_ws
from repro.engine.core import local_week_arrays as j_week_arrays
from repro_torch.configs.presets import INTERVENTION_PRESETS as T_PRESETS
from repro_torch.core import interactions as t_inter
from repro_torch.core import interventions as t_iv
from repro_torch.data import digital_twin_population as t_twin
from repro_torch.data import grid_population as t_grid
from repro_torch.data import watts_strogatz_population as t_ws
from repro_torch.engine.core import local_week_arrays as t_week_arrays

BUILDERS = {
    "twin-2k": (lambda m: m(2000, seed=0, name="twin-2k"), j_twin, t_twin),
    "ws": (lambda m: m(3000, 750, seed=2, name="ws"), j_ws, t_ws),
    "grid": (lambda m: m(30, 30, density=3.0, seed=1, name="grid"), j_grid, t_grid),
}


@pytest.fixture(scope="module")
def twins():
    return j_twin(2000, seed=0, name="twin-2k"), t_twin(2000, seed=0, name="twin-2k")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_population_generators_identical(kind):
    call, jm, tm = BUILDERS[kind]
    jp, tp = call(jm), call(tm)
    for f in ("name", "num_people", "num_locations"):
        assert getattr(jp, f) == getattr(tp, f)
    for f in ("age_group", "beta_sus", "beta_inf", "home_loc", "loc_type",
              "geo_key", "max_occupancy", "contact_prob"):
        _same(getattr(jp, f), getattr(tp, f), f)
    for d, (jd, td) in enumerate(zip(jp.week, tp.week)):
        assert jd.num_real == td.num_real
        for f in ("person", "loc", "start", "end", "active"):
            _same(getattr(jd, f), getattr(td, f), f"day {d} {f}")


@pytest.mark.parametrize("block_size", [64, 128])
def test_week_data_identical(twins, block_size):
    jp, tp = twins
    jw = j_inter.build_week_data(jp, block_size, pack=True)
    tw = t_inter.build_week_data(tp, block_size)
    assert (jw.block_size, jw.num_blocks) == (tw.block_size, tw.num_blocks)
    for f in ("pid", "loc", "start", "end", "row_idx", "col_idx", "row_start",
              "pair_active"):
        _same(jax.device_get(getattr(jw, f)), getattr(tw, f), f)
    # The day step's week dict: the reference's arrays carried across equal
    # the port's own.
    j_arrays = jax.device_get(j_week_arrays(jp, jw))
    carried = t_inter.week_from_numpy(j_arrays, jp.num_people, device="cpu")
    own = t_week_arrays(tp, tw, device="cpu")
    assert carried.keys() == own.keys()
    for k in own:
        _same(carried[k].numpy(), own[k].numpy(), k)


def test_person_slot_table(twins):
    _, tp = twins
    pid = t_inter.build_week_data(tp, 128).pid
    table = t_inter.person_slot_table(pid, tp.num_people)
    V = pid.shape[1]
    assert table.shape[:2] == (7, tp.num_people)
    for d in range(7):
        for p in np.random.default_rng(d).choice(tp.num_people, 50, replace=False):
            row = table[d, p]
            np.testing.assert_array_equal(row[row < V], np.flatnonzero(pid[d] == p))
    # every real visit slot appears exactly once
    for d in range(7):
        slots = np.sort(table[d][table[d] < V])
        np.testing.assert_array_equal(slots, np.flatnonzero(pid[d] >= 0))


@pytest.mark.parametrize("preset", sorted(T_PRESETS))
def test_compile_iv_params_identical(twins, preset):
    jp, tp = twins
    j_slots, j_pa, j_params = j_iv.compile_iv_params(J_PRESETS[preset], jp, 7)
    t_slots, t_params = t_iv.compile_iv_params(T_PRESETS[preset], tp, 7, device="cpu")
    assert j_pa == ()
    assert [dataclasses.astuple(s) for s in j_slots] == \
        [dataclasses.astuple(s) for s in t_slots]
    for f in ("enabled", "day_start", "day_end", "thresh_on", "thresh_off",
              "factor", "people", "locations"):
        _same(jax.device_get(getattr(j_params, f)), getattr(t_params, f).numpy(), f)


def test_per_agent_slot_refused(twins):
    _, tp = twins
    tti = t_iv.TestTraceIsolate("tti", tests_per_day=10)
    with pytest.raises(NotImplementedError, match="TestTraceIsolate"):
        t_iv.compile_iv_params([tti], tp, 0, device="cpu")
