"""The port's interaction pass against the reference's fused Pallas kernel
(``pallas-compact``, interpret mode on the CPU), on tests/test_interactions.py's
random cases and its four extremes, on the canonical and the packed layout.

Tolerances: ``cnt`` and ``edges`` are integers and must agree exactly;
``acc`` is an f32 sum whose order differs (XLA's row-sum tree against the
port's column-sequential order), so it is held to rtol 1e-5, atol 0.

The CUDA kernel itself runs only on a card: tests/test_torch_gpu.py holds
it bitwise against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import population as pop_lib
from repro.kernels.interactions import ops as j_ops
from repro_torch.kernels.interactions import kernel as t_kernel
from repro_torch.kernels.interactions import ops as t_ops
from repro_torch.kernels.interactions import ref as t_ref

from test_interactions import _extreme_case, make_case

B = 64
EXTREMES = ("zero_infectious", "all_infectious", "all_padding_block",
            "single_giant_location")


def _inputs(layout, extent, p_loc, sus_pp, inf_pp, seed, day):
    """One day's interaction-pass inputs as numpy arrays, in the argument
    order of repro_torch's interactions_compact_edges."""
    sched = pop_lib.build_block_schedule(layout.loc, extent, B)
    safe = np.maximum(layout.person, 0)
    sus_v = (sus_pp[safe] * layout.active).astype(np.float32)
    inf_v = (inf_pp[safe] * layout.active).astype(np.float32)
    nb = len(layout.person) // B
    flag = lambda v: ((v > 0) & (layout.person >= 0)).reshape(nb, B).any(1).astype(np.int32)
    return (
        layout.person.astype(np.int32), layout.loc.astype(np.int32),
        layout.start, layout.end,
        p_loc[np.minimum(layout.loc, len(p_loc) - 1)].astype(np.float32),
        sus_v, inf_v,
        sched.row_block, sched.col_block, sched.pair_active.astype(np.int32),
        flag(inf_v), flag(sus_v), np.array([seed, day], np.int64),
    ), sched.row_start.astype(np.int32)


def _reference(args, row_start):
    """The reference's pallas-compact pass (interpret mode)."""
    j = [jnp.asarray(a) for a in args]
    meta = jnp.asarray(args[-1].astype(np.uint32))
    return j_ops.interactions_auto_edges(
        *j[:9], jnp.asarray(row_start), *j[9:12], meta,
        block_size=B, backend="pallas-compact",
    )


def _port(args):
    return t_ops.interactions_compact_edges(
        *[torch.as_tensor(np.array(a)) for a in args], block_size=B)


def _check(args, row_start):
    acc_j, cnt_j, edges_j = (np.asarray(x) for x in _reference(args, row_start))
    acc_t, cnt_t, edges_t = _port(args)
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_j)
    assert int(edges_t) == int(edges_j) == int(cnt_j.sum())
    np.testing.assert_allclose(acc_t.numpy(), acc_j, rtol=1e-5, atol=0)
    # the dense oracle over all pairs gives the same integers
    acc_d, cnt_d = t_ref.interactions_dense(
        *[torch.as_tensor(np.array(a)) for a in args[:7]], args[-1][0], args[-1][1])
    np.testing.assert_array_equal(cnt_d.numpy(), cnt_t.numpy())
    np.testing.assert_allclose(acc_d.numpy(), acc_t.numpy(), rtol=1e-5, atol=0)
    return acc_t, cnt_t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_random_cases_match_reference_kernel(seed, packed):
    day_v, p_loc, sus_pp, inf_pp, _ = make_case(seed, b=B)
    layout = pop_lib.pack_day_occupancy(day_v, B) if packed else day_v
    extent = layout.extent if packed else day_v.num_real
    _check(*_inputs(layout, extent, p_loc, sus_pp, inf_pp, 123, 5))


@pytest.mark.parametrize("kind", EXTREMES)
@pytest.mark.parametrize("packed", [False, True])
def test_extremes_match_reference_kernel(kind, packed):
    day_v, p_loc, sus_pp, inf_pp = _extreme_case(kind, b=B)
    layout = pop_lib.pack_day_occupancy(day_v, B) if packed else day_v
    extent = layout.extent if packed else day_v.num_real
    acc, cnt = _check(*_inputs(layout, extent, p_loc, sus_pp, inf_pp, 77, 3))
    if kind == "zero_infectious":
        assert float(acc.abs().sum()) == 0.0 and int(cnt.sum()) == 0
    if kind == "all_infectious":
        assert int(cnt.sum()) > 0


def test_compaction_is_stable_live_first():
    day_v, p_loc, sus_pp, inf_pp, _ = make_case(4, b=B)
    args, _ = _inputs(day_v, day_v.num_real, p_loc, sus_pp, inf_pp, 1, 2)
    row, col, pa, cinf, rsus = (torch.as_tensor(a) for a in args[7:12])
    rows_c, cols_c, row_start_c, n_live = t_ops.compact_schedule(row, col, pa, cinf, rsus)
    live = t_ops.live_tiles(row, col, pa, cinf, rsus).numpy()
    n = int(n_live[0])
    assert n == live.sum()
    np.testing.assert_array_equal(rows_c[:n].numpy(), args[7][live])
    np.testing.assert_array_equal(cols_c[:n].numpy(), args[8][live])
    np.testing.assert_array_equal(rows_c[n:].numpy(), args[7][~live])
    expect = np.r_[1, (np.diff(rows_c.numpy()) != 0).astype(np.int32)]
    np.testing.assert_array_equal(row_start_c.numpy(), expect)


def test_cpu_tensors_run_the_plain_version():
    day_v, p_loc, sus_pp, inf_pp, _ = make_case(1, b=B)
    args, _ = _inputs(day_v, day_v.num_real, p_loc, sus_pp, inf_pp, 9, 2)
    before = t_kernel.interactions_compact_cuda.launches
    acc, cnt, edges = _port(args)
    assert t_kernel.interactions_compact_cuda.launches == before  # no kernel here
    assert acc.dtype == torch.float32 and cnt.dtype == torch.int32
    assert edges.dtype == torch.int64 and edges.shape == ()


def test_plain_version_chunking_is_bitwise_neutral(monkeypatch):
    day_v, p_loc, sus_pp, inf_pp = _extreme_case("single_giant_location", b=B)
    args, _ = _inputs(day_v, day_v.num_real, p_loc, sus_pp, inf_pp, 5, 1)
    t = [torch.as_tensor(np.array(a)) for a in args]
    rc = t_ops.compact_schedule(*t[7:12])
    kargs = (*t[:7], *rc, *t[10:])
    whole = t_kernel.interactions_compact_plain(*kargs, block_size=B)
    monkeypatch.setattr(t_kernel, "TILES_PER_CHUNK", 1)
    split = t_kernel.interactions_compact_plain(*kargs, block_size=B)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
