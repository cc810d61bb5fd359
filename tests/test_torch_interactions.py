"""The port's interaction pass against the reference's Pallas kernels
(``pallas-compact`` and ``pallas``, interpret mode on the CPU), untraced and
traced, on tests/test_interactions.py's random cases and its four extremes,
on the canonical and the packed layout; and the port's four plain variants
against each other.

Tolerances: ``cnt``, ``trc`` and ``edges`` are integers and must agree
exactly; ``acc`` is an f32 sum whose order differs (XLA's row-sum tree
against the port's column-sequential order), so against the reference it is
held to rtol 1e-5, atol 0. The port's own variants share one order and are
held bitwise.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
holds them bitwise against their plain versions there.
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

from test_interactions import _EXTREME_SEEDS, _extreme_case, make_case

B = 64
EXTREMES = ("zero_infectious", "all_infectious", "all_padding_block",
            "single_giant_location")
BACKENDS = ("pallas-compact", "pallas")
WRAPPERS = (t_kernel.interactions_compact_cuda, t_kernel.interactions_compact_traced_cuda,
            t_kernel.interactions_padded_cuda, t_kernel.interactions_padded_traced_cuda)


def _inputs(layout, extent, p_loc, sus_pp, inf_pp, seed, day, rs=None):
    """One day's interaction-pass inputs as numpy arrays, in the argument
    order both packages' wrappers take; with ``rs``, also a tracing-source
    vector marking about half the infectious people as today's positives."""
    sched = pop_lib.build_block_schedule(layout.loc, extent, B)
    safe = np.maximum(layout.person, 0)
    sus_v = (sus_pp[safe] * layout.active).astype(np.float32)
    inf_v = (inf_pp[safe] * layout.active).astype(np.float32)
    nb = len(layout.person) // B
    flag = lambda v: ((v > 0) & (layout.person >= 0)).reshape(nb, B).any(1).astype(np.int32)
    args = (
        layout.person.astype(np.int32), layout.loc.astype(np.int32),
        layout.start, layout.end,
        p_loc[np.minimum(layout.loc, len(p_loc) - 1)].astype(np.float32),
        sus_v, inf_v,
        sched.row_block, sched.col_block, sched.row_start.astype(np.int32),
        sched.pair_active.astype(np.int32),
        flag(inf_v), flag(sus_v), np.array([seed, day], np.int64),
    )
    if rs is None:
        return args
    src_pp = np.where((inf_pp > 0) & (rs.random(len(inf_pp)) < 0.5), 1.0, 0.0)
    return args, (src_pp[safe] * layout.active).astype(np.float32)


def _random(seed, packed, rs=None):
    day_v, p_loc, sus_pp, inf_pp, _ = make_case(seed, b=B)
    layout = pop_lib.pack_day_occupancy(day_v, B) if packed else day_v
    extent = layout.extent if packed else day_v.num_real
    return _inputs(layout, extent, p_loc, sus_pp, inf_pp, 123, 5, rs)


def _extreme(kind, packed, rs=None):
    day_v, p_loc, sus_pp, inf_pp = _extreme_case(kind, b=B)
    layout = pop_lib.pack_day_occupancy(day_v, B) if packed else day_v
    extent = layout.extent if packed else day_v.num_real
    return _inputs(layout, extent, p_loc, sus_pp, inf_pp, 77, 3, rs)


def _reference(args, backend="pallas-compact", src=None):
    """The reference's Pallas pass (interpret mode): ``(acc, cnt, edges)``,
    or ``(acc, cnt, edges, trc)`` with ``src``."""
    j = [jnp.asarray(a) for a in args[:-1]] + [jnp.asarray(args[-1].astype(np.uint32))]
    if src is None:
        out = j_ops.interactions_auto_edges(*j, block_size=B, backend=backend)
    else:
        out = j_ops.interactions_auto_traced(*j, block_size=B, backend=backend,
                                             src_val=jnp.asarray(src))
    return [np.asarray(x) for x in out]


def _torch(args):
    return [torch.as_tensor(np.array(a)) for a in args]


def _port(args, backend="pallas-compact", src=None):
    if src is None:
        return t_ops.interactions_auto_edges(*_torch(args), backend=backend, block_size=B)
    return t_ops.interactions_auto_traced(*_torch(args), backend=backend, block_size=B,
                                          src_val=torch.as_tensor(src))


def _check(args):
    acc_j, cnt_j, edges_j = _reference(args)
    acc_t, cnt_t, edges_t = _port(args)
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_j)
    assert int(edges_t) == int(edges_j) == int(cnt_j.sum())
    np.testing.assert_allclose(acc_t.numpy(), acc_j, rtol=1e-5, atol=0)
    # the dense oracle over all pairs gives the same integers
    acc_d, cnt_d = t_ref.interactions_dense(*_torch(args[:7]), args[-1][0], args[-1][1])
    np.testing.assert_array_equal(cnt_d.numpy(), cnt_t.numpy())
    np.testing.assert_allclose(acc_d.numpy(), acc_t.numpy(), rtol=1e-5, atol=0)
    return acc_t, cnt_t


def _check_backend(args, src, backend):
    """Untraced and traced pass of ``backend`` against the reference's."""
    for want, got in ((_reference(args, backend), _port(args, backend)),
                      (_reference(args, backend, src), _port(args, backend, src))):
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert got[2].dtype == torch.int64
        assert int(got[2]) == int(want[2]) == int(want[1].sum())
    trc = got[3].numpy()
    np.testing.assert_array_equal(trc, want[3])
    # the dense traced oracle over all pairs gives the same integers
    _, cnt_d, trc_d = t_ref.interactions_dense_traced(
        *_torch(args[:7]), torch.as_tensor(src), args[-1][0], args[-1][1])
    np.testing.assert_array_equal(trc_d.numpy(), trc)
    np.testing.assert_array_equal(cnt_d.numpy(), got[1].numpy())
    assert (trc <= got[1].numpy()).all()
    return trc


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_random_cases_match_reference_kernel(seed, packed):
    _check(_random(seed, packed))


@pytest.mark.parametrize("kind", EXTREMES)
@pytest.mark.parametrize("packed", [False, True])
def test_extremes_match_reference_kernel(kind, packed):
    acc, cnt = _check(_extreme(kind, packed))
    if kind == "zero_infectious":
        assert float(acc.abs().sum()) == 0.0 and int(cnt.sum()) == 0
    if kind == "all_infectious":
        assert int(cnt.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_random_cases_match_reference_backend(backend, seed, packed):
    args, src = _random(seed, packed, np.random.default_rng(1000 + seed))
    trc = _check_backend(args, src, backend)
    assert trc.sum() > 0  # the case exercises the tracing accumulator


@pytest.mark.parametrize("kind", EXTREMES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_extremes_match_reference_backend(backend, kind, packed):
    args, src = _extreme(kind, packed, np.random.default_rng(_EXTREME_SEEDS[kind]))
    trc = _check_backend(args, src, backend)
    if kind == "zero_infectious":
        assert trc.sum() == 0


@pytest.mark.parametrize("case", [("random", 0), ("random", 1), ("random", 2),
                                  *(("extreme", k) for k in EXTREMES)])
def test_four_plain_variants_bitwise(case):
    """Compacted and padded, untraced and traced: one set of live tiles in
    one order, so every output is bitwise equal across the four, and the
    traced calls leave the exposure outputs unchanged."""
    kind, which = case
    make = _random if kind == "random" else _extreme
    args, src = make(which, True, np.random.default_rng(7))
    t = _torch(args)
    s = torch.as_tensor(src)
    rc = t_ops.compact_schedule(t[7], t[8], *t[10:13])
    kargs = (*t[:7], *rc, *t[11:])
    acc, cnt, edges = t_kernel.interactions_compact_plain(*kargs, block_size=B)
    acc_ct, cnt_ct, trc_ct, edges_ct = t_kernel.interactions_compact_plain(
        *kargs, block_size=B, src_val=s)
    acc_p, cnt_p = t_kernel.interactions_padded_plain(*t, block_size=B)
    acc_pt, cnt_pt, trc_pt = t_kernel.interactions_padded_plain(*t, block_size=B, src_val=s)
    for a in (acc_ct, acc_p, acc_pt):
        assert torch.equal(a, acc)
    for c in (cnt_ct, cnt_p, cnt_pt):
        assert torch.equal(c, cnt)
    assert torch.equal(trc_ct, trc_pt)
    assert int(edges) == int(edges_ct) == int(cnt.sum())


def test_padded_plain_skips_schedule_padding():
    """The schedule's padding repeats the last real tile with pair_active
    = 0; the padded pass must not add that tile a second time."""
    day_v, p_loc, sus_pp, inf_pp = _extreme_case("all_infectious", b=B)
    sched = pop_lib.build_block_schedule(day_v.loc, day_v.num_real, B)
    padded = pop_lib.build_block_schedule(day_v.loc, day_v.num_real, B,
                                          pad_to=sched.row_block.shape[0] + 3)
    args = _torch(_inputs(day_v, day_v.num_real, p_loc, sus_pp, inf_pp, 77, 3))
    acc, cnt = t_ops.interactions_padded(*args, block_size=B)
    sched_args = [torch.as_tensor(a.astype(np.int32)) for a in (
        padded.row_block, padded.col_block, padded.row_start, padded.pair_active)]
    acc2, cnt2 = t_ops.interactions_padded(*args[:7], *sched_args, *args[11:],
                                           block_size=B)
    assert int(cnt.sum()) > 0
    assert torch.equal(acc, acc2) and torch.equal(cnt, cnt2)


def test_compaction_is_stable_live_first():
    args = _random(4, False)
    row, col, _, pa, cinf, rsus = (torch.as_tensor(a) for a in args[7:13])
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
    args, src = _random(1, False, np.random.default_rng(3))
    before = [w.launches for w in WRAPPERS]
    for backend in BACKENDS:
        acc, cnt, edges = _port(args, backend)
        assert acc.dtype == torch.float32 and cnt.dtype == torch.int32
        assert edges.dtype == torch.int64 and edges.shape == ()
        *_, trc = _port(args, backend, src)
        assert trc.dtype == torch.int32
    assert [w.launches for w in WRAPPERS] == before  # no kernel here
    with pytest.raises(ValueError, match="unknown interaction backend"):
        _port(args, "compact")


def test_plain_version_chunking_is_bitwise_neutral(monkeypatch):
    args, src = _extreme("single_giant_location", False, np.random.default_rng(5))
    t = _torch(args)
    rc = t_ops.compact_schedule(t[7], t[8], *t[10:13])
    kargs = (*t[:7], *rc, *t[11:])
    calls = (
        lambda: t_kernel.interactions_compact_plain(
            *kargs, block_size=B, src_val=torch.as_tensor(src)),
        lambda: t_kernel.interactions_padded_plain(*t, block_size=B),
    )
    whole = [f() for f in calls]
    monkeypatch.setattr(t_kernel, "TILES_PER_CHUNK", 1)
    for out, f in zip(whole, calls):
        for a, b in zip(out, f()):
            assert torch.equal(a, b)
