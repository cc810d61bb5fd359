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
from repro_torch.core import rng as t_rng

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


# ---------------------------------------------------------------------------
# The CUDA kernels' two identities, pinned on the CPU. The kernels
# (csrc/interactions.cu) hoist the contact hash into per-day, per-visit and
# per-pair parts and compare (h >> 8) with a per-row threshold instead of the
# float uniform with p; and they add only the terms of contributing contact
# pairs. Both must leave every output bitwise unchanged.
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _inner(w, i):
    """Word i's inner hash of rng.hash_u32's fold, in the int64 carrier."""
    return t_rng.fmix32((t_rng._u32(w) + _GOLDEN * (i + 1)) & _MASK)


def _hoisted_hash(seed, day, pid_i, pid_j, loc):
    """The kernels' contact hash: the day's prefix, each visit's words A and
    B, the row's loc word L, and per pair two finalizers."""
    prefix = t_rng.fmix32(t_rng._u32(seed) ^ _GOLDEN)
    prefix = t_rng.fmix32(prefix ^ _inner(t_rng.CONTACT, 0))
    prefix = t_rng.fmix32(prefix ^ _inner(day, 1))
    A = lambda pid: t_rng.fmix32(prefix ^ _inner(pid, 2))
    Bw = lambda pid: _inner(pid, 3)
    lo = pid_i < pid_j
    h = torch.where(lo, A(pid_i) ^ Bw(pid_j), A(pid_j) ^ Bw(pid_i))
    return t_rng.fmix32(t_rng.fmix32(h) ^ _inner(loc, 4))


def _uniform24(k):
    """ref.py's uniform of a hash whose top 24 bits are k, in float32."""
    return (np.asarray(k).astype(np.float32) * np.float32(2.0**-24)
            + np.float32(2.0**-25)).astype(np.float32)


def _threshold(p):
    """Python mirror of the kernels' contact_threshold: a guess from p, then
    the two loops that settle on the count of k with uniform24(k) < p."""
    p = np.float32(p)
    if not p > 0:
        return 0
    e = float(p) * 16777216.0 - 0.5
    k = 0 if e <= 0 else 1 << 24 if e >= 16777216.0 else int(e)
    while k > 0 and not _uniform24(k - 1) < p:
        k -= 1
    while k < 1 << 24 and _uniform24(k) < p:
        k += 1
    return k


_U24 = None


def _grid_count(p):
    """The count of k in [0, 2^24) with uniform24(k) < p, over the whole grid."""
    global _U24
    if _U24 is None:
        _U24 = _uniform24(np.arange(1 << 24, dtype=np.int64))
    if np.isnan(p):  # nothing compares < NaN (searchsorted sorts NaN last)
        return 0
    return int(np.searchsorted(_U24, np.float32(p), side="left"))


_U32_EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9, _MASK - 1, _MASK],
                      np.int64)


@pytest.mark.parametrize("case", ["random", "edges", "equal_pids", "large_pids"])
def test_hoisted_hash_equals_rng_uniform(case):
    """The hoisted hash gives ref.contact_uniform's draw bitwise, in either
    pid order, on random and extreme u32 seeds, days, pids and locs."""
    rs = np.random.default_rng(["random", "edges", "equal_pids", "large_pids"].index(case))
    n = 4096
    pid_max = np.iinfo(np.int32).max
    if case == "edges":
        seed = rs.choice(_U32_EDGES, n)
        day = rs.choice(_U32_EDGES, n)
        pid_i = rs.choice(np.array([0, 1, 2, pid_max - 1, pid_max]), n)
        pid_j = rs.choice(np.array([0, 1, 2, pid_max - 1, pid_max]), n)
        loc = rs.choice(np.array([0, 1, pid_max]), n)
    else:
        seed = rs.integers(0, 1 << 32, n)
        day = rs.integers(0, 1 << 32, n)
        hi = pid_max if case == "large_pids" else 100_000
        pid_i = rs.integers(0, hi, n, endpoint=True)
        pid_j = pid_i.copy() if case == "equal_pids" else rs.integers(0, hi, n, endpoint=True)
        loc = rs.integers(0, hi, n, endpoint=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64))
    want = t_ref.contact_uniform(t(seed), t(day), t(pid_i), t(pid_j), t(loc))
    for a, b in ((pid_i, pid_j), (pid_j, pid_i)):
        h = _hoisted_hash(t(seed), t(day), t(a), t(b), t(loc))
        got = (h >> 8).to(torch.float32) * (2.0**-24) + (2.0**-25)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("which", ["grid", "extreme", "random"])
def test_contact_threshold_matches_the_float_compare(which):
    """(h >> 8) < threshold(p) exactly when the float32 uniform is < p: the
    threshold's guess-and-settle equals the count over the whole 2^24 grid,
    and the compare agrees on every k near it and on random hashes."""
    rs = np.random.default_rng(11)
    if which == "grid":  # p on and next to the uniform's own values
        k = rs.integers(0, 1 << 24, 64)
        u = _uniform24(k)
        ps = np.concatenate([u, np.nextafter(u, np.float32(0)), np.nextafter(u, np.float32(2))])
    elif which == "extreme":
        ps = np.array([0.0, -0.0, -1.0, 1e-45, 2.0**-26, 2.0**-25, 2.0**-24, 0.5, 1.0 - 2.0**-24,
                       1.0, 1.0 + 2.0**-23, 2.0, np.inf, -np.inf, np.nan], np.float32)
    else:
        ps = rs.random(64).astype(np.float32)
    for p in ps:
        thr = _threshold(p)
        assert thr == _grid_count(p), p
        for k in (thr - 2, thr - 1, thr, thr + 1):
            if 0 <= k < 1 << 24:
                assert (k < thr) == bool(_uniform24(k) < np.float32(p)), (p, k)
        h = rs.integers(0, 1 << 32, 256)
        assert ((h >> 8) < thr).tolist() == (_uniform24(h >> 8) < np.float32(p)).tolist()


def _skip_fold(args, src, b):
    """The kernels' order with the left-out terms: per live tile in schedule
    order, each row's part from 0.0f adds, in ascending column order, only the
    terms of contributing contacts (same loc, both pids >= 0 and different,
    overlap > 0, row sus != 0, column inf != 0, u < p); acc = acc + part."""
    pid, loc, start, end, p_loc, sus, inf = args[:7]
    rc = t_ops.compact_schedule(args[7], args[8], *args[10:13])
    n = int(rc[3][0])
    V = pid.shape[0]
    acc = torch.zeros(V, dtype=torch.float32)
    cnt = torch.zeros(V, dtype=torch.int32)
    trc = torch.zeros(V, dtype=torch.int32)
    seed, day = args[13][0], args[13][1]
    for rb, cb in zip(rc[0][:n].tolist(), rc[1][:n].tolist()):
        r = slice(rb * b, (rb + 1) * b)
        c = slice(cb * b, (cb + 1) * b)
        pr, pc = pid[r][:, None], pid[c][None, :]
        ov = (torch.minimum(end[r][:, None], end[c][None, :])
              - torch.maximum(start[r][:, None], start[c][None, :]))
        u = t_ref.contact_uniform(seed, day, pr, pc, loc[r][:, None])
        counts = ((loc[r][:, None] == loc[c][None, :]) & (pr >= 0) & (pc >= 0) & (pr != pc)
                  & (ov > 0) & (sus[r][:, None] != 0) & (inf[c][None, :] != 0)
                  & (u < p_loc[r][:, None]))
        part = torch.zeros(b, dtype=torch.float32)
        for j in range(b):
            term = (ov[:, j] * sus[r]) * inf[c][j]
            part = torch.where(counts[:, j], part + term, part)
        acc[r] = acc[r] + part
        pair = counts & (sus[r][:, None] > 0) & (inf[c][None, :] > 0)
        cnt[r] += pair.sum(1, dtype=torch.int32)
        trc[r] += (pair & (src[c][None, :] > 0)).sum(1, dtype=torch.int32)
    return acc, cnt, trc


def _shuffled(args, src, seed):
    """The visits permuted inside each block: a location's visits are no
    longer contiguous; the schedule and the block flags are unchanged."""
    V = args[0].shape[0]
    perm = np.random.default_rng(seed).permuted(np.arange(V).reshape(-1, B), axis=1).reshape(-1)
    return (*(a[perm] for a in args[:7]), *args[7:]), src[perm]


def _crafted(kind):
    """Small days that put each left-out kind of pair into live tiles:
    rows with sus = 0 and columns with inf = 0 meeting at one location,
    pairs whose windows only touch (overlap 0), and pid -1 slots."""
    rs = np.random.default_rng({"zero_channels": 21, "zero_overlap": 22, "padding": 23}[kind])
    P, Vn = 40, 3 * B - 5
    person = rs.integers(0, P, Vn)
    loc = rs.integers(0, 3, Vn)
    if kind == "zero_overlap":  # back-to-back 1-hour slots: most pairs touch
        start = (rs.integers(0, 8, Vn) * 3600.0).astype(np.float32)
        end = (start + 3600.0).astype(np.float32)
    else:
        start = rs.uniform(0, 20000, Vn).astype(np.float32)
        end = (start + rs.uniform(3000, 20000, Vn)).astype(np.float32)
    day_v = pop_lib.pack_day(person, loc, start, end, pad_multiple=B)
    sus_pp = rs.uniform(0.1, 1.0, P).astype(np.float32)
    inf_pp = rs.uniform(0.1, 1.0, P).astype(np.float32)
    if kind == "zero_channels":
        sus_pp[: P // 2] = 0.0
        inf_pp[P // 4: 3 * P // 4] = 0.0
    p_loc = np.full(3, 0.7, np.float32)
    args, src = _inputs(day_v, day_v.num_real, p_loc, sus_pp, inf_pp, 5, 9,
                        np.random.default_rng(1))
    if kind == "padding":  # pid -1 slots inside the real prefix
        args = list(args)
        holes = rs.choice(day_v.num_real, 40, replace=False)
        args[0] = args[0].copy()
        args[0][holes] = -1
        for i in (5, 6):
            args[i] = args[i].copy()
            args[i][holes] = 0.0
        args = tuple(args)
    return args, src


_SKIP_CASES = ([("random", s, p) for s in (0, 1, 2) for p in (False, True)]
               + [("extreme", k, p) for k in EXTREMES for p in (False, True)]
               + [("shuffled", s, True) for s in (0, 1)]
               + [("crafted", k, False) for k in ("zero_channels", "zero_overlap", "padding")])


@pytest.mark.parametrize("case", _SKIP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_contributing_pairs_alone_give_the_plain_sums(case):
    """Summing only the contributing contacts, in ascending column order, gives
    the plain versions' acc, cnt and trc bitwise, on both schedules."""
    kind, which, packed = case
    if kind == "crafted":
        args, src = _crafted(which)
    else:
        make = _extreme if kind == "extreme" else _random
        args, src = make(which, packed, np.random.default_rng(40 + len(str(which))))
        if kind == "shuffled":
            args, src = _shuffled(args, src, which)
    t = _torch(args)
    s = torch.as_tensor(src)
    acc, cnt, trc = _skip_fold(t, s, B)
    rc = t_ops.compact_schedule(t[7], t[8], *t[10:13])
    plain_c = t_kernel.interactions_compact_plain(*t[:7], *rc, *t[11:], block_size=B, src_val=s)
    plain_p = t_kernel.interactions_padded_plain(*t, block_size=B, src_val=s)
    for got, want in ((acc, plain_c[0]), (cnt, plain_c[1]), (trc, plain_c[2]),
                      (acc, plain_p[0]), (cnt, plain_p[1]), (trc, plain_p[2])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    if kind == "crafted" or (kind == "extreme" and which == "all_infectious"):
        assert int(cnt.sum()) > 0
