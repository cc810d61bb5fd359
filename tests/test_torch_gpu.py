"""The port on a CUDA card: the four interaction kernels bitwise against
their plain versions and each other, one scenario or a batch in one launch,
the launch counters, the wrappers' input checks, and the main path, the TTI
path and a scenario ensemble launching their kernel once a day without a
host sync; the counter draw's kernel bitwise its int64 plain version (day,
TTI and contact shapes, a captured graph, four launches an eager day);
checkpointed studies resumed and recovered bitwise, launches
counting the replayed days, and the invariant guards on a card state equal
to those on its CPU copy; the flash-attention kernel against its
plain version, its wrapper's checks, and a prefill launching it once per
layer; a one-rank nccl mesh and a two-rank gloo mesh sharing the card,
bitwise the local card run; elastic shrinks of a two- and a four-rank mesh,
bitwise the uninterrupted run; the static-network mode against its
EpiHiper-style oracle; the reference's lower-level entry points
(``run_eager``, ``run_scan``, ``day_step``) bitwise the engine on the card;
a server on a two-rank gloo mesh sharing the card, bitwise the local card
run.

Every test here is marked ``gpu`` and skips without a card; the file imports
no JAX, so it runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, INTERVENTION_PRESETS, get_epidemic, reduced_config
from repro_torch.core import contact as contact_lib
from repro_torch.core import disease, rng, transmission
from repro_torch.core import population as pop_lib
from repro_torch.engine import EngineCore
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as f_kernel
from repro_torch.kernels.interactions import kernel as t_kernel
from repro_torch.kernels.rng import kernel as rng_kernel
from repro_torch.models import model as t_model
from repro_torch.kernels.interactions import ops as t_ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, b, visits, locations, people):
    """A random packed day with its interaction-pass inputs (CPU tensors, in
    the wrappers' argument order) and a tracing-source vector."""
    rs = np.random.default_rng(seed)
    person = rs.integers(0, people, visits)
    loc = rs.integers(0, locations, visits)
    loc[rs.random(visits) < 0.2] = 0  # one giant location across blocks
    start = rs.uniform(0, 80000, visits).astype(np.float32)
    end = (start + rs.uniform(600, 20000, visits)).astype(np.float32)
    day = pop_lib.pack_day_occupancy(
        pop_lib.pack_day(person, loc, start, end, pad_multiple=b), b)
    sched = pop_lib.build_block_schedule(day.loc, day.extent, b)
    p_loc = contact_lib.MinMaxAlpha().probability(
        contact_lib.max_occupancy_fast(locations, loc, start, end))
    sus = np.where(rs.random(people) < 0.7, rs.uniform(0.1, 1, people), 0)
    inf = np.where(rs.random(people) < 0.2, rs.uniform(0.1, 1, people), 0)
    src = np.where((inf > 0) & (rs.random(people) < 0.3), 1.0, 0.0)
    safe = np.maximum(day.person, 0)
    t = lambda a, dt: torch.as_tensor(np.array(a)).to(dt)
    pid = t(day.person, torch.int32)
    sus_v = t(sus[safe] * day.active, torch.float32)
    inf_v = t(inf[safe] * day.active, torch.float32)
    nb = pid.shape[0] // b
    args = (pid, t(day.loc, torch.int32), t(day.start, torch.float32),
            t(day.end, torch.float32), t(p_loc[day.loc], torch.float32), sus_v, inf_v,
            t(sched.row_block, torch.int32), t(sched.col_block, torch.int32),
            t(sched.row_start, torch.int32), t(sched.pair_active, torch.int32),
            t_ops.col_has_infectious(inf_v, pid, nb, b),
            t_ops.row_has_susceptible(sus_v, pid, nb, b),
            torch.tensor([seed, 11], dtype=torch.int64))
    return args, t(src[safe] * day.active, torch.float32)


CASES = [(0, 64, 300, 30, 90), (1, 64, 3000, 200, 1000),
         (2, 128, 20000, 1500, 6000), (3, 128, 30000, 2000, 10000)]
WRAPPERS = {
    "compact": t_kernel.interactions_compact_cuda,
    "compact_traced": t_kernel.interactions_compact_traced_cuda,
    "padded": t_kernel.interactions_padded_cuda,
    "padded_traced": t_kernel.interactions_padded_traced_cuda,
}


@pytest.mark.parametrize("seed,b,visits,locations,people", CASES)
def test_kernel_bitwise_equals_plain(cuda, seed, b, visits, locations, people):
    args, _ = _case(seed, b, visits, locations, people)
    cpu = t_ops.interactions_compact_edges(*args, block_size=b)
    before = t_kernel.interactions_compact_cuda.launches
    gpu = t_ops.interactions_compact_edges(*[a.to(cuda) for a in args], block_size=b)
    torch.cuda.synchronize()
    assert t_kernel.interactions_compact_cuda.launches == before + 1
    for a, g in zip(cpu, gpu):
        assert a.dtype == g.dtype and torch.equal(a, g.cpu())
    assert int(gpu[2]) == int(gpu[1].sum()) > 0


@pytest.mark.parametrize("kernel", ["compact_traced", "padded", "padded_traced"])
@pytest.mark.parametrize("seed,b,visits,locations,people", CASES)
def test_new_kernels_bitwise_equal_plain_and_each_other(cuda, kernel, seed, b, visits,
                                                        locations, people):
    """Each new kernel against its plain version on the same CPU inputs, and
    against the untraced compacted kernel: the same live tiles in the same
    order, so acc and cnt are bitwise equal across schedules and arities."""
    args, src = _case(seed, b, visits, locations, people)
    backend = "pallas" if kernel.startswith("padded") else "pallas-compact"
    traced = kernel.endswith("traced")
    run = lambda a, s: (t_ops.interactions_auto_traced(*a, backend=backend, block_size=b,
                                                       src_val=s) if traced else
                        t_ops.interactions_auto_edges(*a, backend=backend, block_size=b))
    cpu = run(args, src)
    before = WRAPPERS[kernel].launches
    gpu = run([a.to(cuda) for a in args], src.to(cuda))
    torch.cuda.synchronize()
    assert WRAPPERS[kernel].launches == before + 1
    for a, g in zip(cpu, gpu):
        assert a.dtype == g.dtype and torch.equal(a, g.cpu())
    base = t_ops.interactions_compact_edges(*[a.to(cuda) for a in args], block_size=b)
    for a, g in zip(base, gpu):  # acc, cnt, edges
        assert torch.equal(a, g)
    if traced:
        assert 0 < int(gpu[3].sum()) <= int(gpu[1].sum())


def test_kernel_wrapper_refuses_bad_inputs(cuda):
    args, src = _case(0, 64, 300, 30, 90)
    args = [a.to(cuda) for a in args]
    rc = t_ops.compact_schedule(args[7], args[8], *args[10:13])
    kargs = [*args[:7], *rc, *args[11:]]
    with pytest.raises(ValueError, match="block_size"):
        t_kernel.interactions_compact_cuda(*kargs, block_size=48)
    bad = list(kargs)
    bad[2] = bad[2].double()
    with pytest.raises(ValueError, match="start"):
        t_kernel.interactions_compact_cuda(*bad, block_size=64)
    bad = list(kargs)
    bad[0] = bad[0].cpu()
    with pytest.raises(ValueError, match="pid"):
        t_kernel.interactions_compact_cuda(*bad, block_size=64)
    with pytest.raises(ValueError, match="src_val"):
        t_kernel.interactions_padded_traced_cuda(*args, src_val=src.to(cuda)[:-1],
                                                 block_size=64)
    with pytest.raises(ValueError, match="schedule"):
        t_kernel.interactions_padded_cuda(*args[:10], args[10][:-1], *args[11:],
                                          block_size=64)


def test_main_path_launches_the_kernel_daily_without_sync(cuda):
    pop = get_epidemic("twin-2k").build()
    core = EngineCore.single(pop, disease.covid_model(),
                             transmission.TransmissionModel(tau=2e-5), device=cuda)
    state = core.init_state()
    torch.cuda.synchronize()
    t_kernel.interactions_compact_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, hist, _ = core.run_days(10, state=state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert t_kernel.interactions_compact_cuda.launches == 10
    _, _, again, _ = core.run_days(10)
    assert torch.equal(hist, again)
    h = hist.cpu().numpy()
    assert (h[:, 5] == h[:, 6]).all()  # contacts == edges


def test_tti_path_launches_the_traced_kernel_daily_without_sync(cuda):
    """A TTI run on each backend: one launch a day of that backend's traced
    kernel and of no other, no host sync, and bitwise-equal histories."""
    pop = get_epidemic("twin-2k").build()
    hists = {}
    for backend, kernel in (("pallas-compact", "compact_traced"),
                            ("pallas", "padded_traced")):
        core = EngineCore.single(pop, disease.covid_model(),
                                 transmission.TransmissionModel(tau=2e-5),
                                 interventions=INTERVENTION_PRESETS["tti"],
                                 device=cuda, backend=backend)
        state = core.init_state()
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, hist, _ = core.run_days(20, state=state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert {k: w.launches for k, w in WRAPPERS.items()} == {
            k: 20 if k == kernel else 0 for k in WRAPPERS}
        hists[backend] = hist.cpu().numpy()
    h = hists["pallas"]
    assert np.array_equal(h, hists["pallas-compact"])
    assert (h[:, 5] == h[:, 6]).all()  # contacts == edges
    assert h[:, 7].sum() > 0  # tests were used


def _full_schedule(nb):
    """Every block pair, row-major: the schedule of a layout with no runs."""
    rows = torch.arange(nb, dtype=torch.int32).repeat_interleave(nb)
    cols = torch.arange(nb, dtype=torch.int32).repeat(nb)
    start = (cols == 0).to(torch.int32)
    return rows, cols, start, torch.ones_like(rows)


def _with_schedule(args, sched, b):
    """``args`` with another (row, col, row_start, pair_active) schedule and
    block flags recomputed from its channels."""
    pid, sus_v, inf_v = args[0], args[5], args[6]
    nb = pid.shape[0] // b
    return (*args[:7], *sched, t_ops.col_has_infectious(inf_v, pid, nb, b),
            t_ops.row_has_susceptible(sus_v, pid, nb, b), args[13])


def _layout_case(kind):
    """Layouts that break the redesigned kernels' shortcuts, as (args, src,
    b): visits shuffled inside each block; one location filling whole
    blocks (a band of off-diagonal tiles, longer than a group of tiles);
    locations alternating inside a block (every run of length 1, walked on
    the full schedule); rows without susceptibility and columns without
    infectivity inside live tiles; and one row run longer than a CTA's
    schedule chunk (entries k .. k + T - 1)."""
    if kind == "shuffled":
        args, src = _case(2, 128, 20000, 1500, 6000)
        V = args[0].shape[0]
        perm = np.random.default_rng(5).permuted(np.arange(V).reshape(-1, 128), axis=1)
        perm = torch.as_tensor(perm.reshape(-1))
        return (*(a[perm] for a in args[:7]), *args[7:]), src[perm], 128
    if kind == "band":
        rs = np.random.default_rng(6)
        n = 9 * 64 + 10  # one location over ten blocks, then a small one
        person = rs.integers(0, 400, n)
        loc = np.where(np.arange(n) < 9 * 64 + 3, 0, 1)
        start = rs.uniform(0, 60000, n).astype(np.float32)
        end = (start + rs.uniform(3000, 30000, n)).astype(np.float32)
        day = pop_lib.pack_day(person, loc, start, end, pad_multiple=64)
        sched = pop_lib.build_block_schedule(day.loc, day.num_real, 64)
        sus = np.where(rs.random(400) < 0.6, rs.uniform(0.1, 1, 400), 0)
        inf = np.where(rs.random(400) < 0.3, rs.uniform(0.1, 1, 400), 0)
        safe = np.maximum(day.person, 0)
        t = lambda a, dt: torch.as_tensor(np.array(a)).to(dt)
        args = (t(day.person, torch.int32), t(day.loc, torch.int32),
                t(day.start, torch.float32), t(day.end, torch.float32),
                torch.full((len(day.person),), 0.3), t(sus[safe] * day.active, torch.float32),
                t(inf[safe] * day.active, torch.float32),
                *(t(a, torch.int32) for a in (sched.row_block, sched.col_block,
                                              sched.row_start, sched.pair_active)),
                None, None, torch.tensor([3, 4], dtype=torch.int64))
        src = t(np.where(inf[safe] > 0, 1.0, 0.0) * day.active, torch.float32)
        return _with_schedule(args, args[7:11], 64), src, 64
    if kind == "alternating":
        args, src = _case(1, 64, 3000, 200, 1000)
        V = args[0].shape[0]
        loc = torch.arange(V, dtype=torch.int32) % 2  # A, B, A, B, ...
        args = (args[0], loc, *args[2:])
        return _with_schedule(args, _full_schedule(V // 64), 64), src, 64
    if kind == "zero_channels":
        args, src = _case(3, 128, 30000, 2000, 10000)
        lane = torch.arange(args[0].shape[0]) % 128
        sus_v = torch.where(lane < 64, 0.0, args[5])  # half the rows of each block
        inf_v = torch.where(lane % 3 == 0, 0.0, args[6])  # a third of the columns
        args = (*args[:5], sus_v, inf_v, *args[7:])
        return _with_schedule(args, args[7:11], 128), src, 128
    # long_run: row block 0 has 150 entries (a CTA of 2 x 32 threads scans
    # its run 64 entries at a time), cycling over all column blocks.
    args, src = _case(0, 32, 300, 30, 90)
    nb = args[0].shape[0] // 32
    rows = torch.cat([torch.zeros(150, dtype=torch.int32),
                      torch.arange(1, nb, dtype=torch.int32)])
    cols = torch.cat([torch.arange(150, dtype=torch.int32) % nb,
                      torch.arange(1, nb, dtype=torch.int32)])
    start = torch.cat([torch.tensor([1], dtype=torch.int32), torch.zeros(149, dtype=torch.int32),
                       torch.ones(nb - 1, dtype=torch.int32)])
    return _with_schedule(args, (rows, cols, start, torch.ones_like(rows)), 32), src, 32


LAYOUTS = ["shuffled", "band", "alternating", "zero_channels", "long_run"]


@pytest.mark.parametrize("kernel", list(WRAPPERS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernels_bitwise_on_layouts_without_shortcuts(cuda, layout, kernel):
    """Each kernel bitwise equal to its plain version on layouts where a
    location is not one run per block, fills whole blocks, alternates, or
    whose live tiles hold rows and columns that cannot contribute."""
    args, src, b = _layout_case(layout)
    backend = "pallas" if kernel.startswith("padded") else "pallas-compact"
    traced = kernel.endswith("traced")
    run = lambda a, s: (t_ops.interactions_auto_traced(*a, backend=backend, block_size=b,
                                                       src_val=s) if traced else
                        t_ops.interactions_auto_edges(*a, backend=backend, block_size=b))
    cpu = run(args, src)
    before = WRAPPERS[kernel].launches
    gpu = run([a.to(cuda) for a in args], src.to(cuda))
    torch.cuda.synchronize()
    assert WRAPPERS[kernel].launches == before + 1
    for a, g in zip(cpu, gpu):
        assert a.dtype == g.dtype and torch.equal(a, g.cpu())
    assert int(gpu[1].sum()) > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_padded_equals_compacted_on_layouts_without_shortcuts(cuda, layout):
    args, src, b = _layout_case(layout)
    args = [a.to(cuda) for a in args]
    src = src.to(cuda)
    for run in (lambda be: t_ops.interactions_auto_edges(*args, backend=be, block_size=b),
                lambda be: t_ops.interactions_auto_traced(*args, backend=be, block_size=b,
                                                          src_val=src)):
        for x, y in zip(run("pallas"), run("pallas-compact")):
            assert torch.equal(x, y)


@pytest.mark.parametrize("b", [32, 256, 512, 1024])
def test_kernels_bitwise_at_other_tile_widths(cuda, b):
    """Tile widths other than the main path's 128: 32 (many small CTAs) and
    256 to 1024, whose shared memory needs the opt-in above 48 KB (at 1024,
    one CTA of 1024 threads and ~225 KB)."""
    args, src = _case(b, b, 6 * b, 40, 3 * b)
    for kernel in WRAPPERS:
        backend = "pallas" if kernel.startswith("padded") else "pallas-compact"
        traced = kernel.endswith("traced")
        run = lambda a, s: (t_ops.interactions_auto_traced(*a, backend=backend, block_size=b,
                                                           src_val=s) if traced else
                            t_ops.interactions_auto_edges(*a, backend=backend, block_size=b))
        cpu = run(args, src)
        gpu = run([a.to(cuda) for a in args], src.to(cuda))
        torch.cuda.synchronize()
        for x, g in zip(cpu, gpu):
            assert x.dtype == g.dtype and torch.equal(x, g.cpu())
        assert int(gpu[1].sum()) > 0


def _batch_of(case, n, b):
    """``n`` scenarios on one layout (the case's visits, windows, p and
    schedule): scenario 0 is the case, each other has a share of its visits
    inactive, its own scaled and rolled channels and sources, its flags and
    meta; as (batched args, batched src, [(args, src) per scenario])."""
    base, src0 = case
    V = base[0].shape[0]
    nb = V // b
    scen = [(base, src0)]
    for i in range(1, n):
        rs = np.random.default_rng(50 + i)
        off = torch.as_tensor(rs.random(V) < 0.1 * i) | (base[0] < 0)
        pid = torch.where(off, -1, base[0])
        scale = torch.as_tensor(rs.uniform(0.5, 1.5, V).astype(np.float32))
        sus = torch.where(off, 0.0, base[5] * scale)
        inf = torch.where(off, 0.0, base[6].roll(i))
        src = torch.where(inf > 0, src0.roll(i), 0.0)
        args = (pid, *base[1:5], sus, inf, *base[7:11],
                t_ops.col_has_infectious(inf, pid, nb, b),
                t_ops.row_has_susceptible(sus, pid, nb, b),
                torch.tensor([1000 + i, 3 + i], dtype=torch.int64))
        scen.append((args, src))
    per = (0, 5, 6, 11, 12, 13)
    batched = tuple(torch.stack([a[j] for a, _ in scen]) if j in per else base[j]
                    for j in range(14))
    return batched, torch.stack([s for _, s in scen]), scen


def _run(kernel, args, src, b):
    backend = "pallas" if kernel.startswith("padded") else "pallas-compact"
    if kernel.endswith("traced"):
        return t_ops.interactions_auto_traced(*args, backend=backend, block_size=b, src_val=src)
    return t_ops.interactions_auto_edges(*args, backend=backend, block_size=b)


@pytest.mark.parametrize("kernel", list(WRAPPERS))
@pytest.mark.parametrize("b", [64, 128])
def test_batched_kernel_one_launch_bitwise_per_scenario(cuda, kernel, b):
    """Four scenarios in one launch: each scenario's outputs bitwise equal to
    the plain version's and to its own launch alone."""
    size = (20000, 1500, 6000) if b == 128 else (3000, 200, 1000)
    batched, src, scen = _batch_of(_case(2, b, *size), 4, b)
    cpu = _run(kernel, batched, src, b)
    before = WRAPPERS[kernel].launches
    gpu = _run(kernel, [a.to(cuda) for a in batched], src.to(cuda), b)
    torch.cuda.synchronize()
    assert WRAPPERS[kernel].launches == before + 1
    for c, g in zip(cpu, gpu):
        assert c.dtype == g.dtype and c.shape[0] == len(scen) and torch.equal(c, g.cpu())
    for s, (args, src_s) in enumerate(scen):
        alone = _run(kernel, [a.to(cuda) for a in args], src_s.to(cuda), b)
        for g, a in zip(gpu, alone):
            assert torch.equal(g[s], a)
    assert bool((gpu[1].sum(dim=1) > 0).all())


def test_batched_wrapper_refuses_mismatched_shapes(cuda):
    batched, src, _ = _batch_of(_case(0, 64, 300, 30, 90), 2, 64)
    args = [a.to(cuda) for a in batched]
    with pytest.raises(ValueError, match="loc"):
        t_ops.interactions_padded(*args[:1], args[1][None].expand(2, -1).contiguous(),
                                  *args[2:], block_size=64)
    with pytest.raises(ValueError, match="meta"):
        t_ops.interactions_padded(*args[:13], args[13][:1], block_size=64)
    rc = t_ops.compact_schedule(args[7], args[8], *args[10:13])
    assert rc[0].shape == (2, args[7].shape[0]) and rc[3].shape == (2,)
    with pytest.raises(ValueError, match="n_live"):
        t_kernel.interactions_compact_cuda(*args[:7], *rc[:3], rc[3][:1], *args[11:],
                                           block_size=64)


def test_ensemble_launches_once_a_day_for_the_batch(cuda):
    """A B = 4 ensemble: one launch a day for all four scenarios, no host
    sync, and each column bitwise equal to its own batch-of-one run."""
    from repro_torch.configs.sweep import ScenarioBatch

    pop = get_epidemic("twin-2k").build()
    batch = ScenarioBatch.from_product(
        interventions={n: INTERVENTION_PRESETS[n] for n in ("none", "lockdown")},
        tau=2e-5, seeds=[0, 1])
    core = EngineCore(pop, batch, device=cuda)
    state = core.init_state()
    torch.cuda.synchronize()
    t_kernel.interactions_compact_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, hist, _ = core.run_days(15, state=state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert t_kernel.interactions_compact_cuda.launches == 15
    for i, scen in enumerate(batch):
        _, _, one, _ = EngineCore(pop, [scen], device=cuda).run_days(15)
        assert torch.equal(one[..., 0], hist[..., i]), scen.name


# The counter draw (csrc/rng.cu): rng.uniform on CUDA tensors is one launch of
# the kernel, bitwise its plain version, core/rng.py's int64 path, here run
# on the card too.

EDGE_WORDS = (0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1, -1, -2**31, -2**63, 2**63 - 1)
DAY_PEOPLE = 55_130  # the benchmark cell's people


def _carriers(rs, *shape):
    """Random int64 carriers over the whole int64 range (negative ones too:
    the kernel reads the low 32 bits), the edge words first."""
    w = rs.integers(-2**63, 2**63 - 1, size=shape, dtype=np.int64, endpoint=True)
    flat = w.reshape(-1)
    n = min(len(EDGE_WORDS), flat.size)
    flat[:n] = EDGE_WORDS[:n]
    return torch.as_tensor(w)


def _draw_case(name, device):
    """(seed, *words) of one draw, on ``device``."""
    rs = np.random.default_rng(sum(map(ord, name)))
    gpid = torch.arange(DAY_PEOPLE, dtype=torch.int64)
    if name == "edge_words":
        inputs = (_carriers(rs, len(EDGE_WORDS), 1), rng.INFECT, *(_carriers(rs, 20_000)
                                                                 for _ in range(3)))
    elif name in ("day_b1", "day_b256"):
        B = 1 if name == "day_b1" else 256
        inputs = (_carriers(rs, B, 1), rng.INFECT, _carriers(rs, B, 1), gpid)
    elif name == "test_slot":  # engine/day.py's TEST draw: seed and four words
        inputs = (_carriers(rs, 256, 1), rng.TEST, _carriers(rs, 256, 1), 1, gpid)
    elif name == "contact_tiles":  # interactions/ref.py: seed and five words
        pid_r, pid_c = _carriers(rs, 128, 128, 1), _carriers(rs, 128, 1, 128)
        inputs = (_carriers(rs), rng.CONTACT, _carriers(rs), torch.minimum(pid_r, pid_c),
                  torch.maximum(pid_r, pid_c), _carriers(rs, 128, 128, 1))
    elif name == "int32_strided":
        # int32 words are cast as the plain version casts them; int64 views
        # reach the kernel with their strides
        inputs = (_carriers(rs, 256, 2).to(torch.int32)[:, 1:], rng.DWELL,
                  _carriers(rs, 1, 256).t(), _carriers(rs, 3 * DAY_PEOPLE)[::3])
    elif name == "python_seed":
        inputs = (2**32 - 1, rng.SEED_CHOICE, -5, _carriers(rs, 7, 1000))
    return tuple(x.to(device) if isinstance(x, torch.Tensor) else x for x in inputs)


DRAWS = ("edge_words", "day_b1", "day_b256", "test_slot", "contact_tiles",
         "int32_strided", "python_seed")


@pytest.mark.parametrize("name", DRAWS)
def test_rng_kernel_bitwise_equals_plain(cuda, name):
    inputs = _draw_case(name, cuda)
    want = rng.uniform_plain(*inputs)
    before = rng_kernel.uniform_cuda.launches
    got = rng.uniform(*inputs)
    torch.cuda.synchronize()
    assert rng_kernel.uniform_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    cpu = rng.uniform_plain(*(x.cpu() if isinstance(x, torch.Tensor) else x
                              for x in inputs))
    assert torch.equal(got.cpu(), cpu)


def test_rng_kernel_in_a_captured_graph(cuda):
    """A draw captured into a CUDA graph: each replay reads the static
    inputs as they are then, bitwise the plain version."""
    seed, _, day, gpid = _draw_case("day_b256", cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rng.uniform(seed, rng.INFECT, day, gpid)  # the library's build and load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rng.uniform(seed, rng.INFECT, day, gpid)
    for step in range(3):
        seed.add_(step + 1)
        day.add_(1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, rng.uniform_plain(seed, rng.INFECT, day, gpid))


def test_rng_wrapper_refuses_outside_its_envelope(cuda):
    w = torch.zeros((2,), dtype=torch.int64, device=cuda)
    before = rng_kernel.uniform_cuda.launches
    with pytest.raises(ValueError, match="rank"):
        rng.uniform(w.view(1, 1, 1, 1, 2), rng.INFECT)
    with pytest.raises(ValueError, match="words"):
        rng.uniform(w, rng.INFECT, 1, 2, 3, 4, 5, 6)
    with pytest.raises(ValueError, match="device"):
        rng.uniform(w, rng.INFECT, w.cpu())
    assert rng_kernel.uniform_cuda.launches == before


def test_main_path_day_launches_the_draws_without_sync(cuda):
    """One eager day without per-agent slots: four draws (infection,
    seeding, transition, dwell), each one launch, no host sync."""
    pop = get_epidemic("twin-2k").build()
    core = EngineCore.single(pop, disease.covid_model(),
                             transmission.TransmissionModel(tau=2e-5), device=cuda)
    state = core.init_state()
    core.run_days(1, state=state)  # the library's build and load
    torch.cuda.synchronize()
    before = rng_kernel.uniform_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        core.run_days(1, state=state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rng_kernel.uniform_cuda.launches == before + 4


# Flash attention: the kernel and its plain version run the same float32
# arithmetic in another order (float32 |d| <= 1e-5 + 1e-5|x|); a bfloat16
# output may round to the neighbouring bfloat16 (|d| <= 2e-2 + 1e-2|x|).
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("Dh", f_kernel.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk,causal,window", [(128, 128, True, None),
                                                 (100, 173, True, None),
                                                 (96, 96, True, 20),
                                                 (70, 90, False, None),
                                                 (200, 300, True, None),
                                                 (200, 300, False, None)])
def test_flash_kernel_matches_plain(cuda, dtype, Dh, Sq, Sk, causal, window):
    """Full and ragged tiles (200 x 300: Sq not a multiple of the bf16
    design's 128 query rows, Sk not of its 64 keys), end-aligned queries, a
    window narrower than a key tile, bidirectional; 6 query heads over 2
    key/value heads. bf16 runs the wgmma kernel, float32 the split-TF32 one."""
    g = torch.Generator(device=cuda).manual_seed(Dh + Sq)
    draw = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = draw(6, Sq, Dh), draw(2, Sk, Dh), draw(2, Sk, Dh)
    before = f_kernel.flash_attention_bhsd_cuda.launches
    got = f_kernel.flash_attention_bhsd_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert f_kernel.flash_attention_bhsd_cuda.launches == before + 1
    want = f_kernel.flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("Dh", f_kernel.HEAD_DIMS)
def test_flash_kernel_serving_shape(cuda, Dh, dtype):
    """One sequence of the serving prefill's shape: Sq = Sk = 512, 12 query
    heads over 2 key/value heads (G = 6), causal."""
    g = torch.Generator(device=cuda).manual_seed(Dh)
    draw = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = draw(12, 512, Dh), draw(2, 512, Dh), draw(2, 512, Dh)
    got = f_kernel.flash_attention_bhsd_cuda(q, k, v)
    want = f_kernel.flash_attention_bhsd_plain(q, k, v)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_grid_beyond_the_sms(cuda, causal, dtype):
    """More CTAs than the card has SMs (8 x 12 heads of 512 queries: 384
    CTAs of 128 rows in bf16, 768 of 64 in float32), so CTAs wait for a free
    SM and run in several waves."""
    g = torch.Generator(device=cuda).manual_seed(int(causal))
    draw = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = draw(96, 512, 128), draw(16, 512, 128), draw(16, 512, 128)
    ctas = -(-512 // f_kernel.TILES[dtype][0]) * 96
    assert ctas > torch.cuda.get_device_properties(cuda).multi_processor_count
    got = f_kernel.flash_attention_bhsd_cuda(q, k, v, causal=causal)
    want = f_kernel.flash_attention_bhsd_plain(q, k, v, causal=causal)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("Dh", f_kernel.HEAD_DIMS)
def test_flash_float32_reruns_are_bitwise(cuda, Dh):
    """No CTA splits a row's keys and no sum uses atomics, so two float32
    launches on the same inputs give the same bits (causal, a window, and
    end-aligned ragged tiles)."""
    g = torch.Generator(device=cuda).manual_seed(Dh + 1)
    draw = lambda *s: torch.randn(s, generator=g, device=cuda)
    for Sq, Sk, window in ((512, 512, None), (512, 512, 96), (200, 333, None)):
        q, k, v = draw(12, Sq, Dh), draw(2, Sk, Dh), draw(2, Sk, Dh)
        a = f_kernel.flash_attention_bhsd_cuda(q, k, v, window=window)
        b = f_kernel.flash_attention_bhsd_cuda(q, k, v, window=window)
        assert torch.equal(a, b)


def test_flash_float32_takes_more_than_65535_heads(cuda):
    """The 1-D grid takes BH > 65535 (a grid's y dimension stops there):
    65,544 query heads over 8,193 key/value heads, Sq 8 of Sk 24, against
    the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    draw = lambda *s: torch.randn(s, generator=g, device=cuda)
    q, k, v = draw(65_544, 8, 64), draw(8_193, 24, 64), draw(8_193, 24, 64)
    got = f_kernel.flash_attention_bhsd_cuda(q, k, v)
    want = f_kernel.flash_attention_bhsd_plain(q, k, v)
    atol, rtol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_flash_wrapper_refuses_bad_inputs(cuda):
    q = torch.randn(4, 64, 64, device=cuda)
    k = torch.randn(2, 64, 64, device=cuda)
    before = f_kernel.flash_attention_bhsd_cuda.launches
    with pytest.raises(ValueError, match="cpu"):  # no mix of devices
        f_kernel.flash_attention_bhsd_cuda(q, k.cpu(), k)
    with pytest.raises(ValueError, match="cpu"):
        flash_attention(q.view(1, 64, 2, 2, 64), k.cpu().view(1, 64, 2, 64),
                        k.view(1, 64, 2, 64))
    with pytest.raises(ValueError, match="head dim"):
        f_kernel.flash_attention_bhsd_cuda(q[..., :32].contiguous(),
                                           k[..., :32].contiguous(), k[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        f_kernel.flash_attention_bhsd_cuda(q.transpose(0, 1).contiguous().transpose(0, 1),
                                           k, k)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        f_kernel.flash_attention_bhsd_cuda(q.half(), k.half(), k.half())
    odd = torch.empty(4 * 64 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(4, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):  # TMA needs aligned rows
        f_kernel.flash_attention_bhsd_cuda(odd, k.bfloat16(), k.bfloat16())
    odd = torch.empty(4 * 64 * 64 + 1, device=cuda)[1:].view(4, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):  # so does cp.async
        f_kernel.flash_attention_bhsd_cuda(odd, k, k)
    assert f_kernel.flash_attention_bhsd_cuda.launches == before


def test_prefill_launches_flash_once_per_layer(cuda):
    """A reduced qwen2 (head dim 64, a width the kernel takes) prefilled
    with attn_impl "flash" on the card: one launch per layer, and logits
    within 1e-3 of the CPU path's (float32 compute)."""
    cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-1.5b"]), head_dim=64,
                              compute_dtype="float32", attn_impl="flash")
    params = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 96)))
    want, _ = t_model.forward_prefill(cfg, params, {"tokens": toks})
    on_card = {k: {kk: a.to(cuda) for kk, a in v.items()} if isinstance(v, dict)
               else v.to(cuda) for k, v in params.items()}
    f_kernel.flash_attention_bhsd_cuda.launches = 0
    got, cache = t_model.forward_prefill(cfg, on_card, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert f_kernel.flash_attention_bhsd_cuda.launches == cfg.num_layers
    assert cache["k"].is_cuda
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)


# Checkpointed and resilient studies on the card (twin-2k): a resume and a
# recovery are bitwise the uninterrupted card run, and the interaction kernel
# launches once a day, replayed days included.


def _study(B, days=20):
    from repro_torch import api

    return api.ExperimentSpec(dataset="twin-2k", days=days, tau=2e-5,
                              interventions=("none", "lockdown")[:min(B, 2)],
                              replicates=max(B // 2, 1))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _same_study(a, b):
    for k in a.history:
        assert np.array_equal(a.history[k], b.history[k]), k
    for name in a.observables:
        got, want = _leaves(b.observables[name]), _leaves(a.observables[name])
        assert len(got) == len(want) > 0, name
        for x, y in zip(want, got):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), name


@pytest.mark.parametrize("B", [1, 4])
def test_resume_on_the_card_is_bitwise(cuda, tmp_path, B):
    from repro_torch import api

    pop = get_epidemic("twin-2k").build()
    ref = api.run(_study(B), population=pop)
    t_kernel.interactions_compact_cuda.launches = 0
    api.run(_study(B, days=8).with_overrides(ckpt_dir=str(tmp_path), ckpt_every=4),
            population=pop)
    res = api.run(_study(B).with_overrides(ckpt_dir=str(tmp_path), ckpt_every=4),
                  population=pop)
    assert t_kernel.interactions_compact_cuda.launches == 20  # 8 + 12, nothing twice
    assert res.provenance["resumed_from_day"] == 8 and res.num_scenarios == B
    _same_study(ref, res)


@pytest.mark.parametrize("kind", ["nan", "corrupt"])
def test_recovery_on_the_card_is_bitwise(cuda, tmp_path, kind):
    from repro_torch import api
    from repro_torch.runtime import ChaosEvent, ChaosSchedule

    pop = get_epidemic("twin-2k").build()
    ref = api.run(_study(4), population=pop)
    t_kernel.interactions_compact_cuda.launches = 0
    res = api.run(_study(4).with_overrides(ckpt_dir=str(tmp_path), ckpt_every=4,
                                           resilient=True),
                  population=pop, chaos=ChaosSchedule((ChaosEvent(kind, day=12),)))
    rep = res.provenance["resilience"]
    assert rep["restarts"] == 1 and rep["chunks_replayed"] == 1
    # the replayed days launch again: 20 days + one 4-day chunk
    assert t_kernel.interactions_compact_cuda.launches == 20 + 4 * rep["chunks_replayed"]
    assert res.provenance["resumed_from_day"] == 8
    _same_study(ref, res)


def test_guards_on_a_card_state_equal_its_cpu_copy(cuda):
    from repro_torch.runtime.guards import check_state

    pop = get_epidemic("twin-2k").build()
    core = EngineCore(pop, _study(4).build_batch(), device=cuda)
    st = core.run_days(10)[0]
    n = int(core.params.sus_table.shape[-1])
    prev = {k: getattr(st, k).clone() for k in ("cumulative", "isolated_until")}
    health = st.health.clone()
    health[1, 3] = n + 2
    dwell = st.dwell.clone()
    dwell[2, 5] = float("nan")
    bad = dataclasses.replace(st, health=health, dwell=dwell, cumulative=st.cumulative - 1)
    for state in (st, bad):
        on_card = check_state(state, num_states=n, prev=prev)
        on_cpu = check_state(dataclasses.replace(
            state, **{f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)}),
            num_states=n, prev={k: v.cpu() for k, v in prev.items()})
        assert on_card == on_cpu
    assert len(on_card) == 3 and check_state(st, num_states=n, prev=prev) == []


# The captured runner and the simulation server on the card: a runner is a
# CUDA graph of the batched day loop, replayed per chunk, each chunk bitwise
# its eager run (the later chunks too: nothing the loop reads as a Python
# value varies by call); launches counted per replay; a served result
# bitwise equal to a solo api.run on the card.


@pytest.mark.parametrize("preset", ["none", "tti"])
@pytest.mark.parametrize("backend", ["pallas-compact", "pallas"])
def test_captured_runner_equals_eager_run_days(cuda, backend, preset):
    from repro_torch.configs.sweep import ScenarioBatch
    from repro_torch.engine.runner import CapturedDays

    pop = get_epidemic("twin-2k").build()
    batch = ScenarioBatch.from_product(
        interventions={preset: INTERVENTION_PRESETS[preset]}, tau=2e-5, seeds=[0, 1, 2])
    core = EngineCore(pop, batch, device=cuda, backend=backend)
    kernel = {"pallas-compact": "compact", "pallas": "padded"}[backend] + (
        "_traced" if preset == "tti" else "")
    final, _, hist, _ = core.run_days(12)
    runner = core.runner_fn(4)
    state = core.init_state()
    state, _, first, _ = runner(core.params, state)  # the capture
    (build,) = runner.builds()
    assert isinstance(build, CapturedDays) and build.pool_bytes > 0
    draws = 4 + len(core.static.pa_slots)  # per day: four, and TTI's TEST per slot
    assert build.launches == {WRAPPERS[kernel]: 4, rng_kernel.uniform_cuda: 4 * draws}
    hists = [first]
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, _, h, _ = runner(core.params, state)
            hists.append(h)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {k: w.launches for k, w in WRAPPERS.items()} == {
        k: 8 if k == kernel else 0 for k in WRAPPERS}
    assert runner.cache_size() == 1
    assert torch.equal(torch.cat(hists), hist)
    for f in dataclasses.fields(final):
        assert torch.equal(getattr(final, f.name), getattr(state, f.name)), f.name
    if preset == "tti":
        assert hist[:, 7].sum() > 0  # tests were used


def test_a_failed_capture_raises(cuda):
    """A loop that syncs with the host cannot be captured: the build raises
    and nothing is cached; there is no eager fall back on the card."""
    from repro_torch.engine.runner import DayRunner

    def syncs(params, state, carries):
        return state, carries, params * float(state.sum()), None

    runner = DayRunner(syncs, cuda)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        runner(x, x)
    assert runner.cache_size() == 0


def test_served_on_the_card_bitwise_equals_solo_run(cuda):
    from repro_torch import api
    from repro_torch.engine.runner import CapturedDays
    from repro_torch.serve import ServeConfig, SimulationServer

    pop = get_epidemic("twin-2k").build()
    server = SimulationServer(ServeConfig(chunk_days=4, b_lattice=(8,)))
    server._pops["twin-2k"] = pop
    base = api.ExperimentSpec(dataset="twin-2k", days=10, tau=2e-5,
                              interventions=("none", "lockdown"))
    assert not server.warm_up(base)["already_warm"]
    specs = [base.with_overrides(seed=3), base.with_overrides(seed=5, replicates=2),
             base.with_overrides(seed=9, days=7)]
    tickets = [server.submit(s) for s in specs]
    server.drain()
    for spec, ticket in zip(specs, tickets):
        served = ticket.result(timeout=120)
        assert served.served_from["warm"]
        _same_study(api.run(spec, population=pop), served)
    m = server.metrics_dict()
    assert m["executables"] == {"cold_compiles": 1, "warm_dispatches": 2,
                                "recompile_violations": 0, "mesh_builds": {}}
    (key,) = list(server._buckets)
    (build,) = server._buckets.peek(key).runner().builds()
    assert isinstance(build, CapturedDays)


MESH_DAYS = 30


def _mesh_rank(pop, case, backend, sync_debug):
    """One rank of a ``workers`` mesh on the card: MESH_DAYS days of twin-2k
    (the day loop under sync-debug "error" when asked), its launches, the
    gathered final state and the history, as numpy."""
    import torch.distributed as dist

    kw = dict(interventions=INTERVENTION_PRESETS["tti"]) if case == "tti" else {}
    core = EngineCore.single(pop, disease.covid_model(), transmission.TransmissionModel(
        tau=2e-5), seed=0, device="cuda", backend=backend, layout="workers", **kw)
    dist.all_reduce(torch.zeros(1, device="cuda"), group=core.mesh.worker_group)
    torch.cuda.synchronize()  # the group's communicator is up before the loop
    for w in t_kernel.WRAPPERS:
        w.launches = 0
    torch.cuda.set_sync_debug_mode("error" if sync_debug else 0)
    try:
        final, _, hist, _ = core.run_days(MESH_DAYS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = {w.__name__: w.launches for w in t_kernel.WRAPPERS}
    final = core.gather_state(final)
    return ({f: getattr(final, f).cpu().numpy() for f in ("health", "dwell", "cumulative")},
            hist.cpu().numpy(), launches)


@pytest.mark.parametrize("dist_backend,W,case,backend", [
    ("nccl", 1, "none", "pallas-compact"), ("gloo", 2, "none", "pallas-compact"),
    ("gloo", 2, "tti", "pallas")])
def test_mesh_on_the_card_equals_the_local_run(cuda, tmp_path, dist_backend, W, case, backend):
    """A W = 1 mesh over nccl (its day loop under sync-debug "error") and a
    W = 2 mesh of two ranks sharing the card over gloo are bitwise the local
    card run, and each rank launches its kernel once a day."""
    from repro_torch.launch import mesh as mesh_lib

    pop = get_epidemic("twin-2k").build()
    kw = dict(interventions=INTERVENTION_PRESETS["tti"]) if case == "tti" else {}
    core = EngineCore.single(pop, disease.covid_model(), transmission.TransmissionModel(
        tau=2e-5), seed=0, device=cuda, backend=backend, **kw)
    final, _, hist, _ = core.run_days(MESH_DAYS)
    kernel = {"pallas-compact": "interactions_compact", "pallas": "interactions_padded"}[
        backend] + ("_traced" if case == "tti" else "") + "_cuda"
    for f, h, launches in mesh_lib.spawn(
            _mesh_rank, W, backend=dist_backend, device="cuda:0", init_dir=str(tmp_path),
            args=(pop, case, backend, dist_backend == "nccl"), timeout_s=60.0, wall_s=300.0):
        assert np.array_equal(h, hist.cpu().numpy())
        for k, v in f.items():
            assert np.array_equal(v[..., :pop.num_people], getattr(final, k).cpu().numpy()), k
        assert launches == {w.__name__: MESH_DAYS if w.__name__ == kernel else 0
                            for w in t_kernel.WRAPPERS}


SHRINK_DAYS, SHRINK_EVERY, SHRINK_DAY = 12, 3, 6


def _shrink_rank(spec, root):
    """One rank of a resilient twin-2k study on the card under a device loss
    of one worker at SHRINK_DAY: its history, report and launches."""
    from repro_torch import api
    from repro_torch.runtime import ChaosEvent, ChaosSchedule

    for w in t_kernel.WRAPPERS:
        w.launches = 0
    r = api.run(spec.with_overrides(ckpt_dir=root, ckpt_every=SHRINK_EVERY, resilient=True),
                chaos=ChaosSchedule((ChaosEvent("device_loss", day=SHRINK_DAY,
                                                workers_lost=1),)))
    return (r.history, r.provenance["resilience"],
            sum(w.launches for w in t_kernel.WRAPPERS))


@pytest.mark.parametrize("engine,mesh,replicates", [
    ("dist", dict(workers=2), 1), ("hybrid", dict(workers=2, scenarios=2), 3)])
def test_elastic_shrink_on_the_card_equals_the_uninterrupted_run(cuda, tmp_path, engine,
                                                                  mesh, replicates):
    """Ranks sharing the card over gloo lose their highest worker at day 6:
    the survivors' study is bitwise the uninterrupted local card run, the
    lost ranks retire at day 6, and every rank reads 2 -> 1."""
    from repro_torch import api
    from repro_torch.launch import mesh as mesh_lib

    spec = api.ExperimentSpec(dataset="twin-2k", days=SHRINK_DAYS, tau=2e-5,
                              replicates=replicates)
    ref = api.run(spec, device=cuda)
    ranks = mesh["workers"] * mesh.get("scenarios", 1)
    res = mesh_lib.spawn(_shrink_rank, ranks, backend="gloo", device="cuda:0",
                         init_dir=str(tmp_path / "pg"),
                         args=(spec.with_overrides(**mesh), str(tmp_path / "ck")),
                         timeout_s=60.0, wall_s=300.0)
    survivors = ranks // 2
    for rank, (hist, rep, launches) in enumerate(res):
        assert rep["device_losses"] == [{"workers_before": 2, "workers_after": 1}]
        assert rep["final_workers"] == 1
        assert rep["final_layout"] == ("workers" if engine == "dist" else "hybrid")
        if rank < survivors:
            assert launches == SHRINK_DAYS
            for k, v in ref.history.items():
                assert np.array_equal(hist[k], v), k
        else:
            assert hist == {} and rep["retired_at_day"] == SHRINK_DAY == launches


@pytest.mark.parametrize("backend", ["pallas-compact", "pallas"])
def test_static_mode_on_the_card_matches_the_oracle(cuda, backend):
    """The reference's static-network case (Watts-Strogatz 500, SIR, 30
    days) on the card equals the EpiHiper-style oracle on every day."""
    from repro_torch.core import baseline
    from repro_torch.data import watts_strogatz_population

    pop = watts_strogatz_population(500, 120, seed=9, name="bl")
    tm = transmission.TransmissionModel(tau=1.5e-5)
    oracle = baseline.run_sir_on_network(pop, baseline.precompute_contact_network(pop, seed=4),
                                         tm, 30, 4, seed_per_day=2, seed_days=5,
                                         recovery_days=7.0)
    core = EngineCore.single(pop, disease.sir_model(7.0), tm, seed=4, static_network=True,
                             seed_per_day=2, seed_days=5, device=cuda, backend=backend)
    _, hist = core.run1(30)
    for k in ("cumulative", "infectious"):
        assert np.array_equal(hist[k], oracle[k]), k


@pytest.mark.parametrize("backend", ["pallas-compact", "pallas"])
def test_lowlevel_views_on_the_card_equal_the_engine(cuda, backend):
    """``run_eager`` (each phase synchronised) and ``run_scan`` + ``day_step``
    on the card: bitwise ``run1``, one launch a day of the backend's
    kernel."""
    from repro_torch.core import simulator as sim_lib

    pop = get_epidemic("twin-2k").build()
    core = EngineCore.single(pop, disease.covid_model(), transmission.TransmissionModel(
        tau=2e-5), seed=0, device=cuda, backend=backend)
    final, hist = core.run1(10)
    kernel = {"pallas-compact": t_kernel.interactions_compact_cuda,
              "pallas": t_kernel.interactions_padded_cuda}[backend]
    torch.cuda.synchronize()
    for w in t_kernel.WRAPPERS:
        w.launches = 0
    st, he, times = sim_lib.run_eager(core, 10)
    static, week, cp, params = sim_lib.legacy_parts(core)
    mid, hs = sim_lib.run_scan(static, week, cp, params, core.init_state1(), 9)
    last, stats = sim_lib.day_step(static, week, cp, params, mid)
    assert {w: w.launches for w in t_kernel.WRAPPERS} == {
        w: 20 if w is kernel else 0 for w in t_kernel.WRAPPERS}
    for k in sim_lib.STAT_KEYS:
        assert np.array_equal(he[k], hist[k]), k
        assert np.array_equal(hs[k].cpu().numpy(), hist[k][:-1]), k
        assert int(stats[k]) == int(hist[k][-1]), k
    for f in ("health", "dwell", "cumulative", "vaccinated"):
        assert torch.equal(getattr(st, f), getattr(final, f)), f
        assert torch.equal(getattr(last, f), getattr(final, f)), f
    assert set(times) == {"visits", "interact", "update"}
    assert all((v > 0).all() for v in times.values())


def _serve_rank(specs):
    """One rank of a two-worker server sharing the card: rank 0 serves
    ``specs`` after warming their bucket, rank 1 follows; rank 0's
    histories, the dispatch log, the mesh builds and the launches."""
    from repro_torch.serve import ServeConfig, SimulationServer

    server = SimulationServer(ServeConfig(layout="workers", workers=2, chunk_days=4,
                                          b_lattice=(4,)))
    for w in t_kernel.WRAPPERS:
        w.launches = 0
    hists = None
    if server.rank == 0:
        server.warm_up(specs[0])
        tickets = [server.submit(s) for s in specs]
        server.drain()
        hists = [t.result(timeout=300).history for t in tickets]
        server.close()
    else:
        server.follow()
    return (hists, server.dispatch_log, dict(server.mesh_builds),
            sum(w.launches for w in t_kernel.WRAPPERS))


def test_served_on_a_card_mesh_equals_the_local_run(cuda, tmp_path):
    """Two ranks sharing the card over gloo serve two requests on the
    ``workers`` layout: bitwise their local card runs, the same dispatch log
    on both ranks, one launch a served (or warm-up) day on each."""
    from repro_torch import api
    from repro_torch.launch import mesh as mesh_lib

    specs = [api.ExperimentSpec(dataset="twin-2k", days=d, tau=2e-5, replicates=r, seed=s)
             for d, r, s in ((10, 2, 0), (7, 1, 4))]
    res = mesh_lib.spawn(_serve_rank, 2, backend="gloo", device="cuda:0",
                         init_dir=str(tmp_path), args=(specs,), timeout_s=60.0, wall_s=300.0)
    (hists, log0, builds, launches), (_, log1, builds1, launches1) = res
    assert log0 == log1 and [e[0] for e in log0] == ["warm", "dispatch", "dispatch"]
    assert builds == builds1 == {"groups": 1, "plan": 1, "tables": 1}
    assert launches == launches1 == 4 + 12 + 8  # the warm-up chunk, then 3 + 2 chunks
    for spec, hist in zip(specs, hists):
        ref = api.run(spec, device=cuda).history
        for k, v in ref.items():
            assert np.array_equal(hist[k], v), k
