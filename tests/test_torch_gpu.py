"""The port on a CUDA card: the interaction kernel bitwise against its plain
version, the launch counter, the wrapper's input checks, and the main path
launching the kernel once a day without a host sync.

Every test here is marked ``gpu`` and skips without a card; the file imports
no JAX, so it runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_epidemic
from repro_torch.core import contact as contact_lib
from repro_torch.core import disease, transmission
from repro_torch.core import population as pop_lib
from repro_torch.engine import EngineCore
from repro_torch.kernels.interactions import kernel as t_kernel
from repro_torch.kernels.interactions import ops as t_ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, b, visits, locations, people):
    """A random packed day with its interaction-pass inputs (CPU tensors)."""
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
    safe = np.maximum(day.person, 0)
    t = lambda a, dt: torch.as_tensor(np.array(a)).to(dt)
    pid = t(day.person, torch.int32)
    sus_v = t(sus[safe] * day.active, torch.float32)
    inf_v = t(inf[safe] * day.active, torch.float32)
    nb = pid.shape[0] // b
    return (pid, t(day.loc, torch.int32), t(day.start, torch.float32),
            t(day.end, torch.float32), t(p_loc[day.loc], torch.float32), sus_v, inf_v,
            t(sched.row_block, torch.int32), t(sched.col_block, torch.int32),
            t(sched.pair_active, torch.int32),
            t_ops.col_has_infectious(inf_v, pid, nb, b),
            t_ops.row_has_susceptible(sus_v, pid, nb, b),
            torch.tensor([seed, 11], dtype=torch.int64))


@pytest.mark.parametrize("seed,b,visits,locations,people", [
    (0, 64, 300, 30, 90), (1, 64, 3000, 200, 1000),
    (2, 128, 20000, 1500, 6000), (3, 128, 30000, 2000, 10000),
])
def test_kernel_bitwise_equals_plain(cuda, seed, b, visits, locations, people):
    args = _case(seed, b, visits, locations, people)
    cpu = t_ops.interactions_compact_edges(*args, block_size=b)
    before = t_kernel.interactions_compact_cuda.launches
    gpu = t_ops.interactions_compact_edges(*[a.to(cuda) for a in args], block_size=b)
    torch.cuda.synchronize()
    assert t_kernel.interactions_compact_cuda.launches == before + 1
    for a, g in zip(cpu, gpu):
        assert a.dtype == g.dtype and torch.equal(a, g.cpu())
    assert int(gpu[2]) == int(gpu[1].sum()) > 0


def test_kernel_wrapper_refuses_bad_inputs(cuda):
    args = [a.to(cuda) for a in _case(0, 64, 300, 30, 90)]
    rc = t_ops.compact_schedule(*args[7:12])
    kargs = [*args[:7], *rc, *args[10:]]
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


def test_main_path_launches_the_kernel_daily_without_sync(cuda):
    pop = get_epidemic("twin-2k").build()
    core = EngineCore.single(pop, disease.covid_model(),
                             transmission.TransmissionModel(tau=2e-5), device=cuda)
    state = core.init_state1()
    torch.cuda.synchronize()
    t_kernel.interactions_compact_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, hist = core.run_days(10, state=state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert t_kernel.interactions_compact_cuda.launches == 10
    _, again = core.run_days(10)
    assert torch.equal(hist, again)
    h = hist.cpu().numpy()
    assert (h[:, 5] == h[:, 6]).all()  # contacts == edges
