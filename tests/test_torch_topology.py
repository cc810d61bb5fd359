"""The port's order statistic for the testing budget and its multi-channel
exposure combine, against the reference's LocalTopology on the same numpy
inputs.

Tolerances: ``rank_threshold`` is exact (the same ``(T, G)`` and the same
take mask); ``combine_many``'s channel 0 is bitwise the port's single-channel
``combine``, and its channel 1 (small integers in f32) equals the
reference's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.topology import LocalTopology as JTopology
from repro_torch.core.interactions import person_slot_table
from repro_torch.engine.topology import LocalTopology as TTopology

P = 500


def _scores(seed):
    """Tiered scores as the day step makes them: symptomatic in (0, 1),
    traced-only in (2, 3), ineligible at 4.0, with forced ties and values
    on the tier edges."""
    rs = np.random.default_rng(seed)
    u = rs.random(P).astype(np.float32)
    tier = rs.choice(3, P, p=[0.3, 0.3, 0.4])
    score = np.where(tier == 0, u, np.where(tier == 1, u + np.float32(2.0), 4.0))
    score = score.astype(np.float32)
    tie = rs.choice(P, 40, replace=False)
    score[tie] = score[tie[0]]  # one value shared by 40 people
    edge = rs.choice(P, 6, replace=False)
    score[edge] = np.float32([0.0, 1.0, 1.0, 2.0, 3.0, 3.0])
    return score


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [0, 1, 7, 40, 150, 299, 10_000])
def test_rank_threshold_matches_reference(seed, k):
    score = _scores(seed)
    gpid = np.arange(P)
    count = int((score < 4.0).sum())
    T_j, G_j = JTopology().rank_threshold(
        jnp.asarray(score), jnp.asarray(gpid, jnp.uint32), jnp.int32(k), P, 1)
    T_t, G_t = TTopology().rank_threshold(
        torch.as_tensor(score), torch.as_tensor(gpid), torch.tensor(k, dtype=torch.int32), P)
    assert float(T_t) == float(T_j) and int(G_t) == int(G_j)
    take = lambda s, T, g, G: (s < 4.0) & (k > 0) & ((s < T) | ((s == T) & (g <= G)))
    t_take = take(torch.as_tensor(score), T_t, torch.as_tensor(gpid), G_t).numpy()
    j_take = np.asarray(take(jnp.asarray(score), T_j, jnp.asarray(gpid, jnp.uint32), G_j))
    np.testing.assert_array_equal(t_take, j_take)
    assert t_take.sum() == min(k, count)  # the budget is exact


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_many_channel_zero_is_combine(seed):
    rs = np.random.default_rng(seed)
    V, people = 2048, 300
    pid = np.where(rs.random(V) < 0.8, rs.integers(0, people, V), -1).astype(np.int32)
    active = (pid >= 0) & (rs.random(V) < 0.9)
    acc = rs.uniform(0, 1e-3, V).astype(np.float32)
    trc = rs.integers(0, 5, V).astype(np.float32)
    slots = torch.as_tensor(person_slot_table(pid[None], people)[0])
    topo = TTopology()
    many = topo.combine_many(slots, torch.as_tensor(active),
                             torch.as_tensor(np.stack([acc, trc], -1)))
    one = topo.combine(slots, torch.as_tensor(active), torch.as_tensor(acc))
    assert many.shape == (people, 2) and many.dtype == torch.float32
    assert torch.equal(many[:, 0], one)
    ref = np.asarray(JTopology().combine_many(
        None, jnp.asarray(pid), jnp.asarray(active), jnp.asarray(np.stack([acc, trc], -1)),
        people))
    np.testing.assert_array_equal(many[:, 1].numpy(), ref[:, 1])
    np.testing.assert_allclose(many[:, 0].numpy(), ref[:, 0], rtol=1e-6, atol=0)
