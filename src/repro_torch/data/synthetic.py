"""Purely synthetic population generators (paper §IV-A2).

Two generators, mirroring the paper exactly:

1. **Watts–Strogatz**: a WS small-world random graph over locations is
   treated as a location–location graph and expanded to a people–location
   bipartite visit graph: each location homes ~Poisson(P/L) people (adjusted
   to exactly P, min 1); each person, each day, sets aside U(6,10) hours of
   sleep centered on midnight and partitions the remaining time between
   U{5..7} visits whose destinations are sampled with replacement from the
   home location's WS neighbors. Used for the WS-20M / WS-100M / WS-US
   strong-scaling datasets (we generate *-mini variants at runnable scale;
   the full shapes exist as configs for the dry-run).

2. **Grid (on-the-fly)**: locations on a W×H grid, `density` people per
   location; each day each person makes N~Poisson(lambda_visits) visits to
   locations ~Poisson(lambda_hops) grid-hops from home (paper: 5.2 and 8).
   Used for weak scaling (per-core loads of Table III).

All randomness is a deterministic function of the dataset seed.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import contact as contact_lib
from repro_torch.core import population as pop_lib

SECONDS_PER_DAY = 86400.0


def _person_attrs(P: int, rs: np.random.Generator):
    age_group = rs.choice(3, size=P, p=[0.22, 0.62, 0.16]).astype(np.int8)
    beta_sus = np.ones((P,), np.float32)
    beta_inf = np.ones((P,), np.float32)
    return age_group, beta_sus, beta_inf


def _ws_graph(L: int, k: int, beta: float, rs: np.random.Generator) -> np.ndarray:
    """Watts–Strogatz ring lattice with rewiring. Returns (L, k) neighbor
    table (directed view; sampling with replacement, so a table is enough)."""
    offsets = np.concatenate([np.arange(1, k // 2 + 1), -np.arange(1, k - k // 2 + 1)])
    nbrs = (np.arange(L)[:, None] + offsets[None, :]) % L
    rewire = rs.random(nbrs.shape) < beta
    nbrs = np.where(rewire, rs.integers(0, L, nbrs.shape), nbrs)
    # avoid self loops
    self_loop = nbrs == np.arange(L)[:, None]
    nbrs = np.where(self_loop, (nbrs + 1) % L, nbrs)
    return nbrs.astype(np.int64)


def watts_strogatz_population(
    num_people: int,
    num_locations: int,
    k: int = 6,
    beta: float = 0.1,
    seed: int = 0,
    name: str = "ws",
    pad_multiple: int = 128,
) -> pop_lib.Population:
    # detlint: ignore[DET001] — host-side population builder: deterministic
    # via the explicit seed; builds inputs, draws no simulation randomness.
    rs = np.random.default_rng(seed)
    P, L = num_people, num_locations
    nbrs = _ws_graph(L, k, beta, rs)

    # People per location ~ Poisson(P/L), adjusted to exactly P, min 1.
    counts = np.maximum(rs.poisson(P / L, size=L), 1).astype(np.int64)
    diff = counts.sum() - P
    while diff != 0:
        idx = rs.integers(0, L, size=abs(diff))
        if diff > 0:
            np.subtract.at(counts, idx, 1)
            counts = np.maximum(counts, 1)
        else:
            np.add.at(counts, idx, 1)
        diff = counts.sum() - P
    home = np.repeat(np.arange(L, dtype=np.int64), counts)[:P]

    age_group, beta_sus, beta_inf = _person_attrs(P, rs)

    week = []
    for _ in range(pop_lib.DAYS_PER_WEEK):
        sleep_h = rs.uniform(6.0, 10.0, size=P)
        awake_start = sleep_h / 2.0 * 3600.0
        awake_end = SECONDS_PER_DAY - awake_start
        nv = rs.integers(5, 8, size=P)  # U{5,6,7}
        vmax = int(nv.max())
        # Partition awake time: sorted uniform draws are the visit boundaries.
        u = np.sort(rs.random((P, vmax)), axis=1)
        starts = awake_start[:, None] + u * (awake_end - awake_start)[:, None]
        ends = np.concatenate([starts[:, 1:], awake_end[:, None]], axis=1)
        valid = np.arange(vmax)[None, :] < nv[:, None]
        choice = rs.integers(0, nbrs.shape[1], size=(P, vmax))
        dest = nbrs[home[:, None], choice]
        person_idx = np.broadcast_to(np.arange(P)[:, None], (P, vmax))
        sel = valid.ravel()
        week.append(
            pop_lib.pack_day(
                person_idx.ravel()[sel],
                dest.ravel()[sel],
                starts.ravel()[sel].astype(np.float32),
                ends.ravel()[sel].astype(np.float32),
                pad_multiple=pad_multiple,
            )
        )

    geo_key = np.arange(L, dtype=np.int64)  # ring order is the geography
    pop = pop_lib.Population(
        name=name,
        num_people=P,
        num_locations=L,
        age_group=age_group,
        beta_sus=beta_sus,
        beta_inf=beta_inf,
        home_loc=home.astype(np.int32),
        loc_type=np.full((L,), 3, np.int8),
        geo_key=geo_key,
        max_occupancy=np.zeros((L,), np.int32),
        contact_prob=np.zeros((L,), np.float32),
        week=pop_lib.pad_week_uniform(week, pad_multiple),
    )
    # Purely synthetic data: fixed contact probability (paper §IV-C3), since
    # max occupancy "cannot be computed in advance" in the on-the-fly case;
    # for precomputed WS data we *can* and do compute min/max/alpha.
    pop.finalize_contact_model(contact_lib.MinMaxAlpha())
    return pop


def grid_population(
    grid_width: int,
    grid_height: int,
    density: float = 4.0,
    lambda_visits: float = 5.2,
    lambda_hops: float = 8.0,
    seed: int = 0,
    name: str = "grid",
    pad_multiple: int = 128,
) -> pop_lib.Population:
    # detlint: ignore[DET001] — host-side population builder: deterministic
    # via the explicit seed; builds inputs, draws no simulation randomness.
    rs = np.random.default_rng(seed)
    L = grid_width * grid_height
    P = int(round(L * density))
    home = rs.integers(0, L, size=P).astype(np.int64)
    hx, hy = home % grid_width, home // grid_width
    age_group, beta_sus, beta_inf = _person_attrs(P, rs)

    week = []
    for _ in range(pop_lib.DAYS_PER_WEEK):
        nv = rs.poisson(lambda_visits, size=P)
        vmax = max(int(nv.max()), 1)
        hops = rs.poisson(lambda_hops, size=(P, vmax))
        theta = rs.uniform(0, 2 * np.pi, size=(P, vmax))
        dx = np.rint(hops * np.cos(theta)).astype(np.int64)
        dy = np.rint(hops * np.sin(theta)).astype(np.int64)
        gx = np.clip(hx[:, None] + dx, 0, grid_width - 1)
        gy = np.clip(hy[:, None] + dy, 0, grid_height - 1)
        dest = gy * grid_width + gx
        start = rs.uniform(6 * 3600, 22 * 3600, size=(P, vmax)).astype(np.float32)
        dur = rs.exponential(5400.0, size=(P, vmax)).astype(np.float32)
        end = np.minimum(start + np.maximum(dur, 300.0), SECONDS_PER_DAY)
        valid = np.arange(vmax)[None, :] < nv[:, None]
        person_idx = np.broadcast_to(np.arange(P)[:, None], (P, vmax))
        sel = valid.ravel()
        week.append(
            pop_lib.pack_day(
                person_idx.ravel()[sel],
                dest.ravel()[sel],
                start.ravel()[sel],
                end.ravel()[sel],
                pad_multiple=pad_multiple,
            )
        )

    # Geography: Morton-ish key preserving 2-D locality for partitioning.
    lx = np.arange(L) % grid_width
    ly = np.arange(L) // grid_width
    geo_key = (ly // 4) * grid_width * 4 + (lx // 4) * 16 + (ly % 4) * 4 + lx % 4

    pop = pop_lib.Population(
        name=name,
        num_people=P,
        num_locations=L,
        age_group=age_group,
        beta_sus=beta_sus,
        beta_inf=beta_inf,
        home_loc=home.astype(np.int32),
        loc_type=np.full((L,), 3, np.int8),
        geo_key=geo_key.astype(np.int64),
        max_occupancy=np.zeros((L,), np.int32),
        contact_prob=np.zeros((L,), np.float32),
        week=pop_lib.pad_week_uniform(week, pad_multiple),
    )
    pop.finalize_contact_model(contact_lib.FixedProbability(0.3))
    return pop
