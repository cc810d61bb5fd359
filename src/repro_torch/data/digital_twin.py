"""Digital-twin-style realistic population generator (paper §IV-A1).

The paper's MD/VA datasets come from a census-fusion pipeline (ACS PUMS,
NHTS, NAICS, building data) that is not reproducible offline. This module
generates populations with the same *structural* properties the simulator
and its load balancer care about:

  * hierarchical geography (state → county → tract → block group) giving
    meaningful geo-sort keys for the static load-balancing scheme;
  * households (home locations) holding 1–6 people;
  * age-typed activity schedules: children attend schools (large, heavy
    locations), adults attend workplaces (lognormal sizes — a few very
    heavy locations, the load-imbalance driver in Fig 2), everyone makes
    random "other" visits (shopping etc.);
  * weekday/weekend structure: work/school visits Mon–Fri only.

Scale is a parameter; the MD/VA configs instantiate ``*-mini`` versions at
CPU-runnable scale while the dry-run configs keep the paper's full entity
counts (Table II) as shapes.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import contact as contact_lib
from repro_torch.core import population as pop_lib

SECONDS_PER_HOUR = 3600.0

LOC_HOME, LOC_WORK, LOC_SCHOOL, LOC_OTHER = 0, 1, 2, 3


def digital_twin_population(
    num_people: int,
    seed: int = 0,
    name: str = "twin",
    locations_per_person: float = 0.525,  # MD: 2.896M locs / 5.513M people
    pad_multiple: int = 128,
) -> pop_lib.Population:
    # detlint: ignore[DET001] — host-side population builder: deterministic
    # via the explicit seed; builds inputs, draws no simulation randomness.
    rs = np.random.default_rng(seed)
    P = num_people

    # --- people & households -------------------------------------------------
    age_group = rs.choice(3, size=P, p=[0.22, 0.62, 0.16]).astype(np.int8)
    hh_sizes = rs.choice([1, 2, 3, 4, 5, 6], size=P, p=[0.28, 0.35, 0.15, 0.13, 0.06, 0.03])
    # Build households until all people assigned.
    cum = np.cumsum(hh_sizes)
    n_homes = int(np.searchsorted(cum, P) + 1)
    home_of_person = np.repeat(np.arange(n_homes), hh_sizes[:n_homes])[:P]

    # --- locations -----------------------------------------------------------
    L = max(int(round(P * locations_per_person)), n_homes + 8)
    n_work = max(int(0.55 * (L - n_homes)), 1)
    n_school = max(int(0.02 * (L - n_homes)), 1)
    n_other = L - n_homes - n_work - n_school
    assert n_other > 0, "population too small for the location mix"
    loc_type = np.concatenate(
        [
            np.full(n_homes, LOC_HOME, np.int8),
            np.full(n_work, LOC_WORK, np.int8),
            np.full(n_school, LOC_SCHOOL, np.int8),
            np.full(n_other, LOC_OTHER, np.int8),
        ]
    )
    work0, school0, other0 = n_homes, n_homes + n_work, n_homes + n_work + n_school

    # Hierarchical geography: block groups of ~600 people, tracts of ~4 BGs,
    # counties of ~50 tracts. Locations are scattered near their community.
    bg_of_person = home_of_person * 0  # placeholder, computed from home below
    n_bg = max(P // 600, 1)
    bg_of_home = (np.arange(n_homes) * n_bg // n_homes).astype(np.int64)
    bg_of_person = bg_of_home[home_of_person]
    # Non-home locations: assigned to block groups roughly uniformly, with
    # heavy workplaces concentrated in "commercial" block groups.
    bg_of_loc = np.empty((L,), np.int64)
    bg_of_loc[:n_homes] = bg_of_home
    bg_of_loc[n_homes:] = rs.integers(0, n_bg, size=L - n_homes)
    tract = bg_of_loc // 4
    county = tract // 50
    geo_key = county * 1_000_000 + tract * 1_000 + bg_of_loc % 1_000

    # --- assignment of people to work/school --------------------------------
    # Workplace sizes ~ lognormal: a few giant sites (hospitals, campuses).
    work_of_person = work0 + rs.choice(
        n_work, size=P, p=_lognormal_weights(n_work, rs)
    )
    school_of_person = school0 + rs.choice(
        n_school, size=P, p=_lognormal_weights(n_school, rs, sigma=0.8)
    )

    # Commute locality: 70% of workers work within their home county — remap
    # a fraction of assignments to a nearby workplace (ACS commute-flow-ish).
    # (Structural only; enough to make geo-sorted partitions meaningful.)

    beta_sus = rs.uniform(0.8, 1.2, size=P).astype(np.float32)
    beta_inf = rs.uniform(0.8, 1.2, size=P).astype(np.float32)
    # Children slightly more susceptible at school-age mixing rates.
    beta_sus[age_group == 0] *= 1.1

    # --- weekly activity schedules -------------------------------------------
    is_child = age_group == 0
    is_adult = age_group == 1
    week = []
    for dow in range(pop_lib.DAYS_PER_WEEK):
        weekday = dow < 5
        persons, locs, starts, ends = [], [], [], []

        def add(mask, loc_ids, t0_h, t1_h, jitter_h=0.75):
            idx = np.flatnonzero(mask)
            if len(idx) == 0:
                return
            j0 = rs.uniform(-jitter_h, jitter_h, size=len(idx))
            j1 = rs.uniform(-jitter_h, jitter_h, size=len(idx))
            persons.append(idx)
            locs.append(loc_ids[idx] if loc_ids.shape == (P,) else loc_ids)
            starts.append(((t0_h + j0) * SECONDS_PER_HOUR).astype(np.float32))
            ends.append(((t1_h + j1) * SECONDS_PER_HOUR).astype(np.float32))

        # Home: everyone, morning and evening blocks.
        add(np.ones(P, bool), home_of_person.astype(np.int64), 0.0, 7.5)
        add(np.ones(P, bool), home_of_person.astype(np.int64), 18.0, 24.0)
        if weekday:
            work_attend = is_adult & (rs.random(P) < 0.72)
            add(work_attend, work_of_person, 9.0, 17.0)
            school_attend = is_child & (rs.random(P) < 0.95)
            add(school_attend, school_of_person, 8.0, 15.0)
        # Other visits: shopping/leisure, more on weekends (but the
        # work/school structure keeps weekdays busier overall).
        n_other_visits = rs.poisson(0.5 if weekday else 1.1, size=P)
        for v in range(int(n_other_visits.max())):
            m = n_other_visits > v
            dest = other0 + rs.integers(0, n_other, size=P)
            s = rs.uniform(10, 20, size=P)
            d = rs.exponential(1.2, size=P) + 0.25
            idx = np.flatnonzero(m)
            persons.append(idx)
            locs.append(dest[idx])
            starts.append((s[idx] * SECONDS_PER_HOUR).astype(np.float32))
            ends.append(((s[idx] + d[idx]) * SECONDS_PER_HOUR).astype(np.float32))

        person_arr = np.concatenate(persons)
        loc_arr = np.concatenate(locs).astype(np.int64)
        start_arr = np.clip(np.concatenate(starts), 0, 86400).astype(np.float32)
        end_arr = np.clip(np.concatenate(ends), 0, 86400).astype(np.float32)
        keep = end_arr > start_arr
        week.append(
            pop_lib.pack_day(
                person_arr[keep], loc_arr[keep], start_arr[keep], end_arr[keep],
                pad_multiple=pad_multiple,
            )
        )

    pop = pop_lib.Population(
        name=name,
        num_people=P,
        num_locations=L,
        age_group=age_group,
        beta_sus=beta_sus,
        beta_inf=beta_inf,
        home_loc=home_of_person.astype(np.int32),
        loc_type=loc_type,
        geo_key=geo_key,
        max_occupancy=np.zeros((L,), np.int32),
        contact_prob=np.zeros((L,), np.float32),
        week=pop_lib.pad_week_uniform(week, pad_multiple),
    )
    pop.finalize_contact_model(contact_lib.MinMaxAlpha())
    return pop


def _lognormal_weights(n: int, rs: np.random.Generator, sigma: float = 1.4):
    w = rs.lognormal(mean=0.0, sigma=sigma, size=n)
    return w / w.sum()
