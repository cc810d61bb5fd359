"""The digital twin the benchmark hands to the program and to the reference.

A frozen numpy copy of the port's twin generator
(``repro_torch/data/digital_twin.py``, its draws in its order), so the
inputs do not move when the program's generator does, plus one draw a
visit that thins each day to the configuration's
``visits_per_person_week`` (the published twin's visits over its
people). The port's weekly pattern (two home stays a day, work, school,
other places) makes about 22 visits a person a week; every visit of it is
kept with one probability, so the kinds keep the pattern's proportions
and the density becomes the published one. It returns raw
arrays only: people, locations, and each day of the week's visits in the
order they were drawn. The program receives them as its own
``Population`` (:func:`to_program_population`); the reference sorts and
packs them itself (``portbench/reference/week.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SECONDS_PER_HOUR = 3600.0
DAYS_PER_WEEK = 7
LOC_HOME, LOC_WORK, LOC_SCHOOL, LOC_OTHER = 0, 1, 2, 3


@dataclasses.dataclass
class Twin:
    """People, locations and a week of raw (unsorted) visits."""

    name: str
    num_people: int
    num_locations: int
    age_group: np.ndarray  # (P,) int8
    beta_sus: np.ndarray  # (P,) float32
    beta_inf: np.ndarray  # (P,) float32
    home_loc: np.ndarray  # (P,) int32
    loc_type: np.ndarray  # (L,) int8
    geo_key: np.ndarray  # (L,) int64
    days: list  # 7 x (person int64, loc int64, start f32, end f32)

    @property
    def visits_per_week(self) -> int:
        return int(sum(len(d[0]) for d in self.days))


def _lognormal_weights(n, rs, sigma=1.4):
    w = rs.lognormal(mean=0.0, sigma=sigma, size=n)
    return w / w.sum()


def generate(params: dict, name: str = "twin") -> Twin:
    """The twin of a configuration's ``twin`` parameters: ``num_people``,
    ``seed``, ``locations_per_person``, ``visits_per_person_week`` and the
    mixes below."""
    P = int(params["num_people"])
    rs = np.random.default_rng(int(params["seed"]))
    age_p = params["age_group_p"]
    hh_sizes_v = params["household_sizes"]
    hh_p = params["household_size_p"]

    age_group = rs.choice(3, size=P, p=age_p).astype(np.int8)
    hh_sizes = rs.choice(hh_sizes_v, size=P, p=hh_p)
    cum = np.cumsum(hh_sizes)
    n_homes = int(np.searchsorted(cum, P) + 1)
    home_of_person = np.repeat(np.arange(n_homes), hh_sizes[:n_homes])[:P]

    L = max(int(round(P * float(params["locations_per_person"]))), n_homes + 8)
    n_work = max(int(params["work_share"] * (L - n_homes)), 1)
    n_school = max(int(params["school_share"] * (L - n_homes)), 1)
    n_other = L - n_homes - n_work - n_school
    if n_other <= 0:
        raise ValueError("population too small for the location mix")
    loc_type = np.concatenate([
        np.full(n_homes, LOC_HOME, np.int8), np.full(n_work, LOC_WORK, np.int8),
        np.full(n_school, LOC_SCHOOL, np.int8), np.full(n_other, LOC_OTHER, np.int8)])
    work0, school0, other0 = n_homes, n_homes + n_work, n_homes + n_work + n_school

    n_bg = max(P // 600, 1)
    bg_of_home = (np.arange(n_homes) * n_bg // n_homes).astype(np.int64)
    bg_of_loc = np.empty((L,), np.int64)
    bg_of_loc[:n_homes] = bg_of_home
    bg_of_loc[n_homes:] = rs.integers(0, n_bg, size=L - n_homes)
    tract = bg_of_loc // 4
    county = tract // 50
    geo_key = county * 1_000_000 + tract * 1_000 + bg_of_loc % 1_000

    work_of_person = work0 + rs.choice(n_work, size=P, p=_lognormal_weights(n_work, rs))
    school_of_person = school0 + rs.choice(
        n_school, size=P, p=_lognormal_weights(n_school, rs, sigma=0.8))

    beta_sus = rs.uniform(0.8, 1.2, size=P).astype(np.float32)
    beta_inf = rs.uniform(0.8, 1.2, size=P).astype(np.float32)
    beta_sus[age_group == 0] *= 1.1

    is_child, is_adult = age_group == 0, age_group == 1
    keep_p = float(params["visits_per_person_week"]) / pattern_visits_per_person_week(params)
    if not 0.0 < keep_p <= 1.0:
        raise ValueError(f"visits_per_person_week asks to keep {keep_p} of the pattern")
    days = []
    for dow in range(DAYS_PER_WEEK):
        weekday = dow < 5
        persons, locs, starts, ends = [], [], [], []

        def add(mask, loc_ids, t0_h, t1_h, jitter_h=0.75):
            idx = np.flatnonzero(mask)
            if len(idx) == 0:
                return
            j0 = rs.uniform(-jitter_h, jitter_h, size=len(idx))
            j1 = rs.uniform(-jitter_h, jitter_h, size=len(idx))
            persons.append(idx)
            locs.append(loc_ids[idx])
            starts.append(((t0_h + j0) * SECONDS_PER_HOUR).astype(np.float32))
            ends.append(((t1_h + j1) * SECONDS_PER_HOUR).astype(np.float32))

        home = home_of_person.astype(np.int64)
        add(np.ones(P, bool), home, 0.0, 7.5)
        add(np.ones(P, bool), home, 18.0, 24.0)
        if weekday:
            add(is_adult & (rs.random(P) < params["work_attend"]), work_of_person, 9.0, 17.0)
            add(is_child & (rs.random(P) < params["school_attend"]), school_of_person, 8.0, 15.0)
        n_other_visits = rs.poisson(params["other_visits_weekday"] if weekday
                                    else params["other_visits_weekend"], size=P)
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

        person = np.concatenate(persons).astype(np.int64)
        loc = np.concatenate(locs).astype(np.int64)
        start = np.clip(np.concatenate(starts), 0, 86400).astype(np.float32)
        end = np.clip(np.concatenate(ends), 0, 86400).astype(np.float32)
        keep = (end > start) & (rs.random(len(person)) < keep_p)
        days.append((person[keep], loc[keep], start[keep], end[keep]))

    return Twin(name=name, num_people=P, num_locations=L, age_group=age_group,
                beta_sus=beta_sus, beta_inf=beta_inf,
                home_loc=home_of_person.astype(np.int32), loc_type=loc_type,
                geo_key=geo_key, days=days)


def pattern_visits_per_person_week(params: dict) -> float:
    """The expected visits a person makes in a week of the unthinned
    pattern: two home stays a day, work on weekdays (adults), school on
    weekdays (children), and the Poisson other visits."""
    child_p, adult_p = params["age_group_p"][0], params["age_group_p"][1]
    weekday = 2 + adult_p * params["work_attend"] + child_p * params["school_attend"] \
        + params["other_visits_weekday"]
    return 5 * weekday + 2 * (2 + params["other_visits_weekend"])


def to_program_population(twin: Twin, contact: dict, pad_multiple: int = 128):
    """The twin as the program's ``repro_torch.core.population.Population``,
    built with the program's own packing and contact model (its
    set-up's work, not the reference's)."""
    from repro_torch.core import contact as contact_lib
    from repro_torch.core import population as pop_lib

    week = [pop_lib.pack_day(p.astype(np.int32), l, s, e, pad_multiple=pad_multiple)
            for p, l, s, e in twin.days]
    pop = pop_lib.Population(
        name=twin.name, num_people=twin.num_people, num_locations=twin.num_locations,
        age_group=twin.age_group, beta_sus=twin.beta_sus, beta_inf=twin.beta_inf,
        home_loc=twin.home_loc, loc_type=twin.loc_type, geo_key=twin.geo_key,
        max_occupancy=np.zeros((twin.num_locations,), np.int32),
        contact_prob=np.zeros((twin.num_locations,), np.float32),
        week=pop_lib.pad_week_uniform(week, pad_multiple))
    pop.finalize_contact_model(contact_lib.MinMaxAlpha(
        min_contacts=float(contact["min_contacts"]),
        max_contacts=float(contact["max_contacts"]), alpha=float(contact["alpha"])))
    return pop
