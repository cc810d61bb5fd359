"""The problem-defined count of the interaction pass, against brute force."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import roofline
from portbench import twin as twin_lib
from portbench.reference import week as week_lib

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def twin():
    cfg = json.load(open(os.path.join(HERE, "configs", "md-covid.json")))
    return twin_lib.generate(dict(cfg["twin"], num_people=2000), name="twin-2k"), cfg


def _brute_pairs(person, loc, start, end, sus, inf):
    """Every ordered pair of visits, one at a time."""
    by_loc = {}
    for v, l in enumerate(loc):
        by_loc.setdefault(int(l), []).append(v)
    pairs, si = set(), 0
    for visits in by_loc.values():
        for i in visits:
            for j in visits:
                if person[i] == person[j]:
                    continue
                if min(end[i], end[j]) - max(start[i], start[j]) > 0:
                    pairs.add((i, j))
                    si += int(sus[i] > 0 and inf[j] > 0)
    return pairs, si


@pytest.mark.parametrize("dow", [0, 5])
def test_pair_count_matches_a_pair_loop(twin, dow):
    tw, _ = twin
    person, loc, start, end = tw.days[dow]
    rs = np.random.default_rng(dow)
    sus = (rs.random(len(person)) < 0.7).astype(np.float32)
    inf = (rs.random(len(person)) < 0.1).astype(np.float32)
    pairs, si = _brute_pairs(person, loc, start, end, sus, inf)
    i, j = roofline.co_present_pairs(person, loc, start, end)
    assert set(zip(i.tolist(), j.tolist())) == pairs
    assert roofline.sus_inf_pairs(person, loc, start, end, sus, inf) == si


def test_reference_pairs_are_the_counted_pairs(twin):
    """The reference's pair list of a day is the count's, in the day's
    (location, start) order."""
    tw, cfg = twin
    person, loc, start, end = tw.days[1]
    p = week_lib.contact_probability(tw, cfg["contact_model"])
    day = week_lib.Day(person, loc, start, end, p, 128, "cpu")
    order = np.lexsort((start, loc))
    i, j = roofline.co_present_pairs(person, loc, start, end)
    ref = set(zip(order[day.pi.numpy()].tolist(), order[day.pj.numpy()].tolist()))
    assert ref == set(zip(i.tolist(), j.tolist()))
    assert torch.all(day.overlap > 0)


def test_bytes_and_bound():
    assert roofline.launch_bytes(1000, 2) == 1000 * (20 + 2 * 12) + 2 * 8
    b = roofline.launch_bytes(10**6, 64)
    assert roofline.least_seconds(b, 0) == pytest.approx(b / 3.35e12)
    many = 10**12
    assert roofline.least_seconds(b, many) == pytest.approx(
        many * roofline.OPS_PER_PAIR / 67e12)


def test_contact_probability_is_the_papers_formula(twin):
    tw, cfg = twin
    p = week_lib.contact_probability(tw, cfg["contact_model"])
    assert p.dtype == np.float32 and p.shape == (tw.num_locations,)
    assert np.all((p > 0) & (p <= 1))
    # a location of N <= 2 makes every pair a contact
    occ = np.zeros(tw.num_locations, np.int64)
    for _, l, s, e in tw.days:
        for loc_id in np.unique(l):
            m = l == loc_id
            t = np.concatenate([s[m], e[m]])
            d = np.concatenate([np.ones(m.sum()), -np.ones(m.sum())])
            o = np.lexsort((d, t))
            occ[loc_id] = max(occ[loc_id], int(np.max(np.cumsum(d[o]))))
    assert np.all(p[occ <= 2] == 1.0)
    big = occ > 2
    N = occ[big].astype(np.float64)
    want = np.minimum((5 + 35 * (1 - np.exp(-N / 1000))) / (N - 1), 1.0)
    np.testing.assert_allclose(p[big], want, rtol=1e-6)
