"""What the model derives from a twin before its first day, worked out
again from the raw visits: each day's visit order, the per-location contact
probability, the same-location pairs that overlap in time, and the order in
which a person's visits are summed.

The model states its sums in a fixed order, and a trajectory follows every
rounding, so the reference sums in that order too:

* a visit's propensity sums the other visits of its location in the day's
  (location, start) order, from 0.0;
* a person's exposure sums that person's visits in the order of the
  occupancy-packed day (whole location runs, largest first, first-fit into
  blocks of ``block_size``; the (location, start) order where packing would
  need more block tiles), from 0.0.
"""

from __future__ import annotations

import numpy as np
import torch


def contact_probability(twin, contact: dict) -> np.ndarray:
    """(L,) float32 p of the min/max/alpha contact model (paper Eq. 1) from
    each location's peak occupancy over the week; at equal times a
    departure leaves before an arrival comes."""
    L = twin.num_locations
    occ = np.zeros((L,), np.int64)
    for _, loc, start, end in twin.days:
        E = len(loc)
        times = np.concatenate([start, end])
        delta = np.concatenate([np.ones(E, np.int64), -np.ones(E, np.int64)])
        locs = np.concatenate([loc, loc])
        order = np.lexsort((delta, times, locs))
        locs, delta = locs[order], delta[order]
        run = np.cumsum(delta)
        first = np.r_[True, locs[1:] != locs[:-1]]
        base = np.maximum.accumulate(np.where(first, np.arange(len(locs)), 0))
        before = np.r_[0, run][base]  # the running total before each location
        np.maximum.at(occ, locs, run - before)
    N = occ.astype(np.float32)
    A, B, a = (np.float32(contact[k]) for k in ("min_contacts", "max_contacts", "alpha"))
    expected = A + (B - A) * (np.float32(1.0) - np.exp(-N / a))
    p = expected / np.maximum(N - np.float32(1.0), np.float32(1.0))
    return np.where(N <= 2.0, np.float32(1.0), np.minimum(p, np.float32(1.0))).astype(np.float32)


def _runs(loc_sorted):
    change = np.flatnonzero(np.diff(loc_sorted)) + 1
    return np.r_[0, change], np.r_[change, len(loc_sorted)]


def _tiles(first_slot, last_slot, b) -> int:
    tiles = set()
    for s, e in zip(first_slot // b, last_slot // b):
        for r in range(s, e + 1):
            for c in range(s, e + 1):
                tiles.add((r, c))
    return len(tiles)


def packed_positions(loc_sorted: np.ndarray, b: int) -> np.ndarray:
    """Each visit's slot in the occupancy-packed day: runs of at least ``b``
    visits open a block-aligned segment whose tail block is a bin; smaller
    runs go, largest first (ties by position), into the first bin with room,
    else into a new block. Falls back to the sorted order where packing
    needs more block tiles."""
    starts, ends = _runs(loc_sorted)
    counts = ends - starts
    order = sorted(range(len(starts)), key=lambda i: (-counts[i], i))
    segments, bins = [], []  # bins: [segment index, free slots]
    for r in order:
        c = int(counts[r])
        if c >= b:
            segments.append([r])
            if (-c) % b:
                bins.append([len(segments) - 1, (-c) % b])
            continue
        for entry in bins:
            if entry[1] >= c:
                segments[entry[0]].append(r)
                entry[1] -= c
                break
        else:
            segments.append([r])
            bins.append([len(segments) - 1, b - c])
    pos = np.empty(len(loc_sorted), np.int64)
    slot = 0
    run_first = np.empty(len(starts), np.int64)
    for seg in segments:
        seg_start = slot
        for r in seg:
            n = int(counts[r])
            pos[starts[r]:ends[r]] = np.arange(slot, slot + n)
            run_first[r] = slot
            slot += n
        slot += (-(slot - seg_start)) % b
    packed = _tiles(run_first, run_first + counts - 1, b)
    plain = _tiles(starts, ends - 1, b)
    return np.arange(len(loc_sorted)) if packed > plain else pos


class Day:
    """One day of the week on a device: visits in (location, start) order,
    the overlapping same-location pairs ordered by (row, column), and the
    person-major order of the exposure sum."""

    def __init__(self, person, loc, start, end, p_loc, block_size, device):
        order = np.lexsort((start, loc))
        person, loc, start, end = person[order], loc[order], start[order], end[order]
        self.n = len(person)
        pos = packed_positions(loc, block_size)
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)
        self.person = t(person, torch.int64)
        self.loc = t(loc, torch.int64)
        self.start = t(start, torch.float32)
        self.end = t(end, torch.float32)
        self.p = t(p_loc[loc], torch.float32)
        # pairs (i, j): every ordered pair of distinct people's visits to one
        # location whose windows overlap, row-major, columns ascending
        starts, ends = _runs(loc)
        run_len = np.repeat(ends - starts, ends - starts)
        run_start = np.repeat(starts, ends - starts)
        pi = np.repeat(np.arange(self.n), run_len)
        first = np.repeat(np.cumsum(run_len) - run_len, run_len)
        pj = np.repeat(run_start, run_len) + (np.arange(len(pi)) - first)
        pi, pj = t(pi, torch.int64), t(pj, torch.int64)
        overlap = torch.clamp(torch.minimum(self.end[pi], self.end[pj])
                              - torch.maximum(self.start[pi], self.start[pj]), min=0.0)
        keep = (self.person[pi] != self.person[pj]) & (overlap > 0.0)
        self.pi, self.pj, self.overlap = pi[keep], pj[keep], overlap[keep]
        # the exposure sum: each person's visits by packed slot
        by_person = np.lexsort((pos, person))
        ppl = person[by_person]
        firsts = np.r_[0, np.flatnonzero(np.diff(ppl)) + 1]
        lens = np.diff(np.r_[firsts, self.n])
        ranks = np.arange(self.n) - np.repeat(firsts, lens)
        self.combine = [(t(ppl[ranks == k], torch.int64), t(by_person[ranks == k], torch.int64))
                        for k in range(int(lens.max(initial=0)))]


class Week:
    """The seven days of a twin's week for the reference, on ``device``."""

    def __init__(self, twin, contact: dict, block_size: int, device):
        p_loc = contact_probability(twin, contact)
        self.num_people = twin.num_people
        self.num_locations = twin.num_locations
        self.days = [Day(*d, p_loc, block_size, device) for d in twin.days]
