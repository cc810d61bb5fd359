"""Population container, visit schedules, and partitioning (paper §IV-A, §V-B).

A population is a bipartite people–location graph with a weekly visit
schedule (visits repeat every 7 days unless interventions change them).
Every day's visits are stored as flat arrays **presorted by location id**
and padded to a static size, so one day step serves every day at fixed
shapes. Interventions never change shapes — they toggle per-visit
``active`` masks and per-person attribute multipliers.

Static load balancing (paper §V-B) is reproduced exactly: locations are
sorted by a geographic key, load is estimated by visit counts, and locations
are greedily packed into partitions until each reaches the mean load. The
same packing drives (a) location sharding across devices and (b) the active
block-pair schedule of the interaction kernel.

Pure numpy; the arrays it builds are byte-identical to the reference
package's ``repro.core.population``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import contact as contact_lib

DAYS_PER_WEEK = 7


@dataclasses.dataclass
class DayVisits:
    """One day-of-week's visits, sorted by (loc, start), padded to length V.

    Padding entries have ``person == -1`` and ``active == False`` and sort to
    the end (loc == num_locations sentinel is avoided; padding keeps the last
    real loc id so sortedness holds, but active=False removes it from all
    math)."""

    person: np.ndarray  # (V,) int32
    loc: np.ndarray  # (V,) int32, non-decreasing over active prefix
    start: np.ndarray  # (V,) float32 seconds since midnight
    end: np.ndarray  # (V,) float32
    active: np.ndarray  # (V,) bool
    num_real: int

    def __len__(self) -> int:
        return len(self.person)


@dataclasses.dataclass
class Population:
    """People, locations, and a weekly visit schedule."""

    name: str
    num_people: int
    num_locations: int
    # Person attributes
    age_group: np.ndarray  # (P,) int8 (0: child, 1: adult, 2: senior)
    beta_sus: np.ndarray  # (P,) f32 susceptibility multiplier beta_sigma
    beta_inf: np.ndarray  # (P,) f32 infectivity multiplier beta_iota
    home_loc: np.ndarray  # (P,) int32
    # Location attributes
    loc_type: np.ndarray  # (L,) int8 (0 home, 1 work, 2 school, 3 other)
    geo_key: np.ndarray  # (L,) int64 sort key (state/county/tract/blockgroup)
    max_occupancy: np.ndarray  # (L,) int32
    contact_prob: np.ndarray  # (L,) f32, from the contact model
    # Weekly schedule
    week: list  # list[DayVisits] of length 7

    @property
    def visits_per_week(self) -> int:
        return int(sum(d.num_real for d in self.week))

    def day(self, day_index: int) -> DayVisits:
        return self.week[day_index % DAYS_PER_WEEK]

    def finalize_contact_model(self, model=None) -> None:
        """Compute per-location max occupancy (pre-processing, §IV-C3) and
        contact probabilities. Mutates ``max_occupancy``/``contact_prob``."""
        model = model or contact_lib.MinMaxAlpha()
        occ = np.zeros((self.num_locations,), np.int32)
        for d in self.week:
            n = d.num_real
            occ = np.maximum(
                occ,
                contact_lib.max_occupancy_fast(
                    self.num_locations, d.loc[:n], d.start[:n], d.end[:n]
                ),
            )
        self.max_occupancy = occ
        self.contact_prob = np.asarray(model.probability(occ), np.float32)

    def stats(self) -> dict:
        return {
            "people": self.num_people,
            "locations": self.num_locations,
            "visits_per_week": self.visits_per_week,
            "mean_visits_per_person_day": self.visits_per_week
            / max(1, self.num_people) / DAYS_PER_WEEK,
            "max_occupancy_p99": int(np.percentile(self.max_occupancy, 99))
            if len(self.max_occupancy) else 0,
        }

    def preprocess(self, model=None, block_size: int = 128,
                   pack: bool = True) -> dict:
        """Full pre-processing pass (§IV-C3): contact model finalization
        plus, when ``pack``, the occupancy-aware schedule-packing summary
        for ``block_size`` — NP (block-pair tiles) before/after packing per
        week, aggregated. The dict is also stored as ``preprocess_stats``.
        """
        self.finalize_contact_model(model)
        stats = self.stats()
        if pack:
            stats["packing"] = week_packing_stats(self, block_size)
        self.preprocess_stats = stats
        return stats


def pack_day(
    person: np.ndarray,
    loc: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    pad_to: Optional[int] = None,
    pad_multiple: int = 128,
) -> DayVisits:
    """Sort one day's raw visits by (loc, start) and pad to a static size."""
    order = np.lexsort((start, loc))
    person, loc = person[order], loc[order]
    start, end = start[order], end[order]
    n = len(person)
    size = pad_to if pad_to is not None else n
    size = int(np.ceil(max(size, 1) / pad_multiple) * pad_multiple)
    assert size >= n, (size, n)

    def pad(a, fill):
        out = np.full((size,), fill, a.dtype)
        out[:n] = a
        return out

    last_loc = loc[-1] if n else 0
    return DayVisits(
        person=pad(person.astype(np.int32), -1),
        loc=pad(loc.astype(np.int32), last_loc),
        start=pad(start.astype(np.float32), 0.0),
        end=pad(end.astype(np.float32), 0.0),
        active=pad(np.ones((n,), np.bool_), False),
        num_real=n,
    )


def pad_week_uniform(week: list, pad_multiple: int = 128) -> list:
    """Re-pad all 7 days to one common size so one day step serves the week."""
    size = max(len(d) for d in week)
    size = int(np.ceil(size / pad_multiple) * pad_multiple)
    out = []
    for d in week:
        n = d.num_real
        out.append(
            pack_day(d.person[:n], d.loc[:n], d.start[:n], d.end[:n], pad_to=size,
                     pad_multiple=pad_multiple)
        )
    return out


# ----------------------------------------------------------------------------
# Occupancy-aware visit packing (active-set schedule compaction)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class PackedDayVisits:
    """One day's visits in the *occupancy-packed* layout.

    Unlike :class:`DayVisits` (globally (loc, start)-sorted, padding only at
    the end), the packed layout reorders whole location runs so that small
    locations never straddle a block boundary and giant locations start on
    one, which shrinks the block-pair schedule NP. Alignment padding may sit
    *inside* the array: padding slots carry ``person == -1`` and repeat the
    preceding run's loc id, so run detection in
    :func:`build_block_schedule` merges them into that run without growing
    its block span. ``extent`` is the prefix length containing every real
    visit — trailing padding beyond it must not be scanned for runs.
    """

    person: np.ndarray  # (V,) int32, -1 on padding (interior or trailing)
    loc: np.ndarray  # (V,) int32; padding repeats the preceding run's loc
    start: np.ndarray  # (V,) float32
    end: np.ndarray  # (V,) float32
    active: np.ndarray  # (V,) bool
    extent: int  # slots [0, extent) hold all real visits + alignment pads
    num_real: int  # count of real visits
    np_before: int = 0  # schedule tiles of the canonical layout
    np_after: int = 0  # schedule tiles of this layout (<= np_before)

    def __len__(self) -> int:
        return len(self.person)


def occupancy_pack_order(
    loc_sorted: np.ndarray,  # (n,) run-contiguous visit loc ids
    block_size: int,
) -> tuple[np.ndarray, int]:
    """Greedy occupancy-aware packing of location runs into block-aligned
    segments. Returns ``(slot_src, extent)``: ``slot_src`` maps output slot
    -> input visit index (-1 = alignment padding) for the first ``extent``
    slots.

    Strategy (first-fit decreasing):
      * runs with >= block_size visits start on a block boundary, so their
        O((run/b)^2) tile band absorbs no neighbors;
      * the partial tail block of a big run becomes an open bin — small
        runs placed there add **zero** tiles (the (tail, tail) tile is
        already in the band);
      * remaining small runs are first-fit-decreasing bin-packed into
        whole blocks, so none straddles a boundary.
    """
    b = block_size
    n = len(loc_sorted)
    if n == 0:
        return np.full((0,), -1, np.int64), 0
    change = np.flatnonzero(np.diff(loc_sorted)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    counts = ends - starts
    run_order = sorted(range(len(starts)), key=lambda i: (-counts[i], i))

    segments: list[list[int]] = []  # each: run indices, emitted in order
    bins: list[list[int]] = []  # [segment_index, free_slots]
    for r in run_order:
        c = int(counts[r])
        if c >= b:
            segments.append([r])
            free = (-c) % b
            if free:
                bins.append([len(segments) - 1, free])
        else:
            for entry in bins:
                if entry[1] >= c:
                    segments[entry[0]].append(r)
                    entry[1] -= c
                    break
            else:
                segments.append([r])
                bins.append([len(segments) - 1, b - c])

    slot_src: list[int] = []
    for seg in segments:
        seg_start = len(slot_src)
        for r in seg:
            slot_src.extend(range(int(starts[r]), int(ends[r])))
        pad = (-(len(slot_src) - seg_start)) % b
        slot_src.extend([-1] * pad)
    return np.asarray(slot_src, np.int64), len(slot_src)


def pack_day_occupancy(
    day: DayVisits,
    block_size: int,
    pad_to: Optional[int] = None,
) -> PackedDayVisits:
    """Re-layout one (loc, start)-sorted day into the occupancy-packed
    order. Epidemiologically a no-op: the counter-based RNG keys every draw
    on (pid, pid, day, loc), so visit layout is a free variable — validated
    against the dense oracle in tests/test_interactions.py."""
    n = day.num_real
    src, extent = occupancy_pack_order(np.asarray(day.loc[:n]), block_size)
    size = max(extent, pad_to or 0, block_size)
    size = int(np.ceil(size / block_size) * block_size)
    assert size >= extent, (size, extent)

    def take(a, fill):
        out = np.full((size,), fill, a.dtype)
        sel = src >= 0
        out[: extent][sel] = a[:n][src[sel]]
        return out

    person = take(day.person, np.int32(-1))
    start = take(day.start, np.float32(0.0))
    end = take(day.end, np.float32(0.0))
    loc = take(day.loc, np.int32(0))
    # Padding repeats the preceding run's loc id (forward fill) so the
    # diff-based run detection merges it without extending any block span.
    pad_mask = np.ones((size,), bool)
    pad_mask[: extent] = src < 0
    if pad_mask.any() and not pad_mask.all():
        idx = np.where(pad_mask, 0, np.arange(size))
        idx = np.maximum.accumulate(idx)
        loc = loc[idx]
    if n == 0:
        return PackedDayVisits(
            person=person, loc=loc, start=start, end=end,
            active=person >= 0, extent=extent, num_real=n,
            np_before=1, np_after=1,  # build_block_schedule's (0,0) fallback
        )
    # First-fit-decreasing can (rarely) lose to a lucky sorted layout whose
    # run boundaries happen to coincide with block boundaries; guard so
    # "packing never grows NP" is an invariant, not a heuristic outcome.
    # The two schedule sizes are kept on the result so callers
    # (week_packing_stats, benches) don't rebuild schedules to report them.
    v0 = int(np.ceil(n / block_size) * block_size)
    base_loc = np.concatenate(
        [day.loc[:n], np.full(v0 - n, day.loc[n - 1], day.loc.dtype)]
    )
    np_before = build_block_schedule(base_loc, n, block_size).num_pairs
    np_after = build_block_schedule(loc, extent, block_size).num_pairs
    if np_after > np_before:
        size_c = max(v0, pad_to or 0, block_size)
        size_c = int(np.ceil(size_c / block_size) * block_size)

        def pad_c(a, fill):
            out = np.full((size_c,), fill, a.dtype)
            out[:n] = a[:n]
            return out

        return PackedDayVisits(
            person=pad_c(day.person, np.int32(-1)),
            loc=pad_c(day.loc, day.loc[n - 1]),
            start=pad_c(day.start, np.float32(0.0)),
            end=pad_c(day.end, np.float32(0.0)),
            active=pad_c(day.active, False),
            extent=n,
            num_real=n,
            np_before=np_before,
            np_after=np_before,
        )
    return PackedDayVisits(
        person=person, loc=loc, start=start, end=end,
        active=person >= 0, extent=extent, num_real=n,
        np_before=np_before, np_after=np_after,
    )


def extend_packed(p: PackedDayVisits, size: int) -> PackedDayVisits:
    """Grow a packed day with trailing padding (uniform week sizing)."""
    if size == len(p):
        return p
    assert size > len(p), (size, len(p))
    pad = size - len(p)

    def ext(a, fill):
        return np.concatenate([a, np.full((pad,), fill, a.dtype)])

    return PackedDayVisits(
        person=ext(p.person, np.int32(-1)),
        loc=ext(p.loc, p.loc[-1] if len(p.loc) else np.int32(0)),
        start=ext(p.start, np.float32(0.0)),
        end=ext(p.end, np.float32(0.0)),
        active=ext(p.active, False),
        extent=p.extent,
        num_real=p.num_real,
        np_before=p.np_before,
        np_after=p.np_after,
    )


# ----------------------------------------------------------------------------
# Static load balancing (paper §V-B)
# ----------------------------------------------------------------------------


def balanced_location_partition(
    geo_key: np.ndarray,  # (L,) sort key
    visits_per_loc: np.ndarray,  # (L,) load proxy (weekly visit counts)
    num_partitions: int,
) -> np.ndarray:
    """Greedy prefix packing of geo-sorted locations by visit-count load.

    Returns part_of_loc (L,) int32. Mirrors the paper: sort by geography,
    accumulate until the partition exceeds the mean load, move on; the last
    partition takes the remainder. Heavy locations may own a partition alone.
    """
    L = len(geo_key)
    order = np.argsort(geo_key, kind="stable")
    loads = visits_per_loc[order].astype(np.float64)
    total = float(loads.sum())
    target = total / max(num_partitions, 1)
    part = np.zeros((L,), np.int32)
    cur, acc = 0, 0.0
    for i in range(L):
        part[order[i]] = cur
        acc += loads[i]
        if acc >= target * (cur + 1) and cur < num_partitions - 1:
            cur += 1
    return part


def naive_location_partition(num_locations: int, num_partitions: int) -> np.ndarray:
    """Uniform-count split (the paper's 'no load balancing' baseline)."""
    return (
        np.arange(num_locations, dtype=np.int64) * num_partitions // max(num_locations, 1)
    ).astype(np.int32)


def partition_people(num_people: int, num_partitions: int) -> np.ndarray:
    """People are uniformly partitioned (visit fan-out is what's balanced)."""
    return (
        np.arange(num_people, dtype=np.int64) * num_partitions // max(num_people, 1)
    ).astype(np.int32)


def partition_imbalance(part: np.ndarray, load: np.ndarray, num_partitions: int) -> float:
    """max/mean partition load — the metric Fig 2 is about."""
    per = np.zeros((num_partitions,), np.float64)
    np.add.at(per, part, load.astype(np.float64))
    mean = per.mean()
    return float(per.max() / mean) if mean > 0 else 1.0


# ----------------------------------------------------------------------------
# Block-pair schedule for the interaction pass
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class BlockSchedule:
    """Active (row_block, col_block) tile pairs for a location-sorted visit
    array: exactly the tiles that contain at least one same-location pair.
    This is the static block-sparsity structure that replaces the paper's
    per-location event queues. Ordered row-major so each row block's column
    tiles are consecutive (enables streaming accumulation in the kernel)."""

    block_size: int
    num_blocks: int  # V / block_size
    row_block: np.ndarray  # (NP,) int32
    col_block: np.ndarray  # (NP,) int32
    row_start: np.ndarray  # (NP,) bool — first pair of its row-block run
    pair_active: np.ndarray  # (NP,) bool — False on padding pairs
    num_pairs: int  # number of active pairs

    @property
    def dense_pairs(self) -> int:
        return self.num_blocks * self.num_blocks

    @property
    def sparsity(self) -> float:
        return 1.0 - self.num_pairs / max(self.dense_pairs, 1)


def build_block_schedule(
    loc_sorted: np.ndarray,  # (V,) visit loc ids, non-decreasing on real prefix
    num_real: int,
    block_size: int,
    pad_to: Optional[int] = None,
) -> BlockSchedule:
    V = len(loc_sorted)
    assert V % block_size == 0, (V, block_size)
    nb = V // block_size
    pairs: set[tuple[int, int]] = set()
    if num_real > 0:
        loc = loc_sorted[:num_real]
        # Run boundaries of each location segment.
        change = np.flatnonzero(np.diff(loc)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [num_real]])
        for s, e in zip(starts, ends):
            b0, b1 = s // block_size, (e - 1) // block_size
            for rb in range(b0, b1 + 1):
                for cb in range(b0, b1 + 1):
                    pairs.add((rb, cb))
    if not pairs:
        pairs.add((0, 0))
    arr = np.array(sorted(pairs), np.int32)
    num_pairs = len(arr)
    pair_active = np.ones((num_pairs,), np.bool_)
    if pad_to is not None and pad_to > num_pairs:
        # Pad by repeating the final pair with active=False. The repeat keeps
        # the kernel's output index_map constant over the padding (no output
        # block eviction/revisit with undefined contents) and the active flag
        # makes the body a no-op, so there is no double counting.
        reps = np.repeat(arr[-1:], pad_to - num_pairs, axis=0)
        arr = np.concatenate([arr, reps])
        pair_active = np.concatenate(
            [pair_active, np.zeros((pad_to - num_pairs,), np.bool_)]
        )
    row_block, col_block = arr[:, 0].copy(), arr[:, 1].copy()
    row_start = np.zeros((len(arr),), np.bool_)
    seen: set[int] = set()
    for k in range(len(arr)):
        if pair_active[k] and int(row_block[k]) not in seen:
            row_start[k] = True
            seen.add(int(row_block[k]))
    return BlockSchedule(
        block_size=block_size,
        num_blocks=nb,
        row_block=row_block,
        col_block=col_block,
        row_start=row_start,
        pair_active=pair_active,
        num_pairs=num_pairs,
    )


def week_packing_stats(pop: "Population", block_size: int) -> dict:
    """Schedule-size effect of occupancy-aware packing over a population's
    week: total block-pair tiles (NP) and padded visit-slot counts before
    and after :func:`pack_day_occupancy`, summed over the 7 days."""
    np_before = np_after = v_before = v_after = 0
    for d in pop.week:
        n = d.num_real
        base = pack_day(
            d.person[:n], d.loc[:n], d.start[:n], d.end[:n],
            pad_multiple=block_size,
        )
        packed = pack_day_occupancy(base, block_size)
        np_before += packed.np_before
        np_after += packed.np_after
        v_before += len(base)
        v_after += len(packed)
    return {
        "block_size": block_size,
        "np_before": int(np_before),
        "np_after": int(np_after),
        "np_reduction": float(np_before / max(np_after, 1)),
        "v_before": int(v_before),
        "v_after": int(v_after),
    }
