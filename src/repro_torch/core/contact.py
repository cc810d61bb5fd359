"""Contact models (paper §III-A3).

The min/max/alpha model computes, per location, the probability p that any
given pair of simultaneously-present people actually come into contact, as a
function of the location's maximum occupancy N (a proxy for its size):

    p = min(1, [A + (B - A) * (1 - exp(-N / alpha))] / (N - 1))     (Eq. 1)

so that a person visiting at peak occupancy expects between A and B contacts.
The paper uses A=5, B=40, alpha=1000 (calibrated against POLYMOD).

Max occupancy is a *pre-processing* product of the visit schedule (§IV-C3),
and the per-location p is computed once at initialization and stored as a
location attribute. Host-side numpy: the arrays are byte-identical to the
reference package's ``repro.core.contact``.

The second model (fixed probability everywhere) is used for purely synthetic
populations where max occupancy is not known in advance.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MinMaxAlpha:
    min_contacts: float = 5.0  # A
    max_contacts: float = 40.0  # B
    alpha: float = 1000.0

    def probability(self, max_occupancy):
        """Vectorized Eq. 1 over a numpy array of occupancies."""
        N = np.asarray(max_occupancy, dtype=np.float32)
        A, B, a = self.min_contacts, self.max_contacts, self.alpha
        expected = A + (B - A) * (1.0 - np.exp(-N / a))
        p = expected / np.maximum(N - 1.0, 1.0)
        # N <= 2: everyone present makes contact (Eq. 1 is defined for N > 2).
        p = np.where(N <= 2.0, 1.0, np.minimum(p, 1.0))
        return p.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FixedProbability:
    p: float = 0.5

    def probability(self, max_occupancy):
        N = np.asarray(max_occupancy, dtype=np.float32)
        return np.full_like(N, np.float32(self.p))


def max_occupancy_fast(
    num_locations: int,
    visit_loc: np.ndarray,
    visit_start: np.ndarray,
    visit_end: np.ndarray,
) -> np.ndarray:
    """Peak simultaneous occupancy per location from one day's visits
    (O(E log E)): per-location running max via sorted cumulative deltas.
    Departures sort before arrivals at equal times, so touching visits
    never overlap."""
    E = len(visit_loc)
    occ = np.zeros((num_locations,), np.int32)
    if E == 0:
        return occ
    times = np.concatenate([visit_start, visit_end])
    deltas = np.concatenate([np.ones(E, np.int64), -np.ones(E, np.int64)])
    locs = np.concatenate([visit_loc, visit_loc]).astype(np.int64)
    # Sort by (loc, time, delta) with departures first at equal times.
    order = np.lexsort((deltas, times, locs))
    locs_s, deltas_s = locs[order], deltas[order]
    run = np.cumsum(deltas_s)
    # Subtract the cumulative total up to the start of each location segment.
    seg_start = np.searchsorted(locs_s, np.arange(num_locations), side="left")
    seg_end = np.searchsorted(locs_s, np.arange(num_locations), side="right")
    base = np.concatenate([[0], run])[seg_start]
    # Per-location running max of (run - base) over its segment.
    np.maximum.at(occ, locs_s, (run - np.repeat(base, seg_end - seg_start)).astype(np.int32))
    return occ
