"""The least time the interaction pass needs, counted from the problem.

The count depends on the day's own visits and on who is susceptible and
who infectious, never on the kernel's tiles, padding or schedule, so a
redesign of the kernel does not move the yardstick:

* **pairs**: ordered pairs of visits by different people to one location
  whose time windows overlap, the row visitor susceptible and the column
  visitor infectious; each needs the contact draw and, on contact, the
  transmission term;
* **bytes**: each input read once and each output written once, at the
  problem's types: per visit of the day, its person id, location, start,
  end and contact probability (shared by the scenarios of a launch); per
  visit and scenario, its susceptibility and infectivity in and its
  propensity sum out; per scenario, the day's contact count out;
* **operations** per pair: the plain formula (``overlap * sus * inf``
  summed) and the counter hash of the contact draw, each 32-bit ALU step
  counted once.

Peaks: NVIDIA H100 SXM5 data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s of
FP32 outside the tensor cores (the hash is 32-bit integer work, run at
no more than that rate), both at the card's 700 W limit; the result line
records the limit the card reported.
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SHARED_BYTES_PER_VISIT = 5 * 4  # pid, loc, start, end, p
SCENARIO_BYTES_PER_VISIT = 3 * 4  # sus, inf in; propensity sum out
BYTES_PER_SCENARIO = 8  # the day's contact count out (int64)

_HASH_WORD = 1 + 8 + 1 + 8  # word + constant, fmix, xor into h, fmix
OPS_PER_PAIR = (
    4  # overlap: min, max, subtract, clamp
    + 2  # the pair's ordered person ids
    + 3 * _HASH_WORD  # the words that vary by pair: min id, max id, location
    + 3  # top bits to a float in (0, 1)
    + 1  # the draw against the location's p
    + 3  # overlap * sus * inf
    + 1  # the running sum
    + 1  # the contact count
)


def co_present_pairs(person, loc, start, end):
    """``(i, j)`` index arrays of every ordered pair of visits by different
    people to one location whose windows overlap (by location, then i,
    then j)."""
    person, loc = np.asarray(person), np.asarray(loc)
    start, end = np.asarray(start), np.asarray(end)
    order = np.lexsort((start, loc))
    ls = loc[order]
    change = np.flatnonzero(np.diff(ls)) + 1
    starts, ends = np.r_[0, change], np.r_[change, len(ls)]
    lens = ends - starts
    per = np.repeat(lens, lens)
    i = np.repeat(np.arange(len(ls)), per)
    first = np.repeat(np.cumsum(per) - per, per)
    j = np.repeat(np.repeat(starts, lens), per) + (np.arange(len(i)) - first)
    i, j = order[i], order[j]
    keep = ((person[i] != person[j])
            & ((np.minimum(end[i], end[j]) - np.maximum(start[i], start[j])) > 0))
    return i[keep], j[keep]


def sus_inf_pairs(person, loc, start, end, sus, inf) -> int:
    """Co-present pairs whose row visitor is susceptible (``sus`` > 0) and
    whose column visitor is infectious (``inf`` > 0); ``sus``/``inf`` are
    per visit."""
    i, j = co_present_pairs(person, loc, start, end)
    return int(np.sum((np.asarray(sus)[i] > 0) & (np.asarray(inf)[j] > 0)))


def launch_bytes(visits: float, scenarios: float) -> float:
    """Bytes of one launch of a day's ``visits`` over ``scenarios``
    scenarios."""
    return (visits * (SHARED_BYTES_PER_VISIT + scenarios * SCENARIO_BYTES_PER_VISIT)
            + scenarios * BYTES_PER_SCENARIO)


def least_seconds(nbytes: float, pairs: float) -> float:
    """The larger of the memory and the operation bound."""
    return max(nbytes / PEAK_BYTES_PER_S, pairs * OPS_PER_PAIR / PEAK_OPS_PER_S)
