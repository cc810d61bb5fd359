"""The weekly visit schedule: stacked (7, ...) host arrays, then the day
loop's device tensors.

``build_week_data`` stacks the 7 day-of-week visit arrays and block-pair
schedules into fixed-shape numpy arrays (the day step picks its day by
``day % 7``), exactly the arrays of the reference's
``repro.core.interactions.build_week_data``. ``week_from_numpy`` uploads
them once, as the day step's ``week`` dict on a device.

``person_slot_table`` adds what the deterministic exposure combine needs:
for every day of the week and every person, that person's visit slots in
ascending slot order, padded with the out-of-range slot ``V``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import population as pop_lib


@dataclasses.dataclass(frozen=True)
class WeekData:
    """Stacked (7, ...) host arrays of the weekly schedule."""

    pid: np.ndarray  # (7, V) int32, -1 padding
    loc: np.ndarray  # (7, V) int32
    start: np.ndarray  # (7, V) f32
    end: np.ndarray  # (7, V) f32
    row_idx: np.ndarray  # (7, NP) int32
    col_idx: np.ndarray  # (7, NP) int32
    row_start: np.ndarray  # (7, NP) int32
    pair_active: np.ndarray  # (7, NP) int32
    block_size: int
    num_blocks: int


def build_week_data(pop: pop_lib.Population, block_size: int) -> WeekData:
    """Stack the weekly schedule for the kernels, in the occupancy-packed
    visit layout (population.py:pack_day_occupancy, the reference's
    ``pack=True``), which shrinks the block-pair schedule NP; layout is
    epidemiologically free (counter-based draws key on ids, not slots)."""
    week = [pop_lib.pack_day_occupancy(d, block_size) for d in pop.week]
    size = max(len(d) for d in week)
    week = [pop_lib.extend_packed(d, size) for d in week]
    extents = [d.extent for d in week]
    scheds = [
        pop_lib.build_block_schedule(d.loc, e, block_size)
        for d, e in zip(week, extents)
    ]
    np_max = max(s.row_block.shape[0] for s in scheds)
    scheds = [
        pop_lib.build_block_schedule(d.loc, e, block_size, pad_to=np_max)
        for d, e in zip(week, extents)
    ]

    def stack(getter, dtype):
        return np.stack([getter(x) for x in zip(week, scheds)]).astype(dtype)

    return WeekData(
        pid=stack(lambda x: x[0].person, np.int32),
        loc=stack(lambda x: x[0].loc, np.int32),
        start=stack(lambda x: x[0].start, np.float32),
        end=stack(lambda x: x[0].end, np.float32),
        row_idx=stack(lambda x: x[1].row_block, np.int32),
        col_idx=stack(lambda x: x[1].col_block, np.int32),
        row_start=stack(lambda x: x[1].row_start, np.int32),
        pair_active=stack(lambda x: x[1].pair_active, np.int32),
        block_size=block_size,
        num_blocks=len(week[0]) // block_size,
    )


def person_slot_table(pid: np.ndarray, num_people: int) -> np.ndarray:
    """(7, V) visit person ids -> (7, P, K) int64 slot table.

    Row ``[d, p]`` lists person p's visit slots on day d in ascending
    order, padded with ``V`` (one past the last slot); K is the most visits
    any person makes on any day (at least 1)."""
    days, V = pid.shape
    per_day = []
    for d in range(days):
        slots = np.flatnonzero(pid[d] >= 0)
        people = pid[d][slots].astype(np.int64)
        order = np.argsort(people, kind="stable")  # by person, then by slot
        slots, people = slots[order], people[order]
        counts = np.bincount(people, minlength=num_people)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        per_day.append((slots, people, np.arange(len(people)) - first[people],
                        int(counts.max(initial=0))))
    K = max(1, max(k for *_, k in per_day))
    table = np.full((days, num_people, K), V, np.int64)
    for d, (slots, people, rank, _) in enumerate(per_day):
        table[d, people, rank] = slots
    return table


def week_from_numpy(arrays: dict, num_people: int, *, device) -> dict:
    """The day step's ``week`` dict from numpy arrays.

    ``arrays`` holds the (7, ...) arrays of the reference's
    ``repro.engine.core.local_week_arrays`` (keys ``pid``, ``loc``,
    ``start``, ``end``, ``p``, ``row``, ``col``, ``pa``; others are
    ignored), e.g. from ``jax.device_get``. Returns them as tensors on
    ``device`` plus the ``slots`` table of :func:`person_slot_table`."""
    pid = np.asarray(arrays["pid"])
    t = lambda k, dtype: torch.as_tensor(np.array(arrays[k]), device=device).to(dtype)
    return {
        "pid": t("pid", torch.int32),
        "loc": t("loc", torch.int32),
        "start": t("start", torch.float32),
        "end": t("end", torch.float32),
        "p": t("p", torch.float32),
        "row": t("row", torch.int32),
        "col": t("col", torch.int32),
        "pa": t("pa", torch.int32),
        "slots": torch.as_tensor(person_slot_table(pid, num_people), device=device),
    }
