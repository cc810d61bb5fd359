"""Elastic rescaling: continue a run on a different worker count (the port
of the reference's ``repro.runtime.elastic``, numpy only).

The simulation state is (P,)-shaped person arrays plus scalars, so moving a
run between person-sharded layouts is a pure host-side reshuffle:
:func:`plan_elastic_rescale` gives the padded ``(W, Pw)`` layouts and
:func:`repartition_person_array` moves the real people between them.
Counter-based RNG makes the continued run bitwise identical to an
uninterrupted one. ``EngineCore.adopt_state`` uses these to take a snapshot
written on any worker count onto its own (a local run's one worker, or a
mesh's W) — after an elastic shrink (``runtime/resilience.py``), the
survivors' W - k.
"""

from __future__ import annotations

import numpy as np


def plan_elastic_rescale(num_people: int, old_workers: int, new_workers: int):
    """Mapping between padded (W, Pw) person-sharded layouts.

    Returns (old_layout, new_layout, copy_plan) where copy_plan is a list
    of (old_flat_slice, new_flat_slice) for the real (unpadded) people."""
    old_pw = int(np.ceil(num_people / old_workers))
    new_pw = int(np.ceil(num_people / new_workers))
    return (
        {"workers": old_workers, "per_worker": old_pw},
        {"workers": new_workers, "per_worker": new_pw},
        [(slice(0, num_people), slice(0, num_people))],
    )


def repartition_person_array(arr, num_people: int, new_workers: int, fill=0):
    """(W_old, Pw_old) -> (W_new, Pw_new), preserving the first P entries."""
    flat = np.asarray(arr).reshape(-1)[:num_people]
    new_pw = int(np.ceil(num_people / new_workers))
    out = np.full((new_workers * new_pw,) + flat.shape[1:], fill, flat.dtype)
    out[:num_people] = flat
    return out.reshape(new_workers, new_pw, *flat.shape[1:])
