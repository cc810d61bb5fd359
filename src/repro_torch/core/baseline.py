"""EpiHiper-style static-contact-network baseline (paper §VI, §VIII): the
port of the reference's ``repro.core.baseline``, numpy on the host.

EpiHiper pre-processes the visit schedule into a FIXED contact network (per
run), then diffuses the disease over it. The engine runs that mode as
``EngineCore.single(..., static_network=True)``: the contact hash is keyed
by the day of the week instead of the absolute day, so every week has the
same contact network per replicate seed.

This module is the *independent* oracle for that mode, and mirrors
EpiHiper's architecture literally: enumerate each day-of-week's contact
edges explicitly (the same contact draws, :func:`repro_torch.core.rng.
np_uniform`), then run SIR diffusion over the edge list with the same
transmission model, in float64. It uses no engine code and no torch.

Its exposure is summed in float64 over edges, the engine's in float32 over
visits, so the two agree exactly only while no infection draw lands within
the rounding of ``exp(-A)`` and no dwell time within the rounding of a whole
day (``run_sir_on_network(..., margins=True)`` says how close each day
came); on small populations (Watts–Strogatz 500) they agree on every day.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import disease as disease_lib
from repro_torch.core import population as pop_lib
from repro_torch.core import rng
from repro_torch.core import transmission as tx_lib


@dataclasses.dataclass
class ContactNetwork:
    """Weekly static contact network: directed contact edges per day-of-week."""

    src: list  # 7 arrays of person ids (susceptible side)
    dst: list  # 7 arrays of person ids (infectious side)
    duration: list  # 7 arrays of overlap seconds


def precompute_contact_network(pop: pop_lib.Population, seed: int) -> ContactNetwork:
    """Enumerate the contacts of each day-of-week (the EpiHiper
    preprocessing script): per location run, every ordered pair of distinct
    people whose visits overlap, kept where the symmetric CONTACT draw
    (keyed by the day of the week) falls under the location's contact
    probability."""
    src_all, dst_all, dur_all = [], [], []
    for dow, day in enumerate(pop.week):
        n = day.num_real
        loc, person = day.loc[:n], day.person[:n]
        start, end = day.start[:n], day.end[:n]
        srcs, dsts, durs = [], [], []
        # location runs (visits are location-sorted)
        change = np.flatnonzero(np.diff(loc)) + 1
        for s, e in zip(np.concatenate([[0], change]), np.concatenate([change, [n]])):
            if e - s < 2:
                continue
            p = person[s:e]
            st, en = start[s:e], end[s:e]
            ov = np.minimum(en[:, None], en[None, :]) - np.maximum(st[:, None], st[None, :])
            ii, jj = np.nonzero((ov > 0) & (p[:, None] != p[None, :]))
            if len(ii) == 0:
                continue
            pmin = np.minimum(p[ii], p[jj])
            pmax = np.maximum(p[ii], p[jj])
            u = rng.np_uniform(seed, int(rng.CONTACT), dow, pmin, pmax,
                               np.full(len(ii), loc[s]))
            keep = u < pop.contact_prob[loc[s]]
            srcs.append(p[ii][keep])
            dsts.append(p[jj][keep])
            durs.append(ov[ii, jj][keep])
        src_all.append(np.concatenate(srcs) if srcs else np.zeros(0, np.int64))
        dst_all.append(np.concatenate(dsts) if dsts else np.zeros(0, np.int64))
        dur_all.append(np.concatenate(durs) if durs else np.zeros(0, np.float64))
    return ContactNetwork(src_all, dst_all, dur_all)


def run_sir_on_network(
    pop: pop_lib.Population,
    net: ContactNetwork,
    tm: tx_lib.TransmissionModel,
    days: int,
    seed: int,
    seed_per_day: int = 2,
    seed_days: int = 5,
    recovery_days: float = 7.0,
    margins: bool = False,
) -> dict:
    """SIR diffusion over the static network with the simulator's draws
    (the INFECT, SEED_CHOICE and DWELL streams on global person ids).
    Returns ``{"cumulative", "infectious"}``, each a (days,) int array.

    ``margins`` adds, per day, how close the day's decisions came to
    flipping under another rounding of the same arithmetic (the engine's is
    float32): ``infect_margin``, the least ``|u - exp(-A)| / (1 + A)`` over
    the susceptible people with exposure, and ``dwell_margin``, the least
    ``|d - round(d)| / d`` over the dwell times ``d`` drawn that day
    (recovery falls on day ``ceil(d)``; a draw under one day, clipped to
    exactly 1.0, counts its distance from 1); ``inf`` where there is
    none."""
    P = pop.num_people
    S, I, R = 0, 1, 2
    state = np.zeros(P, np.int32)
    dwell = np.full(P, disease_lib.ABSORBING_DWELL)
    cum = 0
    hist = {"cumulative": [], "infectious": []}
    if margins:
        hist.update(infect_margin=[], dwell_margin=[])
    pid = np.arange(P)
    for day in range(days):
        dow = day % 7
        src, dst, dur = net.src[dow], net.dst[dow], net.duration[dow]
        inf_val = (state == I).astype(np.float64) * pop.beta_inf
        sus_val = (state == S).astype(np.float64) * pop.beta_sus
        A = np.zeros(P)
        # edges are ordered pairs (both (i, j) and (j, i) are listed), so one
        # directed contribution per edge covers both roles
        np.add.at(A, src, dur * sus_val[src] * inf_val[dst])
        A *= tm.tau * tm.time_unit
        u = rng.np_uniform(seed, int(rng.INFECT), day, pid)
        infected = (A > 0) & (u > np.exp(-A))
        if day < seed_days and seed_per_day:
            us = rng.np_uniform(seed, int(rng.SEED_CHOICE), day, pid)
            us = np.where(state == S, us, 2.0)
            k = min(seed_per_day, P)
            thresh = np.partition(us, k - 1)[k - 1]
            infected |= (us <= thresh) & (state == S)
        newly = infected & (state == S)
        if margins:
            exposed = (A > 0) & (state == S)
            m = np.abs(u - np.exp(-A))[exposed] / (1.0 + A[exposed])
            hist["infect_margin"].append(float(m.min()) if m.size else np.inf)
        # timed recovery
        dwell -= 1.0
        recovered = (state == I) & (dwell <= 0)
        state[recovered] = R
        state[newly] = I
        d = rng.np_uniform(seed, int(rng.DWELL), day, pid)
        raw = -recovery_days * np.log(d[newly])
        dwell[newly] = np.maximum(raw, 1.0)
        if margins:  # a draw clipped to one day is exactly 1.0 in any rounding
            m = np.where(raw <= 1.0, 1.0 - raw, np.abs(raw - np.round(raw)) / raw)
            hist["dwell_margin"].append(float(m.min()) if m.size else np.inf)
        cum += int(newly.sum())
        hist["cumulative"].append(cum)
        hist["infectious"].append(int((state == I).sum()))
    return {k: np.asarray(v) for k, v in hist.items()}
