"""A plain batched simulation of the model: the reference the program is
held to.

It follows the model as the paper and the configuration state it (paper
Algorithm 2): each day, the interventions fold into who visits and how
susceptible each person is; every pair of co-present visitors makes
contact with its location's probability; each susceptible visitor sums
``overlap * sus * inf`` over its infectious contacts; each person sums
its visits, scaled by tau, into exposure A, and is infected with
probability ``1 - exp(-A)``; seeding, then the disease automaton; then the
day's counts and the intervention triggers. Every draw is the counter hash
of ``reference/rng.py``. A batch is a list of scenarios that run in
lockstep from day 0; each one's numbers depend on nothing but its own.

``fdt`` is the float type of the exposure arithmetic (overlap, the
channels, the pair terms, the sums, tau and ``exp``): float32 as the
configuration states, or a lower one for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import rng

ABSORBING = 1.0e9
NEVER_OFF = -3.0e38
STAT_KEYS = ("day", "new_infections", "cumulative", "infectious", "susceptible",
             "contacts", "edges", "tests_used", "isolated", "traced")


class Disease:
    """The configuration's automaton as (S,) and (S, S) tables."""

    def __init__(self, cfg: dict, device):
        states = list(cfg["states"])
        S, idx = len(states), {s: i for i, s in enumerate(states)}
        tp = np.zeros((S, S), np.float32)
        for s, outs in cfg["transitions"].items():
            for t, p in outs.items():
                tp[idx[s], idx[t]] = p
        for i in range(S):
            if tp[i].sum() == 0.0:
                tp[i, i] = 1.0
        dwell = np.full((S,), ABSORBING, np.float32)
        for s, d in cfg["dwell_mean_days"].items():
            dwell[idx[s]] = d
        sym = np.zeros((S,), np.float32)
        for s in cfg["symptomatic"]:
            sym[idx[s]] = 1.0
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.sus = t(cfg["susceptibility"])
        self.inf = t(cfg["infectivity"])
        self.sym = t(sym)
        self.cum = t(np.cumsum(tp, axis=-1).astype(np.float32))
        self.dwell = t(dwell)
        self.entry = idx[cfg["entry_state"]]
        self.initial = idx[cfg["initial_state"]]


def _people_mask(sel: dict, twin, seed: int, device):
    kind = sel["kind"]
    P = twin.num_people
    if kind == "age_group":
        m = twin.age_group == sel["group"]
    elif kind == "random_fraction":
        h = rng.hash32(seed, rng.INIT_ATTR, sel["salt"], torch.arange(P, device=device))
        return ((h >> 8).to(torch.float64) * 2.0 ** -24 + 2.0 ** -25) < sel["fraction"]
    elif kind == "everyone":
        m = np.ones((P,), bool)
    else:
        m = np.zeros((P,), bool)
    return torch.as_tensor(m, device=device)


def _loc_mask(sel: dict, twin, device):
    if sel["kind"] == "loc_type":
        m = twin.loc_type == sel["loc_type"]
    elif sel["kind"] == "everyone":
        m = np.ones((twin.num_locations,), bool)
    else:
        m = np.zeros((twin.num_locations,), bool)
    return torch.as_tensor(m, device=device)


def _ordered_sum(out, rows, vals, rank):
    """``out[rows] += vals`` with the entries of one row added in the order
    they come (``rank``: their place within their row)."""
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == k
        r = rows[sel]
        out[r] = out[r] + vals[sel]
    return out


def _rank_in_runs(keys):
    """Each entry's place within its run of equal ``keys`` (sorted)."""
    n = keys.numel()
    if n == 0:
        return keys
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    idx = torch.arange(n, device=keys.device)
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    return idx - start


def simulate(week, twin, cfg: dict, preset: list, seeds, taus, days: int, *,
             device, fdt=torch.float32, pair_counts: bool = False):
    """Run the scenarios (one ``preset``, per-scenario ``seeds`` and
    ``taus``) for ``days`` days. Returns ``{key: (days, B) int64 numpy}``
    for the ten statistics, and with ``pair_counts`` also
    ``"sus_inf_pairs"``: each day's co-present susceptible-infectious
    visit pairs per scenario. A preset holds classic interventions only."""
    dz = Disease(cfg["disease"], device)
    B, P = len(seeds), twin.num_people
    seed = torch.as_tensor([int(s) & 0xFFFFFFFF for s in seeds], device=device)[:, None]
    tau = torch.as_tensor([np.float32(t) for t in taus], device=device).to(fdt)[:, None]
    gpid = torch.arange(P, device=device)
    beta_sus = torch.as_tensor(twin.beta_sus, device=device)
    beta_inf = torch.as_tensor(twin.beta_inf, device=device)
    classic = [iv for iv in preset if iv["kind"] == "classic"]
    if len(classic) != len(preset):
        raise NotImplementedError("the reference runs classic interventions only")
    masks = []
    for iv in classic:
        people = torch.stack([_people_mask(iv["selector"], twin, s, device) for s in seeds])
        masks.append((people, _loc_mask(iv["selector"], twin, device)))

    health = torch.full((B, P), dz.initial, dtype=torch.int64, device=device)
    dwell = torch.full((B, P), ABSORBING, dtype=torch.float32, device=device)
    active = torch.zeros((B, len(classic)), dtype=torch.bool, device=device)
    vaccinated = torch.zeros((B, P), dtype=torch.bool, device=device)
    cumulative = torch.zeros((B,), dtype=torch.int64, device=device)
    rows = {k: [] for k in STAT_KEYS + (("sus_inf_pairs",) if pair_counts else ())}
    zero = torch.zeros((B,), dtype=torch.int64, device=device)

    for day in range(days):
        wd = week.days[day % 7]
        # ---- interventions ---------------------------------------------
        visit_ok = torch.ones((B, P), dtype=torch.bool, device=device)
        loc_open = torch.ones((B, twin.num_locations), dtype=torch.bool, device=device)
        sus_mult = torch.ones((B, P), dtype=torch.float32, device=device)
        for k, (iv, (people, locs)) in enumerate(zip(classic, masks)):
            on = active[:, k:k + 1]
            act = iv["action"]["kind"]
            if act == "isolate":
                visit_ok = visit_ok & ~(on & people)
            elif act == "close":
                loc_open = loc_open & ~(on & locs[None])
            elif act == "vaccinate":
                vaccinated = vaccinated | (on & people)
                factor = torch.tensor(np.float32(1.0 - iv["action"]["efficacy"]), device=device)
                sus_mult = sus_mult * torch.where(vaccinated & people, factor, 1.0)
        sus_p = dz.sus[health] * beta_sus * sus_mult
        inf_p = dz.inf[health] * beta_inf

        # ---- visits, contacts, the pair sums ------------------------------
        ok_v = visit_ok[:, wd.person] & loc_open[:, wd.loc]
        sus_v = torch.where(ok_v, sus_p[:, wd.person], 0.0).to(fdt)
        inf_v = torch.where(ok_v, inf_p[:, wd.person], 0.0).to(fdt)
        cand = (sus_v[:, wd.pi] > 0) & (inf_v[:, wd.pj] > 0)
        b, k = cand.nonzero(as_tuple=True)  # row-major: by scenario, row, column
        i, j = wd.pi[k], wd.pj[k]
        pa, pb = wd.person[i], wd.person[j]
        u = rng.uniform(seed[b, 0], rng.CONTACT, day, torch.minimum(pa, pb),
                        torch.maximum(pa, pb), wd.loc[i])
        hit = u < wd.p[i]
        b, k, i, j = b[hit], k[hit], i[hit], j[hit]
        rho = (wd.overlap[k].to(fdt) * sus_v[b, i]) * inf_v[b, j]
        row = b * wd.n + i
        acc = _ordered_sum(torch.zeros(B * wd.n, dtype=fdt, device=device), row, rho,
                           _rank_in_runs(row)).reshape(B, wd.n)
        cnt = torch.bincount(b, minlength=B)
        A = torch.zeros((B, P), dtype=fdt, device=device)
        for ppl, vis in wd.combine:
            A[:, ppl] = A[:, ppl] + acc[:, vis]
        A = A * tau

        # ---- infection, seeding, the automaton ---------------------------
        u = rng.uniform(seed, rng.INFECT, day, gpid[None])
        infected = (A > 0.0) & (u > torch.exp(-A).float())
        sus_ok = dz.sus[health] > 0.0
        us = torch.where(sus_ok, rng.uniform(seed, rng.SEED_CHOICE, day, gpid[None]), 2.0)
        kseed = min(int(cfg["seed_per_day"]), P) - 1
        thresh = torch.sort(us, dim=-1).values[:, max(kseed, 0)]
        seeded = (us <= thresh[:, None]) & sus_ok & (
            int(cfg["seed_per_day"]) > 0 and day < int(cfg["seed_days"]))
        new = (infected | seeded) & sus_ok

        nxt = (dz.cum[health] < rng.uniform(seed, rng.TRANSITION, day, gpid[None])[..., None]
               ).sum(dim=-1)
        dwell_after = dwell - 1.0
        timed = dwell_after <= 0.0
        health_t = torch.where(timed, nxt, health)
        health_new = torch.where(new, dz.entry, health_t)
        changed = new | (timed & (health_new != health))
        mean = dz.dwell[health_new]
        draw = -mean * torch.log(rng.uniform(seed, rng.DWELL, day, gpid[None]))
        draw = torch.where(mean >= ABSORBING, ABSORBING, torch.clamp(draw, min=1.0))
        dwell = torch.where(changed, draw, dwell_after)

        health = health_new

        cumulative = cumulative + new.sum(dim=-1)
        infectious = (dz.inf[health] > 0.0).sum(dim=-1)
        stats = {"day": torch.full((B,), day, dtype=torch.int64, device=device),
                 "new_infections": new.sum(dim=-1), "cumulative": cumulative,
                 "infectious": infectious, "susceptible": (dz.sus[health] > 0.0).sum(dim=-1),
                 "contacts": cnt, "edges": cnt, "tests_used": zero, "isolated": zero,
                 "traced": zero}
        for key in STAT_KEYS:
            rows[key].append(stats[key])
        if pair_counts:
            rows["sus_inf_pairs"].append(cand.sum(dim=-1))

        # ---- triggers, from the day's counts ------------------------------
        new_active = []
        for k, iv in enumerate(classic):
            t = iv["trigger"]
            if t["kind"] == "day_range":
                on = torch.full((B,), day >= t["start"] and day < t.get("end", 2**31 - 1),
                                device=device)
            else:
                x = stats[t["metric"]]
                off = NEVER_OFF if t["off"] is None else t["off"]
                on = torch.where(active[:, k], x >= off, x >= t["on"])
            new_active.append(on)
        if classic:
            active = torch.stack(new_active, dim=-1)
    return {k: torch.stack(v).to(torch.int64).cpu().numpy() for k, v in rows.items()}
