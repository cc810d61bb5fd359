"""Transmission model (paper §III-A4).

Propensity of a contact between susceptible i and infectious j overlapping
for T seconds:

    rho(i, j, T) = T * tau * beta_sigma(p_i) * sigma(X_i)
                         * beta_iota(p_j)  * iota(X_j)        (Eq. 2)

Per-person accumulated propensity over the day's m infectious contacts:

    A(p_i) = sum_j rho(X_i, X_j, T_j)                          (Eq. 3)

and p_i is infected iff  a = -log(u)/A < 1  for u ~ U(0,1), i.e. with
probability 1 - exp(-A). All draws are counter-based (core/rng.py).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import rng


@dataclasses.dataclass(frozen=True)
class TransmissionModel:
    tau: float = 0.05  # global tuning value (paper validation uses 0.05)
    time_unit: float = 1.0  # multiplier converting visit time units -> seconds


def sample_infections(total_propensity: torch.Tensor, seed, day,
                      pid: torch.Tensor) -> torch.Tensor:
    """Bernoulli(1 - exp(-A)) per person, via the paper's -log(u)/A < 1 form.

    ``pid`` are the global person ids keying the draws."""
    u = rng.uniform(seed, rng.INFECT, day, pid)
    # -log(u)/A < 1  <=>  u > exp(-A); guard A == 0 (no exposure).
    return (total_propensity > 0.0) & (u > torch.exp(-total_propensity))
