"""Learning-rate schedules (the reference's ``optim/schedules.py``): pure
functions of a step tensor, computed in float32 as the reference computes
them."""

from __future__ import annotations

import math

import torch


def linear_warmup(warmup_steps: int):
    def f(step):
        return torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)

    return f


def cosine_schedule(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(step):
        s = step.float()
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return f
