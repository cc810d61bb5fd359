"""Serving step functions (the reference's ``launch/steps.py``, prefill and
greedy decode; training waits for the optimizer port)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return M.forward_prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, token, pos: int):
        logits, new_cache = M.decode_step(cfg, params, cache, token, pos)
        # greedy next token (serving semantics); argmax takes the first maximum
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache

    return decode_step
