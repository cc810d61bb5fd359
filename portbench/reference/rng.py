"""The simulator's counter-based draws, written plainly.

Every random decision of the model is a pure function of (seed, stream,
day, ids): the Murmur3 finalizer folded over the words, as the paper's
partition-invariant scheme and the model's reproducibility guarantee state
it. u32 words are carried in int64 tensors, masked to 32 bits after each
step; a product is taken in 16-bit halves so it stays inside int64.
"""

from __future__ import annotations

import torch

CONTACT, INFECT, TRANSITION, DWELL, SEED_CHOICE = 0x01, 0x02, 0x03, 0x04, 0x05
INIT_ATTR = 0x07

_C1, _C2, _GOLDEN, _MASK = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF


def _mul(h, c):
    return ((h * (c & 0xFFFF)) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _MASK


def _fmix(h):
    h = h ^ (h >> 16)
    h = _mul(h, _C1)
    h = h ^ (h >> 13)
    h = _mul(h, _C2)
    return h ^ (h >> 16)


def _word(w):
    if isinstance(w, int):
        return w & _MASK
    return w.to(torch.int64) & _MASK


def hash32(seed, *words):
    """The mixed u32 of ``seed`` and ``words`` (ints or int tensors that
    broadcast), as an int64 tensor."""
    h = _fmix(_word(seed) ^ _GOLDEN)
    for i, w in enumerate(words):
        h = _fmix(h ^ _fmix((_word(w) + _GOLDEN * (i + 1)) & _MASK))
    return h


def uniform(seed, *words, dtype=torch.float32):
    """U(0, 1) from the top 24 bits, offset by 2^-25 (never 0), each step
    in ``dtype``."""
    return (hash32(seed, *words) >> 8).to(dtype) * (2.0 ** -24) + (2.0 ** -25)
