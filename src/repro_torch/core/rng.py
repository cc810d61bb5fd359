"""Counter-based hash RNG for partition-invariant stochastic draws.

Every random draw is a *pure function* of ``(seed, day, entity ids,
stream)`` via a 32-bit mixing hash, so results are bitwise identical across
layouts and replays, and bitwise identical to the reference package's
``repro.core.rng`` (the same Murmur3 finalizer, the same word folding).

Representation: ``torch.uint32`` lacks basic CPU ops, so a u32 word is
carried in an int64 tensor holding a value in ``[0, 2**32)``. Every multiply
is split into 16-bit halves so no intermediate leaves int64's range, and
every add or multiply is masked back to 32 bits. On the card, :func:`uniform`
does not run that chain: a draw on CUDA tensors is one launch of the
hand-written kernel of ``csrc/rng.cu`` (``kernels/rng/kernel.py``), which
folds the words on native ``unsigned`` lanes and writes only the float32
draw. Its plain version is :func:`uniform_plain`, the int64 path, which the
CPU runs and the tests hold the kernel to, bit for bit; :func:`hash_u32`
keeps the int64 path on every device. The CUDA interaction kernel
(``csrc/interactions.cu``) runs the same hash on native ``unsigned`` too.

Streams (documented constants, one per random decision in the simulator):
  CONTACT      per (pid_i, pid_j, day): did a co-occupant pair make contact?
  INFECT       per (pid, day): infection draw against total propensity
  TRANSITION   per (pid, day): FSA next-state categorical draw
  DWELL        per (pid, day): dwell-time draw for the state entered
  SEED_CHOICE  per (pid, day): outbreak seeding
  TEST         per (slot, pid, day): testing-priority draw
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.rng import kernel as rng_kernel
from repro_torch.runtime import spans

# Stream ids — keep stable; they are part of the reproducibility contract.
CONTACT = 0x01
INFECT = 0x02
TRANSITION = 0x03
DWELL = 0x04
SEED_CHOICE = 0x05
VISIT_SAMPLE = 0x06
INIT_ATTR = 0x07
TEST = 0x08

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_MASK = 0xFFFFFFFF


def _u32(x):
    """A u32 word as an int64 tensor (python ints pass through masked)."""
    if isinstance(x, (int, np.integer)):
        return int(x) & _MASK
    return x.to(torch.int64) & _MASK


def _mul32(h, c: int):
    """``(h * c) mod 2**32`` for a u32-valued int64 tensor and constant c,
    in 16-bit halves so the product never overflows int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(h):
    """Murmur3 finalizer: full-avalanche 32-bit mix (python int or
    u32-valued int64 tensor)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_u32(seed, *words):
    """Combine u32 words into one mixed u32 (int64 tensor in [0, 2**32)).

    Any of ``seed``/``words`` may be tensors (broadcasting applies) or
    python ints; at least one must be a tensor. Order-sensitive: (i, j) and
    (j, i) produce independent draws.
    """
    with spans.span("rng.hash"):
        h = fmix32(_u32(seed) ^ _GOLDEN)  # a python int while the seed is one
        for i, w in enumerate(words):
            h = fmix32(h ^ fmix32((_u32(w) + _GOLDEN * (i + 1)) & _MASK))
        return h


def uniform(seed, *words):
    """U(0,1) float32 from the hash; never exactly 0 (safe for log).

    Top 24 bits -> [0, 1) with 2^-24 resolution, then offset by 2^-25, every
    step in float32 as the reference does it. Where a word is a CUDA tensor,
    one launch of the kernel (``kernels/rng/kernel.py:uniform_cuda``), which
    raises on what it does not take; elsewhere :func:`uniform_plain`."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in (seed, *words)):
        with spans.span("rng.hash"):
            return rng_kernel.uniform_cuda(seed, *words)
    return uniform_plain(seed, *words)


def uniform_plain(seed, *words):
    """:func:`uniform` on int64 carriers: the kernel's plain version."""
    h = hash_u32(seed, *words)
    return (h >> 8).to(torch.float32) * (2.0**-24) + (2.0**-25)


def exponential(mean, seed, *words):
    """Exponential(mean) draw."""
    return -mean * torch.log(uniform(seed, *words))


def categorical(cum_probs, seed, *words):
    """Inverse-CDF categorical draw.

    cum_probs: (..., K) cumulative probabilities along the last axis.
    Returns the int32 index with the batch shape of the hash words.
    """
    u = uniform(seed, *words)
    return (cum_probs < u[..., None]).sum(dim=-1).to(torch.int32)


def np_uniform(seed, *words):
    """NumPy mirror of :func:`uniform` for host-side generators (float64)."""

    def mix(h):
        h = np.uint32(h)
        with np.errstate(over="ignore"):
            h ^= h >> np.uint32(16)
            h *= np.uint32(_C1)
            h ^= h >> np.uint32(13)
            h *= np.uint32(_C2)
            h ^= h >> np.uint32(16)
        return h

    with np.errstate(over="ignore"):
        h = mix(np.uint32(seed & _MASK) ^ np.uint32(_GOLDEN))
        for i, w in enumerate(words):
            w = np.asarray(w, dtype=np.uint64) & np.uint64(_MASK)
            h = mix(h ^ mix(w.astype(np.uint32)
                            + np.uint32(_GOLDEN) * np.uint32(i + 1)))
    u = (h >> np.uint32(8)).astype(np.float64) * 2.0**-24
    return u + 2.0**-25
