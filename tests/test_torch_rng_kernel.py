"""The counter-draw kernel's host side on the CPU: the argument packing of
``kernels/rng/kernel.py`` against ``torch.broadcast_tensors`` at the call
sites' shapes, the envelope it refuses, and ``rng.uniform`` on CPU tensors
running the plain int64 path with no launch. The kernel itself runs only on
a card (``tests/test_torch_gpu.py -k rng``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import rng
from repro_torch.kernels.rng import kernel as rng_kernel

B, P = 3, 37
_g = torch.Generator().manual_seed(0)


def _ints(*shape, dtype=torch.int64):
    return torch.randint(-2**40, 2**40, shape, generator=_g).to(dtype)


def _day():
    """The day's draws: seed and day (B, 1), the global person ids (P,)."""
    return _ints(B, 1), _ints(B, 1), torch.arange(P, dtype=torch.int64)


def _pair_tile(n=2, b=8):
    """The contact draw of ``interactions/ref.py:contact_uniform`` on
    (n, b, b) pair tiles: seed and day 0-d (``meta``), loc along the rows."""
    pid_r, pid_c, loc = _ints(n, b, 1), _ints(n, 1, b), _ints(n, b, 1)
    return (_ints(), rng.CONTACT, _ints(), torch.minimum(pid_r, pid_c),
            torch.maximum(pid_r, pid_c), loc)


def _cases():
    seed, day, gpid = _day()
    strided = _ints(2 * P, dtype=torch.int32)[::2]  # int32, not contiguous
    dense = _ints(5, 1), _ints(1, 5)
    return {
        # (seed, *words), the prefix the kernel folds once a row
        "infect": ((seed, rng.INFECT, day, gpid), 3),
        "infect_b1": ((seed[:1], rng.INFECT, day[:1], gpid), 3),
        "test_slot": ((seed, rng.TEST, day, 1, gpid), 4),
        "contact_tiles": (_pair_tile(), 3),
        "contact_dense": ((7, rng.CONTACT, 11, torch.minimum(*dense),
                           torch.maximum(*dense), dense[0]), 3),
        "int32_strided": ((seed, rng.DWELL, day.to(torch.int32), strided), 3),
        "transposed": ((_ints(P, B).t(), rng.SEED_CHOICE, 5), 0),
        "per_person_seed": ((gpid, rng.INFECT, day, 2**32 + 5), 0),
        "column": ((seed, rng.TRANSITION, day), 3),
        "rank4": ((_ints(2, 1, 1, 1), rng.INFECT, _ints(1, 3, 1, 1), _ints(4, 1),
                   _ints(5)), 4),
        "scalar": ((_ints(), rng.INFECT, -1), 3),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_broadcast_tensors(name):
    inputs, prefix = CASES[name]
    p = rng_kernel.pack(*inputs)
    tensors = [x.to(torch.int64) for x in inputs if isinstance(x, torch.Tensor)]
    expanded = iter(torch.broadcast_tensors(*tensors))
    shape = tuple(torch.broadcast_shapes(*(t.shape for t in tensors)))
    assert p.shape == shape and p.device == torch.device("cpu")
    assert p.prefix == prefix
    shape4 = (1,) * (4 - len(shape)) + shape
    for x, word, const, stride in zip(inputs, p.words, p.consts, p.strides):
        if not isinstance(x, torch.Tensor):
            assert word is None and const == int(x) & 0xFFFFFFFF and stride == (0,) * 4
            continue
        want = next(expanded)
        assert word.dtype == torch.int64 and const == 0
        # expand's strides where the output has more than one element, 0 on
        # the axes the word broadcasts along
        assert all(s == w for s, w, n in zip(stride[4 - len(shape):], want.stride(), shape)
                   if n > 1)
        assert all(s == 0 for s, n in zip(stride, (1,) * (4 - word.dim()) + word.shape)
                   if n == 1)
        # What the kernel reads: the word's storage at its strides.
        seen = torch.as_strided(word, shape4, stride, word.storage_offset())
        assert torch.equal(seen, want.reshape(shape4))
    # The prefix is constant along the last axis; the next input is not.
    last = lambda k: torch.as_strided(p.words[k], shape4, p.strides[k],
                                      p.words[k].storage_offset())
    for k in range(p.prefix):
        if p.words[k] is not None:
            assert torch.equal(last(k), last(k)[..., :1].expand(shape4))
    if p.prefix < len(inputs):
        assert p.strides[p.prefix][-1] != 0
    args = p.arguments()
    assert len(args) == 6 + 6 * 7
    assert args[:6] == [len(inputs), p.prefix, *shape4]


@pytest.mark.parametrize("bad", ["rank5", "seven_words", "no_tensor", "two_devices",
                                 "on_cpu"])
def test_wrapper_refuses_outside_its_envelope(bad):
    seed, day, gpid = _day()
    call = {
        "rank5": lambda: rng_kernel.pack(_ints(1, 1, 1, 1, 2), rng.INFECT),
        "seven_words": lambda: rng_kernel.pack(seed, 1, 2, 3, 4, 5, 6, gpid),
        "no_tensor": lambda: rng_kernel.pack(1, rng.INFECT, 2),
        "two_devices": lambda: rng_kernel.pack(seed, rng.INFECT,
                                               torch.zeros(P, dtype=torch.int64,
                                                           device="meta")),
        "on_cpu": lambda: rng_kernel.uniform_cuda(seed, rng.INFECT, day, gpid),
    }[bad]
    launches = rng_kernel.uniform_cuda.launches
    with pytest.raises((ValueError, TypeError)):
        call()
    assert rng_kernel.uniform_cuda.launches == launches


def test_pack_imports_no_symbolic_shapes():
    """Packing in a fresh process leaves sympy unimported: its import (through
    ``torch.broadcast_shapes``) would add seconds to a study's set-up."""
    code = ("import sys, torch\n"
            "from repro_torch.core import rng\n"
            "from repro_torch.kernels.rng import kernel\n"
            "kernel.pack(torch.zeros(3, 1, dtype=torch.int64), rng.INFECT, 5, torch.arange(7))\n"
            "print('sympy' in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, check=True, timeout=120)
    assert out.stdout.strip() == "False"


def test_uniform_on_cpu_runs_the_plain_path_without_a_launch():
    launches = rng_kernel.uniform_cuda.launches
    for inputs, _ in CASES.values():
        u = rng.uniform(*inputs)
        assert torch.equal(u, rng.uniform_plain(*inputs))
        assert u.dtype == torch.float32 and u.device.type == "cpu"
    seed, day, gpid = _day()
    cum = torch.tensor([[0.2, 0.7, 1.0]]).expand(P, 3)
    rng.categorical(cum, seed, rng.TRANSITION, day, gpid)
    rng.exponential(2.0, seed, rng.DWELL, day, gpid)
    assert rng_kernel.uniform_cuda.launches == launches
    # The plain path is numpy's mirror of the same hash.
    np.testing.assert_array_equal(
        rng.uniform(5, rng.INFECT, 9, gpid).numpy(),
        rng.np_uniform(5, rng.INFECT, 9, gpid.numpy()).astype(np.float32))
