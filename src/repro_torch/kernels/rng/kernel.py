"""The counter-draw kernel: CUDA build, binding, argument packing.

``csrc/rng.cu`` holds a hand-written Hopper (sm_90a) kernel,
``rng_uniform_kernel``: ``core/rng.py:uniform`` on CUDA tensors, the whole
Murmur3 fold and the float32 uniform in one launch on native u32 lanes,
writing only the float32 result. It replaces no Pallas TPU kernel: on the
TPU, XLA fused the same chain of u32 ops into one loop, where eager PyTorch
runs ~124 int64 ops a draw, each a pass over memory. Its plain version is
``core/rng.py:uniform_plain``, the int64 path that the CPU runs and the
tests hold the kernel to, bit for bit.

The source is compiled with ``nvcc`` into a shared library with a plain C
interface at first use (into ``build/`` beside the package's ``csrc/``,
keyed by a hash of the source and flags) and called through ``ctypes`` on
PyTorch's current stream, with no host sync. Nothing here is imported or
built when the module is imported. :func:`uniform_cuda` counts its launches
in ``uniform_cuda.launches``; a launch captured into a CUDA graph is counted
at each replay instead (``engine/runner.py``).

The words broadcast as torch broadcasts them (rank at most
:data:`MAX_RANK`, at most :data:`MAX_WORDS` words after the seed):
:func:`pack` works out on the host what a launch takes, each tensor word's
strides after ``expand`` (0 on a broadcast axis), python ints as u32
constants, and the prefix of inputs constant along the last axis, which the
kernel folds once a row. On the card the ``rng.hash`` span of
``core/rng.py:uniform`` brackets only the host's launch: the profiler links
no host operation to a ``ctypes`` launch, so a trace finds the kernel's
device time by its name, ``rng_uniform_kernel``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct

import torch

from repro_torch.kernels import build as build_lib

SOURCE = build_lib.CSRC / "rng.cu"
# --fmad=false: no contraction of the uniform's product into its sum, so the
# kernel's float arithmetic is the plain version's bit for bit.
NVCC_FLAGS = (*build_lib.BASE_FLAGS, "--fmad=false")
MAX_RANK = 4  # the output's rank, at most (csrc kRank)
MAX_WORDS = 6  # words after the seed, at most (csrc kMaxInputs - 1)
_MASK = 0xFFFFFFFF
# The C entry point's int64 arguments per input: its pointer, constant and
# strides (csrc kPerInput), after a header of inputs, prefix and the shape.
_PER_INPUT = 2 + MAX_RANK


def build():
    """Compile the kernel if its library is missing; returns the library
    path and the ``-Xptxas -v`` report (registers, shared memory, spills)."""
    return build_lib.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.rng_uniform_launch
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@dataclasses.dataclass(frozen=True)
class Packed:
    """What one launch takes, for the seed and the words in order.

    ``shape`` is the output's (the tensors' broadcast shape); per input,
    ``words`` holds its int64 tensor or None for a python int, ``consts``
    that int as a u32 (0 for a tensor), ``strides`` its strides in elements
    after ``expand`` to ``shape``, padded in front with 0 to rank
    :data:`MAX_RANK`; ``prefix`` counts the leading inputs constant along
    the last axis (all of them where it has one element)."""

    shape: tuple
    device: torch.device
    words: tuple
    consts: tuple
    strides: tuple
    prefix: int

    def arguments(self) -> list:
        """The C entry point's int64 arguments (``csrc/rng.cu``), as ints."""
        shape = (1,) * (MAX_RANK - len(self.shape)) + tuple(self.shape)
        out = [len(self.words), self.prefix, *shape]
        for t, c, s in zip(self.words, self.consts, self.strides):
            out += [0 if t is None else t.data_ptr(), c, *s]
        return out + [0] * (_PER_INPUT * (1 + MAX_WORDS - len(self.words)))


def pack(seed, *words) -> Packed:
    """The launch's arguments for ``uniform(seed, *words)``; raises on what
    the kernel does not take. A tensor word of another dtype than int64 is
    cast to int64, as the plain version's ``_u32`` casts it; the kernel
    reads its low 32 bits."""
    inputs = (seed, *words)
    if len(words) > MAX_WORDS:
        raise ValueError(f"{len(words)} words: the kernel takes at most {MAX_WORDS}")
    tensors = [x for x in inputs if isinstance(x, torch.Tensor)]
    if not tensors:
        raise TypeError("uniform needs at least one tensor among the seed and words")
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"words on {sorted({str(t.device) for t in tensors})}: "
                         "the kernel takes one device")
    # The shape of broadcast views: torch.broadcast_shapes would import
    # torch.fx's symbolic shapes (sympy) at its first call, seconds of a
    # process's set-up.
    shape = tuple(torch.broadcast_tensors(*tensors)[0].shape)
    if len(shape) > MAX_RANK:
        raise ValueError(f"shape {shape}: the kernel takes rank {MAX_RANK} at most")
    carried, consts, strides = [], [], []
    for x in inputs:
        if isinstance(x, torch.Tensor):
            t = x if x.dtype == torch.int64 else x.to(torch.int64)
            carried.append(t)
            consts.append(0)
            # expand's strides, with 0 also on axes of one element
            strides.append((0,) * (MAX_RANK - t.dim())
                           + tuple(0 if n == 1 else s for n, s in zip(t.shape, t.stride())))
        else:
            carried.append(None)
            consts.append(int(x) & _MASK)
            strides.append((0,) * MAX_RANK)
    row_constant = not shape or shape[-1] == 1
    prefix = 0
    while prefix < len(inputs) and (row_constant or strides[prefix][-1] == 0):
        prefix += 1
    return Packed(shape, device, tuple(carried), tuple(consts), tuple(strides), prefix)


def uniform_cuda(seed, *words) -> torch.Tensor:
    """``core/rng.py:uniform`` in one launch on the current stream (no host
    sync): float32 of the words' broadcast shape, bitwise the plain
    version. Raises on inputs the kernel does not take (:func:`pack`), on
    tensors off the card, and if the launch is refused."""
    p = pack(seed, *words)
    if p.device.type != "cuda":
        raise ValueError(f"words on {p.device}: the kernel runs on a CUDA device")
    # detlint: ignore[DET005] — rng_uniform_kernel stores every element: its
    # grid covers every row and every column of the output
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    args = p.arguments()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().rng_uniform_launch(
            struct.pack(f"{len(args)}q", *args), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rng kernel launch failed: CUDA error {err}")
    uniform_cuda.launches += 1
    return out


uniform_cuda.launches = 0
