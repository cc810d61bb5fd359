"""The interaction-pass kernels: CUDA build, binding, plain versions.

``csrc/interactions.cu`` holds hand-written Hopper (sm_90a) kernels, one
templated tile body in four instantiations, each replacing a Pallas TPU
kernel of ``src/repro/kernels/interactions/kernel.py``:

  ================================  ====================================
  wrapper                           replaces
  ================================  ====================================
  interactions_compact_cuda         ``_fused_kernel`` (:205), untraced
  interactions_compact_traced_cuda  ``_fused_kernel``, traced arity
  interactions_padded_cuda          ``_kernel`` (:66), untraced
  interactions_padded_traced_cuda   ``_kernel``, traced arity
  ================================  ====================================

The source is compiled with ``nvcc`` into a shared library with a plain C
interface at first use (into ``build/`` beside the package's ``csrc/``,
keyed by a hash of the source and flags) and called through ``ctypes`` on
PyTorch's current stream. Nothing here is imported or built when the module
is imported. Each wrapper counts its own launches in ``<wrapper>.launches``.
A launch has one CTA per schedule entry, of :func:`threads` threads; the
outputs are views of one zeroed buffer (one fill per call). The source's
header states the design: the hoisted hash, the draw only for pairs that
can count, and why leaving the other terms out keeps every output bitwise.

:func:`interactions_compact_plain` and :func:`interactions_padded_plain` are
the plain PyTorch versions: the same inputs, the same per-tile
column-sequential accumulation order (``ref.pair_tile_traced``), live tiles
folded into their rows in schedule order. They equal the kernels bitwise
(``acc``, ``cnt``, ``trc`` and ``edges``). They sync with the host (the
live count and the run lengths become python ints), so they serve the CPU
and the card-side comparison, never the CUDA day loop.

The compacted kernels take the schedule that ``ops.compact_schedule``
builds and return ``(acc (V,) f32, cnt (V,) int32[, trc (V,) int32],
edges () int64)``; the padded kernels take the uncompacted schedule with
its ``row_start`` and ``pair_active`` and return ``(acc, cnt[, trc])``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as build_lib
from repro_torch.kernels.interactions.ref import pair_tile_traced

SOURCE = build_lib.CSRC / "interactions.cu"
# --fmad=false: no contraction of a product into a sum, so the kernels'
# float arithmetic is the plain versions' bit for bit.
NVCC_FLAGS = (*build_lib.BASE_FLAGS, "--fmad=false")


def build():
    """Compile the kernels if their library is missing; returns the library
    path and the ``-Xptxas -v`` report (registers, shared memory, spills)."""
    return build_lib.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.interactions_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 20
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.interactions_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.interactions_shared_bytes.restype = ctypes.c_longlong
    return lib


# Tiles a CTA stages at once: it has TILES_PER_GROUP * block_size threads
# (at most 1024), and all of them walk the group's candidate pairs.
TILES_PER_GROUP = 2


def threads(block_size: int) -> int:
    """The CTA's thread count for tiles of ``block_size``."""
    return max(1, min(TILES_PER_GROUP, 1024 // block_size)) * block_size


def shared_bytes(block_size: int) -> int:
    """Dynamic shared memory per CTA, from the built library."""
    return _library().interactions_shared_bytes(block_size, threads(block_size))


_VISITS = ("pid", "loc", "start", "end", "p_loc", "sus_val", "inf_val")
_FLAGS = ("col_has_inf", "row_has_sus", "meta")
# The positional arguments of the compacted and the padded wrappers.
COMPACT_ARGS = (*_VISITS, "rows_c", "cols_c", "row_start_c", "n_live", *_FLAGS)
PADDED_ARGS = (*_VISITS, "row_idx", "col_idx", "row_start", "pair_active", *_FLAGS)
_FLOAT = ("start", "end", "p_loc", "sus_val", "inf_val", "src_val")


def _launch(args, src_val, *, padded: bool, block_size: int):
    """Check the wrapper's positional ``args`` (and ``src_val`` for the
    traced arity), allocate the zeroed outputs and launch the instantiation on
    the current stream. Raises on inputs the kernel does not take, and if
    the launch is refused. Returns ``(acc, cnt, trc or None, edges or
    None)``."""
    names = PADDED_ARGS if padded else COMPACT_ARGS
    if len(args) != len(names):
        raise TypeError(f"expected {len(names)} arguments {names}, got {len(args)}")
    a = dict(zip(names, args))
    if src_val is not None:
        a["src_val"] = src_val
    b = block_size
    pid = a["pid"]
    V = pid.shape[0]
    if b % 32 or not 32 <= b <= 1024 or V % b:
        raise ValueError(f"block_size {b} must be a multiple of 32 in "
                         f"[32, 1024] dividing V={V}")
    for name, t in a.items():
        want = (torch.float32 if name in _FLOAT else torch.int64
                if name == "meta" else torch.int32)
        if t.device != pid.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, expected {pid.device}")
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}, got {t.dtype}")
    for name in (*_VISITS[1:], "src_val"):
        if name in a and a[name].shape != (V,):
            raise ValueError(f"{name} has shape {tuple(a[name].shape)}, expected ({V},)")
    sched = names[7:10] + (("pair_active",) if padded else ())
    NP = a[sched[0]].shape[0]
    if any(a[k].shape != (NP,) for k in sched):
        raise ValueError(f"schedule arrays {sched} must all be (NP,)")
    if not padded and a["n_live"].shape != (1,):
        raise ValueError("n_live must be (1,)")
    if (a["col_has_inf"].shape != (V // b,) or a["row_has_sus"].shape != (V // b,)
            or a["meta"].shape != (2,)):
        raise ValueError("block flags must be (V // b,) and meta (2,)")

    # One zeroed buffer holds every output (one fill, not four): acc, cnt,
    # trc when traced, then the edges slot (8-byte aligned: V is even), as
    # non-overlapping views.
    nout = 2 if src_val is None else 3
    buf = torch.zeros((nout * V + 2,), dtype=torch.int32, device=pid.device)
    acc = buf[:V].view(torch.float32)
    cnt = buf[V:2 * V]
    trc = None if src_val is None else buf[2 * V:3 * V]
    edges = None if padded else buf[nout * V:].view(torch.int64).view(())
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(pid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().interactions_launch(
            int(src_val is not None), int(padded),
            *(ptr(a[n]) for n in _VISITS), ptr(src_val), *(ptr(a[n]) for n in sched[:3]),
            ptr(a.get("pair_active")), ptr(a.get("n_live")),
            *(ptr(a[n]) for n in _FLAGS),
            acc.data_ptr(), cnt.data_ptr(), ptr(trc), ptr(edges), NP, b, threads(b),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"interactions kernel launch failed: CUDA error {err}")
    return acc, cnt, trc, edges


def interactions_compact_cuda(*args, block_size: int):
    """Launch the compacted kernel on the current stream (no host sync).

    ``args`` are :data:`COMPACT_ARGS`: int32 pid, loc, rows_c, cols_c,
    row_start_c, n_live (1,), col_has_inf, row_has_sus; float32 start, end,
    p_loc, sus_val, inf_val; int64 meta (2,) = [seed, day] as u32 values.
    Raises on anything else, and if the launch is refused. Returns
    ``(acc, cnt, edges)``."""
    acc, cnt, _, edges = _launch(args, None, padded=False, block_size=block_size)
    interactions_compact_cuda.launches += 1
    return acc, cnt, edges


def interactions_compact_traced_cuda(*args, src_val, block_size: int):
    """:func:`interactions_compact_cuda` with the tracing accumulator:
    ``src_val`` (V,) float32 in, returns ``(acc, cnt, trc, edges)``."""
    acc, cnt, trc, edges = _launch(args, src_val, padded=False, block_size=block_size)
    interactions_compact_traced_cuda.launches += 1
    return acc, cnt, trc, edges


def interactions_padded_cuda(*args, block_size: int):
    """Launch the padded kernel (no host sync). ``args`` are
    :data:`PADDED_ARGS`: the uncompacted int32 (NP,) schedule in place of
    the compacted one, the rest as :func:`interactions_compact_cuda`.
    Returns ``(acc, cnt)``: the TPU kernel has no edge counter."""
    acc, cnt, _, _ = _launch(args, None, padded=True, block_size=block_size)
    interactions_padded_cuda.launches += 1
    return acc, cnt


def interactions_padded_traced_cuda(*args, src_val, block_size: int):
    """:func:`interactions_padded_cuda` with the tracing accumulator:
    ``src_val`` (V,) float32 in, returns ``(acc, cnt, trc)``."""
    acc, cnt, trc, _ = _launch(args, src_val, padded=True, block_size=block_size)
    interactions_padded_traced_cuda.launches += 1
    return acc, cnt, trc


for _wrapper in (interactions_compact_cuda, interactions_compact_traced_cuda,
                 interactions_padded_cuda, interactions_padded_traced_cuda):
    _wrapper.launches = 0


# Live tiles per vectorised step of the plain versions: bounds their memory
# to a few (TILES_PER_CHUNK, b, b) temporaries.
TILES_PER_CHUNK = 128


def _fold_tiles(visits, src_val, rows, cols, guard, meta, b):
    """The plain versions' common body. ``rows``/``cols`` (n,) are the
    tiles to add, in schedule order, each row block's tiles consecutive;
    a tile whose ``guard`` is false adds nothing. Returns
    ``(acc, cnt, trc or None, edges)``."""
    pid, loc, start, end, p_loc, sus_val, inf_val = visits
    V = pid.shape[0]
    dev = pid.device
    acc = torch.zeros((V,), dtype=torch.float32, device=dev)
    cnt = torch.zeros((V,), dtype=torch.int32, device=dev)
    trc = None if src_val is None else torch.zeros((V,), dtype=torch.int32, device=dev)
    n = rows.shape[0]
    if n == 0:
        return acc, cnt, trc, torch.zeros((), dtype=torch.int64, device=dev)
    rows, cols = rows.long(), cols.long()
    seed, day = meta[0], meta[1]
    blk = lambda a, idx: a.view(-1, b)[idx]
    parts, counts, traced = [], [], []
    for s in range(0, n, TILES_PER_CHUNK):
        r, c = rows[s:s + TILES_PER_CHUNK], cols[s:s + TILES_PER_CHUNK]
        part, pc, tc = pair_tile_traced(
            seed, day,
            blk(pid, r), blk(loc, r), blk(start, r), blk(end, r),
            blk(p_loc, r), blk(sus_val, r),
            blk(pid, c), blk(loc, c), blk(start, c), blk(end, c), blk(inf_val, c),
            None if src_val is None else blk(src_val, c),
        )
        g = guard[s:s + TILES_PER_CHUNK, None]
        parts.append(torch.where(g, part, 0.0))
        counts.append(torch.where(g, pc, 0))
        if tc is not None:
            traced.append(torch.where(g, tc, 0))
    outs = [(acc, torch.cat(parts)), (cnt, torch.cat(counts))]
    if trc is not None:
        outs.append((trc, torch.cat(traced)))
    # Fold tiles into their rows in schedule order: a row's tiles are one
    # consecutive run, so the p-th tile of every run is added in one step.
    prev = torch.cat([rows[:1] - 1, rows[:-1]])
    first = torch.cummax(
        torch.where(rows != prev, torch.arange(n, device=dev), 0), dim=0
    ).values
    pos = torch.arange(n, device=dev) - first
    lanes = torch.arange(b, device=dev)
    for p in range(int(pos.max()) + 1):
        sel = pos == p
        idx = (rows[sel, None] * b + lanes).reshape(-1)
        for out, tiles in outs:
            out[idx] = out[idx] + tiles[sel].reshape(-1)
    return acc, cnt, trc, outs[1][1].sum(dtype=torch.int64)


def interactions_compact_plain(
    pid, loc, start, end, p_loc, sus_val, inf_val,
    rows_c, cols_c, row_start_c, n_live, col_has_inf, row_has_sus, meta,
    *, block_size: int, src_val=None,
):
    """Plain PyTorch version of :func:`interactions_compact_cuda` (and, with
    ``src_val``, of :func:`interactions_compact_traced_cuda`): the same
    inputs and outputs, bitwise. Walks the live prefix; the kernel's guard
    ``row_has_sus & col_has_inf`` applies per tile."""
    n = int(n_live[0])
    rows, cols = rows_c[:n].long(), cols_c[:n].long()
    guard = (row_has_sus[rows] > 0) & (col_has_inf[cols] > 0)
    acc, cnt, trc, edges = _fold_tiles(
        (pid, loc, start, end, p_loc, sus_val, inf_val), src_val,
        rows, cols, guard, meta, block_size)
    return (acc, cnt, edges) if trc is None else (acc, cnt, trc, edges)


def interactions_padded_plain(
    pid, loc, start, end, p_loc, sus_val, inf_val,
    row_idx, col_idx, row_start, pair_active, col_has_inf, row_has_sus, meta,
    *, block_size: int, src_val=None,
):
    """Plain PyTorch version of :func:`interactions_padded_cuda` (and, with
    ``src_val``, of :func:`interactions_padded_traced_cuda`): the same
    inputs and outputs, bitwise. Walks each row run of the padded schedule
    from its ``row_start`` entry and adds the tiles that pass the full guard
    ``pair_active & col_has_inf & row_has_sus``, in schedule order."""
    NP = row_idx.shape[0]
    rows, cols = row_idx.long(), col_idx.long()
    k = torch.arange(NP, device=rows.device)
    run = torch.cummax(torch.where(row_start == 1, k, -1), dim=0).values
    in_run = (run >= 0) & (rows[run.clamp(min=0)] == rows)
    keep = (in_run & (pair_active == 1) & (col_has_inf[cols] > 0)
            & (row_has_sus[rows] > 0))
    acc, cnt, trc, _ = _fold_tiles(
        (pid, loc, start, end, p_loc, sus_val, inf_val), src_val,
        rows[keep], cols[keep], torch.ones_like(rows[keep], dtype=torch.bool),
        meta, block_size)
    return (acc, cnt) if trc is None else (acc, cnt, trc)
