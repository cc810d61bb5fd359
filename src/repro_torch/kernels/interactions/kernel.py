"""The fused compacted interaction kernel: CUDA build, binding, plain twin.

``csrc/interactions_compact.cu`` is a hand-written Hopper (sm_90a) kernel
that replaces the reference's Pallas TPU kernel
``src/repro/kernels/interactions/kernel.py:_fused_kernel``. It is compiled
with ``nvcc`` into a shared library with a plain C interface at first use
(into ``build/`` beside the package's ``csrc/``, keyed by a hash of the
source and flags) and called through ``ctypes`` on PyTorch's current
stream. Nothing here is imported or built when the module is imported.

:func:`interactions_compact_plain` is its plain PyTorch version: the same
inputs, the same per-tile column-sequential accumulation order
(``ref.pair_tile``), tiles folded into rows in compacted order. It equals the
kernel bitwise (``acc``, ``cnt`` and ``edges``). It syncs with the host
(``n_live`` and the run lengths become python ints), so it serves the CPU
and the card-side comparison, never the CUDA day loop.

Both take the compacted schedule that ``ops.compact_schedule`` builds and
return ``(acc (V,) f32, cnt (V,) int32, edges () int64)``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.interactions.ref import pair_tile

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "interactions_compact.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing; returns the library
    path and the ``-Xptxas -v`` report (registers, shared memory, spills)."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"interactions_compact_{key.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, log.read_text() if log.exists() else ""


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.interactions_compact_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


_INT = ("pid", "loc", "rows_c", "cols_c", "row_start_c", "n_live",
        "col_has_inf", "row_has_sus")
_FLOAT = ("start", "end", "p_loc", "sus_val", "inf_val")


def interactions_compact_cuda(
    pid, loc, start, end, p_loc, sus_val, inf_val,
    rows_c, cols_c, row_start_c, n_live, col_has_inf, row_has_sus, meta,
    *, block_size: int,
):
    """Launch the CUDA kernel on the current stream (no host sync).

    int32: pid, loc, rows_c, cols_c, row_start_c, n_live (1,), col_has_inf,
    row_has_sus; float32: start, end, p_loc, sus_val, inf_val; int64 meta
    (2,) = [seed, day] as u32 values. Raises on anything else, and if the
    launch is refused. Each accepted launch adds one to
    ``interactions_compact_cuda.launches``."""
    args = dict(pid=pid, loc=loc, start=start, end=end, p_loc=p_loc,
                sus_val=sus_val, inf_val=inf_val, rows_c=rows_c, cols_c=cols_c,
                row_start_c=row_start_c, n_live=n_live,
                col_has_inf=col_has_inf, row_has_sus=row_has_sus, meta=meta)
    b = block_size
    V = pid.shape[0]
    if b % 32 or not 32 <= b <= 1024 or V % b:
        raise ValueError(f"block_size {b} must be a multiple of 32 in "
                         f"[32, 1024] dividing V={V}")
    for name, a in args.items():
        want = (torch.int32 if name in _INT else torch.float32
                if name in _FLOAT else torch.int64)
        if a.device != pid.device or not a.is_cuda:
            raise ValueError(f"{name} is on {a.device}, expected {pid.device}")
        if a.dtype != want or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}, got {a.dtype}")
    for name in ("loc", "start", "end", "p_loc", "sus_val", "inf_val"):
        if args[name].shape != (V,):
            raise ValueError(f"{name} has shape {tuple(args[name].shape)}, expected ({V},)")
    NP = rows_c.shape[0]
    if cols_c.shape != (NP,) or row_start_c.shape != (NP,) or n_live.shape != (1,):
        raise ValueError("schedule arrays must be (NP,) and n_live (1,)")
    if col_has_inf.shape != (V // b,) or row_has_sus.shape != (V // b,) or meta.shape != (2,):
        raise ValueError("block flags must be (V // b,) and meta (2,)")

    acc = torch.zeros((V,), dtype=torch.float32, device=pid.device)
    cnt = torch.zeros((V,), dtype=torch.int32, device=pid.device)
    edges = torch.zeros((), dtype=torch.int64, device=pid.device)
    ptrs = [a.data_ptr() for a in args.values()]
    with torch.cuda.device(pid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().interactions_compact_launch(
            *ptrs, acc.data_ptr(), cnt.data_ptr(), edges.data_ptr(),
            NP, b, stream,
        )
    if err != 0:
        raise RuntimeError(f"interactions_compact launch failed: CUDA error {err}")
    interactions_compact_cuda.launches += 1
    return acc, cnt, edges


interactions_compact_cuda.launches = 0


# Live tiles per vectorised step of the plain version: bounds its memory to
# a few (TILES_PER_CHUNK, b, b) temporaries.
TILES_PER_CHUNK = 128


def interactions_compact_plain(
    pid, loc, start, end, p_loc, sus_val, inf_val,
    rows_c, cols_c, row_start_c, n_live, col_has_inf, row_has_sus, meta,
    *, block_size: int,
):
    """Plain PyTorch version of :func:`interactions_compact_cuda`: the same
    inputs and outputs, bitwise. Vectorised over live tiles (in chunks of
    ``TILES_PER_CHUNK``), column-sequential inside a tile."""
    b = block_size
    V = pid.shape[0]
    dev = pid.device
    acc = torch.zeros((V,), dtype=torch.float32, device=dev)
    cnt = torch.zeros((V,), dtype=torch.int32, device=dev)
    n = int(n_live[0])
    if n == 0:
        return acc, cnt, torch.zeros((), dtype=torch.int64, device=dev)
    rows = rows_c[:n].long()
    cols = cols_c[:n].long()
    # The kernel's per-tile guard: a tile that fails it adds nothing.
    guard = (row_has_sus[rows] > 0) & (col_has_inf[cols] > 0)
    seed, day = meta[0], meta[1]
    blk = lambda a, idx: a.view(-1, b)[idx]
    parts, counts = [], []
    for s in range(0, n, TILES_PER_CHUNK):
        r, c = rows[s:s + TILES_PER_CHUNK], cols[s:s + TILES_PER_CHUNK]
        part, pc = pair_tile(
            seed, day,
            blk(pid, r), blk(loc, r), blk(start, r), blk(end, r),
            blk(p_loc, r), blk(sus_val, r),
            blk(pid, c), blk(loc, c), blk(start, c), blk(end, c), blk(inf_val, c),
        )
        g = guard[s:s + TILES_PER_CHUNK, None]
        parts.append(torch.where(g, part, 0.0))
        counts.append(torch.where(g, pc, 0))
    part = torch.cat(parts)  # (n, b)
    pc = torch.cat(counts)
    # Fold tiles into their rows in compacted order: a row's live tiles are
    # one consecutive run, so the r-th tile of every run is added in one step.
    first = torch.cummax(
        torch.where(row_start_c[:n] > 0, torch.arange(n, device=dev), 0), dim=0
    ).values
    pos = torch.arange(n, device=dev) - first
    lanes = torch.arange(b, device=dev)
    for p in range(int(pos.max()) + 1):
        sel = pos == p
        idx = (rows[sel, None] * b + lanes).reshape(-1)
        acc[idx] = acc[idx] + part[sel].reshape(-1)
        cnt[idx] = cnt[idx] + pc[sel].reshape(-1)
    return acc, cnt, pc.sum(dtype=torch.int64)
