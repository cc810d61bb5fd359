"""Build a CUDA source of ``csrc/`` into a shared library with ``nvcc``.

A library has a plain C interface and is loaded with ``ctypes``. It is
compiled at first use into ``build/`` beside the package's ``csrc/``, keyed
by a hash of the source and the flags, and never when a module is imported.
Two builds of different sources may run at once (each in its own thread or
process): each writes a temporary file and renames it into place.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
# sm_90a: Hopper with its architecture-specific instructions; a plain C
# interface (no PyTorch headers) keeps a build to seconds.
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build(source: Path, flags: tuple) -> tuple[Path, str]:
    """Compile ``source`` with ``flags`` if its library is missing; returns
    the library path and the ``-Xptxas -v`` report (registers, shared
    memory, spills per kernel)."""
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    lib = BUILD_DIR / f"{source.stem}_{key.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, log.read_text() if log.exists() else ""
