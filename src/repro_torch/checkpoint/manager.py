"""Checkpoints with integrity verification (the port of the reference's
``repro.checkpoint.manager``, in the same on-disk format).

  * A checkpoint is a directory ``step-%010d``: ``manifest.json`` + one
    ``.npy`` per tree leaf, named by its flattened key path with ``/``
    written as ``__``. The manifest holds ``step``, ``time``, ``extra`` and,
    per leaf, its ``shape``, ``dtype`` and SHA-256 digest. The layout and
    the manifest schema are the reference's, so a snapshot written by
    either package's manager restores through the other.
  * **Integrity**: every read path (``restore``/``restore_flat``/
    ``verify``) re-checks the bytes it loads against the manifest and
    raises :class:`CheckpointCorruptionError` naming the offending leaf.
    ``latest_valid_step`` walks snapshots newest-first, quarantining corrupt
    ones (moved under ``quarantine/``) so a resume falls back to the
    next-older valid step.
  * **Threads and devices**: :meth:`CheckpointManager.save` copies every
    tensor to host numpy in the calling thread (a synchronising copy, so the
    caller may reuse or overwrite its tensors as soon as ``save`` returns);
    the background writer sees numpy arrays only — it computes the digests,
    writes ``.tmp-N`` and renames it into place. No CUDA tensor crosses a
    thread. ``restore`` places leaves on the device of the template's
    tensors.
  * Writes are atomic (tmp dir + rename) and asynchronous, one in flight at
    a time (``save`` first joins the previous write); ``wait()`` joins the
    writer and **re-raises** any exception it hit, once. Readers join the
    in-flight writer first, so they never race a half-written snapshot.
    Retention keeps the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


class CheckpointCorruptionError(RuntimeError):
    """A snapshot failed integrity verification (truncated/bit-flipped/
    missing leaf file, or a leaf disagreeing with its manifest entry or
    with the tree it is restored into)."""


def _children(tree):
    """``(key, child)`` pairs of an inner node in the reference's flattening
    order (dict keys sorted, dataclass fields in order, sequence indices),
    or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_tree(tree) -> dict[str, Any]:
    """Flatten a tree to {key-path: leaf}, the on-disk leaf naming.

    Dict keys, dataclass field names and sequence indices become path
    segments joined with ``/``; ``None`` holds no leaf. These are the keys
    the reference's ``flatten_tree`` gives the same structure and the keys
    ``restore_flat`` returns."""
    flat = {}

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            flat["/".join(prefix)] = node
            return
        for k, v in kids:
            walk(v, prefix + [k])

    walk(tree, [])
    return flat


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else references (a CPU tensor's
    ``.numpy()`` and ``np.asarray`` would share the caller's memory, which
    the caller may overwrite while the writer thread reads it)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def leaf_digest(arr: np.ndarray) -> str:
    """SHA-256 over a leaf's raw bytes (C-contiguous). The bytes are read
    through a buffer, not copied into a ``bytes`` object: hashlib hashes a
    large buffer with the interpreter lock released, so a background write
    does not stall the thread that drives the day loop."""
    return hashlib.sha256(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


class CheckpointManager:
    QUARANTINE = "quarantine"

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._write_exc: Optional[BaseException] = None
        #: steps moved aside by :meth:`quarantine` over this manager's
        #: lifetime (the resilience report reads this).
        self.quarantined_steps: list[int] = []

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot ``tree`` at ``step``. Copies every leaf to host numpy
        here, then writes in a background thread (one write in flight: the
        previous one is joined first, re-raising its exception if it
        failed)."""
        self.wait()
        host = {k: _to_host(v) for k, v in flatten_tree(tree).items()}
        saved_at = time.time()

        def write():
            meta = {
                "step": int(step),
                "time": saved_at,
                "extra": extra or {},
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                               "sha256": leaf_digest(v)}
                           for k, v in host.items()},
            }
            tmp = os.path.join(self.directory, f".tmp-{step}")
            final = os.path.join(self.directory, f"step-{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            for k, v in host.items():
                np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), v)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 — surfaced at the next wait()
                    self._write_exc = e

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the in-flight background write; re-raise its exception if
        it failed (once — the error is cleared after being surfaced)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._write_exc is not None:
            exc, self._write_exc = self._write_exc, None
            raise RuntimeError(
                f"background checkpoint write failed in {self.directory}"
            ) from exc

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        # No wait() here: the writer itself calls all_steps() via _gc(),
        # and a thread must not join itself.
        return sorted(int(d.split("-")[1]) for d in os.listdir(self.directory)
                      if d.startswith("step-"))

    def latest_step(self) -> Optional[int]:
        self.wait()  # a reader never races the in-flight writer
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- integrity ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step:010d}")

    def _load_leaf(self, step: int, key: str, entry: dict) -> np.ndarray:
        """Load one leaf and verify it against its manifest entry."""
        path = os.path.join(self._step_dir(step), key.replace("/", "__") + ".npy")
        try:
            arr = np.load(path)
        except FileNotFoundError as e:
            raise CheckpointCorruptionError(
                f"step {step}: leaf '{key}' is missing ({path})") from e
        except Exception as e:  # truncated/garbled .npy header or payload
            raise CheckpointCorruptionError(
                f"step {step}: leaf '{key}' is unreadable "
                f"({type(e).__name__}: {e})") from e
        if list(arr.shape) != list(entry.get("shape", arr.shape)):
            raise CheckpointCorruptionError(
                f"step {step}: leaf '{key}' has shape {list(arr.shape)}, "
                f"manifest says {entry['shape']}")
        if str(arr.dtype) != entry.get("dtype", str(arr.dtype)):
            raise CheckpointCorruptionError(
                f"step {step}: leaf '{key}' has dtype {arr.dtype}, "
                f"manifest says {entry['dtype']}")
        want = entry.get("sha256")  # absent in pre-integrity checkpoints
        if want is not None and leaf_digest(arr) != want:
            raise CheckpointCorruptionError(
                f"step {step}: leaf '{key}' failed its SHA-256 digest check "
                "(bit-flip or partial write)")
        return arr

    def verify(self, step: int) -> list[str]:
        """Integrity-check every leaf of a snapshot against its manifest.
        Returns a list of problems (empty = valid); never raises for
        corruption."""
        try:
            meta = self.manifest(step)
        except (CheckpointCorruptionError, FileNotFoundError) as e:
            return [str(e)]
        problems = []
        for k, entry in meta.get("leaves", {}).items():
            try:
                self._load_leaf(step, k, entry)
            except CheckpointCorruptionError as e:
                problems.append(str(e))
        return problems

    def quarantine(self, step: int) -> str:
        """Move a (corrupt) snapshot aside under ``quarantine/`` so it is
        never restored from again, keeping the bytes for post-mortems."""
        qdir = os.path.join(self.directory, self.QUARANTINE)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, f"step-{step:010d}")
        if os.path.exists(dst):  # re-quarantine of a rewritten step
            dst = f"{dst}.{int(time.time() * 1e6)}"
        os.rename(self._step_dir(step), dst)
        self.quarantined_steps.append(int(step))
        return dst

    def latest_valid_step(self, quarantine: bool = True) -> Optional[int]:
        """Newest step that passes :meth:`verify`, walking older snapshots
        as corrupt ones are found (and, by default, quarantining those).
        Returns None when no valid snapshot remains."""
        self.wait()
        for step in reversed(self.all_steps()):
            if not self.verify(step):
                return step
            if quarantine:
                self.quarantine(step)
        return None

    # -- restore ------------------------------------------------------------
    def restore(self, tree_like, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``tree_like``, whose leaves are
        tensors: each restored leaf is a tensor on its template leaf's
        device. Every leaf is verified against the manifest (shape, dtype,
        SHA-256) as it is loaded, and must have its template's shape and
        dtype: a mismatch raises, nothing is cast."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        meta = self.manifest(step)
        loaded = {}
        for k, like in flatten_tree(tree_like).items():
            entry = meta.get("leaves", {}).get(k)
            if entry is None:
                raise CheckpointCorruptionError(
                    f"step {step}: leaf '{k}' requested by the restore "
                    "template is not in the manifest")
            t = torch.from_numpy(self._load_leaf(step, k, entry))
            if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
                raise ValueError(
                    f"{k}: checkpoint {tuple(t.shape)} {t.dtype} != expected "
                    f"{tuple(like.shape)} {like.dtype}")
            loaded[k] = t.to(like.device)
        return _unflatten(tree_like, loaded, [])

    def restore_flat(self, step: Optional[int] = None) -> dict[str, np.ndarray]:
        """Load every leaf of a checkpoint as host numpy, keyed by the
        flattened key path (see :func:`flatten_tree`). Unlike ``restore``
        this needs no template, so it also recovers leaves whose shapes are
        unknowable before reading (a day-chunked run's history-so-far).
        Leaves are digest-verified as they load."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        meta = self.manifest(step)
        return {k: self._load_leaf(step, k, entry)
                for k, entry in meta["leaves"].items()}

    def manifest(self, step: Optional[int] = None) -> dict:
        self.wait()
        step = step if step is not None else self.latest_step()
        path = os.path.join(self._step_dir(step), "manifest.json")
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            raise
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointCorruptionError(
                f"step {step}: manifest.json is unreadable "
                f"({type(e).__name__}: {e})") from e


def _unflatten(like, loaded: dict, prefix: list):
    """Rebuild ``like``'s structure with the ``loaded`` leaves."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return loaded["/".join(prefix)]
    vals = {k: _unflatten(v, loaded, prefix + [k]) for k, v in kids}
    if isinstance(like, dict):
        return {k: vals[str(k)] for k in like}
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **vals)
    return type(like)(vals[str(i)] for i in range(len(like)))
