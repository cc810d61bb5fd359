"""Synthetic LM token pipeline: deterministic, sharded, restart-exact.

The reference's ``repro/data/tokens.py`` on the port's counter hash
(``core/rng.py:np_uniform``): batch b of step s is a pure function of
(seed, step), and its bytes equal the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import rng


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.8  # fraction of deterministic transitions

    def _successor(self, tok):
        return (tok * 31 + 17) % self.vocab_size

    def batch(self, step: int) -> np.ndarray:
        """(global_batch, seq_len) int32 for `step` — pure function."""
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        rows = np.arange(B, dtype=np.uint64) + np.uint64(step) * np.uint64(B)
        u0 = rng.np_uniform(self.seed, rng.VISIT_SAMPLE, 0, rows)
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = (u0 * V).astype(np.int64)
        for t in range(1, S):
            u = rng.np_uniform(self.seed, rng.VISIT_SAMPLE, t, rows)
            u2 = rng.np_uniform(self.seed + 1, rng.VISIT_SAMPLE, t, rows)
            det = self._successor(toks[:, t - 1])
            rnd = (u2 * V).astype(np.int64)
            toks[:, t] = np.where(u < self.structure, det, rnd)
        return toks.astype(np.int32)

    def shard(self, step: int, worker: int, num_workers: int) -> np.ndarray:
        """This worker's rows of the global batch (contiguous split)."""
        full = self.batch(step)
        per = self.global_batch // num_workers
        return full[worker * per : (worker + 1) * per]
