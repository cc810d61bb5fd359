"""detlint rule registry for the port — one module per encoded bug class,
each the torch/CUDA counterpart of the reference's rule of the same code:

  DET001  raw RNG use outside core/rng.py (torch, numpy, stdlib)
  DET002  undeclared / reused counter-RNG stream ids
  DET003  constructors whose dtype follows torch.get_default_dtype()
  DET004  narrowed integer sums crossing torch.distributed collectives
  DET005  CUDA: float atomics, fast-math intrinsics and flags, FP
          contraction left on, kernel outputs neither zeroed nor written
  DET006  host nondeterminism in what a day replays
"""

from __future__ import annotations

from repro_torch.analysis.lint.rules import (
    det001_raw_rng,
    det002_streams,
    det003_dtype,
    det004_widening,
    det005_cuda,
    det006_host_nondet,
)

_RULES = (
    det001_raw_rng.RawRngRule(),
    det002_streams.StreamRegistryRule(),
    det003_dtype.DefaultDtypeRule(),
    det004_widening.WideningRule(),
    det005_cuda.CudaDeterminismRule(),
    det006_host_nondet.HostNondetRule(),
)


def all_rules():
    return _RULES


def rule_catalog() -> dict:
    """code -> one-line description (for ``--list-rules``)."""
    return {r.code: r.description for r in _RULES}
