"""Shared CLI plumbing for the launch drivers (the port of the reference's
``repro.launch.cli``).

The common flags (dataset / disease / backend / seed / workers /
checkpointing / ``--spec`` / ``--device``) are defined once here, and both
drivers, ``launch/simulate.py`` and ``launch/sweep.py``, reduce to: parse
flags, build or load an :class:`~repro_torch.api.ExperimentSpec`, call
:func:`repro_torch.api.run` on ``--device``.

Flag semantics with ``--spec``: the spec file is the base, and any flag the
user actually passed overrides the corresponding spec field (all common
flags default to ``None`` = "not given", so spec values survive untouched).
Without ``--spec``, the driver's own defaults fill the gaps.

A mesh spec (``--workers`` / ``--scenarios`` > 1) runs on
``workers x scenarios`` ranks: started here with
``repro_torch.launch.mesh.spawn`` over ``--backend-dist`` (``gloo`` by
default, which also lets several ranks share one card; ``nccl`` on
request), or, under ``torchrun``, the ranks torchrun started. Rank 0 prints
and writes; the other ranks stay quiet.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.api.spec import BACKENDS, ENGINES, ExperimentSpec
from repro_torch.configs.presets import DISEASES, INTERVENTION_PRESETS
from repro_torch.launch import mesh as mesh_lib

#: A CLI mesh's group timeout: ranks wait this long for each other at a
#: collective (their host builds before the first day included); and the
#: wall limit of the whole spawned study.
MESH_TIMEOUT_S = 600.0
MESH_WALL_S = 7 * 24 * 3600.0


def add_common_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flag set shared by every epidemic launch driver. All defaults
    are ``None`` so :func:`build_spec` can tell "not given" from a value."""
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="experiment spec (.toml or .json); other flags "
                         "override its fields")
    ap.add_argument("--dataset", default=None,
                    help="epidemic dataset name (configs/epidemics.py)")
    ap.add_argument("--disease", default=None, choices=sorted(DISEASES))
    ap.add_argument("--days", type=int, default=None)
    ap.add_argument("--tau", type=float, default=None,
                    help="base transmissibility (default: dataset's)")
    ap.add_argument("--seed", type=int, default=None,
                    help="base Monte Carlo seed (replicate r uses seed+r)")
    ap.add_argument("--replicates", type=int, default=None,
                    help="Monte Carlo replicates (innermost sweep axis)")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="interaction kernel backend")
    ap.add_argument("--engine", default=None, choices=list(ENGINES),
                    help="pin an engine (default: derived from batch x mesh)")
    ap.add_argument("--workers", type=int, default=None,
                    help="people/location-shard each scenario over this "
                         "many devices")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="shard the scenario axis over this many devices")
    ap.add_argument("--static-network", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="EpiHiper-style fixed weekly contact network "
                         "(--no-static-network overrides a spec's true)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (enables day-chunked "
                         "checkpointing + resume)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="days per checkpoint chunk")
    ap.add_argument("--resilient", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="run the chunk loop under the recovery policy "
                         "(failure -> restore newest valid snapshot -> "
                         "bitwise replay; needs --ckpt-dir)")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="restart cap for the resilient chunk loop")
    ap.add_argument("--out", default=None,
                    help="write the RunResult JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU only on request)")
    ap.add_argument("--backend-dist", default="gloo", choices=list(mesh_lib.BACKENDS),
                    help="torch.distributed backend of a mesh's ranks (default gloo)")
    return ap


# args attribute -> ExperimentSpec.with_overrides keyword (1:1 names).
COMMON_SPEC_KEYS = (
    "dataset", "disease", "days", "tau", "seed", "replicates", "backend",
    "engine", "workers", "scenarios", "static_network", "ckpt_dir",
    "ckpt_every", "resilient", "max_restarts",
)


def build_spec(args: argparse.Namespace, defaults: dict,
               **extra) -> ExperimentSpec:
    """``--spec`` file (flags override) or a spec built from ``defaults``.

    ``extra`` carries driver-specific overrides (e.g. the parsed
    intervention axis); ``None`` values are ignored like unset flags."""
    try:
        base = (ExperimentSpec.from_file(args.spec) if args.spec
                else ExperimentSpec(**defaults))
        overrides = {k: getattr(args, k) for k in COMMON_SPEC_KEYS}
        overrides.update(extra)
        return base.with_overrides(**overrides)
    except (ValueError, TypeError, KeyError, FileNotFoundError) as e:
        raise SystemExit(f"error: {e}")


def parse_intervention_axis(csv: str) -> tuple:
    """Comma list of preset names -> validated tuple."""
    names = tuple(n.strip() for n in csv.split(",") if n.strip())
    for n in names:
        if n not in INTERVENTION_PRESETS:
            raise SystemExit(
                f"error: unknown intervention preset '{n}'; "
                f"have {sorted(INTERVENTION_PRESETS)}")
    return names


def parse_float_axis(csv: str, flag: str) -> tuple:
    try:
        return tuple(float(s) for s in csv.split(","))
    except ValueError:
        raise SystemExit(
            f"error: {flag} must be comma-separated floats, got '{csv}'")


def _rank_run(spec: ExperimentSpec, device: str):
    """One rank of a spawned mesh: the study (every rank returns the same)."""
    from repro_torch import api

    return api.run(spec, device=device)


def run(spec: ExperimentSpec, device: str, backend_dist: str = "gloo"):
    """:func:`repro_torch.api.run` on ``device``, on the ranks a mesh spec
    needs: under torchrun, its ranks (their group joined over
    ``backend_dist``), else ranks spawned here; what the port does not run
    (a policy) is reported as a CLI error."""
    from repro_torch.api import runner

    ranks = runner.mesh_ranks(spec)
    try:
        if ranks > 1 and not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            mesh_lib.join_torchrun(backend_dist, device, timeout_s=MESH_TIMEOUT_S)
        if ranks == 1 or dist.is_initialized():
            return runner.run(spec, device=device)
        return mesh_lib.spawn(_rank_run, ranks, backend=backend_dist, device=device,
                              init_dir=tempfile.gettempdir(), args=(spec, device),
                              timeout_s=MESH_TIMEOUT_S, wall_s=MESH_WALL_S,
                              threads=max(1, (os.cpu_count() or 1) // ranks))[0]
    except NotImplementedError as e:
        raise SystemExit(f"error: {e}")


def is_rank0() -> bool:
    """Whether this process prints and writes: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0
