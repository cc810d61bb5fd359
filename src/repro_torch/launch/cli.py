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
"""

from __future__ import annotations

import argparse

from repro_torch.api.spec import BACKENDS, ENGINES, ExperimentSpec
from repro_torch.configs.presets import DISEASES, INTERVENTION_PRESETS


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


def run(spec: ExperimentSpec, device: str):
    """:func:`repro_torch.api.run` on ``device``, with what the port does not
    run yet (an engine, a policy) reported as a CLI error."""
    from repro_torch import api

    try:
        return api.run(spec, device=device)
    except NotImplementedError as e:
        raise SystemExit(f"error: {e}")
