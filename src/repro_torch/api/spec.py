"""Declarative experiment specification — the input to :func:`repro_torch.api.run`.

The port of the reference's ``repro.api.spec``, with the same fields,
defaults and validation, so a spec file written for the reference loads
here unchanged. An :class:`ExperimentSpec` describes a *study*: the
population (by dataset name), the disease (by preset name), the
intervention sweep axes, transmissibility scales, Monte Carlo replicates,
run length, interaction backend, the device-mesh shape, the checkpoint
policy, and the observables to reduce. Everything is plain data —
``to_json``/``from_json`` round-trip exactly, and ``from_toml`` loads the
same fields from a TOML file.

``backend`` keeps the reference's five names; the reference holds all five
bitwise equal, and the port runs ``jnp``, ``scan``, ``compact`` and
``pallas-compact`` on its compacted route and ``pallas`` on its padded route
(:data:`ROUTES`). ``pack_visits`` is accepted; the port always packs (the
reference's histories do not depend on it). Which engine runs the study is
derived from the spec (``mesh.workers`` x ``mesh.scenarios`` x batch size)
by :func:`repro_torch.api.runner.run`; ``engine`` can pin one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

from repro_torch.configs import epidemics as epi_lib
from repro_torch.configs import presets
from repro_torch.configs.sweep import ScenarioBatch
from repro_torch.core import transmission as tx_lib

ENGINES = ("auto", "single", "dist", "ensemble", "sharded", "hybrid")
BACKENDS = ("jnp", "scan", "compact", "pallas", "pallas-compact")
#: The port's interaction route for each of the reference's backend names.
ROUTES = {"jnp": "pallas-compact", "scan": "pallas-compact",
          "compact": "pallas-compact", "pallas-compact": "pallas-compact",
          "pallas": "pallas"}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Device-mesh shape. ``workers`` shards people/locations of each
    scenario; ``scenarios`` shards the batch axis. (1, 1) means a single
    device; both >1 selects the hybrid 2-D engine. A mesh runs one process
    per rank (``repro_torch.launch.mesh.spawn`` or ``torchrun``), every rank
    calling ``api.run`` with the same spec."""

    workers: int = 1
    scenarios: int = 1


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Day-chunked checkpoint policy, engine-independent: the run loop
    scans ``every``-day chunks and snapshots state + history-so-far at
    each chunk boundary through CheckpointManager (observable carries are
    replayed from the history on resume — they are pure reductions).
    ``directory=None`` disables checkpointing (one unchunked run)."""

    directory: Optional[str] = None
    every: int = 50
    keep: int = 3
    resume: bool = True  # resume from the latest checkpoint when present


@dataclasses.dataclass(frozen=True)
class ResilienceSpec:
    """Recovery policy for the day-chunked run loop
    (:mod:`repro_torch.runtime.resilience`). With ``enabled`` the chunk loop
    runs under failure→restore→replay recovery (needs
    ``checkpoint.directory``): capped, backed-off restarts from the newest
    *valid* snapshot (corrupt ones are quarantined), a post-chunk invariant
    pack treated as a fault on violation, per-chunk straggler detection
    (on a mesh, one vote of all ranks decides a repartition), and elastic
    shrink onto fewer workers on device loss (a mesh's lost ranks retire,
    the survivors rebuild and resume; on one worker the loss re-raises).
    Pure policy — it never changes the science, so it is not part of the
    checkpoint resume key and recovered runs are bitwise-equal to
    uninterrupted ones."""

    enabled: bool = False
    max_restarts: int = 3
    backoff_s: float = 0.0
    guards: bool = True  # post-chunk invariant pack (runtime/guards.py)
    elastic: bool = True  # device loss -> rebuild on fewer workers
    straggler_window: int = 5
    straggler_factor: float = 4.0
    repartition_on_straggler: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One fully-specified epidemic study.

    Sweep axes (``interventions`` × ``tau_scales`` × ``replicates``) expand
    to a :class:`ScenarioBatch` via :meth:`build_batch`; scalar axes mean a
    single run. All fields are JSON/TOML-serializable scalars, strings, or
    lists — diseases and interventions are referenced by preset name
    (:mod:`repro_torch.configs.presets`).
    """

    name: str = "experiment"
    dataset: str = "twin-2k"
    disease: str = "covid"
    days: int = 60
    # --- sweep axes ----------------------------------------------------
    interventions: Tuple[str, ...] = ("none",)
    tau: Optional[float] = None  # base tau; None = the dataset's default
    tau_scales: Tuple[float, ...] = (1.0,)
    replicates: int = 1
    seed: int = 0  # replicate r runs with Monte Carlo seed `seed + r`
    # --- epidemic knobs ------------------------------------------------
    seed_per_day: int = 10
    seed_days: int = 7
    static_network: bool = False
    # --- execution -----------------------------------------------------
    backend: str = "jnp"
    block_size: int = 128
    pack_visits: bool = True
    engine: str = "auto"
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    checkpoint: CheckpointSpec = dataclasses.field(default_factory=CheckpointSpec)
    resilience: ResilienceSpec = dataclasses.field(default_factory=ResilienceSpec)
    # --- analysis ------------------------------------------------------
    observables: Tuple[str, ...] = (
        "daily_new_infections", "attack_rate", "peak_day", "ensemble_mean_ci",
        "teps",
    )

    # ------------------------------------------------------------------
    def __post_init__(self):
        # Normalize list-y fields to tuples so frozen specs hash/compare.
        object.__setattr__(self, "interventions", tuple(self.interventions))
        object.__setattr__(self, "tau_scales",
                           tuple(float(t) for t in self.tau_scales))
        object.__setattr__(self, "observables", tuple(self.observables))

    def validate(self) -> "ExperimentSpec":
        from repro_torch.api import observables as obs_lib  # cycle-free at call time

        if self.dataset not in epi_lib.EPIDEMICS:
            raise ValueError(f"unknown dataset '{self.dataset}'; "
                             f"have {sorted(epi_lib.EPIDEMICS)}")
        if self.disease not in presets.DISEASES:
            raise ValueError(f"unknown disease '{self.disease}'; "
                             f"have {sorted(presets.DISEASES)}")
        for name in self.interventions:
            if name not in presets.INTERVENTION_PRESETS:
                raise ValueError(
                    f"unknown intervention preset '{name}'; "
                    f"have {sorted(presets.INTERVENTION_PRESETS)}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got '{self.backend}'")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got '{self.engine}'")
        for name in self.observables:
            if name not in obs_lib.OBSERVABLES:
                raise ValueError(
                    f"unknown observable '{name}'; "
                    f"have {sorted(obs_lib.OBSERVABLES)}")
        if self.days < 1 or self.replicates < 1:
            raise ValueError("days and replicates must be >= 1")
        if self.mesh.workers < 1 or self.mesh.scenarios < 1:
            raise ValueError("mesh axes must be >= 1")
        if self.num_scenarios == 1 and self.mesh.scenarios > 1:
            raise ValueError(
                f"mesh.scenarios={self.mesh.scenarios} but the sweep axes "
                "produce a single scenario — add replicates/interventions/"
                "tau_scales, or drop the scenarios axis")
        if self.checkpoint.every < 1:
            raise ValueError("checkpoint.every must be >= 1")
        rs = self.resilience
        if rs.enabled and not self.checkpoint.directory:
            raise ValueError(
                "resilience.enabled needs checkpoint.directory — recovery "
                "restores from snapshots")
        if rs.max_restarts < 0 or rs.straggler_window < 2 or \
                rs.straggler_factor <= 1.0:
            raise ValueError(
                "resilience: max_restarts >= 0, straggler_window >= 2, "
                "straggler_factor > 1 required")
        return self

    # ------------------------------------------------------------------
    @property
    def num_scenarios(self) -> int:
        return len(self.interventions) * len(self.tau_scales) * self.replicates

    def compile_fingerprint(self) -> dict:
        """The spec fields that shape a runner, as opposed to the ones that
        merely feed it tensor values: the reference's dict, field for field
        (``backend`` is the spec's name, not the port's route). Two specs
        with equal fingerprints (plus equal quantized batch width / seeding
        cap — see :mod:`repro_torch.serve.buckets`) share one warm runner,
        on the card one captured CUDA graph: tau/seeds/replicate counts ride
        in as tensors, days is served by chunked dispatch, and observables
        are replayed after the run. The interventions *tuple* (names, in
        order) is part of it because it fixes the batch's slot structure."""
        return {
            "dataset": self.dataset,
            "disease": self.disease,
            "interventions": tuple(self.interventions),
            "static_network": bool(self.static_network),
            "backend": self.backend,
            "block_size": int(self.block_size),
            "pack_visits": bool(self.pack_visits),
        }

    def base_tau(self) -> float:
        if self.tau is not None:
            return float(self.tau)
        epi = epi_lib.EPIDEMICS[self.dataset]
        tau = getattr(epi, "tau", None)
        return float(tau) if tau is not None else tx_lib.TransmissionModel().tau

    def build_batch(self) -> ScenarioBatch:
        """Expand the sweep axes to the factorial ScenarioBatch
        (interventions × tau × seeds, seeds innermost)."""
        self.validate()
        base = self.base_tau()
        return ScenarioBatch.from_product(
            interventions={
                n: presets.INTERVENTION_PRESETS[n] for n in self.interventions
            },
            tau=[base * s for s in self.tau_scales],
            disease=presets.DISEASES[self.disease](),
            seeds=[self.seed + r for r in range(self.replicates)],
            seed_per_day=self.seed_per_day,
            seed_days=self.seed_days,
            static_network=self.static_network,
        )

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["interventions"] = list(self.interventions)
        d["tau_scales"] = list(self.tau_scales)
        d["observables"] = list(self.observables)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        _check_fields(cls, d, "ExperimentSpec")
        if "mesh" in d and isinstance(d["mesh"], dict):
            _check_fields(MeshSpec, d["mesh"], "mesh")
            d["mesh"] = MeshSpec(**d["mesh"])
        if "checkpoint" in d and isinstance(d["checkpoint"], dict):
            _check_fields(CheckpointSpec, d["checkpoint"], "checkpoint")
            d["checkpoint"] = CheckpointSpec(**d["checkpoint"])
        if "resilience" in d and isinstance(d["resilience"], dict):
            _check_fields(ResilienceSpec, d["resilience"], "resilience")
            d["resilience"] = ResilienceSpec(**d["resilience"])
        return cls(**d).validate()

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_toml(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(_load_toml(s))

    @classmethod
    def from_file(cls, path: str) -> "ExperimentSpec":
        with open(path, "rb") as f:
            raw = f.read()
        if path.endswith((".toml", ".tml")):
            return cls.from_toml(raw.decode())
        return cls.from_json(raw.decode())

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    # ------------------------------------------------------------------
    def with_overrides(self, **kwargs) -> "ExperimentSpec":
        """Functional update; ``None`` values are ignored (the CLI passes
        every flag, with None meaning "not given"). Mesh/checkpoint/
        resilience fields go through flat aliases ``workers``/
        ``scenarios``/``ckpt_dir``/``ckpt_every``/``resilient``/
        ``max_restarts``."""
        updates = {k: v for k, v in kwargs.items() if v is not None}
        mesh = self.mesh
        if "workers" in updates or "scenarios" in updates:
            mesh = dataclasses.replace(
                mesh,
                workers=int(updates.pop("workers", mesh.workers)),
                scenarios=int(updates.pop("scenarios", mesh.scenarios)),
            )
        ckpt = self.checkpoint
        if "ckpt_dir" in updates or "ckpt_every" in updates:
            ckpt = dataclasses.replace(
                ckpt,
                directory=updates.pop("ckpt_dir", ckpt.directory),
                every=int(updates.pop("ckpt_every", ckpt.every)),
            )
        res = self.resilience
        if "resilient" in updates or "max_restarts" in updates:
            res = dataclasses.replace(
                res,
                enabled=bool(updates.pop("resilient", res.enabled)),
                max_restarts=int(updates.pop("max_restarts",
                                             res.max_restarts)),
            )
        return dataclasses.replace(
            self, mesh=mesh, checkpoint=ckpt, resilience=res, **updates
        ).validate()


def _check_fields(cls, d: dict, label: str) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown {label} field(s) {sorted(unknown)}; "
                         f"have {sorted(known)}")


def _load_toml(s: str) -> dict:
    import tomllib

    return tomllib.loads(s)
