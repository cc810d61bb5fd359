"""Epidemic dataset configs (paper Table II/III).

Full-scale entity counts are kept for the dry-run (shapes only); ``*-mini``
variants are generated and *run* on CPU for the benchmark suite. The scale
notes record the reduction factor so Table-II comparisons are explicit.
"""

from __future__ import annotations

from repro_torch.configs.base import EpidemicConfig

EPIDEMICS = {
    # --- digital twins (paper Table II; §IV-A1) -------------------------
    "md": EpidemicConfig(
        name="md", generator="twin", num_people=5_513_000,
        scale_note="paper MD: 5.513M people / 2.896M locs / 25.97M visits/wk",
    ),
    "va": EpidemicConfig(
        name="va", generator="twin", num_people=7_685_000, seed=1,
        scale_note="paper VA: 7.685M people / 4.092M locs / 36.20M visits/wk",
    ),
    "md-mini": EpidemicConfig(
        name="md-mini", generator="twin", num_people=55_130,
        scale_note="MD at 1/100 scale (CPU-runnable)",
    ),
    "va-mini": EpidemicConfig(
        name="va-mini", generator="twin", num_people=76_850, seed=1,
        scale_note="VA at 1/100 scale (CPU-runnable)",
    ),
    "twin-2k": EpidemicConfig(
        name="twin-2k", generator="twin", num_people=2_000,
        scale_note="test-size twin",
    ),
    # --- Watts-Strogatz synthetics (paper Table II; §IV-A2) -------------
    "ws-us": EpidemicConfig(
        name="ws-us", generator="ws", num_people=280_400_000,
        num_locations=71_710_000,
        scale_note="paper WS-US: 280.4M people / 71.71M locs",
    ),
    "ws-100m": EpidemicConfig(
        name="ws-100m", generator="ws", num_people=100_000_000,
        num_locations=25_000_000,
    ),
    "ws-20m": EpidemicConfig(
        name="ws-20m", generator="ws", num_people=20_000_000,
        num_locations=5_000_000,
    ),
    "ws-200k": EpidemicConfig(
        name="ws-200k", generator="ws", num_people=200_000,
        num_locations=50_000, scale_note="WS-20M at 1/100 scale",
    ),
    "ws-50k": EpidemicConfig(
        name="ws-50k", generator="ws", num_people=50_000,
        num_locations=12_500, scale_note="bench-size WS",
    ),
    # --- grid weak-scaling loads (paper Table III) -----------------------
    # per-worker loads: 144k/36k, 288k/72k, 576k/144k (people/locs per core)
    "grid-1x": EpidemicConfig(
        name="grid-1x", generator="grid", num_people=144_000, grid=(190, 190),
        scale_note="Table III 1x per-core load (36.1k locs)",
    ),
    "grid-2x": EpidemicConfig(
        name="grid-2x", generator="grid", num_people=288_000, grid=(269, 268),
        scale_note="Table III 2x per-core load (72.1k locs)",
    ),
    "grid-4x": EpidemicConfig(
        name="grid-4x", generator="grid", num_people=576_000, grid=(380, 379),
        scale_note="Table III 4x per-core load (144k locs)",
    ),
    "grid-tiny": EpidemicConfig(
        name="grid-tiny", generator="grid", num_people=14_400, grid=(60, 60),
        scale_note="1x load at 1/10 (CPU tests)",
    ),
}
