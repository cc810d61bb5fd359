"""Epidemic dataset config: which generator builds a population, at what size."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EpidemicConfig:
    name: str
    generator: str  # twin | ws | grid
    num_people: int
    num_locations: int = 0  # ws only
    grid: tuple = ()  # grid only
    scale_note: str = ""
    seed: int = 0
    tau: float = 2.0e-5
    days: int = 200

    def build(self, pad_multiple: int = 128):
        from repro_torch.data import (
            digital_twin_population,
            grid_population,
            watts_strogatz_population,
        )

        if self.generator == "twin":
            return digital_twin_population(
                self.num_people, seed=self.seed, name=self.name,
                pad_multiple=pad_multiple,
            )
        if self.generator == "ws":
            return watts_strogatz_population(
                self.num_people, self.num_locations, seed=self.seed,
                name=self.name, pad_multiple=pad_multiple,
            )
        if self.generator == "grid":
            w, h = self.grid
            return grid_population(
                w, h, density=self.num_people / (w * h), seed=self.seed,
                name=self.name, pad_multiple=pad_multiple,
            )
        raise ValueError(self.generator)
