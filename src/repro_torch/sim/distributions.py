"""Named delay distributions for the network simulator.

The port of `repro.sim.distributions` (numpy, unchanged): the same
samplers draw the same delays from the same `np.random.Generator`.

Every distribution is normalized so its mean equals ``scale`` (when
the mean exists) — swapping a light tail for a heavy one changes the
*shape* of waiting, not the average load, which is what makes
time-to-decode comparisons across straggler profiles meaningful:

* ``constant``     — degenerate (scale exactly).
* ``exponential``  — memoryless baseline; the blind-box multicast of
                     paper §IV-A is exactly this regime.
* ``lognormal``    — the classic compute-straggler tail
                     (exp(σZ − σ²/2)·scale); ``shape`` is σ.
* ``pareto``       — heavy tail (Lomax, normalized); ``shape`` is α.
                     α ≤ 1 has infinite mean — legal, the simulator
                     measures medians too, but the bundled profiles
                     keep α > 1.

Custom distributions register by name (`register_distribution`), same
pattern as the engine's kernel registry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

# name -> sampler(rng, size, scale, shape) returning float64 ndarray
_SAMPLERS: Dict[str, Callable] = {}


def register_distribution(name: str, sampler: Callable) -> None:
    """Register ``sampler(rng, size, scale, shape) -> np.ndarray``."""
    _SAMPLERS[name] = sampler


def available_distributions() -> list[str]:
    return sorted(_SAMPLERS)


register_distribution(
    "constant", lambda rng, size, scale, shape: np.full(size, scale))
register_distribution(
    "exponential", lambda rng, size, scale, shape:
    rng.exponential(scale, size=size))
register_distribution(
    "lognormal", lambda rng, size, scale, shape:
    scale * rng.lognormal(mean=-0.5 * shape * shape, sigma=shape,
                          size=size))
register_distribution(
    "pareto", lambda rng, size, scale, shape:
    scale * max(shape - 1.0, 0.0) * rng.pareto(shape, size=size)
    if shape > 1.0 else scale * rng.pareto(shape, size=size))


@dataclass(frozen=True)
class DistSpec:
    """A named delay distribution with its scale and shape parameter.

    ``shape`` is σ for lognormal, α for pareto, ignored otherwise.
    Frozen/hashable so it can sit inside SimConfig.
    """

    name: str = "exponential"
    scale: float = 1.0
    shape: float = 1.0

    def sample(self, rng: np.random.Generator, size) -> np.ndarray:
        return sample_delays(self, rng, size)


def sample_delays(spec: DistSpec, rng: np.random.Generator,
                  size) -> np.ndarray:
    """Draw `size` delays from `spec` (vectorized, host numpy)."""
    try:
        sampler = _SAMPLERS[spec.name]
    except KeyError:
        raise KeyError(
            f"unknown distribution {spec.name!r}; registered: "
            f"{available_distributions()}") from None
    return np.asarray(sampler(rng, size, float(spec.scale),
                              float(spec.shape)), dtype=np.float64)


# The straggler profiles the benchmarks sweep: same unit mean,
# increasingly heavy upper tails.
STRAGGLER_PROFILES: Dict[str, DistSpec] = {
    "constant": DistSpec("constant", 1.0, 0.0),
    "exponential": DistSpec("exponential", 1.0, 0.0),
    "lognormal": DistSpec("lognormal", 1.0, 1.0),
    "pareto": DistSpec("pareto", 1.0, 1.5),
}
