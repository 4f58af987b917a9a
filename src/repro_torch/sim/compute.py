"""Per-client local-training compute time for the arrival clock.

The port of `repro.sim.compute` (numpy, on the port's
`sim.distributions.DistSpec`).  A :class:`ComputeModel` produces one
simulated compute time per cohort member, and the async strategy adds
that client's time to every packet it sources, so a fast client's
packets arrive while a slow client is still training.

Two modes, matching how real FL systems estimate device speed:

* **modeled** (default) — per-client work is an i.i.d. draw from a
  `repro_torch.sim` distribution (a FLOP-count proxy; unit-mean
  lognormal by default, the classic compute-straggler tail) divided by
  ``flops_per_second``.
* **measured** — ``measured_scale > 0`` rescales the *actual* wall
  seconds each client's local training took (collected by
  ``federation.rounds.train_cohort``) into simulated seconds, so the
  schedule reflects the real heterogeneity of the training run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .distributions import DistSpec


@dataclass(frozen=True)
class ComputeModel:
    """How long each cohort member computes before it can transmit."""

    # per-client work draw (FLOP proxy; unit mean keeps profiles
    # comparable, same convention as the straggler distributions)
    work: DistSpec = field(default_factory=lambda: DistSpec(
        "lognormal", 1.0, 0.5))
    flops_per_second: float = 1.0
    # > 0: ignore `work` and rescale measured training wall seconds
    measured_scale: float = 0.0

    def times(self, rng: np.random.Generator, k: int,
              measured_wall: Optional[np.ndarray] = None) -> np.ndarray:
        """(k,) strictly-positive simulated compute seconds."""
        if self.measured_scale > 0.0:
            if measured_wall is None:
                raise ValueError(
                    "measured_scale > 0 needs measured_wall times")
            t = np.asarray(measured_wall, np.float64) * self.measured_scale
        else:
            if self.flops_per_second <= 0.0:
                raise ValueError("flops_per_second must be positive")
            t = self.work.sample(rng, k) / self.flops_per_second
        # a zero compute time would make "strictly later than the
        # network-only schedule" vacuous; clamp to a tick
        return np.maximum(t, np.finfo(np.float64).tiny)
