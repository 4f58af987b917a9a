"""Client populations: millions of heterogeneous clients, cheap cohorts.

The port of `repro.sim.population` (numpy, unchanged): the same seed
gives the same slowness vector, cohorts and dropout masks.

A population is a static vector of per-client *speed factors* (drawn
once, seed-deterministic) plus the two failure knobs of real FL
fleets:

* **churn** (`p_churn`)   — a client is offline at selection time; the
                            server notices immediately and invites a
                            replacement, so cohorts stay full but the
                            sampler does extra work.
* **dropout** (`p_dropout`) — a *selected* participant silently fails
                            mid-round: it trains (or not) but its
                            packets never arrive, and the server only
                            finds out by waiting.  This is the failure
                            mode that separates FedNC (decodes the
                            survivors at rank K_live) from FedAvg
                            (blocks on the missing coupon forever).

Everything is numpy-vectorized: init is O(N) once, each cohort draw is
O(k) expected, so 10^6 clients cost ~8 MB and nothing per round.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .distributions import DistSpec


@dataclass(frozen=True)
class PopulationConfig:
    n_clients: int = 1000
    # static per-client slowness multiplier (bandwidth/compute mix);
    # normalized to unit mean at init so the gap scale stays the unit
    speed: DistSpec = field(default_factory=lambda: DistSpec(
        "lognormal", 1.0, 0.5))
    p_churn: float = 0.0
    p_dropout: float = 0.0


class ClientPopulation:
    """Static heterogeneity + cohort sampling for one population."""

    def __init__(self, config: PopulationConfig, seed: int = 0):
        if config.n_clients < 1:
            raise ValueError("population needs at least one client")
        self.config = config
        rng = np.random.default_rng(seed)
        slowness = config.speed.sample(rng, config.n_clients)
        mean = float(slowness.mean())
        if mean > 0:
            slowness = slowness / mean     # unit-mean normalization
        self.slowness = slowness.astype(np.float64)

    @property
    def n_clients(self) -> int:
        return self.config.n_clients

    def sample_cohort(self, rng: np.random.Generator, k: int
                      ) -> tuple[np.ndarray, int]:
        """Sample k distinct *online* clients (partial participation).

        Returns ``(indices, n_churned)`` — the cohort plus how many
        invitations bounced off churned-away clients.  Expected O(k)
        regardless of population size: candidates are drawn with
        replacement and deduplicated, so no O(N) permutation ever runs.
        """
        N = self.n_clients
        if k > N:
            raise ValueError(f"cohort {k} exceeds population {N}")
        p_churn = self.config.p_churn
        if p_churn >= 1.0:
            raise ValueError("p_churn >= 1: nobody is ever online")
        chosen: list[int] = []
        seen: set[int] = set()
        n_churned = 0
        while len(chosen) < k:
            if len(seen) >= N:
                raise RuntimeError(
                    f"churn left fewer than {k} of {N} clients online "
                    "this round")
            want = max(2 * (k - len(chosen)) + 8, 16)
            cand = rng.integers(0, N, size=want)
            online = rng.random(want) >= p_churn
            for c, ok in zip(cand.tolist(), online.tolist(),
                             strict=True):
                if c in seen:
                    continue
                seen.add(c)
                if not ok:
                    n_churned += 1
                    continue
                chosen.append(c)
                if len(chosen) == k:
                    break
        return np.asarray(chosen, dtype=np.int64), n_churned

    def dropout_mask(self, rng: np.random.Generator, k: int) -> np.ndarray:
        """(k,) bool — True where the participant actually transmits."""
        return rng.random(k) >= self.config.p_dropout
