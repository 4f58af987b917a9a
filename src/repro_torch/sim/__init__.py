"""repro_torch.sim — vectorized event-driven FL network simulator.

The port of `repro.sim`.  FedNC's efficiency and robustness claims are
*temporal* — Prop. 1 is about how many arrivals the server must wait
for — so this package simulates the missing axis: per-client
compute/bandwidth heterogeneity, straggler tails, dropout and churn,
partial participation, and the arrival-order stream the server
actually hears.  It is numpy apart from the rank-only
`repro_torch.engine.stream.StreamDecoder`, which runs on the host.

distributions.py — named delay distributions (constant, exponential,
                   lognormal, pareto) normalized to a common mean so
                   straggler tails are comparable; a registry for
                   custom ones.
compute.py       — per-client local-training compute times for the
                   async arrival clock (`ComputeModel`).
population.py    — ClientPopulation: static per-client speed factors
                   over millions of clients, churn-aware cohort
                   sampling, dropout injection.
events.py        — the vectorized event engine: one round's arrival
                   stream (times, sources) as a handful of numpy
                   kernels, never a Python-per-event loop.
simulator.py     — NetworkSimulator: runs FedNC (stop at rank K via
                   `engine.stream.StreamDecoder`) and FedAvg (wait for
                   every cohort member) against the *same* arrival
                   stream, producing per-round draw counts and
                   simulated-clock decode times.
"""
from .compute import ComputeModel
from .distributions import (STRAGGLER_PROFILES, DistSpec,
                            available_distributions, register_distribution,
                            sample_delays)
from .events import RoundEvents, arrival_stream
from .population import ClientPopulation, PopulationConfig
from .simulator import NetworkSimulator, RoundStats, SimConfig, SimTrace

__all__ = [
    "ComputeModel", "DistSpec", "STRAGGLER_PROFILES",
    "available_distributions", "register_distribution", "sample_delays",
    "RoundEvents", "arrival_stream", "ClientPopulation", "PopulationConfig",
    "NetworkSimulator", "RoundStats", "SimConfig", "SimTrace",
]
