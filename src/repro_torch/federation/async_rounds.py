"""Async round orchestration: the outer FL loop on a simulated clock.

The port of `repro.federation.async_rounds`.  `rounds.run_experiment`
is lockstep; this driver runs the same local-training loop but
aggregates through an :class:`~repro_torch.federation.server.AsyncFedNCStrategy`,
so each round yields the two temporal quantities Prop. 1 is about:

* ``consumed``  — arrivals the server listened to before rank K
                  (~K, vs the blind-box collector's K·H(K)), and
* ``sim_time``  — the simulated clock at decode, driven by the
                  arrival schedule (straggler tails included).

`blind_box_schedule` adapts a `repro_torch.sim` gap distribution into
the strategy's ``schedule_fn``.  Passing a
:class:`repro_torch.sim.ComputeModel` as ``compute`` delays each packet
by its source client's simulated local-training time, and each round's
log carries both ``sim_time`` (coupled) and ``sim_time_network``.
Each round is an ``async.round`` span with an ``async.decode`` instant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.channel import ArrivalSchedule

from .rounds import FLExperiment, train_cohort


@dataclass
class AsyncRoundLog:
    round: int
    decoded: bool
    n_aggregated: int
    consumed: int         # arrivals until rank K
    sim_time: float       # simulated clock at decode (compute-coupled
                          # when a ComputeModel is configured)
    train_loss: float
    test_acc: float
    wall_s: float
    sim_time_network: float = float("nan")   # network-only decode time


def blind_box_schedule(gap=None, rate_scale: float = 1.0
                       ) -> Callable[[int, np.random.Generator],
                                     ArrivalSchedule]:
    """Arrival schedule factory: i.i.d. gaps from a `repro_torch.sim`
    DistSpec (default unit exponential — the memoryless multicast of
    paper §IV-A), cumulated into arrival times."""
    def make(n: int, rng: np.random.Generator) -> ArrivalSchedule:
        from repro_torch.sim.distributions import DistSpec
        spec = gap if gap is not None else DistSpec()
        return ArrivalSchedule(np.cumsum(spec.sample(rng, n))
                               / max(rate_scale, 1e-12))
    return make


def run_async_experiment(exp: FLExperiment, init_params: Any,
                         rounds: int, *, eval_every: int = 1,
                         compute: Optional[Any] = None,
                         verbose: bool = False) -> list[AsyncRoundLog]:
    """`rounds.run_experiment`, but the strategy's report must carry
    the async fields (consumed / sim_time), i.e. AsyncFedNCStrategy.
    Cohort sampling and local training are the shared
    `rounds.train_cohort`, so async and lockstep runs stay comparable.
    `compute` (a :class:`repro_torch.sim.ComputeModel`) adds each
    client's simulated local-training time into its packets' arrival
    clock."""
    rng = np.random.default_rng(exp.seed)
    global_params = init_params
    logs: list[AsyncRoundLog] = []

    tr = obs.get_tracer()
    for t in range(rounds):
        with obs.timed("async.round", cat="fl", round=t) as sw:
            client_params, weights, loss, walls = train_cohort(
                exp, rng, global_params)
            if compute is not None:
                ct = compute.times(rng, len(client_params),
                                   measured_wall=walls)
                result = exp.strategy.aggregate(client_params, weights,
                                                global_params, rng,
                                                compute_times=ct)
            else:
                result = exp.strategy.aggregate(client_params, weights,
                                                global_params, rng)
            global_params = result.global_params
            rep = result.report
            consumed = getattr(rep, "consumed", -1)
            sim_time = getattr(rep, "sim_time", float("nan"))
            sim_time_network = getattr(rep, "sim_time_network",
                                       float("nan"))
            if tr.enabled:
                tr.instant("async.decode", cat="fl", round=t,
                           consumed=int(consumed),
                           sim_time=float(sim_time))

            acc = float("nan")
            if (t + 1) % eval_every == 0:
                acc = exp.eval_fn(global_params, exp.test_set.images,
                                  exp.test_set.labels)
            sw.fence((global_params, acc))
        logs.append(AsyncRoundLog(t, bool(result.decoded),
                                  result.n_aggregated, int(consumed),
                                  float(sim_time), loss, acc,
                                  sw.dur_s,
                                  float(sim_time_network)))
        if verbose:
            print(f"round {t:3d} decoded={result.decoded} "
                  f"consumed={consumed} sim_t={sim_time:.3f} "
                  f"net_t={sim_time_network:.3f} acc={acc:.4f}")
    return logs
