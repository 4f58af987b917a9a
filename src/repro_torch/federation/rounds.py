"""Round orchestration: the outer FL loop of Algorithm 1.

The port of `repro.federation.rounds`.  Each round: sample K
participants -> local training -> strategy aggregation (FedAvg or
FedNC, through the configured channel) -> evaluate the global model.
The numpy generator is consumed exactly as the reference consumes it,
so the same seed samples the same cohorts and batch orders.  Each
round is an ``fl.round`` span and each client's training an
``fl.local_train`` span, both fenced on their device results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.data.synthetic import SyntheticImageDataset, batches

from .client import LocalTrainer


@dataclass
class RoundLog:
    round: int
    decoded: bool
    n_aggregated: int
    train_loss: float
    test_acc: float
    wall_s: float


@dataclass
class FLExperiment:
    """Everything one FL run needs, bundled."""
    trainer: LocalTrainer
    strategy: Any                       # FedAvgStrategy | FedNCStrategy
    partitions: Sequence[np.ndarray]    # per-client index sets
    dataset: SyntheticImageDataset
    test_set: SyntheticImageDataset
    eval_fn: Callable[[Any, Any, Any], float]   # (params, x, y) -> acc
    clients_per_round: int = 10
    batch_size: int = 32
    seed: int = 0


def train_cohort(exp: FLExperiment, rng: np.random.Generator,
                 global_params: Any
                 ) -> tuple[list, np.ndarray, float, np.ndarray]:
    """Sample this round's participants and run local training.

    Shared by the lockstep and async round drivers (identical RNG
    consumption).  Returns (client_params, normalized size weights,
    mean local loss, per-client training wall seconds); the walls feed
    the *measured* mode of `repro_torch.sim.ComputeModel`."""
    N = len(exp.partitions)
    part = rng.choice(N, size=exp.clients_per_round, replace=False)
    client_params, losses, sizes, walls = [], [], [], []
    for k in part:
        idx = exp.partitions[k]
        ds_k = exp.dataset.subset(idx)
        it = batches(ds_k, min(exp.batch_size, max(len(ds_k), 1)),
                     seed=int(rng.integers(0, 2**31 - 1)),
                     epochs=exp.trainer.local_epochs)
        with obs.timed("fl.local_train", cat="fl",
                       client=int(k)) as sw:
            p_k, loss_k = exp.trainer.train(global_params, it)
            sw.fence(p_k)        # measured walls feed ComputeModel
        walls.append(sw.dur_s)
        client_params.append(p_k)
        losses.append(loss_k)
        sizes.append(len(ds_k))
    weights = np.asarray(sizes, np.float32)
    return (client_params, weights / weights.sum(),
            float(np.mean(losses)), np.asarray(walls, np.float64))


def run_experiment(exp: FLExperiment, init_params: Any, rounds: int,
                   *, eval_every: int = 1, verbose: bool = False
                   ) -> list[RoundLog]:
    rng = np.random.default_rng(exp.seed)
    global_params = init_params
    logs: list[RoundLog] = []

    for t in range(rounds):
        with obs.timed("fl.round", cat="fl", round=t) as sw:
            client_params, weights, loss, _ = train_cohort(
                exp, rng, global_params)
            result = exp.strategy.aggregate(client_params, weights,
                                            global_params, rng)
            global_params = result.global_params

            acc = float("nan")
            if (t + 1) % eval_every == 0:
                acc = exp.eval_fn(global_params, exp.test_set.images,
                                  exp.test_set.labels)
            sw.fence((global_params, acc))
        logs.append(RoundLog(t, bool(result.decoded), result.n_aggregated,
                             loss, acc, sw.dur_s))
        if verbose:
            print(f"round {t:3d} decoded={result.decoded} "
                  f"loss={loss:.4f} acc={acc:.4f}")
    return logs


def final_accuracy(logs: list[RoundLog], k_last: int = 5) -> float:
    accs = [l.test_acc for l in logs if not np.isnan(l.test_acc)]
    if not accs:
        return float("nan")
    return float(np.mean(accs[-k_last:]))
