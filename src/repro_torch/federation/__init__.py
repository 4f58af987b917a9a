"""FL substrate: local training, server strategies, round orchestration
(lockstep and async/simulated-clock variants).

The port of `repro.federation`: CNN training on the card (`client`),
FedAvg / FedNC / async / hierarchical aggregation through the port's
engine and kernels (`server`), and the round drivers (`rounds`,
`async_rounds`)."""
from .async_rounds import (AsyncRoundLog, blind_box_schedule,
                           run_async_experiment)
from .client import LocalTrainer
from .rounds import FLExperiment, RoundLog, run_experiment
from .server import (AsyncFedNCStrategy, FedAvgStrategy, FedNCStrategy,
                     HierarchicalFedNCStrategy)

__all__ = [
    "LocalTrainer", "FLExperiment", "RoundLog", "run_experiment",
    "AsyncRoundLog", "blind_box_schedule", "run_async_experiment",
    "AsyncFedNCStrategy", "FedAvgStrategy", "FedNCStrategy",
    "HierarchicalFedNCStrategy",
]
