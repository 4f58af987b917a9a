"""Channel models for FedNC experiments (paper §III-A, §IV-A).

The port of `repro.core.channel`'s row-gather channels:

* `ErasureChannel`  — each uploaded packet is independently lost with
                      probability p (robustness claim, §III-A.3).
* `BlindBoxChannel` — the server receives `budget` packets by random
                      sampling with replacement (Prop. 1 setting).

Both decide their whole action on the n transmitted tuples up front
(``plan_transform`` -> :class:`RowGather`) with a seeded numpy
generator, drawing exactly what the reference draws — so the same seed
gives the same plan in both packages, and `repro_torch.engine` folds
the plan into its chunk-streamed encode→decode dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ChannelReport:
    """What happened during one round's transmission."""
    sent: int
    delivered: int
    decodable: bool
    distinct_sources: int = -1      # FedAvg bookkeeping under blind box


@dataclass(frozen=True)
class RowGather:
    """Channel plan: rows `idx` (host int array) survive, in order."""
    idx: np.ndarray


class ErasureChannel:
    """IID packet erasures with probability `p_erase`."""

    def __init__(self, p_erase: float, seed: int = 0):
        self.p_erase = float(p_erase)
        self.rng = np.random.default_rng(seed)

    def plan_transform(self, n: int, s: int) -> RowGather:
        """Decide the erasure pattern for n tuples (one RNG draw)."""
        keep = self.rng.random(n) >= self.p_erase
        return RowGather(np.nonzero(keep)[0])

    def transmit_plain(self, packets: torch.Tensor
                       ) -> tuple[torch.Tensor, np.ndarray, ChannelReport]:
        """FedAvg baseline: returns (delivered, source_ids, report)."""
        K = packets.shape[0]
        keep = self.rng.random(K) >= self.p_erase
        idx = np.nonzero(keep)[0]
        rep = ChannelReport(K, len(idx), len(idx) == K,
                            distinct_sources=len(idx))
        return packets[torch.as_tensor(idx, device=packets.device)], idx, rep


class BlindBoxChannel:
    """Random sampling with replacement: the Prop.-1 setting."""

    def __init__(self, budget: int, seed: int = 0):
        self.budget = int(budget)
        self.rng = np.random.default_rng(seed)

    def plan_transform(self, n: int, s: int) -> RowGather:
        """The server's `budget` receptions as uniform draws *with
        replacement* from the n tuples; repeated rows are dependent, so
        the engine's selector skips them."""
        return RowGather(self.rng.integers(0, n, size=self.budget))
