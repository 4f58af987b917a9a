"""Channel models for FedNC experiments (paper §III-A, §IV-A).

The port of `repro.core.channel`'s coding channels:

* `ErasureChannel`  — each uploaded packet is independently lost with
                      probability p (robustness claim, §III-A.3).
* `BlindBoxChannel` — the server receives `budget` packets by random
                      sampling with replacement (Prop. 1 setting).
* `MultiHopChannel` — η network-interior links each re-code the stream
                      with fresh random coefficients (Prop. 2's η).

An async server reads arrivals in the order of an `ArrivalSchedule`
and reports the simulated clock in an `AsyncChannelReport`.

Each decides its whole action on the n transmitted tuples up front
(``plan_transform`` -> :class:`RowGather` or :class:`RowMix`) with a
seeded numpy generator, drawing exactly what the reference draws, and
``transmit_encoded`` is the stage-wise form of the same plan.  The
erasure and blind-box plans are therefore identical in both packages;
a multi-hop plan's hop matrices come from torch generators seeded with
the reference's numpy draw, so its R differs from the reference's (the
tests hand the reference's R to both).  `repro_torch.engine` folds a
plan into its chunk-streamed encode→decode dispatch.  A byzantine
relay's plan, :class:`RowTamper`, comes from
`repro_torch.adversary.ByzantineChannel`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .gf import get_field, rank
from .rlnc import EncodedBatch


@dataclass
class ChannelReport:
    """What happened during one round's transmission."""
    sent: int
    delivered: int
    decodable: bool
    distinct_sources: int = -1      # FedAvg bookkeeping under blind box


@dataclass
class AsyncChannelReport(ChannelReport):
    """ChannelReport plus the simulated clock: when (and after how
    many arrivals) an async server had what it needed."""
    consumed: int = -1              # arrivals until rank K (Prop. 1)
    sim_time: float = float("nan")  # simulated clock at decode
    # decode time of the network-only schedule (no compute coupling);
    # equals sim_time when no ComputeModel was in play
    sim_time_network: float = float("nan")


@dataclass(frozen=True)
class ArrivalSchedule:
    """Per-packet arrival times (host numpy) for n transmitted tuples.

    `order` is the permutation that sorts transmission order into
    arrival order, and `time_of(g)` is the simulated clock after the
    g-th arrival.  Times may be in any order: relays and per-client
    latency reorder packets.
    """

    times: np.ndarray

    @property
    def n(self) -> int:
        return int(np.asarray(self.times).shape[0])

    @functools.cached_property
    def order(self) -> np.ndarray:
        """Transmission-order indices sorted by arrival time (stable)."""
        return np.argsort(np.asarray(self.times), kind="stable")

    def time_of(self, g: int) -> float:
        """Simulated clock once g arrivals have been heard (1-based)."""
        if not 1 <= g <= self.n:
            raise ValueError(f"arrival count {g} outside 1..{self.n}")
        return float(np.asarray(self.times)[self.order[g - 1]])

    def offset_by(self, offsets) -> "ArrivalSchedule":
        """A new schedule with per-packet `offsets` (transmission order)
        added to the times: a packet cannot leave before its source
        client finished computing."""
        offsets = np.asarray(offsets, np.float64)
        times = np.asarray(self.times, np.float64)
        if offsets.shape != times.shape:
            raise ValueError(
                f"offsets shape {offsets.shape} != times {times.shape}")
        return ArrivalSchedule(times + offsets)


@dataclass(frozen=True)
class RowGather:
    """Channel plan: rows `idx` (host int array) survive, in order."""
    idx: np.ndarray


@dataclass(frozen=True)
class RowMix:
    """Channel plan: received tuples are R·(A, C) — a linear mix of the
    sent ones (network-interior recoding, Prop. 2).  R (host uint8)."""
    R: torch.Tensor


@dataclass(frozen=True)
class RowTamper:
    """Channel plan: a byzantine interior node delivers all n tuples,
    but XORs rows ``idx`` with adversarial noise — uniform GF(2^s)
    symbols expanded from 4-byte counters (`repro_torch.core.seeds`),
    so the plan stays tiny: the engine regenerates the error rows at
    the widths it knows (K for coding rows, L for payloads).

    ``row_seeds``/``payload_seeds`` are (m,) uint32 numpy arrays or
    ``None``: seeding only the payload models flipped symbols, only the
    row a forged coding vector, and both an arbitrarily hostile relay."""
    idx: np.ndarray
    row_seeds: np.ndarray | None = None
    payload_seeds: np.ndarray | None = None

    @property
    def m(self) -> int:
        return int(np.asarray(self.idx).shape[0])


def _decodable(batch: EncodedBatch, s: int) -> bool:
    return batch.n >= batch.K and rank(get_field(s), batch.A) == batch.K


class ErasureChannel:
    """IID packet erasures with probability `p_erase`."""

    def __init__(self, p_erase: float, seed: int = 0):
        self.p_erase = float(p_erase)
        self.rng = np.random.default_rng(seed)

    def plan_transform(self, n: int, s: int) -> RowGather:
        """Decide the erasure pattern for n tuples (one RNG draw)."""
        keep = self.rng.random(n) >= self.p_erase
        return RowGather(np.nonzero(keep)[0])

    def transmit_encoded(self, batch: EncodedBatch, s: int
                         ) -> tuple[EncodedBatch, ChannelReport]:
        """Stage-wise erasures (the oracle for the fused plan)."""
        idx = self.plan_transform(batch.n, s).idx
        out = batch[torch.as_tensor(idx, dtype=torch.int64)]
        return out, ChannelReport(batch.n, len(idx), _decodable(out, s))

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

    def transmit_encoded(self, batch: EncodedBatch, s: int
                         ) -> tuple[EncodedBatch, ChannelReport]:
        """Stage-wise blind-box delivery of already-encoded tuples."""
        idx = self.plan_transform(batch.n, s).idx
        out = batch[torch.as_tensor(idx, dtype=torch.int64)]
        return out, ChannelReport(batch.n, self.budget, _decodable(out, s),
                                  distinct_sources=len(set(idx.tolist())))

    def receive_plain(self, packets: torch.Tensor
                      ) -> tuple[torch.Tensor, np.ndarray, ChannelReport]:
        """FedAvg: the server gets `budget` draws with replacement;
        duplicate sources deliver duplicate packets."""
        K = packets.shape[0]
        draws = self.rng.integers(0, K, size=self.budget)
        distinct = len(set(draws.tolist()))
        rep = ChannelReport(self.budget, self.budget,
                            decodable=(distinct == K),
                            distinct_sources=distinct)
        return (packets[torch.as_tensor(draws, device=packets.device)],
                draws, rep)

    def receive_encoded(self, make_coded, K: int, s: int
                        ) -> tuple[EncodedBatch, ChannelReport]:
        """FedNC: `make_coded(n)` yields n fresh random coded tuples;
        the server keeps the `budget` it hears."""
        batch = make_coded(self.budget)
        dec = self.budget >= K and rank(get_field(s), batch.A) == K
        return batch, ChannelReport(self.budget, self.budget, dec)


class MultiHopChannel:
    """η re-coding links between clients and server (Prop. 2).

    Each link draws a fresh random square recoding matrix over GF(2^s).
    The compose of η random matrices is singular with probability
    <= 1 - (1 - 2^-s)^η  (paper eq. 10 with d=1).
    """

    def __init__(self, eta: int, seed: int = 0):
        self.eta = int(eta)
        self.rng = np.random.default_rng(seed)

    def plan_transform(self, n: int, s: int) -> RowMix:
        """Compose the η hop matrices into one n×n mix on the host.

        One numpy draw, as in the reference, gives `base`; hop h's
        matrix comes from ``torch.Generator().manual_seed(base + h)``
        where the reference uses ``jax.random.PRNGKey(base + h)``."""
        field = get_field(s)
        base = int(self.rng.integers(0, 2**31 - 1))
        R_comp = torch.eye(n, dtype=torch.uint8)
        for h in range(self.eta):
            R = field.random_elements(torch.Generator().manual_seed(base + h),
                                      (n, n))
            R_comp = field.matmul(R, R_comp)
        return RowMix(R_comp)

    def transmit_encoded(self, batch, s: int, engine=None
                         ) -> tuple[EncodedBatch, ChannelReport]:
        """η sequential recodes, composed first: A' = (R_η···R_1)A,
        C' = (R_η···R_1)C, with the payload recoded once through the
        engine's chunk-streamed kernel — bit-identical to hop-by-hop.

        The default `engine` is the ``auto`` engine of the batch's
        payload device."""
        if engine is None:
            from repro_torch.engine import EngineConfig, get_engine
            engine = get_engine(EngineConfig(s=s), device=batch.C.device)
        R_comp = self.plan_transform(batch.n, s).R
        out = engine.recode_with(R_comp, batch)
        dec = rank(get_field(s), out.A) == batch.K
        return out, ChannelReport(batch.n, out.n, dec)
