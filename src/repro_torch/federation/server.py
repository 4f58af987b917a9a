"""Server aggregation strategies: FedAvg (paper §II-A baseline) and
FedNC (paper Alg. 1), both behind one interface so round loops and
experiments swap them freely.

The port of `repro.federation.server`.  The channel between clients
and server is pluggable (core.channel): `None` (ideal),
ErasureChannel, BlindBoxChannel, MultiHopChannel.  Every strategy
consumes the round's numpy generator as the reference does: where the
reference turns a draw into ``jax.random.PRNGKey(draw)``, the port
seeds ``torch.Generator().manual_seed(draw)`` from the same draw at the
same place in the stream, so client sampling, batch seeds, blind-box
draws, arrival schedules and packet sources agree; only the coding
coefficients themselves come from another generator.  That generator
is a host one: coding rows are (n, K) matrices the engine plans and
inverts on the host, so whether a round decodes does not depend on
the device it runs on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import fednc as fednc_mod
from repro_torch.core import packets as pkt
from repro_torch.core.channel import (ArrivalSchedule, AsyncChannelReport,
                                      BlindBoxChannel, ChannelReport)
from repro_torch.core.fednc import FedNCConfig, RoundResult
from repro_torch.core.rlnc import random_coding_matrix


def _generator(rng: np.random.Generator) -> torch.Generator:
    """The port's stand-in for the reference's
    ``jax.random.PRNGKey(int(rng.integers(0, 2**31 - 1)))``: one draw
    of the same stream."""
    return torch.Generator().manual_seed(int(rng.integers(0, 2**31 - 1)))


@dataclass
class FedAvgStrategy:
    """Classic FedAvg; under a BlindBoxChannel the server aggregates
    whatever K draws it happens to receive (duplicates included) —
    the paper's 'blind box effect'."""

    channel: Any = None

    def aggregate(self, client_params: Sequence[Any],
                  weights: Sequence[float], prev_global: Any,
                  rng: np.random.Generator) -> RoundResult:
        if isinstance(self.channel, BlindBoxChannel):
            K = len(client_params)
            draws = rng.integers(0, K, size=self.channel.budget)
            chosen = [client_params[i] for i in draws]
            w = np.asarray([weights[i] for i in draws], np.float32)
            w = w / w.sum()
            agg = pkt.tree_map(lambda *xs: fednc_mod._weighted_sum(w, xs),
                               *chosen)
            distinct = len(set(draws.tolist()))
            rep = ChannelReport(self.channel.budget, self.channel.budget,
                                True, distinct_sources=distinct)
            return RoundResult(agg, True, rep, distinct)
        return fednc_mod.fedavg_round(client_params, weights, prev_global,
                                      channel=self.channel)


@dataclass
class FedNCStrategy:
    """FedNC (Alg. 1).  Under a BlindBoxChannel every received packet
    is a *fresh coded* packet — random mixtures of ALL K participants —
    so any full-rank K of them aggregate every client's contribution.
    Runs on `device`."""

    config: FedNCConfig = field(default_factory=FedNCConfig)
    channel: Any = None
    device: Any = "cuda"

    def aggregate(self, client_params: Sequence[Any],
                  weights: Sequence[float], prev_global: Any,
                  rng: np.random.Generator) -> RoundResult:
        gen = _generator(rng)
        cfg = self.config
        if isinstance(self.channel, BlindBoxChannel):
            # encode once per emitted packet: the network multicasts
            # fresh combinations; the server keeps `budget` of them
            # (packetized as the reference does here: unquantized)
            engine = fednc_mod.engine_for(cfg, self.device)
            P, spec = engine.packetize(client_params)
            K = P.shape[0]
            n = self.channel.budget
            A = random_coding_matrix(gen, n, K, cfg.s)
            batch = engine.encode(P, A)
            res = fednc_mod.decode_and_aggregate(
                batch, spec, weights, prev_global, cfg, device=self.device)
            res.report = ChannelReport(n, n, res.decoded)
            return res
        return fednc_mod.fednc_round(client_params, weights, prev_global,
                                     cfg, gen, channel=self.channel,
                                     device=self.device)


@dataclass
class AsyncFedNCStrategy:
    """FedNC with an asynchronous server: Prop. 1 made operational.

    The network multicasts `budget` coded tuples whose arrival times
    come from `schedule_fn`; the server feeds them, *in arrival
    order*, to a `repro_torch.engine.stream` decoder and stops at rank
    K — it aggregates from the first rank-K prefix of arrivals (~K
    packets).  The report records how many arrivals were consumed and
    the simulated clock at decode.

    With per-client ``compute_times`` (see `repro_torch.sim.ComputeModel`
    and ``run_async_experiment``), each multicast tuple is attributed a
    uniformly random source client and delayed by that client's
    local-training time; the report then carries both clocks
    (``sim_time`` coupled, ``sim_time_network`` network-only, from the
    same gap draws).
    """

    config: FedNCConfig = field(default_factory=FedNCConfig)
    budget: int = 0     # coded tuples multicast per round; 0 -> K + 8
    # (n, rng) -> ArrivalSchedule for the n multicast tuples; None
    # means transmission order with unit gaps (an ideal pipe)
    schedule_fn: Optional[
        Callable[[int, np.random.Generator], ArrivalSchedule]] = None
    device: Any = "cuda"

    def aggregate(self, client_params: Sequence[Any],
                  weights: Sequence[float], prev_global: Any,
                  rng: np.random.Generator, *,
                  compute_times=None) -> RoundResult:
        from repro_torch.engine.stream import StreamDecoder, stream_decode
        cfg = self.config
        engine = fednc_mod.engine_for(cfg, self.device)
        P, spec, qspecs = fednc_mod.packetize_clients(client_params, cfg,
                                                      self.device)
        K = P.shape[0]
        n = self.budget if self.budget else K + 8
        gen = _generator(rng)
        batch = engine.encode(P, engine.coding_matrix(gen, n, K))
        if self.schedule_fn is not None:
            sched_net = self.schedule_fn(n, rng)
            if sched_net.n != n:
                raise ValueError(
                    f"schedule covers {sched_net.n} arrivals, need {n}")
        else:
            sched_net = ArrivalSchedule(np.arange(1, n + 1, dtype=float))
        if compute_times is not None:
            ct = np.asarray(compute_times, np.float64)
            if ct.shape[0] != K:
                raise ValueError(
                    f"compute_times covers {ct.shape[0]} clients, "
                    f"need {K}")
            # blind-box source attribution: each multicast tuple waits
            # for a uniformly random client's local training
            sources = rng.integers(0, K, size=n)
            sched = sched_net.offset_by(ct[sources])
        else:
            sched = sched_net
        ok, P_hat, consumed = stream_decode(batch, cfg.s, order=sched.order,
                                            device=self.device)
        sim_time = sched.time_of(consumed) if consumed else 0.0
        if compute_times is None:
            sim_time_network = sim_time
        else:
            # the counterfactual clock: same gap draws, no compute.
            # Rank-only replay (L = 0): host row space, no payload.
            rank_dec = StreamDecoder(K=K, L=0, s=cfg.s)
            rank_dec.ingest(batch.A[torch.as_tensor(sched_net.order)])
            g_net = rank_dec.decoded_at or consumed
            sim_time_network = (sched_net.time_of(g_net)
                                if g_net else 0.0)
        report = AsyncChannelReport(
            sent=n, delivered=consumed, decodable=bool(ok),
            consumed=consumed, sim_time=sim_time,
            sim_time_network=sim_time_network)
        if not ok:
            return RoundResult(prev_global, False, report, 0)
        agg = fednc_mod.aggregate_decoded(P_hat, spec, weights,
                                          qspecs=qspecs)
        return RoundResult(agg, True, report, K)


@dataclass
class HierarchicalFedNCStrategy:
    """Hierarchical FedNC (paper §III): clients upload to trusted edge
    servers, each edge emits K_e + `spare_per_edge` random combinations
    in the global coding-vector space, and the central server decodes
    the WAN-delivered stack — one fused dispatch of the engine's
    `multi_edge_round`."""

    config: FedNCConfig = field(default_factory=FedNCConfig)
    num_edges: int = 2
    spare_per_edge: int = 0
    channel: Any = None           # the WAN hop (edge -> central server)
    device: Any = "cuda"

    def aggregate(self, client_params: Sequence[Any],
                  weights: Sequence[float], prev_global: Any,
                  rng: np.random.Generator) -> RoundResult:
        from repro_torch.core.hierarchy import hierarchical_fednc_round
        return hierarchical_fednc_round(
            client_params, weights, prev_global, self.config,
            _generator(rng), num_edges=self.num_edges,
            spare_per_edge=self.spare_per_edge, wan_channel=self.channel,
            device=self.device)
