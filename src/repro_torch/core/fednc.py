"""FedNC round logic — Algorithm 1 of the paper, as a composable module.

The port of `repro.core.fednc` (bit-exact path).  One round:

    P   <- stack(packetize(w_k) for k in participants)     (paper: P)
    A   <- random coding matrix over GF(2^s)               (paper: a_i)
    C   <- A · P                                           (eq. 4)
    ... tuples (a_i, C_i) traverse the channel ...
    if A' (received) invertible:
        P_hat <- GE(A', C');  w <- Σ p_k · unpacketize(P_hat_k)
    else:
        w <- w_prev                                        (skip round)

The coded math lives in repro_torch.engine.CodingEngine; this module
maps FedNCConfig onto an engine and turns decoded packets back into a
weighted FedAvg aggregate.  `packetize_clients`/`encode_clients` (the
client side) and `decode_and_aggregate`/`aggregate_decoded` (the server
side) are the same round cut at the channel, for callers that carry the
coded tuples themselves.  With ``quantize_bits`` the clients ship the
lossy int8 packets of paper ref. [22] (their per-tensor scales travel
uncoded beside them, as `qspecs`).  Otherwise the field path is
bit-exact and the aggregate sums in the same term order as
`fedavg_round`, so a decoded FedNC round equals FedAvg on the same
clients bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.engine.defaults import DEFAULT_CHUNK_L

from . import packets as pkt
from .channel import ChannelReport
from .rlnc import EncodedBatch


@dataclass(frozen=True)
class FedNCConfig:
    s: int = 8                 # field size (symbol bits), paper Table I
    kernel_impl: str = "auto"  # engine-registry kernel name
    extra_tuples: int = 0      # send K + extra coded tuples (erasure headroom)
    systematic: bool = False   # identity-prefixed coding matrix
    quantize_bits: int = 0     # 0 = bit-exact float bytes (default);
    #                            8 = paper-[22] affine int8 packets (4x
    #                            smaller uploads, lossy)
    coding_density: float = 1.0  # <1.0 = sparse RLNC coefficients
    chunk_l: int = DEFAULT_CHUNK_L  # streamed-chunk symbols (0 = one shot)


def engine_for(cfg: FedNCConfig, device="cuda"):
    """The (cached) CodingEngine realizing this round configuration."""
    # call-time import: repro_torch.engine imports repro_torch.core
    from repro_torch.engine import EngineConfig, get_engine
    return get_engine(EngineConfig(
        s=cfg.s,
        kernel=cfg.kernel_impl,
        chunk_l=cfg.chunk_l,
        extra_tuples=cfg.extra_tuples,
        systematic=cfg.systematic,
        coding_density=cfg.coding_density,
    ), device)


@dataclass
class RoundResult:
    global_params: Any
    decoded: bool
    report: Optional[ChannelReport]
    n_aggregated: int


def _weighted_sum(w: np.ndarray, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ_k w_k·x_k in float32, summed left to right from 0 — the term
    order of the reference's ``sum(wk * jnp.asarray(x, jnp.float32))``.
    Each product and each sum is its own rounded float32 operation."""
    acc = 0
    for wk, x in zip(w, xs, strict=True):
        acc = acc + float(wk) * x.to(torch.float32)
    return acc.to(xs[0].dtype)


def packetize_clients(client_params: Sequence[Any], cfg: FedNCConfig,
                      device="cuda"
                      ) -> tuple[torch.Tensor, pkt.PacketSpec,
                                 Optional[list]]:
    """Head of Alg. 1, also for callers that run their own coded
    pipeline (e.g. the async strategy): (P, spec, qspecs) on `device`;
    qspecs is None unless `quantize_bits` is set.  Quantization stays
    per client (a few Python floats of metadata each); the
    packetization itself is one batched pass."""
    engine = engine_for(cfg, device)
    if not cfg.quantize_bits:
        P, spec = engine.packetize(client_params)
        return P, spec, None
    qtrees, qspecs = zip(*(pkt.quantize_pytree(p, bits=cfg.quantize_bits)
                           for p in client_params))
    P, spec = engine.packetize(list(qtrees))
    return P, spec, list(qspecs)


def _aggregate(P_hat: torch.Tensor, spec: pkt.PacketSpec,
               weights: Sequence[float], qspecs: Optional[list] = None
               ) -> Any:
    """Decoded packets -> weighted FedAvg aggregate (paper §II-A);
    quantized packets are dequantized per client first."""
    K = P_hat.shape[0]
    w = np.asarray(weights, np.float32)
    w = w / w.sum()
    stacked = pkt.packets_to_pytrees(P_hat, spec)
    if qspecs is not None:
        trees = [pkt.dequantize_pytree(pkt.tree_map(lambda x, k=k: x[k],
                                                    stacked), qs)
                 for k, qs in enumerate(qspecs)]
        return pkt.tree_map(lambda *xs: _weighted_sum(w, xs), *trees)
    return pkt.tree_map(lambda x: _weighted_sum(w, [x[k] for k in range(K)]),
                        stacked)


def aggregate_decoded(P_hat: torch.Tensor, spec: pkt.PacketSpec,
                      weights: Sequence[float],
                      qspecs: Optional[list] = None) -> Any:
    """Tail of Alg. 1 for callers that decode their own packets:
    decoded (K, L) symbols -> weighted FedAvg aggregate, the same
    arithmetic as `fednc_round` (dequantized first when `qspecs`, from
    `packetize_clients`, is given)."""
    return _aggregate(P_hat, spec, weights, qspecs)


def encode_clients(client_params: Sequence[Any], cfg: FedNCConfig,
                   generator: torch.Generator, device="cuda"
                   ) -> tuple[EncodedBatch, pkt.PacketSpec, Optional[list]]:
    """Packetize and RLNC-encode K client parameter trees on `device`:
    (batch of K + extra_tuples tuples, spec, qspecs)."""
    engine = engine_for(cfg, device)
    P, spec, qspecs = packetize_clients(client_params, cfg, device)
    K = P.shape[0]
    A = engine.coding_matrix(generator, K + cfg.extra_tuples, K)
    return engine.encode(P, A), spec, qspecs


def decode_and_aggregate(batch: EncodedBatch, spec: pkt.PacketSpec,
                         weights: Sequence[float], prev_global: Any,
                         cfg: FedNCConfig, qspecs: Optional[list] = None,
                         device="cuda") -> RoundResult:
    """Server side of Alg. 1: decode (selecting K rows when n > K),
    weighted FedAvg, or skip."""
    K = batch.K
    if batch.n < K:
        return RoundResult(prev_global, False, None, 0)
    ok, P_hat = engine_for(cfg, device).decode(batch)
    if not ok:
        return RoundResult(prev_global, False, None, 0)
    return RoundResult(_aggregate(P_hat, spec, weights, qspecs), True,
                       None, K)


def fednc_round(client_params: Sequence[Any], weights: Sequence[float],
                prev_global: Any, cfg: FedNCConfig,
                generator: torch.Generator, channel=None, *,
                device="cuda") -> RoundResult:
    """Full Alg.-1 round on `device`: a thin adapter over
    CodingEngine.round()."""
    P, spec, qspecs = packetize_clients(client_params, cfg, device)
    out = engine_for(cfg, device).round(P, generator, channel=channel)
    if not out.ok:
        return RoundResult(prev_global, False, out.report, 0)
    agg = _aggregate(out.packets, spec, weights, qspecs)
    return RoundResult(agg, True, out.report, P.shape[0])


def fedavg_round(client_params: Sequence[Any], weights: Sequence[float],
                 prev_global: Any, channel=None) -> RoundResult:
    """Classic FedAvg baseline (paper §II-A), same channel interface;
    runs where the client parameters are."""
    w = np.asarray(weights, np.float32)
    if channel is not None:
        stacked = pkt.pytrees_to_packets(client_params, s=8)[0]
        _, idx, report = channel.transmit_plain(stacked)
        if len(idx) == 0:
            return RoundResult(prev_global, False, report, 0)
        client_params = [client_params[i] for i in idx]
        w = w[list(idx)]
    else:
        report = None
    w = w / w.sum()
    agg = pkt.tree_map(lambda *xs: _weighted_sum(w, xs), *client_params)
    return RoundResult(agg, True, report, len(client_params))
