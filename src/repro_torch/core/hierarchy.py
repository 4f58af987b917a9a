"""Hierarchical FedNC (paper §III: clients "encode their parameters at
trusted edge servers before uploading them to the central server").

The port of `repro.core.hierarchy`.  K clients are partitioned across E
edge servers.  Each edge collects its clients' plain packets over the
trusted local hop and emits `n_e` random linear combinations of them,
with coding vectors in the GLOBAL client index space (support = that
edge's clients); the edges' coded tuples cross the untrusted WAN to
the server, optionally re-coded on the way (`MultiHopChannel`), and
the server decodes all K originals once the stacked coding matrix
reaches rank K.

`hierarchical_fednc_round` is a thin adapter over
:meth:`repro_torch.engine.CodingEngine.multi_edge_round`, which runs
the whole edge tier — E local encodes, the WAN channel and the decode
— as one chunk-streamed dispatch.  `per_edge_round_reference` keeps
the E-dispatch path (one encode per edge, stage-wise WAN, decode) as
the bit-exactness oracle: both draw edge e's mixing matrix from the
same generator in edge order, and the WAN plan from the same numpy
stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from . import packets as pkt
from .fednc import FedNCConfig, RoundResult, _aggregate, engine_for
from .gf import get_field
from .rlnc import EncodedBatch


@dataclass(frozen=True)
class EdgeGroup:
    """Client indices served by one edge server."""
    client_ids: tuple


def partition_edges(K: int, num_edges: int) -> list[EdgeGroup]:
    ids = np.array_split(np.arange(K), num_edges)
    return [EdgeGroup(tuple(int(i) for i in grp)) for grp in ids]


def edge_encode(P: torch.Tensor, edge: EdgeGroup, K: int, n_out: int,
                cfg: FedNCConfig, generator: torch.Generator
                ) -> EncodedBatch:
    """One edge's mixing: `n_out` combinations of ITS clients' packets
    (chunk-streamed on P's device), with coding vectors embedded in the
    global K-client index space on the host."""
    cols = torch.as_tensor(edge.client_ids, dtype=torch.int64)
    A_local = get_field(cfg.s).random_elements(
        generator, (n_out, len(edge.client_ids))).cpu()
    C = engine_for(cfg, P.device).encode(P[cols.to(P.device)], A_local).C
    A_global = torch.zeros((n_out, K), dtype=torch.uint8)
    A_global[:, cols] = A_local
    return EncodedBatch(A=A_global, C=C)


def per_edge_round_reference(P: torch.Tensor, edges: Sequence[EdgeGroup],
                             cfg: FedNCConfig, generator: torch.Generator, *,
                             spare_per_edge: int = 0, wan_channel=None):
    """The E-dispatch path: one engine `encode` per edge, stage-wise
    WAN, stage-wise decode.  The bit-exactness oracle for
    :meth:`~repro_torch.engine.CodingEngine.multi_edge_round`; returns
    an EngineRound."""
    from repro_torch.engine.engine import EngineRound
    K = P.shape[0]
    batches = [edge_encode(P, edge, K, len(edge.client_ids) + spare_per_edge,
                           cfg, generator) for edge in edges]
    combined = batches[0]
    for b in batches[1:]:
        combined = combined.concat(b)
    report = None
    if wan_channel is not None:
        combined, report = wan_channel.transmit_encoded(combined, cfg.s)
        if not report.decodable:
            return EngineRound(False, None, report)
    if combined.n < K:
        return EngineRound(False, None, report)
    ok, P_hat = engine_for(cfg, P.device).decode(combined)
    return EngineRound(ok, P_hat, report)


def hierarchical_fednc_round(client_params: Sequence[Any],
                             weights: Sequence[float], prev_global: Any,
                             cfg: FedNCConfig, generator: torch.Generator, *,
                             num_edges: int = 2, spare_per_edge: int = 0,
                             wan_channel=None, fused: bool = True,
                             device="cuda") -> RoundResult:
    """Full hierarchical round on `device`: client -> edge encode ->
    WAN -> server.  ``fused=True`` runs the edge tier as one dispatch
    (`multi_edge_round`); ``fused=False`` the per-edge reference,
    bit-identical by construction."""
    K = len(client_params)
    engine = engine_for(cfg, device)
    P, spec = engine.packetize(client_params)
    edges = partition_edges(K, num_edges)
    if fused:
        out = engine.multi_edge_round(
            P, generator, [edge.client_ids for edge in edges],
            spare_per_edge=spare_per_edge, wan_channel=wan_channel)
    else:
        out = per_edge_round_reference(
            P, edges, cfg, generator, spare_per_edge=spare_per_edge,
            wan_channel=wan_channel)
    if not out.ok:
        return RoundResult(prev_global, False, out.report, 0)
    return RoundResult(_aggregate(out.packets, spec, weights), True,
                       out.report, K)
