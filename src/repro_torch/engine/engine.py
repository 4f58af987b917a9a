"""CodingEngine: the encode -> channel -> select -> decode spine.

The port of `repro.engine.engine`.  FedNC's round cost is the coded
matmul C = A·P and its inverse (paper §II-B, Alg. 1); this engine owns
that path on one device:

* **batched packetization** — client trees become one (K, L) symbol
  matrix on the engine's device (core.packets.pytrees_to_packets);
* **registry dispatch** — the kernel is a name resolved through
  repro_torch.engine.registry; ``auto`` is the hand-written CUDA kernel,
  whose wrapper runs its plain version on a CPU engine's tensors;
* **chunked streaming executor** — the lane dimension L is cut into
  `chunk_l`-symbol column views of P; each is launched asynchronously
  on the current CUDA stream and writes straight into its columns of
  the output, and with a decode matrix the decode of chunk i is queued
  right behind its encode;
* **row-space planning on the host** — selection, inversion and
  channel plans work on (n, K) matrices of a few dozen bytes, and the
  round branches on their outcome anyway, so they run as plain tensor
  code on the CPU; only the L-sized products touch the card;
* **fused channels and recoding** — channels exposing
  `plan_transform` (erasure, blind box: a RowGather; multi-hop relays:
  a RowMix; a byzantine relay: a RowTamper) are folded into the
  stream: the plan is decided on the coding matrix first, then encode,
  channel and decode run as one chunk-streamed dispatch.  `recode` is
  the relay operation (Prop. 2), `decode_verified` the byzantine
  cross-check, and `multi_edge_round` the whole hierarchical topology
  (paper §III) as one fused dispatch in the global coding-vector
  space.  Channels without a plan run stage by stage.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import packets as pkt
from repro_torch.core import seeds as seedlib
from repro_torch.core.channel import ChannelReport, RowGather, RowMix, RowTamper
from repro_torch.core.gf import get_field, invert
from repro_torch.core.rlnc import EncodedBatch, SeededBatch

from .defaults import DEFAULT_CHUNK_L
from .registry import (is_seeded_kernel, materialized_kernel_name,
                       resolve_kernel, seeded_kernel_name)
from .select import incremental_select


def resolve_device(device) -> torch.device:
    """The engine device; asking for the card where there is none
    raises instead of carrying on elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported engine device {dev}")
    return dev


def _is_seed_rows(A: torch.Tensor) -> bool:
    """True iff the row operand is a (n,) seed vector: seeds are 1-D,
    materialized rows a 2-D uint8 matrix, so dispatch is unambiguous."""
    return A.dim() == 1


@dataclass(frozen=True)
class EngineConfig:
    """Everything the coding spine needs, in one hashable record."""

    s: int = 8                   # field size (symbol bits), paper Table I
    kernel: str = "auto"         # registry name (see engine.registry)
    chunk_l: int = DEFAULT_CHUNK_L   # symbols per streamed chunk; 0 = off
    extra_tuples: int = 0        # send K + extra coded tuples
    systematic: bool = False     # identity-prefixed coding matrix
    coding_density: float = 1.0  # <1.0 = sparse RLNC coefficients


@dataclass(frozen=True)
class EngineRound:
    """Outcome of one engine round (the coded math, pre-aggregation)."""

    ok: bool
    packets: Optional[torch.Tensor]  # (K, L) decoded symbols when ok
    report: Any = None               # ChannelReport when a channel ran
    # redundant-rank cross-check (round(verify=True)): True = every
    # redundant delivered tuple is consistent with the decode, False =
    # corruption detected, None = not checked / no redundancy to check
    verified: Optional[bool] = None


_DEFAULT_CONFIG = EngineConfig()


class CodingEngine:
    """Owns the RLNC pipeline for one EngineConfig on one device."""

    def __init__(self, config: EngineConfig = _DEFAULT_CONFIG,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.kernel_name, self._kernel = resolve_kernel(config.kernel)
        # A seeded kernel covers only the encode side; decode mixes with
        # materialized matrices (A^-1) through the materialized sibling.
        # Both siblings are resolved so either packet format decodes.
        self.seeded = is_seeded_kernel(self.kernel_name)
        if self.seeded:
            self._seed_kernel = self._kernel
            _, self._mat_kernel = resolve_kernel(
                materialized_kernel_name(self.kernel_name))
        else:
            _, self._seed_kernel = resolve_kernel(
                seeded_kernel_name(self.kernel_name))
            self._mat_kernel = self._kernel
        self.field = get_field(config.s)       # host-side row-space work
        #: L-sized kernel dispatches issued so far (monotonic)
        self.dispatch_count = 0

    # -- packetization ----------------------------------------------------

    def packetize(self, client_params: Sequence[Any]
                  ) -> tuple[torch.Tensor, pkt.PacketSpec]:
        """K client trees -> (K, L) symbol matrix on the engine device."""
        return pkt.pytrees_to_packets(client_params, s=self.config.s,
                                      device=self.device)

    def unpacketize(self, P_hat: torch.Tensor, spec: pkt.PacketSpec):
        """(K, L) decoded symbols -> stacked tree (leading K axis)."""
        return pkt.packets_to_pytrees(P_hat, spec)

    # -- coding matrices (drawn on the generator's device, kept on host) --

    def coding_matrix(self, generator: torch.Generator, n: int, K: int
                      ) -> torch.Tensor:
        from repro_torch.core import rlnc
        cfg = self.config
        if cfg.systematic:
            A = rlnc.systematic_coding_matrix(generator, n, K, cfg.s)
        elif cfg.coding_density < 1.0:
            A = rlnc.sparse_coding_matrix(generator, n, K, cfg.s,
                                          density=cfg.coding_density)
        else:
            A = rlnc.random_coding_matrix(generator, n, K, cfg.s)
        return A.cpu()

    def coding_seeds(self, generator: torch.Generator, n: int
                     ) -> torch.Tensor:
        """n row seeds — the seed-addressed coding "matrix".  Only the
        plain uniform draw has a seeded form."""
        cfg = self.config
        if cfg.systematic or cfg.coding_density < 1.0:
            raise ValueError(
                "seeded coding vectors require plain uniform RLNC "
                "(systematic=False, coding_density=1.0)")
        return seedlib.draw_seeds(generator, n).cpu()

    def expand_seeds(self, seeds, K: int) -> torch.Tensor:
        """Materialize the (n, K) rows a seed vector addresses."""
        return seedlib.expand_rows(seedlib.as_seeds(seeds).cpu(), K,
                                   self.config.s)

    # -- chunked executor -------------------------------------------------

    def _chunks(self, L: int) -> tuple[int, int]:
        """(chunk width, count) covering L; the last chunk may be
        narrower — the kernels mask a ragged edge themselves."""
        cl = self.config.chunk_l
        if cl <= 0 or L <= cl:
            return max(L, 1), 1
        return cl, -(-L // cl)

    def matmul(self, A: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
        """C = A·P, chunk-streamed through the configured kernel.  A
        (n,) seed vector as `A` runs the seeded kernel."""
        return self._stream(A, P, enc_seeded=_is_seed_rows(A))

    def _stream(self, A, P, A_post=None, *, enc_seeded: bool = False):
        """Run the kernel chunk by chunk over column views of P; the
        last launch of each chunk writes into that chunk's columns of
        the output.

        With `A_post` (the decode mixing matrix) each chunk goes through
        both products before the next is queued: A_post·(A·P_i).  No
        chunk depends on another, and the launches are asynchronous, so
        the host queues chunk i+1 while the card runs chunk i.  With
        ``enc_seeded`` the first operand is the (n,) seed vector and the
        encode leg runs the seeded kernel; the A_post leg is always the
        materialized kernel.
        """
        if P.device.type != self.device.type:
            raise ValueError(f"P is on {P.device}, the engine on "
                             f"{self.device}")
        enc_kernel = self._seed_kernel if enc_seeded else self._mat_kernel
        post_kernel = self._mat_kernel
        s = self.config.s
        A = A.to(P.device)
        if A_post is not None:
            A_post = A_post.to(P.device)
        n_out = (A_post if A_post is not None else A).shape[0]
        L = P.shape[1]
        if L == 0:
            return torch.zeros((n_out, 0), dtype=torch.uint8,
                               device=P.device)

        def mm(kernel, M, X, out=None):
            self.dispatch_count += 1
            return kernel(M, X, s=s, out=out)

        def leg(X, out=None):
            if A_post is None:
                return mm(enc_kernel, A, X, out)
            return mm(post_kernel, A_post, mm(enc_kernel, A, X), out)

        cl, nc = self._chunks(L)
        if nc == 1:
            return leg(P)
        out = torch.empty((n_out, L), dtype=torch.uint8, device=P.device)
        for c in range(nc):
            lo, hi = c * cl, min(L, (c + 1) * cl)
            leg(P[:, lo:hi], out[:, lo:hi])
        return out

    # -- pipeline stages --------------------------------------------------

    def encode(self, P: torch.Tensor, A: torch.Tensor):
        """C = A·P as an EncodedBatch; a (n,) seed vector as `A` runs
        the seeded kernel and returns a SeededBatch."""
        if _is_seed_rows(A):
            return self.encode_seeded(P, A)
        return EncodedBatch(A=A, C=self.matmul(A, P))

    def encode_seeded(self, P: torch.Tensor, seeds) -> SeededBatch:
        """C = rows(seeds)·P without materializing the coding matrix;
        bit-exact vs ``encode(P, expand_seeds(seeds, K)).C``."""
        seeds = seedlib.as_seeds(seeds)
        C = self._stream(seeds, P, enc_seeded=True)
        return SeededBatch(seeds=seeds, C=C, K=int(P.shape[0]))

    def recode(self, batch, generator: torch.Generator, n_out: int
               ) -> EncodedBatch:
        """Relay recoding (paper Prop. 2): emit `n_out` fresh random
        combinations of the received tuples without decoding.

        The relay draws R (n_out, n) over GF(2^s) from `generator` and
        forwards (R·A, R·C) (:meth:`recode_with`).  A SeededBatch is
        accepted; the output rows are materialized, since a composed
        row has no seed.

        >>> eng = CodingEngine(EngineConfig(s=8), device="cpu")
        >>> P = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
        >>> g = torch.Generator().manual_seed(0)
        >>> relay = eng.recode(eng.encode(P, eng.coding_matrix(g, 3, 3)),
        ...                    g, n_out=4)
        >>> ok, P_hat = eng.decode(relay)
        >>> ok and torch.equal(P_hat, P)
        True
        """
        R = self.field.random_elements(generator, (n_out, batch.n)).cpu()
        return self.recode_with(R, batch)

    def recode_with(self, R: torch.Tensor, batch) -> EncodedBatch:
        """Recode with an explicit mixing matrix: (R·A, R·C).

        Both products run through the registry kernel on the engine's
        device, as in the reference (the coding rows come back to the
        host).  η sequential hops compose by linearity, which
        `core.channel.MultiHopChannel` relies on."""
        R = torch.as_tensor(R, dtype=torch.uint8).cpu()
        if isinstance(batch, SeededBatch):
            batch = batch.expand(self.config.s)
        A = self.matmul(R, batch.A.to(self.device)).cpu()
        return EncodedBatch(A=A, C=self.matmul(R, batch.C))

    def select(self, batch) -> tuple[bool, EncodedBatch]:
        """Pick K independent tuples out of n >= K (row space on host)."""
        if isinstance(batch, SeededBatch):
            batch = batch.expand(self.config.s)
        ok, idx, _ = incremental_select(batch.A.cpu(), self.config.s)
        return ok, EncodedBatch(A=batch.A[idx.to(batch.A.device)],
                                C=batch.C[idx.to(batch.C.device)])

    def decode(self, batch) -> tuple[bool, Optional[torch.Tensor]]:
        """(ok, P_hat): select (if n > K), invert A, stream A^-1·C."""
        if isinstance(batch, SeededBatch):
            batch = batch.expand(self.config.s)
        K = batch.K
        if batch.n < K:
            return False, None
        ok = True
        if batch.n > K:
            ok, batch = self.select(batch)
        ok_inv, A_inv = invert(self.field, batch.A.cpu())
        if not (ok and ok_inv):
            return False, None
        return True, self.matmul(A_inv, batch.C)

    def decode_verified(self, batch) -> tuple[bool, Optional[torch.Tensor],
                                              Optional[bool]]:
        """(ok, P_hat, verified): decode plus the byzantine cross-check.

        Decoding consumes K of the n delivered tuples; the n - K
        redundant ones are re-encoded from P_hat and compared, digest
        by digest, with what the channel delivered.  An honest channel
        delivers only exact GF combinations, so any mismatch proves a
        corrupted tuple.  ``verified`` is None when there is no
        redundancy to check.  The digests are taken on the host, one
        row at a time: (n - K) rows of L bytes, a copy the size of the
        redundant payload.

        >>> eng = CodingEngine(EngineConfig(s=8), device="cpu")
        >>> P = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
        >>> A = eng.coding_matrix(torch.Generator().manual_seed(0), 5, 3)
        >>> batch = eng.encode(P, A)
        >>> ok, P_hat, verified = eng.decode_verified(batch)
        >>> ok, torch.equal(P_hat, P), verified
        (True, True, True)
        >>> C = batch.C.clone(); C[4, 0] ^= 1
        >>> eng.decode_verified(EncodedBatch(A=batch.A, C=C))[2]
        False
        """
        if isinstance(batch, SeededBatch):
            batch = batch.expand(self.config.s)
        K, n = batch.K, batch.n
        if n < K:
            return False, None, None
        A = batch.A.cpu()
        ok, idx, _ = incremental_select(A, self.config.s)
        ok_inv, A_inv = invert(self.field, A[idx])
        if not (ok and ok_inv):
            return False, None, None
        P_hat = self.matmul(A_inv, batch.C[idx.to(batch.C.device)])
        red = torch.as_tensor(np.setdiff1d(np.arange(n), idx.numpy()))
        if red.numel() == 0:
            return True, P_hat, None
        pred = self.matmul(A[red], P_hat).cpu().numpy()
        got = batch.C[red.to(batch.C.device)].cpu().numpy()
        verified = all(hashlib.sha256(pred[i].tobytes()).digest()
                       == hashlib.sha256(got[i].tobytes()).digest()
                       for i in range(len(red)))
        return True, P_hat, verified

    # -- fused round internals --------------------------------------------

    def _fused_ideal_round(self, P: torch.Tensor, A: torch.Tensor,
                           seeds: Optional[torch.Tensor] = None
                           ) -> EngineRound:
        """Lossless delivery: resolve invertibility on the (n, K)
        matrix, then stream A_inv·(A_sel·P) in one dispatch.  With
        `seeds`, A is their expansion and the encode leg runs the
        seeded kernel on the matching seed subset."""
        A = A.cpu()
        n, K = A.shape
        if n < K:
            return EngineRound(False, None, None)
        ok = True
        if n > K:
            ok, idx, _ = incremental_select(A, self.config.s)
            A_sel = A[idx]
            enc = seeds[idx] if seeds is not None else A_sel
        else:
            A_sel = A
            enc = seeds if seeds is not None else A
        ok_inv, A_inv = invert(self.field, A_sel)
        if not (ok and ok_inv):
            return EngineRound(False, None, None)
        # encode only the selected rows: the ideal channel delivers
        # everything, so unselected headroom rows are dead work
        P_hat = self._stream(enc, P, A_post=A_inv,
                             enc_seeded=seeds is not None)
        return EngineRound(True, P_hat, None)

    def _expand_err(self, err_seeds, which, width: int,
                    device=None) -> torch.Tensor:
        """Materialize adversarial error rows `which` of a RowTamper
        seed vector at `width` symbols (K for coding rows, L for
        payloads) on `device` (the host when None) — the same Threefry
        expansion as the wire format."""
        sel = seedlib.as_seeds(np.asarray(err_seeds)[which], device=device)
        return seedlib.expand_rows(sel, width, self.config.s)

    def _fused_tamper_round(self, P: torch.Tensor, A: torch.Tensor,
                            plan: RowTamper,
                            seeds: Optional[torch.Tensor] = None,
                            verify: bool = False) -> EngineRound:
        """RowTamper tail: byzantine corruption folded into the stream.

        All n tuples arrive, rows `plan.idx` XOR-ed with seed-expanded
        noise.  Selection and inversion run on the received (corrupted)
        matrix, while the encode leg replays the true rows, so the
        decode is exactly what a stage-wise receiver computes:

            P_hat = A_rx[sel]^-1 · C_rx[sel]
                  = A_inv·(A_true[sel]·P)  ^  A_inv·E[sel]

        with E the payload-error matrix, of which only the few nonzero
        rows are expanded to L symbols, on P's device.  The A_inv·E
        product goes through the materialized kernel in one launch and,
        as in the reference, is not counted in `dispatch_count`.  With
        `verify`, the redundant rows are cross-checked against P_hat
        (:meth:`decode_verified`, residual form) at the cost of two
        more (n-K)-row streamed products.
        """
        n, K = A.shape
        L = P.shape[1]
        s = self.config.s
        idx_np = np.asarray(plan.idx, np.int64)
        A_rx = A
        if plan.m and plan.row_seeds is not None:
            idx_t = torch.as_tensor(idx_np)
            A_rx = A.clone()
            A_rx[idx_t] = A[idx_t] ^ self._expand_err(
                plan.row_seeds, np.arange(plan.m), K)
        ok, sel, _ = incremental_select(A_rx, s)
        report = ChannelReport(n, n, ok)
        if not ok:
            return EngineRound(False, None, report)
        _, A_inv = invert(self.field, A_rx[sel])
        sel_np = sel.numpy()
        enc_rows = seeds if seeds is not None else A
        P_hat = self._stream(enc_rows[sel], P, A_post=A_inv,
                             enc_seeded=seeds is not None)
        pos_of = {int(r): j for j, r in enumerate(idx_np)}

        def err_at(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            hit = [(j, pos_of[int(r)]) for j, r in enumerate(rows)
                   if int(r) in pos_of]
            return (np.asarray([h[0] for h in hit], np.int64),
                    np.asarray([h[1] for h in hit], np.int64))

        if plan.payload_seeds is not None and L:
            where, which = err_at(sel_np)
            if where.size:
                E = self._expand_err(plan.payload_seeds, which, L, P.device)
                P_hat ^= self._mat_kernel(
                    A_inv[:, torch.as_tensor(where)].to(P.device), E, s=s)
        verified = None
        if verify:
            red = np.setdiff1d(np.arange(n), sel_np)
            if red.size:
                red_t = torch.as_tensor(red)
                C_red = self._stream(enc_rows[red_t], P,
                                     enc_seeded=seeds is not None)
                if plan.payload_seeds is not None and L:
                    where, which = err_at(red)
                    if where.size:
                        w = torch.as_tensor(where, device=C_red.device)
                        C_red[w] ^= self._expand_err(plan.payload_seeds,
                                                     which, L, P.device)
                resid = self._stream(A_rx[red_t], P_hat) ^ C_red
                verified = not bool(resid.any())
        return EngineRound(True, P_hat, report, verified)

    def _fused_channel_round(self, P: torch.Tensor, A: torch.Tensor,
                             channel,
                             seeds: Optional[torch.Tensor] = None,
                             verify: bool = False) -> EngineRound:
        """encode -> channel -> select -> decode as ONE streamed dispatch.

        The channel's plan is its whole action on the row space: a
        RowGather says which tuples arrive, a RowMix how relays mixed
        them, a RowTamper which rows a byzantine relay corrupted (that
        one has its own tail).  Delivery, selection and inversion are
        resolved on (n, K) matrices, then the payload flows through a
        single `_stream` whose A_post composes channel and decode.  GF
        algebra is exact, so the result is bit-identical to the
        stage-wise reference.
        """
        A = A.cpu()
        n, K = A.shape
        s = self.config.s
        plan = channel.plan_transform(n, s)
        if isinstance(plan, RowTamper):
            return self._fused_tamper_round(P, A, plan, seeds, verify)
        if isinstance(plan, RowGather):
            delivered = int(len(plan.idx))
            if delivered < K:
                return EngineRound(False, None,
                                   ChannelReport(n, delivered, False))
            idx = torch.as_tensor(plan.idx, dtype=torch.int64)
            A_rx = A[idx]
        elif isinstance(plan, RowMix):
            R = plan.R.cpu()
            delivered = int(R.shape[0])
            A_rx = self.field.matmul(R, A)
        else:
            raise TypeError(f"unsupported channel plan {type(plan).__name__}")
        ok, sel, _ = incremental_select(A_rx, s)
        report = ChannelReport(n, delivered, ok)
        if not ok:
            return EngineRound(False, None, report)
        _, A_inv = invert(self.field, A_rx[sel])      # sel independent
        if isinstance(plan, RowGather):
            rows = idx[sel]
            A_enc = seeds[rows] if seeds is not None else A[rows]
            A_post = A_inv
        else:
            # RowMix touches every source row, so the full seed vector
            # feeds the encode; the relay composition R folds into the
            # materialized A_post (composed rows have no seed).
            A_enc = seeds if seeds is not None else A
            A_post = self.field.matmul(A_inv, R[sel])
        P_hat = self._stream(A_enc, P, A_post=A_post,
                             enc_seeded=seeds is not None)
        return EngineRound(True, P_hat, report)

    def _stagewise_channel_round(self, P: torch.Tensor, A: torch.Tensor,
                                 channel, verify: bool = False
                                 ) -> EngineRound:
        """Fallback for channels without `plan_transform`: materialize
        the coded payload and run the stages in order."""
        batch = self.encode(P, A.cpu())
        batch, report = channel.transmit_encoded(batch, self.config.s)
        if not report.decodable:
            return EngineRound(False, None, report)
        if verify:
            ok, P_hat, verified = self.decode_verified(batch)
            return EngineRound(ok, P_hat, report, verified)
        ok, P_hat = self.decode(batch)
        return EngineRound(ok, P_hat, report)

    def _run_round(self, P: torch.Tensor, A: torch.Tensor, channel,
                   seeds: Optional[torch.Tensor] = None,
                   verify: bool = False) -> EngineRound:
        """Channel dispatch shared by `round` and `multi_edge_round`:
        ideal delivery, a channel's row plan (fused), or the stage-wise
        fallback.  `seeds`, when given, is the seed vector whose
        expansion is A; the stage-wise path materializes.  `verify`
        requests the redundant-rank cross-check (honoured by the
        stage-wise and RowTamper paths; honest fused plans leave
        ``verified=None``)."""
        if seeds is not None:
            seeds = seedlib.as_seeds(seeds).cpu()
        if channel is None:
            return self._fused_ideal_round(P, A, seeds)
        if hasattr(channel, "plan_transform"):
            return self._fused_channel_round(P, A, channel, seeds, verify)
        return self._stagewise_channel_round(P, A, channel, verify)

    # -- the full round ---------------------------------------------------

    def round(self, P: torch.Tensor, generator: torch.Generator,
              channel=None, *, verify: bool = False) -> EngineRound:
        """encode -> (channel) -> select -> decode for one packet matrix.

        The coding rows (or row seeds, on a seeded engine) are drawn
        from `generator`, planned and inverted before any L-sized work;
        then encode and decode of each chunk are queued back to back.
        `verify` runs the byzantine cross-check where the path can
        (see :meth:`_run_round`).

        >>> eng = CodingEngine(EngineConfig(s=8), device="cpu")
        >>> P = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
        >>> out = eng.round(P, torch.Generator().manual_seed(0))
        >>> out.ok and torch.equal(out.packets, P)
        True
        """
        K = P.shape[0]
        n = K + self.config.extra_tuples
        if self.seeded:
            seeds = self.coding_seeds(generator, n)
            return self._run_round(P, self.expand_seeds(seeds, K), channel,
                                   seeds=seeds, verify=verify)
        return self._run_round(P, self.coding_matrix(generator, n, K),
                               channel, verify=verify)

    # -- the fused hierarchical round (paper §III) ------------------------

    def multi_edge_coding_matrix(self, generator: torch.Generator,
                                 edges: Sequence[Sequence[int]], K: int,
                                 n_out: Sequence[int]) -> torch.Tensor:
        """Stacked global-space coding matrix of a whole edge tier.

        Edge e (serving clients `edges[e]`, a subset of range(K)) draws
        its (n_out[e], K_e) local mixing matrix from `generator`, in
        edge order — the stream the per-edge reference
        (`core.hierarchy.per_edge_round_reference`) consumes too — and
        its rows are embedded at that edge's client columns of the
        global K-wide coding-vector space.  Rows of different edges
        never overlap in support.
        """
        blocks = []
        for e, ids in enumerate(edges):
            cols = torch.as_tensor(tuple(int(i) for i in ids),
                                   dtype=torch.int64)
            A_local = self.field.random_elements(
                generator, (int(n_out[e]), len(ids))).cpu()
            A_g = torch.zeros((int(n_out[e]), K), dtype=torch.uint8)
            A_g[:, cols] = A_local
            blocks.append(A_g)
        return torch.cat(blocks, dim=0)

    def multi_edge_round(self, P: torch.Tensor, generator: torch.Generator,
                         edges: Sequence[Sequence[int]], *,
                         spare_per_edge: int = 0, wan_channel=None,
                         verify: bool = False) -> EngineRound:
        """One fused hierarchical round: E edge encodes + WAN + decode.

        Every edge's local encode is a row block of
        :meth:`multi_edge_coding_matrix`, the WAN channel (erasures,
        multi-hop recoding) is planned on the row space, and one
        chunk-streamed `_stream` runs encode, channel and decode per
        chunk.  Bit-exact vs. the per-edge reference
        (`core.hierarchy`, fused=False).  `edges` partitions range(K);
        each edge emits K_e + `spare_per_edge` combinations.

        >>> eng = CodingEngine(EngineConfig(s=8), device="cpu")
        >>> P = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
        >>> out = eng.multi_edge_round(P, torch.Generator().manual_seed(0),
        ...                            edges=[(0, 1), (2,)],
        ...                            spare_per_edge=1)
        >>> out.ok and torch.equal(out.packets, P)
        True
        """
        K = P.shape[0]
        n_out = [len(ids) + spare_per_edge for ids in edges]
        A = self.multi_edge_coding_matrix(generator, edges, K, n_out)
        return self._run_round(P, A, wan_channel, verify=verify)


@functools.lru_cache(maxsize=None)
def _cached_engine(config: EngineConfig, device: str) -> CodingEngine:
    return CodingEngine(config, device)


def get_engine(config: EngineConfig = _DEFAULT_CONFIG,
               device="cuda") -> CodingEngine:
    """Process-wide engine cache keyed by (EngineConfig, device)."""
    return _cached_engine(config, str(resolve_device(device)))
