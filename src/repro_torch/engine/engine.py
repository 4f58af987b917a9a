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
* **fused channels** — channels exposing `plan_transform` (erasure,
  blind box: a RowGather) are folded into the stream: the pattern is
  decided on the coding matrix first, then encode, channel and decode
  run as one chunk-streamed dispatch.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import packets as pkt
from repro_torch.core import seeds as seedlib
from repro_torch.core.channel import ChannelReport, RowGather
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

    def _fused_channel_round(self, P: torch.Tensor, A: torch.Tensor,
                             channel,
                             seeds: Optional[torch.Tensor] = None
                             ) -> EngineRound:
        """encode -> channel -> select -> decode as ONE streamed dispatch.

        The channel's RowGather plan says which tuples arrive; delivery,
        selection and inversion are resolved on (n, K) matrices, then
        the payload flows through a single `_stream` whose A_post is the
        decode matrix.  GF algebra is exact, so the result is
        bit-identical to the stage-wise reference.
        """
        A = A.cpu()
        n, K = A.shape
        s = self.config.s
        plan = channel.plan_transform(n, s)
        if not isinstance(plan, RowGather):
            raise TypeError(f"unsupported channel plan "
                            f"{type(plan).__name__} (RowGather only)")
        delivered = int(len(plan.idx))
        if delivered < K:
            return EngineRound(False, None, ChannelReport(n, delivered, False))
        idx = torch.as_tensor(plan.idx, dtype=torch.int64)
        A_rx = A[idx]
        ok, sel, _ = incremental_select(A_rx, s)
        report = ChannelReport(n, delivered, ok)
        if not ok:
            return EngineRound(False, None, report)
        _, A_inv = invert(self.field, A_rx[sel])      # sel independent
        rows = idx[sel]
        A_enc = seeds[rows] if seeds is not None else A[rows]
        P_hat = self._stream(A_enc, P, A_post=A_inv,
                             enc_seeded=seeds is not None)
        return EngineRound(True, P_hat, report)

    def _run_round(self, P: torch.Tensor, A: torch.Tensor, channel,
                   seeds: Optional[torch.Tensor] = None) -> EngineRound:
        """Channel dispatch: ideal delivery, or a channel's row plan.
        `seeds`, when given, is the seed vector whose expansion is A."""
        if seeds is not None:
            seeds = seedlib.as_seeds(seeds).cpu()
        if channel is None:
            return self._fused_ideal_round(P, A, seeds)
        if hasattr(channel, "plan_transform"):
            return self._fused_channel_round(P, A, channel, seeds)
        raise TypeError(f"channel {type(channel).__name__} has no "
                        "plan_transform; stage-wise channels are not "
                        "ported")

    # -- the full round ---------------------------------------------------

    def round(self, P: torch.Tensor, generator: torch.Generator,
              channel=None) -> EngineRound:
        """encode -> (channel) -> select -> decode for one packet matrix.

        The coding rows (or row seeds, on a seeded engine) are drawn
        from `generator`, planned and inverted before any L-sized work;
        then encode and decode of each chunk are queued back to back.

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
                                   seeds=seeds)
        return self._run_round(P, self.coding_matrix(generator, n, K),
                               channel)


@functools.lru_cache(maxsize=None)
def _cached_engine(config: EngineConfig, device: str) -> CodingEngine:
    return CodingEngine(config, device)


def get_engine(config: EngineConfig = _DEFAULT_CONFIG,
               device="cuda") -> CodingEngine:
    """Process-wide engine cache keyed by (EngineConfig, device)."""
    return _cached_engine(config, str(resolve_device(device)))
