"""Random Linear Network Coding over GF(2^s) (paper §II-B, Alg. 1).

The port of `repro.core.rlnc`: the batch types, coding-matrix and seed
draws, the function API (`encode`, `encode_seeded`, `decodable`,
`decode`, `select_rows`), relay recoding and the float-field baseline.
Encoded tuples are ``(a_i, C_i)``: the coding vector and the coded
packet.  Every draw takes an explicit `torch.Generator` and happens on
that generator's device.  The L-sized products run through the kernel
facade (`repro_torch.kernels.ops`) on the payload's device; the (n, K)
row space (rank, inversion, selection) runs on the host.

`recode` is the network-interior operation that Prop. 2's η counts: a
relay holding tuples (A, C) emits fresh random combinations (R·A, R·C)
without ever decoding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .gf import get_field, invert, rank as gf_rank


@dataclass(frozen=True)
class EncodedBatch:
    """Encoded tuples: A (n, K) coding matrix, C (n, L) coded packets."""

    A: torch.Tensor
    C: torch.Tensor

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def K(self) -> int:
        return self.A.shape[1]

    def __getitem__(self, idx) -> "EncodedBatch":
        return EncodedBatch(A=self.A[idx], C=self.C[idx])

    def concat(self, other: "EncodedBatch") -> "EncodedBatch":
        return EncodedBatch(A=torch.cat([self.A, other.A], 0),
                            C=torch.cat([self.C, other.C], 0))


@dataclass(frozen=True)
class SeededBatch:
    """n seed-addressed encoded tuples: 4-byte seeds instead of rows.

    ``K`` is carried explicitly because it is no longer readable off
    the (absent) coding matrix.
    """

    seeds: torch.Tensor           # (n,) int64 row seeds (32-bit values)
    C: torch.Tensor               # (n, L) uint8 coded payloads
    K: int                        # generation size (columns of A)

    @property
    def n(self) -> int:
        return self.seeds.shape[0]

    def __getitem__(self, idx) -> "SeededBatch":
        return SeededBatch(seeds=self.seeds[idx], C=self.C[idx], K=self.K)

    def concat(self, other: "SeededBatch") -> "SeededBatch":
        if other.K != self.K:
            raise ValueError("generation sizes differ")
        return SeededBatch(seeds=torch.cat([self.seeds, other.seeds], 0),
                           C=torch.cat([self.C, other.C], 0), K=self.K)

    def expand(self, s: int) -> EncodedBatch:
        """Materialize the coding matrix (on the seeds' device):
        ``expand(s).A == seeds.expand_rows(seeds, K, s)``."""
        from .seeds import expand_rows
        return EncodedBatch(A=expand_rows(self.seeds, self.K, s), C=self.C)


def random_coding_matrix(generator: torch.Generator, n: int, K: int,
                         s: int) -> torch.Tensor:
    """n random coding vectors over GF(2^s) — uniform incl. zero."""
    return get_field(s).random_elements(generator, (n, K))


def random_coding_seeds(generator: torch.Generator, n: int
                        ) -> torch.Tensor:
    """n row seeds (int64 holding 32-bit values) — the seed-addressed
    RLNC draw; ``seeds.expand_rows(random_coding_seeds(g, n), K, s)``
    has rows uniform over GF(2^s)^K."""
    from .seeds import draw_seeds
    return draw_seeds(generator, n)


def encode_seeded(P: torch.Tensor, seeds, s: int, *,
                  impl: str = "auto_seeded") -> SeededBatch:
    """C = rows(seeds)·P without materializing the coding matrix.

    `impl` names a seeded registry kernel (``auto_seeded``,
    ``cuda_packed_seeded``, ``table_seeded``); the batch decodes
    identically to ``encode(P, expand_rows(seeds, K, s), s)``."""
    from .seeds import as_seeds
    from repro_torch.kernels.ops import gf_matmul  # call-time: avoids a cycle
    seeds = as_seeds(seeds, P.device)
    C = gf_matmul(seeds, P, s=s, impl=impl)
    return SeededBatch(seeds=seeds, C=C, K=int(P.shape[0]))


def encode(P: torch.Tensor, A, s: int, *, impl: str = "auto"
           ) -> EncodedBatch:
    """C = A·P over GF(2^s).  P: (K, L) symbols, A: (n, K) coefficients;
    `impl` is a registry name (``auto`` is the packed kernel)."""
    from repro_torch.kernels.ops import gf_matmul  # call-time: avoids a cycle
    A = torch.as_tensor(A, dtype=torch.uint8)
    C = gf_matmul(A.to(P.device), P, s=s, impl=impl)
    return EncodedBatch(A=A, C=C)


def sparse_coding_matrix(generator: torch.Generator, n: int, K: int,
                         s: int, density: float = 0.5) -> torch.Tensor:
    """Sparse RLNC: each coefficient is zero w.p. (1-density), nonzero
    uniform otherwise, with at least one nonzero per row."""
    dev = generator.device
    vals = get_field(s).random_nonzero(generator, (n, K))
    keep = torch.rand((n, K), generator=generator, device=dev) < density
    col = torch.randint(0, K, (n,), generator=generator, device=dev)
    keep[torch.arange(n, device=dev), col] = True
    return torch.where(keep, vals, torch.zeros_like(vals))


def systematic_coding_matrix(generator: torch.Generator, n: int, K: int,
                             s: int) -> torch.Tensor:
    """First K rows identity (original packets), remaining rows random."""
    eye = torch.eye(K, dtype=torch.uint8, device=generator.device)
    if n <= K:
        return eye[:n]
    extra = get_field(s).random_elements(generator, (n - K, K))
    return torch.cat([eye, extra], dim=0)


def recode(batch, generator: torch.Generator, n_out: int, s: int, *,
           impl: str = "auto") -> EncodedBatch:
    """Relay recoding: emit `n_out` fresh random combinations of the
    received tuples; new coding vectors compose linearly, A' = R·A.

    Thin adapter over :meth:`repro_torch.engine.CodingEngine.recode` on
    the engine of the batch's payload device, with the registry kernel
    named by `impl`."""
    from repro_torch.engine import EngineConfig, get_engine  # avoids a cycle
    return get_engine(EngineConfig(s=s, kernel=impl),
                      device=batch.C.device).recode(batch, generator, n_out)


def decodable(batch: EncodedBatch, s: int) -> bool:
    """True iff the received coding matrix has full column rank K."""
    return gf_rank(get_field(s), batch.A.cpu()) == batch.K


def decode(batch: EncodedBatch, s: int
           ) -> tuple[bool, Optional[torch.Tensor]]:
    """(ok, P_hat): decode K tuples (Alg. 1).  A is inverted on the host
    and A^-1·C runs through the ``auto`` kernel (the packed one) on C's
    device — the same symbols as the reference's Gaussian elimination of
    [A | C].  Needs n == K (select rows first otherwise); P_hat is None
    when A is singular."""
    if batch.n != batch.K:
        raise ValueError(
            f"decode needs square A; got {batch.n} tuples for K={batch.K}")
    from repro_torch.kernels.ops import gf_matmul  # call-time: avoids a cycle
    ok, A_inv = invert(get_field(s), batch.A.cpu())
    if not ok:
        return False, None
    return True, gf_matmul(A_inv.to(batch.C.device), batch.C, s=s)


def select_rows(batch: EncodedBatch, s: int
                ) -> tuple[bool, EncodedBatch]:
    """(ok, K-row batch): greedily pick K linearly independent tuples
    out of n >= K in row order (`repro_torch.engine.select`)."""
    from repro_torch.engine.select import incremental_select
    ok, idx, _ = incremental_select(batch.A.cpu(), s)
    return ok, EncodedBatch(A=batch.A[idx.to(batch.A.device)],
                            C=batch.C[idx.to(batch.C.device)])


def select_decodable_rows(batch: EncodedBatch, s: int) -> EncodedBatch:
    """Greedy K-independent-row selection (legacy signature); prefer
    :func:`select_rows`, which also reports whether rank K was reached."""
    return select_rows(batch, s)[1]


# ---------------------------------------------------------------------------
# float-field RLNC (the in-datacenter variant)
# ---------------------------------------------------------------------------

def float_coding_matrix(generator: torch.Generator, n: int, K: int
                        ) -> torch.Tensor:
    """Random real (Gaussian) coefficients: invertible almost surely."""
    return torch.randn((n, K), generator=generator, dtype=torch.float32,
                       device=generator.device)


def float_encode(P: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """C = A @ P over the reals.  P: (K, L) float updates."""
    return A.to(P.dtype) @ P


def float_decode(A: torch.Tensor, C: torch.Tensor
                 ) -> tuple[bool, torch.Tensor]:
    """(ok, P_hat) by a linear solve; ok = every entry finite."""
    P_hat = torch.linalg.solve(A.to(torch.float32), C.to(torch.float32))
    return bool(torch.isfinite(P_hat).all()), P_hat.to(C.dtype)
