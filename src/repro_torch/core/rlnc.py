"""Random Linear Network Coding over GF(2^s) (paper §II-B, Alg. 1).

The port of `repro.core.rlnc`'s batch types, coding-matrix draws and
relay recoding.  Encoded tuples are ``(a_i, C_i)``: the coding vector
and the coded packet.  Every draw takes an explicit `torch.Generator`
and happens on that generator's device.

`recode` is the network-interior operation that Prop. 2's η counts: a
relay holding tuples (A, C) emits fresh random combinations (R·A, R·C)
without ever decoding.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .gf import get_field


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
