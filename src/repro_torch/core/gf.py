"""Galois-field GF(2^s) arithmetic for RLNC, on torch tensors.

FedNC mixes model "packets" with coefficients drawn from GF(2^s)
(paper §II-B).  Symbols are s-bit values stored in uint8 (s <= 8).
Addition is XOR; multiplication uses log/antilog tables built from a
primitive polynomial of degree s.

The tables are built once per (field size, device) with numpy and
cached.  Gaussian elimination (`ge_solve`, `rank`, `invert`) is a
Python loop over the K columns of a tiny row-space matrix; it keeps
the reference's pivot rule (first nonzero row at or below the column,
row 0 when there is none) and its ``inv(0) = 0`` sentinel, so even the
result of a singular solve is byte-identical to `repro.core.gf`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

# Primitive polynomials (with the x^s term) for GF(2^s), s = 1..8.
PRIMITIVE_POLY = {
    1: 0b11,          # x + 1
    2: 0b111,         # x^2 + x + 1
    3: 0b1011,        # x^3 + x + 1
    4: 0b10011,       # x^4 + x + 1
    5: 0b100101,      # x^5 + x^2 + 1
    6: 0b1000011,     # x^6 + x + 1
    7: 0b10000011,    # x^7 + x + 1
    8: 0b100011101,   # x^8 + x^4 + x^3 + x^2 + 1 (0x11D)
}


def _build_tables(s: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (exp, log) tables for GF(2^s) as uint8/int32 numpy arrays.

    exp has length 2*(q-1) so that exp[log a + log b] never needs a mod.
    log[0] is set to 0 but is meaningless (multiplication masks zeros).
    """
    if s not in PRIMITIVE_POLY:
        raise ValueError(f"unsupported field size s={s} (need 1..8)")
    q = 1 << s
    poly = PRIMITIVE_POLY[s]
    exp = np.zeros(max(2 * (q - 1), 1), dtype=np.uint8)
    log = np.zeros(q, dtype=np.int32)
    x = 1
    for i in range(q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & q:
            x ^= poly
    for i in range(q - 1, 2 * (q - 1)):
        exp[i] = exp[i - (q - 1)]
    if s == 1:  # q-1 == 1; exp table of len 2 with exp[0]=exp[1]=1
        exp = np.array([1, 1], dtype=np.uint8)
    return exp, log


def _u8(x, device=None) -> torch.Tensor:
    """uint8 tensor on `device` (None: where it already is) from a
    tensor, numpy array or nested list."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.uint8))
    return x.to(device=device, dtype=torch.uint8)


@dataclass(frozen=True)
class GF:
    """A GF(2^s) field with its lookup tables on one device."""

    s: int
    exp: torch.Tensor = field(repr=False)   # uint8, len 2(q-1)
    log: torch.Tensor = field(repr=False)   # int64, len q

    @property
    def q(self) -> int:
        return 1 << self.s

    @property
    def order(self) -> int:  # multiplicative group order
        return self.q - 1

    # ---- element-wise ops (broadcasting, uint8 in / uint8 out) ----

    def add(self, a, b):
        return torch.bitwise_xor(a, b)

    def mul(self, a, b):
        a = _u8(a, self.exp.device)
        b = _u8(b, self.exp.device)
        prod = self.exp[self.log[a.long()] + self.log[b.long()]]
        return torch.where((a != 0) & (b != 0), prod, torch.zeros_like(prod))

    def inv(self, a):
        a = _u8(a, self.exp.device)
        out = self.exp[(self.order - self.log[a.long()]) % self.order]
        # inv(0) := 0 sentinel
        return torch.where(a == 0, torch.zeros_like(out), out)

    # ---- linear algebra ----

    def matmul(self, A, B):
        """GF matrix product: A (n,k) @ B (k,m) -> (n,m), all uint8.

        One broadcast table multiply, then an XOR reduction over k.
        Memory O(n*k*m): the oracle, not the production path (that is
        the lane-packed kernel in repro_torch.kernels).
        """
        A = _u8(A, self.exp.device)
        B = _u8(B, self.exp.device)
        prod = self.mul(A[:, :, None], B[None, :, :])      # (n,k,m)
        return xor_reduce(prod, dim=1)

    def random_elements(self, generator: torch.Generator, shape):
        """Uniform random field elements (including 0), drawn on the
        generator's device."""
        return torch.randint(0, self.q, tuple(shape), generator=generator,
                             device=generator.device, dtype=torch.uint8)

    def random_nonzero(self, generator: torch.Generator, shape):
        return torch.randint(1, max(self.q, 2), tuple(shape),
                             generator=generator, device=generator.device,
                             dtype=torch.uint8)


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduction along a dimension (an empty one reduces to 0)."""
    shape = list(x.shape)
    del shape[dim]
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i in range(x.shape[dim]):
        out ^= x.select(dim, i)
    return out


@functools.lru_cache(maxsize=None)
def _field(s: int, device: str) -> GF:
    exp, log = _build_tables(s)
    return GF(s=s, exp=torch.as_tensor(exp, device=device),
              log=torch.as_tensor(log.astype(np.int64), device=device))


def get_field(s: int, device="cpu") -> GF:
    """The (cached) GF(2^s) field with its tables on `device`."""
    return _field(s, str(torch.device(device)))


# ---------------------------------------------------------------------------
# Gaussian elimination over GF(2^s)
# ---------------------------------------------------------------------------

def _first_true(mask: torch.Tensor) -> int:
    """Index of the first True in a 1-D mask, 0 when there is none —
    the semantics of the reference's ``jnp.argmax(candidates)``."""
    hits = torch.nonzero(mask)
    return int(hits[0, 0]) if hits.numel() else 0


def ge_solve(field: GF, A, C) -> tuple[bool, torch.Tensor]:
    """Solve A @ X = C over GF(2^s) via Gaussian elimination.

    A: (K, K) uint8 coefficient matrix.  C: (K, L) uint8 packets.
    Returns (ok, X): ok is a Python bool (A invertible), X is (K, L)
    uint8 (the reference's garbage when not ok).  Any nonzero pivot is
    exact in GF, so the pivot is the first nonzero row at or below the
    column.
    """
    A = _u8(A, field.exp.device)
    C = _u8(C, field.exp.device)
    K = A.shape[0]
    M = torch.cat([A, C], dim=1)                       # (K, K+L) augmented
    rows = torch.arange(K, device=M.device)
    ok = True
    for col in range(K):
        candidates = (M[:, col] != 0) & (rows >= col)
        piv = _first_true(candidates)                  # first valid pivot
        ok = ok and bool(candidates[piv])
        if piv != col:                                 # swap rows col, piv
            M[[col, piv]] = M[[piv, col]]
        # normalize the pivot row; inv(0)=0 keeps a failed solve finite
        M[col] = field.mul(M[col], field.inv(M[col, col]))
        factors = M[:, col].clone()
        factors[col] = 0
        M = field.add(M, field.mul(factors[:, None], M[col][None, :]))
    return ok, M[:, K:]


def rank(field: GF, A) -> int:
    """Rank of A (n, m) over GF(2^s)."""
    M = _u8(A, field.exp.device).clone()
    n, m = M.shape
    rows = torch.arange(n, device=M.device)
    r = 0
    for col in range(m):
        candidates = (M[:, col] != 0) & (rows >= r)
        piv = _first_true(candidates)
        if not bool(candidates[piv]):
            continue
        if piv != r:
            M[[r, piv]] = M[[piv, r]]
        M[r] = field.mul(M[r], field.inv(M[r, col]))
        factors = M[:, col].clone()
        factors[r] = 0
        M = field.add(M, field.mul(factors[:, None], M[r][None, :]))
        r += 1
    return r


def invert(field: GF, A) -> tuple[bool, torch.Tensor]:
    """(ok, A_inv) over GF(2^s)."""
    K = A.shape[0]
    eye = torch.eye(K, dtype=torch.uint8, device=field.exp.device)
    return ge_solve(field, A, eye)
