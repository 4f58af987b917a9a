"""Incremental-GE row selection for the n > K erasure path.

The port of `repro.engine.select`: one forward elimination pass that
keeps a reduced row-echelon basis ``B`` (row c holds the normalized
basis vector whose pivot is column c, zero while unfilled).  A
candidate row is selected iff its reduction against the basis is
nonzero — the greedy matroid rule — so the selected index set, the ok
flag and the count equal the reference's, dependent rows included.

The row space is tiny (K in the tens) and its loop is sequential, so
it runs on the host in numpy: each GF product is one lookup in the
field's full product table (`field_tables`).  `reduce_row` and
`insert_row` are the reduced-basis step shared with the stream
decoder, which runs them on [B | T] (and on B alone when it tracks the
rank only: a zero-width Y).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.gf import GF, get_field


@functools.lru_cache(maxsize=None)
def field_tables(s: int) -> tuple[np.ndarray, np.ndarray]:
    """The (q, q) product table and the (q,) inverse table of GF(2^s)
    (``inv[0] = 0``), uint8 numpy arrays."""
    field = get_field(s)
    a = torch.arange(1 << s, dtype=torch.uint8)
    return (field.mul(a[:, None], a[None, :]).numpy(),
            field.inv(a).numpy())


def reduce_row(field: GF, B: np.ndarray, Y: np.ndarray, filled: np.ndarray,
               a: np.ndarray, c: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Reduce the candidate row (a, c) against the RREF basis [B | Y]
    (host uint8 arrays; Y and c may have any width, zero included).  B
    is RREF, so subtracting a[p]·[B | Y][p] for every filled pivot p
    zeroes all filled pivot columns at once.  Returns the residual
    ``(red_a, red_c)``; ``red_a`` is zero iff the row is dependent on
    the basis."""
    mul, _ = field_tables(field.s)
    p = np.flatnonzero(filled & (a != 0))
    coeffs = a[p, None]
    red_a = a ^ np.bitwise_xor.reduce(mul[coeffs, B[p]], axis=0)
    red_c = c ^ np.bitwise_xor.reduce(mul[coeffs, Y[p]], axis=0)
    return red_a, red_c


def insert_row(field: GF, B: np.ndarray, Y: np.ndarray, filled: np.ndarray,
               red_a: np.ndarray, red_c: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Insert a nonzero residual (`reduce_row`): normalize it by its
    first nonzero symbol, clear that pivot column from the other rows
    and store it at the pivot.  The same row operations hit Y, keeping
    B[p]·P = Y[p].  Returns new ``(B, Y, filled)``; the inputs are not
    modified."""
    mul, inv = field_tables(field.s)
    piv = int(np.flatnonzero(red_a)[0])        # first nonzero column
    scale = inv[red_a[piv]]
    new_a = mul[red_a, scale]
    new_c = mul[red_c, scale]
    fac = B[:, piv, None]
    B = B ^ mul[fac, new_a]
    Y = Y ^ mul[fac, new_c]
    B[piv] = new_a
    Y[piv] = new_c
    filled = filled.copy()
    filled[piv] = True
    return B, Y, filled


def reduce_insert(field: GF, B: np.ndarray, Y: np.ndarray,
                  filled: np.ndarray, a: np.ndarray, c: np.ndarray):
    """One candidate row (a, c) against the RREF basis [B | Y].

    `reduce_row`, then — when the residual is nonzero, i.e. the row is
    independent — `insert_row`.  Returns ``(B, Y, filled,
    was_independent, inconsistent)``; ``inconsistent`` (zero coefficient
    residual, nonzero payload residual) proves a corrupted tuple.
    """
    red_a, red_c = reduce_row(field, B, Y, filled, a, c)
    found = bool(red_a.any())
    bad = (not found) and bool(red_c.any())
    if found:
        B, Y, filled = insert_row(field, B, Y, filled, red_a, red_c)
    return B, Y, filled, found, bad


def incremental_select(A: torch.Tensor, s: int
                       ) -> tuple[bool, torch.Tensor, int]:
    """Greedily pick K independent rows of A (n, K) over GF(2^s).

    Returns ``(ok, idx, count)``: `ok` — full column rank reached;
    `idx` — (K,) int64 selected row indices in scan order (positions >=
    count are 0, as in the reference), on A's device; `count` —
    independent rows found.  The elimination runs on the host.

    Row 1 below is 2·row 0 over GF(2^8), so the selector skips it:

    >>> A = torch.tensor([[1, 0], [2, 0], [0, 3]], dtype=torch.uint8)
    >>> ok, idx, count = incremental_select(A, 8)
    >>> ok, idx.tolist(), count
    (True, [0, 2], 2)
    """
    n, K = A.shape
    field = get_field(s)
    rows = A.detach().to("cpu", torch.uint8).numpy()
    B = np.zeros((K, K), np.uint8)
    Y = np.zeros((K, 0), np.uint8)
    c0 = np.zeros((0,), np.uint8)
    filled = np.zeros((K,), bool)
    sel = np.zeros((K,), np.int64)
    count = 0
    for i in range(n):
        B, Y, filled, found, _ = reduce_insert(field, B, Y, filled,
                                               rows[i], c0)
        if found:
            sel[count] = i
            count += 1
    return count == K, torch.from_numpy(sel).to(A.device), count
