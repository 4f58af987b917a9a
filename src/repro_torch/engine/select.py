"""Incremental-GE row selection for the n > K erasure path.

The port of `repro.engine.select`: one forward elimination pass that
keeps a reduced row-echelon basis ``B`` (row c holds the normalized
basis vector whose pivot is column c, zero while unfilled).  A
candidate row is selected iff its reduction against the basis is
nonzero — the greedy matroid rule — so the selected index set, the ok
flag and the count equal the reference's, dependent rows included.
The matrices are (n, K) with K in the tens: a Python loop over rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.gf import GF, get_field


def reduce_row(field: GF, B: torch.Tensor, Y: torch.Tensor,
               filled: torch.Tensor, a: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce the candidate row (a, c) against the RREF basis [B | Y] in
    one GF mat-vec (B is RREF, so subtracting a[p]·[B | Y][p] for every
    filled pivot p zeroes all filled pivot columns at once).  Returns
    the residual ``(red_a, red_c)``; ``red_a`` is zero iff the row is
    dependent on the basis."""
    coeffs = torch.where(filled, a, torch.zeros_like(a))
    red_a = a ^ field.matmul(coeffs[None, :], B)[0]
    red_c = c ^ field.matmul(coeffs[None, :], Y)[0]
    return red_a, red_c


def insert_row(field: GF, B: torch.Tensor, Y: torch.Tensor,
               filled: torch.Tensor, red_a: torch.Tensor, red_c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert a nonzero residual (`reduce_row`): normalize it by its
    first nonzero symbol, clear that pivot column from the other rows
    and store it at the pivot.  The same row operations hit Y, keeping
    B[p]·P = Y[p].  Returns new ``(B, Y, filled)``."""
    piv = int(torch.nonzero(red_a != 0)[0, 0])        # first nonzero column
    inv = field.inv(red_a[piv])
    new_a = field.mul(red_a, inv)
    new_c = field.mul(red_c, inv)
    fac = B[:, piv]
    B = B ^ field.mul(fac[:, None], new_a[None, :])
    Y = Y ^ field.mul(fac[:, None], new_c[None, :])
    B[piv] = new_a
    Y[piv] = new_c
    filled = filled.clone()
    filled[piv] = True
    return B, Y, filled


def reduce_insert(field: GF, B: torch.Tensor, Y: torch.Tensor,
                  filled: torch.Tensor, a: torch.Tensor, c: torch.Tensor):
    """One candidate row (a, c) against the RREF basis [B | Y].

    `reduce_row`, then — when the residual is nonzero, i.e. the row is
    independent — `insert_row`.  Returns ``(B, Y, filled,
    was_independent, inconsistent)``; ``inconsistent`` (zero coefficient
    residual, nonzero payload residual) proves a corrupted tuple.
    """
    red_a, red_c = reduce_row(field, B, Y, filled, a, c)
    found = bool((red_a != 0).any())
    bad = (not found) and bool((red_c != 0).any())
    if found:
        B, Y, filled = insert_row(field, B, Y, filled, red_a, red_c)
    return B, Y, filled, found, bad


def incremental_select(A: torch.Tensor, s: int
                       ) -> tuple[bool, torch.Tensor, int]:
    """Greedily pick K independent rows of A (n, K) over GF(2^s).

    Returns ``(ok, idx, count)``: `ok` — full column rank reached;
    `idx` — (K,) int64 selected row indices in scan order (positions >=
    count are 0, as in the reference); `count` — independent rows found.
    Runs on A's device.

    Row 1 below is 2·row 0 over GF(2^8), so the selector skips it:

    >>> A = torch.tensor([[1, 0], [2, 0], [0, 3]], dtype=torch.uint8)
    >>> ok, idx, count = incremental_select(A, 8)
    >>> ok, idx.tolist(), count
    (True, [0, 2], 2)
    """
    n, K = A.shape
    dev = A.device
    field = get_field(s, dev)
    B = torch.zeros((K, K), dtype=torch.uint8, device=dev)
    Y = torch.zeros((K, 0), dtype=torch.uint8, device=dev)
    c0 = torch.zeros((0,), dtype=torch.uint8, device=dev)
    filled = torch.zeros((K,), dtype=torch.bool, device=dev)
    sel = torch.zeros((K,), dtype=torch.int64, device=dev)
    count = 0
    for i in range(n):
        B, Y, filled, found, _ = reduce_insert(field, B, Y, filled,
                                               A[i], c0)
        if found:
            sel[count] = i
            count += 1
    return count == K, sel, count
