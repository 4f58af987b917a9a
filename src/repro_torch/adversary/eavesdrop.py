"""EavesdropperView: what a passive attacker actually learns.

The port of `repro.adversary.eavesdrop`.  `core.channel.Eavesdropper`
answers one question per batch (did the intercepted matrix reach rank
K?).  This view is the *stateful* attacker: it accumulates every
intercepted tuple in the same reduced-basis state the server's
:class:`repro_torch.engine.StreamDecoder` keeps — here a rank-only
decoder (L = 0), which lives on the host and launches nothing — so
"what the attacker knows" is a measurable object: achieved rank,
residual entropy, and (with colluding clients seeding the basis with
identity rows) how many individual source packets have been isolated.

The security claim this makes measurable (paper §III-A.2): under RLNC
over GF(2^s), an attacker holding e < K independent combinations can
decode *nothing* — every source packet remains exactly |GF|^(K-e)-fold
ambiguous.  The rank of the attacker's basis is therefore the whole
story, and ``residual_entropy_bits`` = (K - rank)·s·L is the entropy
of what is still hidden (L symbols per packet).

Closed-form reference: `repro_torch.core.security.eavesdropper_leak_probability`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import seeds as seedlib
from repro_torch.engine.stream import StreamDecoder


def _host(x) -> np.ndarray:
    """Rows, seeds or a coding matrix as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def edge_row_slices(edges, spare_per_edge: int = 0) -> list[tuple[int, int]]:
    """Row ranges of each edge's block in the stacked coding matrix
    built by :meth:`CodingEngine.multi_edge_coding_matrix` (edge e
    contributes ``len(edges[e]) + spare_per_edge`` consecutive rows).

    >>> edge_row_slices([(0, 1), (2,)], spare_per_edge=1)
    [(0, 3), (3, 5)]
    """
    out, start = [], 0
    for ids in edges:
        stop = start + len(ids) + int(spare_per_edge)
        out.append((start, stop))
        start = stop
    return out


def tap_edges(A, edges, tapped, spare_per_edge: int = 0) -> np.ndarray:
    """The rows an attacker sitting on edge links `tapped` captures out
    of a stacked hierarchical coding matrix `A` (global coding-vector
    space), as a host uint8 array.  Edge blocks have support only on
    their member columns, so capturing every row of e < E edges still
    spans < K columns — the structural form of the e < K claim."""
    A = _host(A)
    rows = []
    slices = edge_row_slices(edges, spare_per_edge)
    for e in sorted(set(int(t) for t in tapped)):
        start, stop = slices[e]
        rows.append(A[start:stop])
    if not rows:
        return np.zeros((0, A.shape[1]), np.uint8)
    return np.concatenate(rows, axis=0)


class EavesdropperView:
    """Accumulated knowledge of a passive attacker on one stream.

    Feed it whatever crosses the tapped links — materialized (m, K)
    coding rows or (m,) 32-bit seed headers (the 4-byte wire format
    hides nothing: the expansion is public) — via :meth:`observe`, or
    let it flip its own per-tuple coin with :meth:`intercept`.

    `colluders` lists client indices whose plaintext packets the
    attacker already has (colluding clients know their own update):
    each contributes one identity row to the basis for free.

    >>> from repro_torch.core.gf import get_field
    >>> f = get_field(8)
    >>> A = f.random_elements(torch.Generator().manual_seed(0), (6, 4))
    >>> ev = EavesdropperView(K=4)
    >>> ev.observe(A[:3])           # 3 of 4: rank wall not reached
    3
    >>> ev.rank < 4 and not ev.full_leak
    True
    >>> ev.observe(A[3:])
    4
    >>> ev.full_leak                # >= K independent rows captured
    True
    """

    def __init__(self, K: int, s: int = 8, seed: int = 0,
                 p_intercept: float = 0.0, colluders=()):
        self.K, self.s = int(K), int(s)
        self.p = float(p_intercept)
        self.rng = np.random.default_rng(seed)
        self._dec = StreamDecoder(K=self.K, L=0, s=self.s)
        self.intercepted = 0
        self.colluders = tuple(int(i) for i in colluders)
        for i in self.colluders:
            if not 0 <= i < self.K:
                raise ValueError(f"colluder {i} outside range({self.K})")
            e_i = np.zeros((self.K,), np.uint8)
            e_i[i] = 1
            self._dec.push(e_i)

    # -- feeding ----------------------------------------------------------

    def observe(self, rows) -> int:
        """Consume captured coding rows (or seed headers); returns the
        rank afterwards."""
        rows = _host(rows)
        if rows.size:
            self._dec.ingest(rows)
            self.intercepted += int(rows.shape[0])
        return self.rank

    def intercept(self, rows) -> int:
        """Per-tuple interception: each of the transmitted `rows` is
        captured independently with probability ``p_intercept`` (own
        numpy generator, the reference's draws).  Returns how many were
        captured this call.

        Missed tuples are fed as all-zero rows, as the reference feeds
        them: a zero row is a dependent arrival with no payload and
        leaves the basis, the rank and ``inconsistent`` untouched."""
        rows = _host(rows)
        n = int(rows.shape[0])
        got = self.rng.random(n) < self.p
        if rows.ndim == 1:       # 32-bit seed headers: expansion public
            rows = seedlib.expand_rows(seedlib.as_seeds(rows), self.K,
                                       self.s).numpy()
        if n:
            self._dec.ingest(np.where(got[:, None], rows, 0))
        self.intercepted += int(got.sum())
        return int(got.sum())

    # -- what the attacker has --------------------------------------------

    @property
    def rank(self) -> int:
        """Dimension of the attacker's span (colluders included)."""
        return self._dec.rank

    @property
    def full_leak(self) -> bool:
        """rank == K: the attacker can run the same GE the server runs."""
        return self.rank == self.K

    def residual_entropy_bits(self, L: int = 1) -> float:
        """Entropy proxy of what is still hidden: each unresolved basis
        dimension is a uniformly unknown GF(2^s) row of L symbols."""
        return float((self.K - self.rank) * self.s * L)

    def sources_recovered(self) -> int:
        """Source packets the attacker has *isolated* — basis rows that
        reduced to a unit vector.  Always >= len(colluders); grows past
        it only when interception + collusion pin down further columns
        (at rank K it jumps to K: the RREF basis is the identity)."""
        B = self._dec.basis().numpy()
        unit = (B != 0).sum(axis=1) == 1
        diag = B[np.arange(self.K), np.arange(self.K)] == 1
        return int((unit & diag).sum())

    def report(self) -> dict:
        return {
            "intercepted": self.intercepted,
            "colluders": len(self.colluders),
            "rank": self.rank,
            "full_leak": bool(self.full_leak),
            "sources_recovered": self.sources_recovered(),
            "residual_entropy_bits": self.residual_entropy_bits(),
        }
