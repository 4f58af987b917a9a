"""Tick scheduler: per-slot FIFO queues -> fixed-shape padded blocks.

The port of `repro.serve.scheduler` (numpy, unchanged).

The continuous-batching trick (sglang-style chunked prefill, applied
to decoders): arrivals for any mix of jobs are queued per slot, and
every scheduler *tick* drains up to ``g_tick`` tuples from EVERY
slot's queue into one fixed ``(slots, g_tick)`` padded block.  Because
the block shape never changes, every tick is one `DecoderBank.ingest` of
the same shape (one batched launch), no matter how lopsided the per-job
traffic is.

Queues are strictly FIFO and blocks are front-packed (valid tuples at
positions ``0..n-1``, zero padding behind them), which is what makes
per-job completion *arrival counts* invariant to the tick size — the
determinism property tests/test_torch_serve.py pins down.
"""
from __future__ import annotations

from collections import deque

import numpy as np


class FifoScheduler:
    """Per-slot FIFO arrival queues coalesced into padded tick blocks."""

    def __init__(self, slots: int, K: int, L: int, g_tick: int = 8):
        if g_tick < 1:
            raise ValueError("g_tick must be >= 1")
        self.slots, self.K, self.L = int(slots), int(K), int(L)
        self.g_tick = int(g_tick)
        self._q: list[deque] = [deque() for _ in range(self.slots)]

    def enqueue(self, slot: int, *, seed: int, payload,
                row=None) -> None:
        """Queue one coded tuple for `slot`.

        `row` is the materialized (k,) coding row for the materialized
        wire format, or None for the seeded format (the 4-byte `seed`
        is expanded at the tick).  `payload` is the (l,) coded symbols;
        both are zero-padded here to the bank-wide (K,)/(L,) shapes.
        """
        use = row is None
        r = np.zeros((self.K,), np.uint8)
        if row is not None:
            row = np.asarray(row, np.uint8)
            r[: row.shape[0]] = row
        c = np.zeros((self.L,), np.uint8)
        payload = np.asarray(payload, np.uint8)
        c[: payload.shape[0]] = payload
        self._q[int(slot)].append((r, np.uint32(seed), use, c))

    def queue_depth(self, slot: int) -> int:
        return len(self._q[int(slot)])

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._q)

    @property
    def max_depth(self) -> int:
        return max((len(q) for q in self._q), default=0)

    def clear(self, slot: int) -> int:
        """Drop a slot's queued tuples (job completed); returns count."""
        n = len(self._q[int(slot)])
        self._q[int(slot)].clear()
        return n

    def next_block(self):
        """Drain <= g_tick tuples per slot into one padded tick block.

        Returns ``(rows, seeds, use_seed, valid, C)`` with shapes
        ``(slots, g_tick, K) / (slots, g_tick) x3 / (slots, g_tick, L)``
        ready for `DecoderBank.ingest`, or None if every queue is empty.
        """
        if self.pending == 0:
            return None
        J, g = self.slots, self.g_tick
        rows = np.zeros((J, g, self.K), np.uint8)
        seeds = np.zeros((J, g), np.uint32)
        use = np.zeros((J, g), bool)
        valid = np.zeros((J, g), bool)
        C = np.zeros((J, g, self.L), np.uint8)
        for j in range(J):
            q = self._q[j]
            for p in range(min(g, len(q))):
                r, sd, u, c = q.popleft()
                rows[j, p] = r
                seeds[j, p] = sd
                use[j, p] = u
                valid[j, p] = True
                C[j, p] = c
        return rows, seeds, use, valid, C
