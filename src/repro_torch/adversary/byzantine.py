"""Byzantine packet injection and the recovery loop it forces.

The port of `repro.adversary.byzantine`.  :class:`ByzantineChannel` is
an active interior node: each coded tuple crossing it is corrupted
independently with probability `rate`, by XOR with uniform GF(2^s)
noise expanded from 4-byte counters (`repro_torch.core.seeds`).  That
makes every mode the tiny :class:`repro_torch.core.channel.RowTamper`
plan, so a byzantine round still runs through the engine's fused path:

* ``mode="flip"``  — payload symbols flipped, coding row intact;
* ``mode="forge"`` — the coding row replaced while the payload still
  belongs to the old row: a forged header;
* ``mode="both"``  — an arbitrarily hostile relay.

The channel draws only from numpy, exactly as the reference does, so
the same seed gives the same plan (and the same Threefry-expanded
noise) in both packages.  Detection is the redundant-rank cross-check
(`CodingEngine.decode_verified`, ``round(verify=True)``), and
:func:`rounds_to_recovery` measures how many retries a server needs
until a decode passes it.

Replayed seeds — the seeded wire format's own attack, where an old
4-byte header is re-sent with a different payload — are not a per-row
XOR (the forged row duplicates another transmitted row), so they are
modeled on the stream path instead: :func:`replayed_seed_batch` builds
the attack batch, and the server's `StreamDecoder` flags every replay
as an inconsistent dependent arrival.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import seeds as seedlib
from repro_torch.core.channel import ChannelReport, RowTamper
from repro_torch.core.gf import get_field, rank
from repro_torch.core.rlnc import EncodedBatch, SeededBatch

MODES = ("flip", "forge", "both")


class ByzantineChannel:
    """Corrupt each transmitted tuple independently with prob `rate`.

    ``plan_transform`` gives the engine's fused path its RowTamper;
    ``transmit_encoded`` is the stage-wise oracle, drawing the same RNG
    stream and producing bit-identical corruption.
    """

    def __init__(self, rate: float, seed: int = 0, mode: str = "flip"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"corruption rate {rate} outside [0, 1]")
        self.rate = float(rate)
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.corrupted = 0      # tuples tampered with so far

    def plan_transform(self, n: int, s: int) -> RowTamper:
        """This transmission's corruption pattern (one draw of the
        stream `transmit_encoded` consumes)."""
        hit = self.rng.random(n) < self.rate
        idx = np.nonzero(hit)[0]
        m = int(idx.size)
        self.corrupted += m
        # both seed vectors are drawn whatever the mode, so the stream
        # (and every later round) does not depend on the mode
        row_seeds = self.rng.integers(0, 2**32, size=m, dtype=np.uint32)
        payload_seeds = self.rng.integers(0, 2**32, size=m, dtype=np.uint32)
        return RowTamper(
            idx=idx,
            row_seeds=row_seeds if self.mode in ("forge", "both") else None,
            payload_seeds=(payload_seeds if self.mode in ("flip", "both")
                           else None))

    def transmit_encoded(self, batch, s: int
                         ) -> tuple[EncodedBatch, ChannelReport]:
        """Stage-wise oracle for the fused RowTamper path."""
        plan = self.plan_transform(batch.n, s)
        out = apply_tamper(batch, plan, s)
        dec = out.n >= out.K and rank(get_field(s), out.A) == out.K
        return out, ChannelReport(batch.n, out.n, dec)


def apply_tamper(batch, plan: RowTamper, s: int) -> EncodedBatch:
    """Materialize a RowTamper plan against an encoded batch.

    A SeededBatch is expanded first: a corrupted row has no seed.  The
    coding-row noise is expanded where A lies, the payload noise where
    C lies."""
    if isinstance(batch, SeededBatch):
        batch = batch.expand(s)
    A, C = batch.A, batch.C
    if plan.m:
        idx = np.asarray(plan.idx, np.int64)
        if plan.row_seeds is not None:
            A = A.clone()
            i = torch.as_tensor(idx, device=A.device)
            A[i] ^= seedlib.expand_rows(
                seedlib.as_seeds(plan.row_seeds, A.device), batch.K, s)
        if plan.payload_seeds is not None and C.shape[1]:
            C = C.clone()
            i = torch.as_tensor(idx, device=C.device)
            C[i] ^= seedlib.expand_rows(
                seedlib.as_seeds(plan.payload_seeds, C.device),
                int(C.shape[1]), s)
    return EncodedBatch(A=A, C=C)


def replayed_seed_batch(batch: SeededBatch, count: int, s: int = 8,
                        seed: int = 0) -> SeededBatch:
    """Append `count` replayed tuples to a seeded batch: each re-sends
    the 4-byte header of a random earlier tuple with a fresh garbage
    payload.  The replayed rows are exact duplicates in the row space,
    so every one of them reaches the server's basis as a *dependent*
    arrival with a mismatched payload — the precise signature
    `StreamDecoder` counts in ``inconsistent``.  The picks and the
    garbage are the reference's numpy draws; seeds and payloads stay on
    the batch's devices."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, batch.n, size=int(count))
    seeds = batch.seeds
    seeds2 = torch.cat([seeds, seeds[torch.as_tensor(pick,
                                                     device=seeds.device)]])
    L = int(batch.C.shape[1])
    junk = rng.integers(0, 2**s, size=(int(count), L)).astype(np.uint8)
    C2 = torch.cat([batch.C, torch.from_numpy(junk).to(batch.C.device)])
    return SeededBatch(seeds=seeds2, C=C2, K=batch.K)


def rounds_to_recovery(engine, P: torch.Tensor, generator: torch.Generator,
                       channel, max_rounds: int = 64) -> dict:
    """Retry engine rounds against a hostile channel until a decode is
    accepted (rank K reached and the cross-check did not flag it): the
    server discards a flagged round and re-requests fresh tuples, whose
    coding rows each retry draws from `generator`.

    Returns ``rounds`` (1-based count of the accepted round, or
    ``max_rounds`` with ``accepted`` False when the budget ran out),
    ``flagged`` (decodes rejected by verification), ``rank_failures``
    (corruption broke invertibility), ``accepted``, and ``correct`` —
    whether the accepted decode equals P (False is a missed
    detection)."""
    flagged = rank_failures = 0
    for r in range(int(max_rounds)):
        out = engine.round(P, generator, channel, verify=True)
        if not out.ok:
            rank_failures += 1
            continue
        if out.verified is False:
            flagged += 1
            continue
        return {"rounds": r + 1, "flagged": flagged,
                "rank_failures": rank_failures, "accepted": True,
                "correct": bool(torch.equal(out.packets, P))}
    return {"rounds": int(max_rounds), "flagged": flagged,
            "rank_failures": rank_failures, "accepted": False,
            "correct": False}
