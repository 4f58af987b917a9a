"""The vectorized event engine: one round's arrival stream.

The port of `repro.sim.events` (numpy, unchanged): the same generator
gives the same stream, draw for draw.

A round's "events" are the packets the server hears, in the order it
hears them.  The generating model (documented in docs/simulator.md):

* The live cohort multicasts continuously; the server's g-th reception
  is sourced from a uniformly random live participant — exactly the
  paper §IV-A blind-box assumption, which is what makes the measured
  FedAvg draw count coupon-collector distributed and the FedNC one
  rank-K distributed (Prop. 1).
* The *gap* between consecutive receptions is an independent draw from
  the configured straggler distribution, stretched by the source's
  static slowness factor and divided by the number of live emitters
  (aggregate bandwidth grows with the cohort).  Heavy-tailed gaps are
  straggler stalls: the stream freezes while everyone waits on a slow
  uploader.
* An optional per-client *delay* distribution adds a one-per-client
  latency offset and re-sorts — packets from slow clients arrive late
  and out of emission order.  This leaves the blind-box regime (the
  arrival-order source sequence is no longer i.i.d. uniform), which is
  the point: it is the knob Prop. 1 cannot see and only the simulator
  can measure.

Everything is a handful of O(G) numpy kernels — sample, cumsum,
argsort — never a Python loop over events.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .distributions import DistSpec


@dataclass
class RoundEvents:
    """One round's server-side arrival stream, in arrival order."""

    times: np.ndarray     # (G,) nondecreasing simulated clock
    sources: np.ndarray   # (G,) cohort-local source index in [0, k)
    live: np.ndarray      # (k,) bool — which cohort members transmit

    @property
    def n_events(self) -> int:
        return int(self.times.shape[0])

    def first_arrival_index(self) -> np.ndarray:
        """(k,) index of each cohort member's first arrival (n_events
        where it never arrives — dropped clients, short streams)."""
        k = self.live.shape[0]
        first = np.full(k, self.n_events, dtype=np.int64)
        np.minimum.at(first, self.sources,
                      np.arange(self.n_events, dtype=np.int64))
        return first


def arrival_stream(rng: np.random.Generator, live: np.ndarray,
                   slowness: np.ndarray, gap: DistSpec,
                   n_events: int,
                   delay: Optional[DistSpec] = None) -> RoundEvents:
    """Build one round's arrival stream of `n_events` receptions.

    `live` is the (k,) transmit mask, `slowness` the (k,) per-client
    static factors.  Dead clients are never drawn as sources.
    """
    live = np.asarray(live, bool)
    k = live.shape[0]
    live_idx = np.nonzero(live)[0]
    k_live = int(live_idx.shape[0])
    if k_live == 0 or n_events == 0:
        return RoundEvents(np.zeros(0), np.zeros(0, np.int64), live)
    sources = live_idx[rng.integers(0, k_live, size=n_events)]
    gaps = gap.sample(rng, n_events) * slowness[sources] / k_live
    times = np.cumsum(gaps)
    if delay is not None:
        offsets = delay.sample(rng, k)
        times = times + offsets[sources]
        order = np.argsort(times, kind="stable")
        times, sources = times[order], sources[order]
    return RoundEvents(times, sources, live)
