"""NetworkSimulator: FedNC vs FedAvg against the same arrival stream.

The port of `repro.sim.simulator`.  Every draw is the reference's numpy
draw, in the reference's order, and the FedNC collector's rank
evolution runs through the port's rank-only
:class:`repro_torch.engine.stream.StreamDecoder` (L = 0: the host
basis, no device work), so a run's `RoundStats` equal the reference's
field for field.

Each simulated round:

1. **Cohort** — `clients_per_round` distinct online clients sampled
   from the population (churned invitations are replaced and counted);
   each participant independently *drops out* with `p_dropout` and
   then never transmits.
2. **Stream** — the event engine builds the round's arrival stream
   (times + sources) from the configured straggler gap distribution
   and the cohort's static slowness factors.
3. **FedNC** — the server feeds arrivals to a
   :class:`repro_torch.engine.stream.StreamDecoder` (real GF(2^s) rank
   evolution, one block per round) and stops at rank
   K_live: `fednc_draws` arrivals, `fednc_time` on the simulated
   clock.  For cohorts too large to carry a K×K basis, the
   ``stages`` decoder samples the identical rank-evolution law —
   draw g is useful with probability 1 − q^(r−K) — as K geometric
   stages (see docs/simulator.md for the equivalence).
4. **FedAvg** — the blind-box collector: the server is done when every
   cohort member has been heard at least once.  A single dropout
   blocks it forever (`fedavg_complete=False`, it waits until
   `timeout`); FedNC just decodes the survivors.

Determinism: everything flows from one `np.random.Generator(seed)`,
so equal seeds give bit-identical traces (tested).  Per-round work is
O(G) numpy + one decoder block of K + 32 rows, G ≈ K·H(K); populations
are O(N) once — 10^6 clients × 100 rounds runs in seconds on CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.coupon import expected_draws_fedavg_asymptotic

from .distributions import DistSpec
from .events import arrival_stream
from .population import ClientPopulation, PopulationConfig


@dataclass(frozen=True)
class SimConfig:
    population: PopulationConfig = field(
        default_factory=PopulationConfig)
    clients_per_round: int = 64
    s: int = 8                    # GF(2^s) of the coded packets
    gap: DistSpec = field(default_factory=DistSpec)   # stream gaps
    delay: Optional[DistSpec] = None   # per-client reorder offsets
    decoder: str = "auto"         # "stream" | "stages" | "auto"
    timeout: float = math.inf     # simulated seconds per round
    seed: int = 0

    # cohorts above this run the geometric-stage rank law instead of
    # carrying a K x K GF basis through the StreamDecoder
    stream_decoder_max_k: int = 512


@dataclass
class RoundStats:
    """One round's measured outcome (simulated clock + draw counts)."""

    round: int
    k: int                  # cohort size
    k_live: int             # cohort members that actually transmit
    n_dropped: int
    n_churned: int
    fednc_draws: int        # arrivals until rank K_live (Prop. 1, measured)
    fednc_time: float       # simulated clock at decode
    fednc_decoded: bool
    fedavg_draws: int       # arrivals until every cohort member heard
    fedavg_time: float
    fedavg_complete: bool
    fedavg_heard: int       # distinct sources heard by completion/timeout


@dataclass
class SimTrace:
    """The per-round stats of one simulation run."""

    config: SimConfig
    rounds: list[RoundStats] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.rounds)

    def column(self, name: str) -> np.ndarray:
        return np.asarray([getattr(r, name) for r in self.rounds])

    def summary(self) -> dict:
        """Aggregate means; the draw ratio uses only rounds where both
        collectors finished (under dropout FedAvg never does)."""
        both = [r for r in self.rounds
                if r.fednc_decoded and r.fedavg_complete]
        out = {
            "rounds": len(self.rounds),
            "k": self.config.clients_per_round,
            "population": self.config.population.n_clients,
            "fednc_decode_rate": float(np.mean(
                self.column("fednc_decoded"))) if self.rounds else 0.0,
            "fedavg_complete_rate": float(np.mean(
                self.column("fedavg_complete"))) if self.rounds else 0.0,
            "n_dropped_mean": float(np.mean(
                self.column("n_dropped"))) if self.rounds else 0.0,
        }
        if both:
            nc = np.asarray([r.fednc_draws for r in both], float)
            avg = np.asarray([r.fedavg_draws for r in both], float)
            t_nc = np.asarray([r.fednc_time for r in both])
            t_avg = np.asarray([r.fedavg_time for r in both])
            out.update(
                fednc_draws_mean=float(nc.mean()),
                fedavg_draws_mean=float(avg.mean()),
                draw_ratio=float(avg.mean() / nc.mean()),
                time_to_rank_k_mean=float(t_nc.mean()),
                time_to_all_k_mean=float(t_avg.mean()),
                time_to_rank_k_p50=float(np.median(t_nc)),
                time_to_all_k_p50=float(np.median(t_avg)),
                time_speedup=float(t_avg.mean() / t_nc.mean()),
            )
        return out


_DEFAULT_CONFIG = SimConfig()    # shared default (ruff B008)


class NetworkSimulator:
    """Event-driven FL network simulation for one SimConfig."""

    def __init__(self, config: SimConfig = _DEFAULT_CONFIG):
        self.config = config
        self.population = ClientPopulation(config.population,
                                           seed=config.seed)
        k = config.clients_per_round
        if config.decoder == "stream":
            self._use_stream = True
        elif config.decoder == "stages":
            self._use_stream = False
        elif config.decoder == "auto":
            self._use_stream = k <= config.stream_decoder_max_k
        else:
            raise ValueError(f"unknown decoder {config.decoder!r}")
        m = self.metrics = obs.MetricsRegistry()
        self._m_rounds = m.counter("sim.rounds")
        self._m_nc_draws = m.counter("sim.fednc_draws")
        self._m_avg_draws = m.counter("sim.fedavg_draws")
        self._m_dropped = m.counter("sim.dropped")

    # -- per-round pieces -------------------------------------------------

    def _fednc_draws_stream(self, rng: np.random.Generator,
                            live: np.ndarray, horizon: int
                            ) -> Optional[int]:
        """Measured rank evolution: feed fresh uniform coded vectors
        (support = live cohort columns) to a StreamDecoder; return the
        arrival count reaching rank K_live (None: not within horizon).

        Blind-box metadata per arrival is a 4-byte row seed — the wire
        format of the seeded kernel family — not a K-symbol row: the
        StreamDecoder regenerates each row (Threefry, bit-identical to
        the reference's) and masks dropout columns (``col_mask``).
        Determinism by SimConfig.seed is preserved (seeds come from the
        same per-round Generator)."""
        from repro_torch.engine.stream import StreamDecoder
        k = live.shape[0]
        k_live = int(live.sum())
        prefix = min(horizon, k + 32)
        seeds = rng.integers(0, 1 << 32, size=prefix, dtype=np.uint32)
        dec = StreamDecoder(K=k, L=0, s=self.config.s)
        ranks = dec.ingest_seeded(seeds, col_mask=live)
        hit = np.nonzero(ranks >= k_live)[0]
        if hit.size == 0:
            return None
        return int(hit[0]) + 1

    def _fednc_draws_stages(self, rng: np.random.Generator,
                            k_live: int) -> int:
        """The same rank-evolution law, sampled: stage r -> r+1 takes
        Geom(1 - q^(r-K)) draws (a uniform vector escapes an r-dim
        subspace of F_q^K with exactly that probability)."""
        q = float(1 << self.config.s)
        p = 1.0 - q ** (np.arange(k_live, dtype=np.float64) - k_live)
        return int(rng.geometric(p).sum())

    def _round(self, t: int, rng: np.random.Generator) -> RoundStats:
        cfg = self.config
        k = cfg.clients_per_round
        cohort, n_churned = self.population.sample_cohort(rng, k)
        live = self.population.dropout_mask(rng, k)
        k_live = int(live.sum())
        n_dropped = k - k_live
        slowness = self.population.slowness[cohort]

        if k_live == 0:
            return RoundStats(t, k, 0, n_dropped, n_churned,
                              0, math.inf, False,
                              0, math.inf, False, 0)

        # -- build a stream long enough for both collectors ------------
        # E[FedAvg draws] = K·H(K) (paper eq. 5 via core.coupon) + slack
        n0 = int(1.6 * expected_draws_fedavg_asymptotic(k_live)) + 64
        while True:
            ev = arrival_stream(rng, live, slowness, cfg.gap,
                                n_events=n0, delay=cfg.delay)
            first = ev.first_arrival_index()
            live_first = first[live]
            # FedNC: measured (stream) or sampled (stages) draw count
            if self._use_stream:
                g_nc = self._fednc_draws_stream(rng, live, n0)
            else:
                g_nc = self._fednc_draws_stages(rng, k_live)
                if g_nc > n0:
                    g_nc = None
            if g_nc is not None and (n_dropped > 0
                                     or (live_first < n0).all()):
                break
            n0 *= 2     # rare: straggler-heavy round outran the horizon

        fednc_time = float(ev.times[g_nc - 1])
        fednc_decoded = fednc_time <= cfg.timeout

        # -- FedAvg: the all-K wait ------------------------------------
        if n_dropped == 0:
            g_avg = int(live_first.max()) + 1
            t_avg = float(ev.times[g_avg - 1])
            complete = t_avg <= cfg.timeout
        else:
            complete = False
            t_avg = cfg.timeout   # blocks on the missing coupon
        if complete:
            heard = k_live
            draws = g_avg
        else:
            horizon_t = min(cfg.timeout, float(ev.times[-1]))
            arrived = live_first < ev.n_events
            heard_t = np.where(arrived, ev.times[
                np.minimum(live_first, ev.n_events - 1)], math.inf)
            heard = int((heard_t <= horizon_t).sum())
            draws = int((ev.times <= horizon_t).sum())
            t_avg = cfg.timeout if math.isfinite(cfg.timeout) \
                else math.inf

        return RoundStats(t, k, k_live, n_dropped, n_churned,
                          int(g_nc), fednc_time, bool(fednc_decoded),
                          int(draws), float(t_avg), bool(complete),
                          heard)

    # -- the run ----------------------------------------------------------

    def run(self, rounds: int) -> SimTrace:
        """Simulate `rounds` rounds; deterministic in `config.seed`."""
        rng = np.random.default_rng(self.config.seed)
        trace = SimTrace(self.config)
        tr = obs.get_tracer()
        for t in range(rounds):
            with tr.span("sim.round", cat="sim", round=t):
                stats = self._round(t, rng)
            trace.rounds.append(stats)
            self._m_rounds.inc()
            self._m_nc_draws.inc(stats.fednc_draws)
            self._m_avg_draws.inc(stats.fedavg_draws)
            self._m_dropped.inc(stats.n_dropped)
            if tr.enabled:
                tr.instant("sim.decode", cat="sim", round=t,
                           draws=stats.fednc_draws,
                           sim_time=stats.fednc_time)
                if stats.fedavg_complete:
                    tr.instant("sim.fedavg_complete", cat="sim",
                               round=t, draws=stats.fedavg_draws)
        return trace
