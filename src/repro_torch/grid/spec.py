"""Scenario axes and their expansion into frozen ScenarioSpec records.

The port of `repro.grid.spec` (pure Python): the same axes give the
same scenario names and seeds.

The grid is a cartesian product over seven axes; a scenario is one cell.
Two properties the rest of the machinery leans on:

* **Normalization before product** — axes that cannot affect a
  strategy are collapsed to a canonical value before the product is
  deduplicated (the GF kernel never touches the network simulator;
  delay reordering never touches a hierarchical coding round), so the
  grid enumerates *distinct measurements*, not redundant reruns.
* **Stable seeds** — each scenario's seed is
  ``crc32(name) ^ base_seed``: a pure function of the scenario's own
  coordinates.  Growing the grid, reordering axes, or filtering
  scenarios never changes the seed (and therefore the trace) of any
  existing cell.
"""
from __future__ import annotations

import itertools
import zlib
from dataclasses import dataclass

#: strategy families -> which executor runs them (see execute.py)
SIM_STRATEGIES = ("fednc_stream", "fednc_stages", "fedavg")
HIER_PREFIX = "hier:"          # "hier:4" = §III hierarchy at E=4 edges
ASYNC_STRATEGIES = ("async", "async_compute")
ENGINE_STRATEGY = "engine"     # flat fused engine rounds (kernel axis)


def scenario_seed(name: str, base_seed: int = 0) -> int:
    """Deterministic, order-independent per-scenario seed."""
    return (zlib.crc32(name.encode("utf-8")) ^ (base_seed & 0xFFFFFFFF)
            ) & 0x7FFFFFFF


@dataclass(frozen=True)
class ScenarioSpec:
    """One grid cell: every knob a scenario run needs, picklable."""

    name: str
    strategy: str              # SIM_STRATEGIES | "hier:E" | ASYNC_*
    straggler: str             # repro_torch.sim.STRAGGLER_PROFILES key
    delay_spread: float        # mean per-client reorder offset; 0 = off
    p_dropout: float           # mid-round silent-failure probability
    population: int            # clients in the population
    kernel: str                # engine registry name ("-" = unused)
    clients_per_round: int
    rounds: int
    s: int = 8
    seed: int = 0
    adversary: str = "none"    # repro_torch.adversary axis (kind:param)

    @property
    def num_edges(self) -> int:
        """E for hierarchical strategies, 0 otherwise."""
        if self.strategy.startswith(HIER_PREFIX):
            return int(self.strategy[len(HIER_PREFIX):])
        return 0

    @property
    def compute_coupled(self) -> bool:
        return self.strategy == "async_compute"

    def axes(self) -> dict:
        """The scenario's coordinates, as recorded in GRID_*.json."""
        return {
            "strategy": self.strategy,
            "straggler": self.straggler,
            "delay_spread": self.delay_spread,
            "p_dropout": self.p_dropout,
            "population": self.population,
            "kernel": self.kernel,
            "adversary": self.adversary,
        }


@dataclass(frozen=True)
class GridAxes:
    """The declarative grid: list the values per axis, call expand().

    >>> g = GridAxes(strategy=("fednc_stream", "fedavg"),
    ...              straggler=("exponential", "pareto"))
    >>> [s.name for s in g.expand()]  # doctest: +NORMALIZE_WHITESPACE
    ['fednc_stream-exponential-d0-p0-n10000-k-',
     'fednc_stream-pareto-d0-p0-n10000-k-',
     'fedavg-exponential-d0-p0-n10000-k-',
     'fedavg-pareto-d0-p0-n10000-k-']
    """

    strategy: tuple = ("fednc_stream", "fedavg")
    straggler: tuple = ("exponential", "pareto")
    delay_spread: tuple = (0.0,)
    p_dropout: tuple = (0.0,)
    population: tuple = (10_000,)
    kernel: tuple = ("auto",)
    adversary: tuple = ("none",)
    # shared (non-axis) knobs
    clients_per_round: int = 32
    rounds: int = 20
    s: int = 8
    base_seed: int = 0

    def expand(self) -> list:
        """Normalized, deduplicated cartesian expansion."""
        specs: list[ScenarioSpec] = []
        seen: set[str] = set()
        for combo in itertools.product(
                self.strategy, self.straggler, self.delay_spread,
                self.p_dropout, self.population, self.kernel,
                self.adversary):
            spec = self._make(*combo)
            if spec.name in seen:
                continue
            seen.add(spec.name)
            specs.append(spec)
        return specs

    def _make(self, strategy: str, straggler: str, delay: float,
              dropout: float, population: int, kernel: str,
              adversary: str = "none") -> ScenarioSpec:
        from repro_torch.adversary.spec import AdversarySpec
        adv = AdversarySpec.parse(adversary)    # validate early
        if strategy in SIM_STRATEGIES:
            kernel = "-"          # simulator never runs a GF kernel
            adv = AdversarySpec()  # arrival stream carries no payload
        elif strategy.startswith(HIER_PREFIX):
            delay = 0.0           # no arrival stream in a coding round
            straggler = "-"
            population = self.clients_per_round
            if adv.kind != "eavesdrop":
                # hierarchical cells model the edge-link tap; active /
                # colluding adversaries are the flat engine's axis
                adv = AdversarySpec()
        elif strategy in ASYNC_STRATEGIES:
            kernel = "-"          # engine kernel fixed by FedNCConfig
            dropout = 0.0         # async driver has no dropout knob yet
            delay = 0.0           # schedule_fn owns the arrival model
            adv = AdversarySpec()  # no per-round coded batch to attack
        elif strategy == ENGINE_STRATEGY:
            delay = 0.0           # no arrival stream in a coding round
            straggler = "-"
            population = self.clients_per_round
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        name = (f"{strategy.replace(':', '')}-{straggler}"
                f"-d{delay:g}-p{dropout:g}-n{population}-k{kernel}")
        # suffix only under an active adversary, so adding the axis
        # never renames (= never reseeds) any pre-existing cell
        if not adv.none:
            name += f"-a{adv.tag}"
        return ScenarioSpec(
            name=name, strategy=strategy, straggler=straggler,
            delay_spread=float(delay), p_dropout=float(dropout),
            population=int(population), kernel=kernel,
            clients_per_round=self.clients_per_round,
            rounds=self.rounds, s=self.s,
            seed=scenario_seed(name, self.base_seed),
            adversary=str(adv))

    def config(self) -> dict:
        """The grid-level record written into GRID_*.json."""
        return {
            "axes": {
                "strategy": list(self.strategy),
                "straggler": list(self.straggler),
                "delay_spread": list(self.delay_spread),
                "p_dropout": list(self.p_dropout),
                "population": list(self.population),
                "kernel": list(self.kernel),
                "adversary": list(self.adversary),
            },
            "clients_per_round": self.clients_per_round,
            "rounds": self.rounds,
            "s": self.s,
            "base_seed": self.base_seed,
        }

