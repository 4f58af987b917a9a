"""The port's network simulator (`repro_torch.sim`: events, population,
NetworkSimulator) against the JAX package's.

The simulator is numpy apart from the FedNC collector's rank
evolution, which runs through the port's rank-only `StreamDecoder` on
Threefry-expanded row seeds; both packages draw the same numpy stream
in the same order, so arrays and every `RoundStats` field must be
equal exactly.  `tests/data/sim_scale_reference.json` holds the
reference's `summary()` at `examples/sim_scale.py`'s default scale
(10^6 clients, K = 64, 100 rounds, seed 0) for lognormal and pareto
gaps; it is regenerated here from the reference, so it cannot go stale:

    PYTHONPATH=src python tests/test_torch_sim.py    # rewrites it
"""
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest

from repro import obs as jobs
from repro import sim as jsim
from repro_torch import obs as tobs
from repro_torch import sim as tsim

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / \
    "sim_scale_reference.json"
SCALE = {"n_clients": 10**6, "clients_per_round": 64, "rounds": 100,
         "seed": 0}
SCALE_STRAGGLERS = ("lognormal", "pareto")


def _config(pkg, *, n_clients=500, k=16, straggler="exponential",
            decoder="auto", p_dropout=0.0, p_churn=0.0, timeout=math.inf,
            delay=None, s=8, seed=3, **extra):
    return pkg.SimConfig(
        population=pkg.PopulationConfig(n_clients=n_clients,
                                        p_dropout=p_dropout,
                                        p_churn=p_churn),
        clients_per_round=k, s=s, gap=pkg.STRAGGLER_PROFILES[straggler],
        delay=delay, decoder=decoder, timeout=timeout, seed=seed, **extra)


def scale_summaries(pkg) -> dict:
    """`summary()` of each scale run of `pkg` (the reference or the
    port), keyed by straggler profile."""
    out = {}
    for straggler in SCALE_STRAGGLERS:
        cfg = _config(pkg, n_clients=SCALE["n_clients"],
                      k=SCALE["clients_per_round"], straggler=straggler,
                      seed=SCALE["seed"])
        out[straggler] = pkg.NetworkSimulator(cfg).run(
            SCALE["rounds"]).summary()
    return out


def write_fixture() -> None:
    """Regenerate the fixture from the JAX reference."""
    doc = {"source": "repro.sim.NetworkSimulator (the JAX reference), "
                     "examples/sim_scale.py's defaults: decoder auto "
                     "(stream), s = 8",
           "config": SCALE, "summaries": scale_summaries(jsim)}
    FIXTURE.write_text(json.dumps(doc, indent=1) + "\n")


# ---------------------------------------------------------------------------
# events and population
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("straggler", ["constant", "exponential",
                                       "lognormal", "pareto"])
@pytest.mark.parametrize("delay", [None, 0.5])
@pytest.mark.parametrize("dead", [0, 3])
def test_arrival_stream_equals_reference(straggler, delay, dead):
    k = 12
    live = np.ones(k, bool)
    live[:dead] = False
    slowness = np.random.default_rng(0).lognormal(0.0, 0.5, k)
    ev = {}
    for name, pkg in (("ref", jsim), ("port", tsim)):
        spec = (pkg.DistSpec("exponential", delay, 0.0)
                if delay is not None else None)
        rng = np.random.default_rng(9)
        ev[name] = pkg.arrival_stream(rng, live, slowness,
                                      pkg.STRAGGLER_PROFILES[straggler], 200,
                                      delay=spec)
        ev[name + "_next"] = rng.random()       # the generator's state after
    for field in ("times", "sources", "live"):
        np.testing.assert_array_equal(getattr(ev["port"], field),
                                      getattr(ev["ref"], field))
    np.testing.assert_array_equal(ev["port"].first_arrival_index(),
                                  ev["ref"].first_arrival_index())
    assert ev["port"].n_events == ev["ref"].n_events
    assert ev["port_next"] == ev["ref_next"]


def test_arrival_stream_with_nobody_live_is_empty():
    ev = tsim.arrival_stream(np.random.default_rng(0), np.zeros(4, bool),
                             np.ones(4), tsim.DistSpec(), 10)
    assert ev.n_events == 0
    np.testing.assert_array_equal(ev.first_arrival_index(), [0, 0, 0, 0])


@pytest.mark.parametrize("p_churn,p_dropout", [(0.0, 0.0), (0.3, 0.1),
                                               (0.9, 0.5)])
def test_population_cohorts_and_dropout_equal_reference(p_churn, p_dropout):
    pops = {name: pkg.ClientPopulation(pkg.PopulationConfig(
        n_clients=300, p_churn=p_churn, p_dropout=p_dropout), seed=4)
        for name, pkg in (("ref", jsim), ("port", tsim))}
    np.testing.assert_array_equal(pops["port"].slowness,
                                  pops["ref"].slowness)
    rngs = {name: np.random.default_rng(2) for name in pops}
    for k in (1, 16, 29):
        got = {name: pops[name].sample_cohort(rngs[name], k)
               for name in pops}
        np.testing.assert_array_equal(got["port"][0], got["ref"][0])
        assert got["port"][1] == got["ref"][1]
        np.testing.assert_array_equal(
            pops["port"].dropout_mask(rngs["port"], k),
            pops["ref"].dropout_mask(rngs["ref"], k))


def test_population_errors_as_the_reference():
    with pytest.raises(ValueError, match="at least one"):
        tsim.ClientPopulation(tsim.PopulationConfig(n_clients=0))
    pop = tsim.ClientPopulation(tsim.PopulationConfig(n_clients=5))
    with pytest.raises(ValueError, match="exceeds"):
        pop.sample_cohort(np.random.default_rng(0), 6)
    pop = tsim.ClientPopulation(tsim.PopulationConfig(n_clients=5,
                                                      p_churn=1.0))
    with pytest.raises(ValueError, match="nobody"):
        pop.sample_cohort(np.random.default_rng(0), 2)


# ---------------------------------------------------------------------------
# NetworkSimulator, round for round
# ---------------------------------------------------------------------------

CASES = {
    "stream": {"decoder": "stream"},
    "stages": {"decoder": "stages"},
    "auto": {"decoder": "auto"},
    "auto_above_stream_max": {"decoder": "auto", "k": 20,
                              "stream_decoder_max_k": 16},
    "stream_s1": {"decoder": "stream", "s": 1},
    "dropout_timeout": {"decoder": "stream", "p_dropout": 0.15,
                        "timeout": 30.0, "straggler": "pareto"},
    "dropout_no_timeout": {"decoder": "stream", "p_dropout": 0.1},
    "stages_dropout": {"decoder": "stages", "p_dropout": 0.2,
                       "timeout": 1e4},
    "churn": {"decoder": "stream", "p_churn": 0.4, "straggler": "lognormal"},
    "delay": {"decoder": "stream", "straggler": "lognormal",
              "delay": ("exponential", 2.0, 0.0)},
    "tight_timeout": {"decoder": "stream", "timeout": 0.3},
}


def _run(pkg, case: dict, rounds: int = 12):
    case = dict(case)
    delay = case.pop("delay", None)
    cfg = _config(pkg, delay=pkg.DistSpec(*delay) if delay else None,
                  **case)
    sim = pkg.NetworkSimulator(cfg)
    return sim, sim.run(rounds)


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulator_rounds_equal_reference(case):
    (_, jt), (_, tt) = _run(jsim, CASES[case]), _run(tsim, CASES[case])
    assert len(tt) == len(jt) == 12
    for jr, tr in zip(jt.rounds, tt.rounds, strict=True):
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tt.summary() == jt.summary()
    for name in ("fednc_draws", "fedavg_time", "fedavg_heard"):
        np.testing.assert_array_equal(tt.column(name), jt.column(name))


def test_simulator_counters_and_spans_equal_reference():
    case = CASES["dropout_timeout"]
    snaps, spans = {}, {}
    for name, pkg, obs in (("ref", jsim, jobs), ("port", tsim, tobs)):
        tracer = obs.Tracer()
        prev = obs.get_tracer()
        obs.set_tracer(tracer)
        try:
            sim, _ = _run(pkg, case, rounds=5)
        finally:
            obs.set_tracer(prev)
        snaps[name] = {k: v["value"] for k, v in
                       sim.metrics.snapshot()["metrics"].items()}
        spans[name] = [(e["name"], e["ph"], e.get("args", {}).get("round"))
                       for e in tracer.events if e.get("cat") == "sim"]
    assert snaps["port"] == snaps["ref"]
    assert spans["port"] == spans["ref"]
    assert ("sim.round", "X", 4) in spans["port"]


def test_simulator_rejects_an_unknown_decoder():
    with pytest.raises(ValueError, match="unknown decoder"):
        tsim.NetworkSimulator(_config(tsim, decoder="magic"))


# ---------------------------------------------------------------------------
# examples/sim_scale.py's scale: 10^6 clients x 100 rounds, K = 64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_scale() -> dict:
    return scale_summaries(jsim)


#: the fixture's clock fields (time_*) against a live reference: they
#: are reductions over 10^6 clients' draws, whose last bit differs
#: between numpy builds (2.0.2 against 2.3.5: at most 8.415e-16
#: relative), so they are held within a few hundred ulps; the counts and
#: rates exactly
CLOCK_RTOL = 1e-13


def test_fixture_matches_the_reference(reference_scale):
    doc = json.loads(FIXTURE.read_text())
    assert doc["config"] == SCALE
    assert doc["summaries"].keys() == reference_scale.keys()
    for straggler, want in reference_scale.items():
        got = doc["summaries"][straggler]
        assert got.keys() == want.keys()
        for key, value in want.items():
            if key.startswith("time_"):
                assert got[key] == pytest.approx(value, rel=CLOCK_RTOL,
                                                 abs=0), key
            else:
                assert got[key] == value, key


@pytest.mark.parametrize("straggler", SCALE_STRAGGLERS)
def test_simulator_at_scale_equals_fixture_and_reference(straggler,
                                                         reference_scale):
    """The port against the live reference, exactly (one numpy build);
    the fixture is held to the reference above."""
    cfg = _config(tsim, n_clients=SCALE["n_clients"],
                  k=SCALE["clients_per_round"], straggler=straggler,
                  seed=SCALE["seed"])
    got = tsim.NetworkSimulator(cfg).run(SCALE["rounds"]).summary()
    assert got == reference_scale[straggler]
    assert got["rounds"] == 100 and got["population"] == 10**6


def test_sim_exports_cover_the_reference():
    assert set(jsim.__all__) <= set(tsim.__all__)


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE}", file=sys.stderr)
