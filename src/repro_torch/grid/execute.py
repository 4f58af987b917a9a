"""Scenario execution: one function per strategy family + the fan-out.

The port of `repro.grid.execute`.  ``run_scenario`` is a pure function
of its :class:`ScenarioSpec` and device (every random draw flows from
``spec.seed``), so scenarios can run in any order, on any worker, and
reproduce bit-identically.  The backends:

* **simulator** (``fednc_stream`` / ``fednc_stages`` / ``fedavg``) —
  a :class:`repro_torch.sim.NetworkSimulator` run: numpy and the
  rank-only stream decoder on the host, so these cells equal the
  reference's value for value.
* **hierarchy** (``hier:E``) — E-edge fused coding rounds through
  :meth:`repro_torch.engine.CodingEngine.multi_edge_round`, honoring
  the GF-kernel axis; the dropout axis becomes WAN erasure.
* **engine** (``engine``) — flat fused coding rounds through
  :meth:`repro_torch.engine.CodingEngine.round`, honoring the
  GF-kernel axis (the seeded family too), with per-packet wire-byte
  accounting (4-byte seed headers vs K-symbol materialized rows).
* **async FL** (``async`` / ``async_compute``) — a miniature
  end-to-end training run through ``run_async_experiment``; the
  ``async_compute`` variant couples per-client local-training compute
  time into the arrival clock and reports whether the coupled clock
  dominates the network-only one (it must — offsets are positive).

**Round generators.**  Where the reference folds round r into
``PRNGKey(spec.seed)``, the port seeds a fresh *host*
`torch.Generator` from :func:`derived_seed` of ``(spec.seed, r)``; the
payload P and the CNN come from host generators too, and move to the
engine's device.  So a cell draws the same coding rows on the CPU and
on the card, and only the products run on the device.  Rebuilding the
rows a round consumed (the eavesdropper's view) uses a fresh
generator from the same derivation, never the consumed one.

**Devices.**  ``run_scenario(spec, device="cuda")`` runs on the card
unless the caller asks for the CPU; without a card it raises.
``run_grid`` fans scenarios over a spawn-context process pool (CUDA is
never forked), after building the kernels in the parent so that no two
workers start the same first-use build; it runs in-process at
``jobs=1``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.engine.engine import resolve_device

from .spec import (ASYNC_STRATEGIES, ENGINE_STRATEGY, HIER_PREFIX,
                   SIM_STRATEGIES, ScenarioSpec)

# miniature FL workload for the async scenarios: big enough to train,
# small enough that a grid of them stays interactive
ASYNC_N_IMAGES = 160
ASYNC_N_CLIENTS = 8
ASYNC_IMAGE_SIZE = 16
HIER_L = 2048           # payload symbols per client in hier scenarios
HIER_SPARES = 2
# per-tuple interception probability of a collude:c cell (the axis
# parameter is the colluder count; the tap rate stays fixed so cells
# differ in exactly one variable)
COLLUDE_INTERCEPT_P = 0.5
# recovery episodes measured per byzantine cell: each is a full
# retry-until-verified loop, so the cost is bounded here rather than
# growing with the corruption rate
MAX_RECOVERY_EPISODES = 3
# the derivation words of the payload and of a recovery episode (the
# reference's fold_in constants)
PAYLOAD_WORD = 10**6
RECOVERY_WORD = 0x7EC0
#: the CUDA sources the engine and hierarchy cells launch
KERNEL_SOURCES = ("gf_matmul", "gf2_xor")

# envelope spans contain the per-stage spans, so they are excluded
# from a cell's per_stage breakdown (they would double-count it)
_ENVELOPE_SPANS = ("grid.scenario", "grid.engine_rounds",
                   "grid.hier_rounds", "engine.round",
                   "engine.multi_edge_round", "fl.round", "async.round",
                   "serve.trace")


def derived_seed(*words: int) -> int:
    """A 32-bit seed derived from `words` (e.g. ``(spec.seed, r)``) by
    numpy's SeedSequence: a pure function of the words.

    >>> derived_seed(7, 0) == derived_seed(7, 0) != derived_seed(7, 1)
    True
    """
    seq = np.random.SeedSequence([int(w) & 0xFFFFFFFF for w in words])
    return int(seq.generate_state(1, np.uint32)[0])


def host_generator(*words: int) -> torch.Generator:
    """A fresh host generator seeded with :func:`derived_seed`."""
    return torch.Generator().manual_seed(derived_seed(*words))


def _payload(spec: ScenarioSpec, device: torch.device) -> torch.Tensor:
    """The cell's (K, HIER_L) packet matrix, drawn on the host."""
    P = torch.randint(0, 1 << spec.s, (spec.clients_per_round, HIER_L),
                      generator=host_generator(spec.seed, PAYLOAD_WORD),
                      dtype=torch.uint8)
    return P.to(device)


def _sim_metrics(spec: ScenarioSpec) -> dict:
    from repro_torch.core import coupon
    from repro_torch.sim import (STRAGGLER_PROFILES, NetworkSimulator,
                                 PopulationConfig, SimConfig)
    from repro_torch.sim.distributions import DistSpec

    decoder = {"fednc_stream": "stream", "fednc_stages": "stages",
               "fedavg": "stages"}[spec.strategy]
    delay = (DistSpec("exponential", spec.delay_spread, 0.0)
             if spec.delay_spread > 0 else None)
    cfg = SimConfig(
        population=PopulationConfig(n_clients=spec.population,
                                    p_dropout=spec.p_dropout),
        clients_per_round=spec.clients_per_round, s=spec.s,
        gap=STRAGGLER_PROFILES[spec.straggler], delay=delay,
        decoder=decoder,
        timeout=1e4 if spec.p_dropout > 0 else math.inf,
        seed=spec.seed)
    trace = NetworkSimulator(cfg).run(spec.rounds)
    s = trace.summary()

    K = spec.clients_per_round
    kh_k = coupon.expected_draws_fedavg(K)
    predicted = kh_k / coupon.expected_draws_fednc(K, spec.s)
    m = {
        "fednc_decode_rate": s["fednc_decode_rate"],
        "fedavg_complete_rate": s["fedavg_complete_rate"],
        "n_dropped_mean": s["n_dropped_mean"],
        "kh_k": kh_k,
        "predicted_draw_ratio": predicted,
        # null when FedAvg never completed (dropout blocks its last
        # coupon) — the checker accepts null only for p_dropout > 0
        "fednc_draws_mean": s.get("fednc_draws_mean"),
        "fedavg_draws_mean": s.get("fedavg_draws_mean"),
        "draw_ratio": s.get("draw_ratio"),
    }
    if "draw_ratio" in s:
        m["fedavg_inflation"] = s["fedavg_draws_mean"] / kh_k
        m["time_to_rank_k_mean"] = s["time_to_rank_k_mean"]
        m["time_to_all_k_mean"] = s["time_to_all_k_mean"]
        m["time_speedup"] = s["time_speedup"]
    return m


def _hier_metrics(spec: ScenarioSpec, device: torch.device) -> dict:
    from repro_torch.adversary import (AdversarySpec, EavesdropperView,
                                       tap_edges)
    from repro_torch.core.channel import ErasureChannel
    from repro_torch.engine import CodingEngine, EngineConfig

    E = spec.num_edges
    K = spec.clients_per_round
    if E < 1 or K < E:
        raise ValueError(f"hier needs 1 <= E <= K, got E={E} K={K}")
    kernel = spec.kernel if spec.kernel != "-" else "auto"
    engine = CodingEngine(EngineConfig(s=spec.s, kernel=kernel,
                                       chunk_l=HIER_L), device=device)
    bounds = np.linspace(0, K, E + 1).astype(int)
    edges = [tuple(range(bounds[e], bounds[e + 1])) for e in range(E)]
    P = _payload(spec, device)
    wan = (ErasureChannel(p_erase=spec.p_dropout, seed=spec.seed)
           if spec.p_dropout > 0 else None)
    adv = AdversarySpec.parse(spec.adversary)
    n_out = [len(ids) + HIER_SPARES for ids in edges]
    adv_rng = np.random.default_rng(spec.seed ^ 0x5EC)
    ev_reports: list[dict] = []
    ok_rounds = 0
    with obs.timed("grid.hier_rounds", cat="grid",
                   rounds=spec.rounds) as sw:
        out = None
        for r in range(spec.rounds):
            out = engine.multi_edge_round(
                P, host_generator(spec.seed, r), edges,
                spare_per_edge=HIER_SPARES, wan_channel=wan)
            if out.ok:
                assert torch.equal(out.packets, P)
                ok_rounds += 1
            if adv.kind == "eavesdrop":
                # the attacker taps ceil(p·E) edge->server links; the
                # stacked matrix is rebuilt from a fresh generator of
                # the round's derivation (the draw the round consumed)
                n_tap = max(1, math.ceil(adv.param * E))
                tapped = adv_rng.choice(E, size=min(n_tap, E),
                                        replace=False)
                A = engine.multi_edge_coding_matrix(
                    host_generator(spec.seed, r), edges, K, n_out)
                view = EavesdropperView(K=K, s=spec.s)
                view.observe(tap_edges(A, edges, tapped,
                                       spare_per_edge=HIER_SPARES))
                rep = view.report()
                rep["tapped_edges"] = int(len(tapped))
                ev_reports.append(rep)
        if out is not None:      # fence before the clock stops
            sw.fence(out.packets)
    m = {
        "num_edges": E,
        "kernel_resolved": engine.kernel_name,
        "payload_symbols": K * HIER_L,
        "decode_rate": ok_rounds / max(spec.rounds, 1),
        "wall_s_per_round": sw.dur_s / max(spec.rounds, 1),
    }
    if ev_reports:
        partial = [rp for rp in ev_reports
                   if rp["tapped_edges"] < E]
        m.update({
            "tapped_edges_mean": float(np.mean(
                [rp["tapped_edges"] for rp in ev_reports])),
            "eavesdrop_rank_mean": float(np.mean(
                [rp["rank"] for rp in ev_reports])),
            "full_leak_rate": float(np.mean(
                [rp["full_leak"] for rp in ev_reports])),
            # the e < K claim, structurally: any untapped edge leaves
            # its member columns entirely outside the captured span
            "rank_wall_holds": bool(all(rp["rank"] < K
                                        for rp in partial)),
        })
    return m


def _engine_metrics(spec: ScenarioSpec, device: torch.device) -> dict:
    """Flat fused engine rounds honoring the kernel axis: a seeded
    kernel name makes `round()` draw 4-byte row seeds and regenerate
    coefficients in the kernel, and the entry reports the wire
    economics (header bytes per packet drop from K·s/8 to 4) beside
    decode correctness against the known packet matrix."""
    from repro_torch.adversary import AdversarySpec
    from repro_torch.core.channel import ErasureChannel
    from repro_torch.core.packets import packet_wire_bytes
    from repro_torch.engine import CodingEngine, EngineConfig

    K = spec.clients_per_round
    kernel = spec.kernel if spec.kernel != "-" else "auto"
    adv = AdversarySpec.parse(spec.adversary)
    # dropout needs erasure headroom; byzantine detection needs
    # redundant rank for the cross-check (decode_verified docstring)
    extra = (HIER_SPARES if spec.p_dropout > 0
             or adv.kind == "byzantine" else 0)
    engine = CodingEngine(EngineConfig(s=spec.s, kernel=kernel,
                                       chunk_l=HIER_L,
                                       extra_tuples=extra), device=device)
    P = _payload(spec, device)
    channel = (ErasureChannel(p_erase=spec.p_dropout, seed=spec.seed)
               if spec.p_dropout > 0 else None)
    n_tuples = K + extra
    adv_metrics: dict = {}
    ok_rounds = 0
    with obs.timed("grid.engine_rounds", cat="grid",
                   rounds=spec.rounds) as sw:
        if adv.kind == "byzantine":
            out, ok_rounds, adv_metrics = _byzantine_rounds(engine, P,
                                                            spec, adv)
        else:
            out = None
            views = []
            for r in range(spec.rounds):
                out = engine.round(P, host_generator(spec.seed, r),
                                   channel=channel)
                if out.ok:
                    assert torch.equal(out.packets, P)
                    ok_rounds += 1
                if adv.kind in ("eavesdrop", "collude"):
                    views.append(_observe_round(engine, spec, r, n_tuples,
                                                adv))
            if views:
                adv_metrics = _eavesdrop_summary(views, n_tuples, K,
                                                 spec, adv)
        if out is not None:      # fence before the clock stops
            sw.fence(out.packets)
    wire = packet_wire_bytes(K, HIER_L, spec.s, seeded=engine.seeded)
    wire_mat = packet_wire_bytes(K, HIER_L, spec.s, seeded=False)
    return {
        "kernel_resolved": engine.kernel_name,
        "seeded": engine.seeded,
        "payload_symbols": K * HIER_L,
        "decode_rate": ok_rounds / max(spec.rounds, 1),
        "wall_s_per_round": sw.dur_s / max(spec.rounds, 1),
        "wire_bytes_per_packet": wire,
        "wire_bytes_per_round": wire * n_tuples,
        "wire_overhead_ratio": wire / wire_mat,
        **adv_metrics,
    }


def _observe_round(engine, spec: ScenarioSpec, r: int, n_tuples: int,
                   adv) -> dict:
    """Round r through a fresh eavesdropper: rebuild the rows (or 4-byte
    seed headers — the expansion is public, so they hide nothing) the
    engine transmitted, from a fresh generator of the round's
    derivation, give the view its per-tuple interception coin flips
    (seeded with the round's derived seed), and return its report."""
    from repro_torch.adversary import EavesdropperView

    K = spec.clients_per_round
    p = adv.param if adv.kind == "eavesdrop" else COLLUDE_INTERCEPT_P
    colluders = range(adv.count) if adv.kind == "collude" else ()
    gen = host_generator(spec.seed, r)
    if engine.seeded:
        rows = engine.coding_seeds(gen, n_tuples)
    else:
        rows = engine.coding_matrix(gen, n_tuples, K)
    view = EavesdropperView(K=K, s=spec.s, p_intercept=p,
                            seed=derived_seed(spec.seed, r),
                            colluders=colluders)
    view.intercept(rows)
    return view.report()


def _eavesdrop_summary(views: list, n_tuples: int, K: int,
                       spec: ScenarioSpec, adv) -> dict:
    """Aggregate per-round eavesdropper reports + the closed form they
    are validated against (collusion reduces the attacker's problem to
    rank K - c over the quotient space, so the same formula applies
    with K - c unknowns)."""
    from repro_torch.core.security import eavesdropper_leak_probability

    p = adv.param if adv.kind == "eavesdrop" else COLLUDE_INTERCEPT_P
    c = adv.count if adv.kind == "collude" else 0
    m = {
        "intercepted_mean": float(np.mean(
            [v["intercepted"] for v in views])),
        "eavesdrop_rank_mean": float(np.mean(
            [v["rank"] for v in views])),
        "full_leak_rate": float(np.mean(
            [v["full_leak"] for v in views])),
        "residual_entropy_bits_mean": float(np.mean(
            [v["residual_entropy_bits"] for v in views])),
        "leak_probability_closed_form": eavesdropper_leak_probability(
            n_tuples, K - c, p, spec.s),
    }
    if c:
        m["colluders"] = c
        m["sources_recovered_mean"] = float(np.mean(
            [v["sources_recovered"] for v in views]))
    return m


def _byzantine_rounds(engine, P: torch.Tensor, spec: ScenarioSpec, adv):
    """The byzantine engine loop: every round runs with the redundant-
    rank cross-check on, a round is *accepted* only when it decodes and
    is not flagged, and each rejected round is retried with fresh coded
    tuples — ``rounds_to_recovery`` episodes laid end to end.  Returns
    ``(last_out, accepted_and_correct, metrics)``; decode_rate for a
    byzantine cell therefore reads "verified-clean AND actually
    correct rounds / rounds"."""
    from repro_torch.adversary import ByzantineChannel, rounds_to_recovery

    channel = ByzantineChannel(adv.param, seed=spec.seed ^ 0xB12,
                               mode="both")
    recov, flagged, rank_failures = [], 0, 0
    detected = undetected_bad = corrupted_rounds = ok_correct = 0
    out = None
    for r in range(spec.rounds):
        before = channel.corrupted
        out = engine.round(P, host_generator(spec.seed, r),
                           channel=channel, verify=True)
        hit = channel.corrupted > before
        corrupted_rounds += hit
        accepted = out.ok and out.verified is not False
        flagged += int(out.ok and out.verified is False)
        rank_failures += int(not out.ok)
        if accepted:
            correct = torch.equal(out.packets, P)
            ok_correct += int(correct)
            undetected_bad += int(hit and not correct)
        elif hit:
            detected += 1
        if not accepted and len(recov) < MAX_RECOVERY_EPISODES:
            # the server's recovery policy: re-request until verified
            # (measured for the first few rejections only — each
            # episode is a full retry loop, too costly per rejection)
            recov.append(rounds_to_recovery(
                engine, P, host_generator(spec.seed, r, RECOVERY_WORD),
                channel))
    m = {
        "corrupted_round_rate": corrupted_rounds / max(spec.rounds, 1),
        "detection_rate": (detected / corrupted_rounds
                           if corrupted_rounds else 1.0),
        "flagged_rounds": flagged,
        "rank_failures": rank_failures,
        "undetected_bad_decodes": undetected_bad,
        "rounds_to_recovery_mean": (float(np.mean(
            [e["rounds"] for e in recov])) if recov else 1.0),
        "recovery_episodes": len(recov),
    }
    return out, ok_correct, m


def _async_metrics(spec: ScenarioSpec, device: torch.device) -> dict:
    from repro_torch.core.fednc import FedNCConfig
    from repro_torch.core.packets import tree_map
    from repro_torch.data import iid_partition, make_image_dataset
    from repro_torch.federation import (AsyncFedNCStrategy, FLExperiment,
                                        LocalTrainer, blind_box_schedule,
                                        run_async_experiment)
    from repro_torch.models.cnn import (cnn_accuracy, cnn_loss, init_cnn,
                                        merge_bn_stats)
    from repro_torch.optim import adam
    from repro_torch.sim import ComputeModel
    from repro_torch.sim.distributions import STRAGGLER_PROFILES

    k = min(spec.clients_per_round, ASYNC_N_CLIENTS)
    ds = make_image_dataset(ASYNC_N_IMAGES, seed=spec.seed,
                            size=ASYNC_IMAGE_SIZE)
    test = make_image_dataset(64, seed=spec.seed + 1,
                              size=ASYNC_IMAGE_SIZE)
    parts = iid_partition(ds.labels, ASYNC_N_CLIENTS, seed=spec.seed)
    strat = AsyncFedNCStrategy(
        config=FedNCConfig(s=spec.s), budget=k + 8,
        schedule_fn=blind_box_schedule(
            STRAGGLER_PROFILES[spec.straggler]), device=device)
    exp = FLExperiment(
        trainer=LocalTrainer(
            loss_fn=lambda p, b: cnn_loss(p, b, train=True),
            optimizer=adam(1e-3), local_epochs=1,
            state_merge=merge_bn_stats, device=device),
        strategy=strat, partitions=parts, dataset=ds, test_set=test,
        eval_fn=lambda p, x, y: cnn_accuracy(p, x, y),
        clients_per_round=k, batch_size=32, seed=spec.seed)
    params = tree_map(lambda x: x.to(device), init_cnn(
        torch.Generator().manual_seed(spec.seed),
        image_size=ASYNC_IMAGE_SIZE))
    compute = (ComputeModel() if spec.compute_coupled else None)
    logs = run_async_experiment(exp, params, rounds=spec.rounds,
                                eval_every=max(spec.rounds, 1),
                                compute=compute)
    sim_t = np.asarray([log.sim_time for log in logs])
    net_t = np.asarray([log.sim_time_network for log in logs])
    m = {
        "decode_rate": float(np.mean([log.decoded for log in logs])),
        "consumed_mean": float(np.mean([log.consumed for log in logs])),
        "budget": strat.budget,
        "sim_time_mean": float(sim_t.mean()),
        "sim_time_network_mean": float(net_t.mean()),
        "final_train_loss": logs[-1].train_loss,
    }
    if spec.compute_coupled:
        # positive per-client compute offsets must push every round's
        # decode strictly past the network-only clock
        m["compute_dominates"] = bool((sim_t > net_t).all())
        m["compute_overhead_mean"] = float((sim_t - net_t).mean())
    return m


def _run_scenario_events(spec: ScenarioSpec, device="cuda"
                         ) -> tuple[dict, list]:
    """Execute one scenario under a scenario-local tracer.

    A fresh enabled :class:`repro_torch.obs.Tracer` is installed for
    the duration (and the previous tracer restored after), so every
    engine / sim span the scenario emits is captured; the entry's
    ``per_stage`` field is the per-span-name time breakdown.  Returns
    ``(entry, trace_events)`` — both plain picklable data, which is
    what lets :func:`run_grid` ship them back from spawn workers and
    merge the per-process traces by pid lane.
    """
    dev = resolve_device(device)
    prev = obs.get_tracer()
    tr = obs.Tracer(process_name=f"grid:{spec.name}")
    obs.set_tracer(tr)
    try:
        with obs.timed("grid.scenario", cat="grid",
                       scenario=spec.name) as sw:
            if spec.strategy in SIM_STRATEGIES:
                metrics = _sim_metrics(spec)
            elif spec.strategy.startswith(HIER_PREFIX):
                metrics = _hier_metrics(spec, dev)
            elif spec.strategy in ASYNC_STRATEGIES:
                metrics = _async_metrics(spec, dev)
            elif spec.strategy == ENGINE_STRATEGY:
                metrics = _engine_metrics(spec, dev)
            else:
                raise ValueError(f"unknown strategy {spec.strategy!r}")
    finally:
        obs.set_tracer(prev)
    prev.extend(tr.events)       # no-op unless an outer tracer is live
    entry = {
        "seed": spec.seed,
        "axes": spec.axes(),
        "rounds": spec.rounds,
        "clients_per_round": spec.clients_per_round,
        "wall_s": sw.dur_s,
        "per_stage": obs.stage_totals(tr.events,
                                      exclude=_ENVELOPE_SPANS),
        **metrics,
    }
    return entry, tr.events


def run_scenario(spec: ScenarioSpec, device="cuda") -> dict:
    """Execute one scenario on `device`; returns its GRID_*.json entry."""
    return _run_scenario_events(spec, device)[0]


def build_kernels() -> None:
    """Build the CUDA libraries the engine cells load (a no-op when they
    exist), so that spawned workers only load them."""
    from repro_torch.kernels import build
    for name in KERNEL_SOURCES:
        build.build(name)


def run_grid(specs: Sequence[ScenarioSpec], jobs: int = 1,
             progress=None, trace_path=None, device="cuda") -> dict:
    """Run every scenario on `device`; returns ``{name: entry}`` in spec
    order.

    ``jobs > 1`` fans out over a spawn-context process pool (each
    worker is a fresh interpreter; fork would copy a live CUDA
    context).  On the card the kernels are built here first.  Results
    are identical to the serial path; only wall time changes.

    ``trace_path`` writes the merged Chrome trace of every scenario to
    that file — workers keep their own pid, so a ``jobs=N`` run shows
    N process lanes on one epoch-aligned timeline.
    """
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError("duplicate scenario names in grid")
    dev = resolve_device(device)
    all_events: list = []
    if jobs <= 1 or len(specs) <= 1:
        results = {}
        for s in specs:
            results[s.name], events = _run_scenario_events(s, dev)
            all_events.extend(events)
            if progress:
                progress(f"{s.name}: {results[s.name]['wall_s']:.1f}s")
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        if dev.type == "cuda":
            build_kernels()
        ctx = mp.get_context("spawn")
        results: dict[str, Optional[dict]] = {}
        with ProcessPoolExecutor(max_workers=min(jobs, len(specs)),
                                 mp_context=ctx) as pool:
            futures = {s.name: pool.submit(_run_scenario_events, s,
                                           str(dev))
                       for s in specs}
            for name in names:
                results[name], events = futures[name].result()
                all_events.extend(events)
                if progress:
                    progress(f"{name}: "
                             f"{results[name]['wall_s']:.1f}s")
    if trace_path is not None:
        obs.save_events(obs.merge_events(all_events), trace_path)
    # a live outer tracer also receives the merged events (the serial
    # path already extended it per scenario; workers could not)
    if jobs > 1 and len(specs) > 1:
        obs.get_tracer().extend(all_events)
    return results
