"""The port's observability layer against the JAX package's.

`repro_torch.obs` keeps the reference's documents: ``fednc-metrics-v1``
snapshots and ``fednc-trace-v1`` Chrome traces.  Held here: the same
sequence of metric calls gives the same snapshot, percentiles and
merges in both; a trace the port writes passes both validators and
summarizes the same under both reports; fencing is a no-op on the CPU;
and a traced port `CodingEngine` round emits the reference's span
names, with `engine.dispatches` equal to `dispatch_count`.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import obs as jobs
from repro.engine import CodingEngine as JEngine
from repro.engine import EngineConfig as JConfig
from repro_torch import obs as tobs
from repro_torch.core.channel import ErasureChannel
from repro_torch.engine import CodingEngine, EngineConfig


def _drive(o):
    """The same calls on either package's registry."""
    reg = o.MetricsRegistry()
    reg.counter("ticks").inc()
    reg.counter("ticks").inc(4)
    for v in (3, 7, 1, 9):
        reg.gauge("depth").set(v)
    h = reg.histogram("lat", bounds=o.exp_buckets(1e-3, 10.0, 2))
    for v in np.random.default_rng(0).lognormal(-3, 1.5, 200):
        h.observe(v)
    reg.histogram("batch", bounds=[1, 2, 4, 8]).observe(5)
    return reg


def test_metric_snapshots_and_merges_equal_the_reference():
    t, j = _drive(tobs), _drive(jobs)
    assert t.snapshot() == j.snapshot()
    assert json.loads(json.dumps(t.snapshot())) == t.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert t.histogram("lat").percentile(q) == \
            j.histogram("lat").percentile(q)
    assert tobs.merge_snapshots(t.snapshot(), _drive(tobs).snapshot()) == \
        jobs.merge_snapshots(j.snapshot(), _drive(jobs).snapshot())
    assert tobs.exp_buckets() == jobs.exp_buckets()
    with pytest.raises(TypeError):
        t.gauge("ticks")                     # registered as a counter
    with pytest.raises(ValueError):
        tobs.merge_snapshots({"schema": "x", "metrics": {}})


def test_port_traces_pass_both_validators_and_summarize_alike(tmp_path):
    tr = tobs.Tracer(process_name="port")
    with tr.span("stage.a", cat="t", n=1) as sp:
        sp.fence(torch.zeros(4))
    with tr.span("stage.b", cat="t"):
        pass
    tr.instant("mark", cat="t", job=3)
    tr.counter("depth", 4)
    with tobs.timed("stage.a", tracer=tr) as sw:
        pass
    assert sw.dur_s >= 0.0
    path = tr.save(tmp_path / "TRACE_port.json")
    events = tobs.load_trace(path)
    assert json.loads(path.read_text())["otherData"]["schema"] == \
        jobs.TRACE_SCHEMA == tobs.TRACE_SCHEMA
    assert tobs.validate_trace(events) == []
    assert jobs.validate_trace(events) == []
    assert tobs.summarize(events) == jobs.summarize(events)
    assert tobs.stage_totals(events) == jobs.stage_totals(events)
    assert tobs.markdown_summary(tobs.summarize(events)) == \
        jobs.markdown_summary(jobs.summarize(events))
    merged = tobs.merge_events(events, events[1:])
    assert merged == jobs.merge_events(events, events[1:])
    assert tobs.validate_trace([{"ph": "X"}]) == \
        jobs.validate_trace([{"ph": "X"}])


def test_cli_summarizes_and_merges(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    tr = tobs.Tracer()
    with tr.span("engine.encode", cat="engine"):
        pass
    a = tr.save(tmp_path / "a.json")
    assert main([str(a), "--merge", str(tmp_path / "m.json"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["stages"]["engine.encode"][
        "count"] == 1
    assert tobs.validate_trace(tobs.load_trace(tmp_path / "m.json")) == []


def test_device_sync_is_a_no_op_on_the_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("synchronize called for CPU values")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    x = (torch.ones(3), [torch.zeros(2)], {"k": np.ones(2)}, 1.5)
    assert tobs.device_sync(x) is x
    assert tobs.device_sync(None) is None
    with tobs.Tracer().span("s") as sp:
        sp.fence(torch.ones(2))


def _span_names(events):
    return sorted({e["name"] for e in events if e.get("ph") == "X"})


@pytest.mark.parametrize("extra,channel", [(0, False), (2, False),
                                           (2, True)])
def test_traced_round_emits_the_reference_spans(extra, channel, monkeypatch):
    """Same spans, per chunk, as the reference engine for the same round
    shape; engine.dispatches == dispatch_count; the untraced round
    fences nothing."""
    K, L = 4, 200
    P = np.random.default_rng(1).integers(0, 256, (K, L)).astype(np.uint8)
    teng = CodingEngine(EngineConfig(s=8, chunk_l=64, extra_tuples=extra),
                        device="cpu")
    jeng = JEngine(JConfig(s=8, kernel="jnp", chunk_l=64,
                           extra_tuples=extra))
    names = {}
    for side, eng, run in (
            ("port", teng, lambda: teng.round(
                torch.from_numpy(P), torch.Generator().manual_seed(0),
                ErasureChannel(0.2, seed=1) if channel else None)),
            ("ref", jeng, lambda: jeng.round(
                jnp.asarray(P), jax.random.PRNGKey(0), _jchannel(channel)))):
        tracer = (tobs if side == "port" else jobs).set_tracer(
            (tobs if side == "port" else jobs).Tracer())
        try:
            out = run()
        finally:
            (tobs if side == "port" else jobs).set_tracer(
                (tobs if side == "port" else jobs).NULL_TRACER)
        assert bool(out.ok)
        names[side] = _span_names(tracer.events)
        chunks = [e for e in tracer.events if e["name"] == "engine.encode"]
        assert len(chunks) == -(-L // 64)
    assert names["port"] == names["ref"]
    assert teng.metrics.snapshot()["metrics"]["engine.dispatches"][
        "value"] == teng.dispatch_count == 2 * -(-L // 64)
    monkeypatch.setattr(tobs.trace, "device_sync", lambda x: pytest.fail(
        "the untraced round fenced"))
    teng.round(torch.from_numpy(P), torch.Generator().manual_seed(0))


def _jchannel(channel: bool):
    if not channel:
        return None
    from repro.core.channel import ErasureChannel as JErasure
    return JErasure(0.2, seed=1)


def test_traced_multi_edge_round_and_decode_spans():
    K, L = 4, 40
    P = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (K, L)).astype(np.uint8))
    eng = CodingEngine(EngineConfig(s=8), device="cpu")
    tr = tobs.set_tracer(tobs.Tracer())
    try:
        out = eng.multi_edge_round(P, torch.Generator().manual_seed(0),
                                   edges=[(0, 1), (2, 3)], spare_per_edge=1)
        A = eng.coding_matrix(torch.Generator().manual_seed(1), K + 2, K)
        ok, P_hat = eng.decode(eng.encode(P, A))
    finally:
        tobs.set_tracer(tobs.NULL_TRACER)
    assert out.ok and ok and torch.equal(P_hat, P)
    names = _span_names(tr.events)
    for want in ("engine.multi_edge_round", "engine.select", "engine.invert",
                 "engine.encode", "engine.decode"):
        assert want in names
    assert tobs.get_tracer() is tobs.NULL_TRACER
