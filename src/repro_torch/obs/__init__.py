"""repro_torch.obs — tracing, metrics, and per-stage profiling.

The port of `repro.obs`, one timing idiom for the port:

* ``with obs.timed("serve.trace") as sw: ...`` — always-on stopwatch;
  ``sw.dur_s`` after.
* ``with obs.get_tracer().span("engine.encode") as sp:
  sp.fence(out)`` — a Chrome trace span that fences device work
  (``torch.cuda.synchronize`` for CUDA tensors), only recorded when
  tracing is enabled (``obs.set_tracer(obs.Tracer())``).
* ``reg = obs.MetricsRegistry(); reg.counter("dispatches").inc()`` —
  mergeable counters/gauges/histograms snapshotting to
  ``fednc-metrics-v1`` JSON.

``python -m repro_torch.obs TRACE.json`` summarizes saved traces.
"""
from repro_torch.obs.metrics import (
    METRICS_SCHEMA,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exp_buckets,
    merge_snapshots,
)
from repro_torch.obs.report import (
    load_trace,
    markdown_summary,
    merge_events,
    stage_totals,
    summarize,
    validate_trace,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    TRACE_SCHEMA,
    NullTracer,
    Tracer,
    clock,
    device_sync,
    events_document,
    get_tracer,
    save_events,
    set_tracer,
    timed,
)

__all__ = [
    "METRICS_SCHEMA", "TRACE_SCHEMA",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "exp_buckets", "merge_snapshots",
    "load_trace", "markdown_summary", "merge_events", "stage_totals",
    "summarize", "validate_trace",
    "NULL_TRACER", "NullTracer", "Tracer", "clock", "device_sync",
    "events_document", "get_tracer", "save_events", "set_tracer",
    "timed",
]
