"""The tracing core: Chrome trace-event JSON, one timing idiom.

The port of `repro.obs.trace`, under the same ``fednc-trace-v1``
documents.  Two primitives share one clock:

* :class:`Tracer` — an *enabled* tracer records spans
  (:meth:`Tracer.span`, Chrome ``"X"`` complete events), instants
  (``"i"``) and counter samples (``"C"``) into an in-memory event
  list that saves as Chrome trace-event JSON (open it in Perfetto /
  ``chrome://tracing``).  The module-level active tracer defaults to
  :data:`NULL_TRACER`, whose ``span()`` returns a shared no-op
  context manager — no timestamps are taken, no events allocated, so
  hot paths (per-chunk kernel launches, per-tick server loops) pay
  essentially nothing when tracing is off.
* :func:`timed` — an always-on stopwatch for the wall numbers call
  sites need regardless of tracing.  When the active tracer is enabled
  the same measurement also lands in the trace as a span, so enabling
  tracing never changes *what* is measured, only whether it is
  recorded.

Spans fence device work before the clock stops
(:meth:`Span.fence` -> :func:`device_sync` ->
``torch.cuda.synchronize``), so a traced span measures *device* time —
kernel launches otherwise return to Python with the kernel still in
flight and the span would under-report.  CPU tensors need no fence.

Event timestamps are epoch-anchored microseconds
(``time_ns`` offset measured once per process against
``perf_counter_ns``), so traces recorded by different processes merge
onto one timeline, each process in its own pid lane.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from typing import Optional

import torch

#: schema tag recorded in the trace document's ``otherData``
TRACE_SCHEMA = "fednc-trace-v1"

# perf_counter gives the best-resolution monotonic durations; the
# offset anchors its arbitrary origin to the epoch once per process so
# per-process lanes share a timeline when merged
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()  # fednc: ignore[FNC001] the port's obs module owns the clock


def clock() -> float:
    """Monotonic seconds — THE clock every obs measurement uses."""
    return time.perf_counter()  # fednc: ignore[FNC001] the port's obs module owns the clock


def _cuda_devices(x, found: set) -> None:
    """Collect the CUDA devices of the tensors in `x` (a tensor, or a
    tuple, list or dict of them, nested)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)


def device_sync(x):
    """Fence: block until the work behind every CUDA tensor in `x`
    finished (``torch.cuda.synchronize`` of each device they lie on).

    A no-op for None, CPU tensors and values that hold no tensor
    (plain floats, numpy arrays), so call sites can pass whatever the
    block produced without caring about its type.  Returns `x`."""
    if x is None:
        return x
    found: set = set()
    _cuda_devices(x, found)
    for dev in found:
        torch.cuda.synchronize(dev)
    return x


class Span:
    """One traced section: ``with tracer.span("engine.encode") as sp``.

    ``sp.fence(out)`` registers device output to block on before the
    clock stops (so the span measures device time, not dispatch time);
    ``sp.dur_s`` holds the duration after exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_pending",
                 "dur_s")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._pending = None
        self.dur_s = 0.0

    def fence(self, x):
        """Block on `x` (device work) just before the span closes."""
        self._pending = x
        return x

    def set(self, **args) -> "Span":
        """Attach/override span args from inside the block."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()  # fednc: ignore[FNC001] the port's obs module owns the clock
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._pending is not None:
            device_sync(self._pending)
            self._pending = None
        t1 = time.perf_counter_ns()  # fednc: ignore[FNC001] the port's obs module owns the clock
        self.dur_s = (t1 - self._t0) / 1e9
        self._tracer._complete(self.name, self.cat, self._t0, t1,
                               self.args)
        return False


class _NullSpan:
    """The shared do-nothing span :data:`NULL_TRACER` hands out."""

    __slots__ = ()
    dur_s = 0.0

    def fence(self, x):
        return x

    def set(self, **args) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a no-op, no time is read."""

    enabled = False
    events: tuple = ()

    def span(self, name: str, cat: str = "", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "", **args) -> None:
        pass

    def counter(self, name: str, value, cat: str = "") -> None:
        pass

    def extend(self, events) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """An enabled tracer accumulating Chrome trace events in memory.

    >>> tr = Tracer(process_name="doctest")
    >>> with tr.span("work", cat="demo", items=3):
    ...     pass
    >>> tr.instant("mark", cat="demo")
    >>> tr.counter("depth", 4)
    >>> [e["ph"] for e in tr.events if e["ph"] != "M"]
    ['X', 'i', 'C']
    """

    enabled = True

    def __init__(self, process_name: Optional[str] = None):
        self.events: list[dict] = []
        self.pid = os.getpid()
        self._tids: dict[int, int] = {}
        self._lock = threading.Lock()
        if process_name:
            self.events.append({
                "name": "process_name", "ph": "M", "pid": self.pid,
                "tid": 0, "args": {"name": str(process_name)},
            })

    # -- internals --------------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    @staticmethod
    def _ts(t_ns: int) -> float:
        return (t_ns + _EPOCH_OFFSET_NS) / 1e3       # epoch microseconds

    def _complete(self, name: str, cat: str, t0_ns: int, t1_ns: int,
                  args: dict) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._ts(t0_ns), "dur": (t1_ns - t0_ns) / 1e3,
              "pid": self.pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- the emitting API -------------------------------------------------

    def span(self, name: str, cat: str = "", **args) -> Span:
        """A duration ("X") event as a context manager."""
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """A point-in-time ("i") event (arrivals, completions, ...)."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._ts(time.perf_counter_ns()),  # fednc: ignore[FNC001] the port's obs module owns the clock
              "pid": self.pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, value, cat: str = "") -> None:
        """A counter-track ("C") sample — Perfetto renders these as
        per-tick counter lanes (queue depth, slot occupancy, ...)."""
        self.events.append({
            "name": name, "cat": cat, "ph": "C",
            "ts": self._ts(time.perf_counter_ns()),  # fednc: ignore[FNC001] the port's obs module owns the clock
            "pid": self.pid, "tid": self._tid(),
            "args": {name: float(value)},
        })

    def extend(self, events) -> None:
        """Merge events recorded elsewhere (e.g. a worker process —
        they keep their own pid, so they land in their own lane)."""
        self.events.extend(events)

    # -- the document -----------------------------------------------------

    def to_document(self) -> dict:
        return events_document(self.events)

    def save(self, path) -> pathlib.Path:
        return save_events(self.events, path)


def events_document(events) -> dict:
    """Wrap an event list as a Chrome trace-event JSON document."""
    return {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "otherData": {"schema": TRACE_SCHEMA},
    }


def save_events(events, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.write_text(json.dumps(events_document(events)))
    return path


# -- the active tracer ------------------------------------------------------

_active: "Tracer | NullTracer" = NULL_TRACER


def get_tracer():
    """The process-wide active tracer (NULL_TRACER unless enabled)."""
    return _active


def set_tracer(tracer):
    """Install `tracer` as the active tracer; returns it.

    ``set_tracer(NULL_TRACER)`` disables tracing again."""
    global _active
    _active = tracer
    return tracer


class Stopwatch:
    """Always-on timing: measures even when tracing is disabled, and
    additionally emits a span into `tracer` when it is enabled."""

    __slots__ = ("name", "cat", "args", "_tracer", "_pending", "_t0",
                 "dur_s")

    def __init__(self, name: str, cat: str, tracer, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self._tracer = tracer
        self._pending = None
        self.dur_s = 0.0

    def fence(self, x):
        """Block on `x` (device work) before the clock stops."""
        self._pending = x
        return x

    def set(self, **args) -> "Stopwatch":
        self.args.update(args)
        return self

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter_ns()  # fednc: ignore[FNC001] the port's obs module owns the clock
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._pending is not None:
            device_sync(self._pending)
            self._pending = None
        t1 = time.perf_counter_ns()  # fednc: ignore[FNC001] the port's obs module owns the clock
        self.dur_s = (t1 - self._t0) / 1e9
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr._complete(self.name, self.cat, self._t0, t1, self.args)
        return False


_USE_ACTIVE = object()


def timed(name: str, cat: str = "", tracer=_USE_ACTIVE,
          **args) -> Stopwatch:
    """The repo-wide stopwatch idiom (replaces raw ``perf_counter``).

    >>> with timed("demo.sleep", cat="demo") as sw:
    ...     _ = sum(range(10))
    >>> sw.dur_s >= 0.0
    True
    """
    if tracer is _USE_ACTIVE:
        tracer = get_tracer()
    return Stopwatch(name, cat, tracer, args)
