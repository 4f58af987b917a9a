"""Named Counter / Gauge / Histogram with mergeable JSON snapshots.

The port of `repro.obs.metrics`, plain Python, the same
``fednc-metrics-v1`` documents.  A :class:`MetricsRegistry` is a bag of named instruments; each process
(engine, server, grid worker) keeps its own and snapshots it into a
plain-JSON document tagged ``fednc-metrics-v1``.  Snapshots from
different processes merge associatively (:func:`merge_snapshots`):
counters add, gauges pool min/max/sum/count, histograms add bucket
counts (fixed, identical bounds are required — that is what makes the
merge exact rather than approximate).

The histogram is fixed-bucket on purpose: merging two t-digest-style
sketches is approximate and order-dependent, while summing aligned
bucket counts is exact and associative, which the grid's
process-pool fan-out needs (worker snapshots arrive in completion
order).
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Optional, Sequence

#: schema tag every snapshot carries (validated by scripts/check_bench.py)
METRICS_SCHEMA = "fednc-metrics-v1"


def exp_buckets(lo: float = 1e-5, hi: float = 100.0,
                per_decade: int = 3) -> tuple:
    """Log-spaced bucket bounds covering [lo, hi] — the default for
    latency histograms (10 µs .. 100 s at 3 buckets/decade).

    >>> exp_buckets(0.001, 1.0, per_decade=1)
    (0.001, 0.01, 0.1, 1.0)
    """
    import math
    n_dec = math.log10(hi / lo)
    n = round(n_dec * per_decade)
    return tuple(round(lo * 10 ** (i / per_decade), 12)
                 for i in range(n + 1))


class Counter:
    """Monotonic count: dispatches, ticks, dropped packets.

    >>> c = Counter("demo")
    >>> c.inc(); c.inc(2); c.value
    3
    """

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Sampled level: queue depth, slot occupancy.  Tracks last /
    min / max / sum / count so merged snapshots keep a usable mean.

    >>> g = Gauge("demo")
    >>> g.set(3); g.set(7); (g.min, g.max, g.mean)
    (3.0, 7.0, 5.0)
    """

    __slots__ = ("name", "last", "min", "max", "sum", "count")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.last = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.sum = 0.0
        self.count = 0

    def set(self, value) -> None:
        v = float(value)
        self.last = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"type": self.kind, "last": self.last, "min": self.min,
                "max": self.max, "sum": self.sum, "count": self.count}


class Histogram:
    """Fixed-bucket distribution: job latencies, batch sizes.

    `bounds` are ascending upper edges; an implicit overflow bucket
    catches everything above the last bound, so ``len(counts) ==
    len(bounds) + 1`` and no observation is ever dropped.

    >>> h = Histogram("demo", bounds=(1.0, 2.0, 4.0))
    >>> for v in (0.5, 1.5, 3.0, 100.0): h.observe(v)
    >>> h.counts
    [1, 1, 1, 1]
    >>> h.percentile(0.5) <= h.percentile(0.99)
    True
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min",
                 "max")
    kind = "histogram"

    def __init__(self, name: str, bounds: Sequence[float]):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram bounds must be ascending+unique: {bounds}")
        self.name = name
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value) -> None:
        v = float(value)
        self.counts[bisect_right(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> float:
        """Bucket-interpolated quantile, clamped to observed min/max
        (exact at the tails, bucket-resolution in between)."""
        if not self.count:
            return 0.0
        assert self.min is not None and self.max is not None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.max)
                frac = (target - seen) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def snapshot(self) -> dict:
        return {"type": self.kind, "bounds": list(self.bounds),
                "counts": list(self.counts), "count": self.count,
                "sum": self.sum, "min": self.min, "max": self.max}


class MetricsRegistry:
    """Get-or-create instrument bag with one JSON snapshot.

    >>> reg = MetricsRegistry()
    >>> reg.counter("a").inc(5)
    >>> reg.counter("a").value          # same instrument back
    5
    >>> reg.snapshot()["schema"]
    'fednc-metrics-v1'
    """

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, factory, kind: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory()
        elif m.kind != kind:
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, lambda: Counter(name), "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, lambda: Gauge(name), "gauge")

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        make = lambda: Histogram(name, bounds or exp_buckets())  # noqa: E731
        return self._get(name, make, "histogram")

    def snapshot(self) -> dict:
        return {"schema": METRICS_SCHEMA,
                "metrics": {name: m.snapshot()
                            for name, m in sorted(self._metrics.items())}}


def _merge_metric(name: str, a: dict, b: dict) -> dict:
    if a["type"] != b["type"]:
        raise ValueError(f"metric {name!r}: type mismatch "
                         f"{a['type']} vs {b['type']}")
    t = a["type"]
    if t == "counter":
        return {"type": t, "value": a["value"] + b["value"]}
    def _opt(f, x, y):
        vals = [v for v in (x, y) if v is not None]
        return f(vals) if vals else None
    if t == "gauge":
        return {"type": t, "last": b["last"] if b["count"] else a["last"],
                "min": _opt(min, a["min"], b["min"]),
                "max": _opt(max, a["max"], b["max"]),
                "sum": a["sum"] + b["sum"],
                "count": a["count"] + b["count"]}
    if t == "histogram":
        if list(a["bounds"]) != list(b["bounds"]):
            raise ValueError(f"histogram {name!r}: bucket bounds differ "
                             "— merge would be approximate")
        return {"type": t, "bounds": list(a["bounds"]),
                "counts": [x + y for x, y in zip(a["counts"],
                                                b["counts"],
                                                strict=True)],
                "count": a["count"] + b["count"],
                "sum": a["sum"] + b["sum"],
                "min": _opt(min, a["min"], b["min"]),
                "max": _opt(max, a["max"], b["max"])}
    raise ValueError(f"metric {name!r}: unknown type {t!r}")


def merge_snapshots(*snaps: dict) -> dict:
    """Associatively merge snapshot documents from N processes.

    >>> r1, r2 = MetricsRegistry(), MetricsRegistry()
    >>> r1.counter("n").inc(2); r2.counter("n").inc(3)
    >>> merge_snapshots(r1.snapshot(), r2.snapshot())["metrics"]["n"]["value"]
    5
    """
    merged: dict = {}
    for snap in snaps:
        if snap.get("schema") != METRICS_SCHEMA:
            raise ValueError(
                f"snapshot schema {snap.get('schema')!r} != "
                f"{METRICS_SCHEMA!r}")
        for name, m in snap["metrics"].items():
            merged[name] = (_merge_metric(name, merged[name], m)
                            if name in merged else dict(m))
    return {"schema": METRICS_SCHEMA,
            "metrics": dict(sorted(merged.items()))}
