"""Load / validate / merge / summarize Chrome trace-event documents.

The port of `repro.obs.report`, the analysis half of
``repro_torch.obs``: given one or more ``TRACE_*.json`` files (written
by :meth:`repro_torch.obs.Tracer.save` or the reference's tracer), it

* validates them as Chrome trace-event JSON (:func:`validate_trace` —
  the same rules ``scripts/check_bench.py`` enforces standalone),
* merges them onto one timeline (:func:`merge_events` — processes stay
  separated by pid lane, no timestamp rewriting needed because every
  tracer records epoch-anchored microseconds),
* and reduces them to per-stage totals/shares and counter-track stats
  (:func:`summarize`, :func:`stage_totals`) — the numbers
  ``python -m repro_torch.obs`` prints.
"""
from __future__ import annotations

import json
import pathlib
from typing import Iterable

#: phases that carry a duration
_DUR_PHASES = {"X"}
#: metadata events are exempt from ts/pid/tid requirements
_META_PHASES = {"M"}


def load_trace(path) -> list[dict]:
    """Read a trace file; accepts both the ``{"traceEvents": [...]}``
    document form and a bare JSON event array."""
    doc = json.loads(pathlib.Path(path).read_text())
    if isinstance(doc, list):
        return doc
    if isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list):
        return doc["traceEvents"]
    raise ValueError(f"{path}: not a Chrome trace-event document")


def validate_trace(events: Iterable[dict]) -> list[str]:
    """Chrome trace-event structural checks; returns error strings.

    >>> validate_trace([{"name": "a", "ph": "X", "ts": 0.0, "dur": 1.0,
    ...                  "pid": 1, "tid": 0}])
    []
    >>> validate_trace([{"ph": "X"}])[0]
    "event 0: missing field 'name'"
    """
    errors = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            errors.append(f"event {i}: missing field 'ph'")
            continue
        if "name" not in ev:
            errors.append(f"event {i}: missing field 'name'")
            continue
        if ph in _META_PHASES:
            continue
        for field in ("ts", "pid", "tid"):
            if not isinstance(ev.get(field), (int, float)):
                errors.append(
                    f"event {i} ({ev['name']}): non-numeric {field!r}")
        if ph in _DUR_PHASES:
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event {i} ({ev['name']}): X event needs dur >= 0")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                errors.append(
                    f"event {i} ({ev['name']}): C event needs numeric "
                    "args")
    return errors


def merge_events(*event_lists: Iterable[dict]) -> list[dict]:
    """Concatenate per-process event lists and sort by timestamp
    (metadata events first so lane names are set before use)."""
    merged: list[dict] = []
    for evs in event_lists:
        merged.extend(evs)
    merged.sort(key=lambda e: (e.get("ph") not in _META_PHASES,
                               e.get("ts", 0.0)))
    return merged


def stage_totals(events: Iterable[dict],
                 exclude: tuple = ()) -> dict:
    """Total seconds per span name — the per-stage breakdown a grid
    cell publishes.  `exclude` drops envelope spans (e.g. the
    whole-scenario span) that would double-count their children."""
    totals: dict = {}
    for ev in events:
        if ev.get("ph") in _DUR_PHASES and ev["name"] not in exclude:
            totals[ev["name"]] = (totals.get(ev["name"], 0.0)
                                  + ev.get("dur", 0.0) / 1e6)
    return {k: round(v, 9) for k, v in sorted(totals.items())}


def summarize(events: Iterable[dict]) -> dict:
    """Reduce a trace to stages / counters / instants.

    >>> s = summarize([
    ...     {"name": "enc", "ph": "X", "ts": 0, "dur": 2e6, "pid": 1,
    ...      "tid": 0},
    ...     {"name": "enc", "ph": "X", "ts": 2e6, "dur": 2e6, "pid": 1,
    ...      "tid": 0},
    ...     {"name": "q", "ph": "C", "ts": 0, "pid": 1, "tid": 0,
    ...      "args": {"q": 3.0}}])
    >>> s["stages"]["enc"]["count"], s["stages"]["enc"]["share"]
    (2, 1.0)
    >>> s["counters"]["q"]["max"]
    3.0
    """
    stages: dict = {}
    counters: dict = {}
    instants: dict = {}
    pids = set()
    for ev in events:
        ph = ev.get("ph")
        if ph in _META_PHASES:
            continue
        pids.add(ev.get("pid"))
        name = ev.get("name", "?")
        if ph in _DUR_PHASES:
            st = stages.setdefault(name, {"count": 0, "total_s": 0.0})
            st["count"] += 1
            st["total_s"] += ev.get("dur", 0.0) / 1e6
        elif ph == "C":
            for v in (ev.get("args") or {}).values():
                c = counters.setdefault(
                    name, {"n": 0, "sum": 0.0, "min": None,
                           "max": None, "last": None})
                c["n"] += 1
                c["sum"] += v
                c["min"] = v if c["min"] is None else min(c["min"], v)
                c["max"] = v if c["max"] is None else max(c["max"], v)
                c["last"] = v
        elif ph == "i":
            instants[name] = instants.get(name, 0) + 1
    grand = sum(st["total_s"] for st in stages.values())
    for st in stages.values():
        st["total_s"] = round(st["total_s"], 9)
        st["mean_s"] = round(st["total_s"] / st["count"], 9)
        st["share"] = round(st["total_s"] / grand, 6) if grand else 0.0
    for c in counters.values():
        c["mean"] = round(c["sum"] / c["n"], 6) if c["n"] else 0.0
    return {"stages": dict(sorted(stages.items())),
            "counters": dict(sorted(counters.items())),
            "instants": dict(sorted(instants.items())),
            "processes": len(pids),
            "total_span_s": round(grand, 9)}


def markdown_summary(summary: dict, title: str = "trace") -> str:
    """Render :func:`summarize` output as a markdown report."""
    lines = [f"## {title}", ""]
    lines.append(f"{summary['processes']} process lane(s), "
                 f"{summary['total_span_s']:.4f} s total span time")
    if summary["stages"]:
        lines += ["", "| stage | count | total s | mean s | share |",
                  "|---|---:|---:|---:|---:|"]
        for name, st in summary["stages"].items():
            lines.append(
                f"| `{name}` | {st['count']} | {st['total_s']:.5f} "
                f"| {st['mean_s']:.6f} | {100 * st['share']:.1f}% |")
    if summary["counters"]:
        lines += ["", "| counter | samples | min | mean | max | last |",
                  "|---|---:|---:|---:|---:|---:|"]
        for name, c in summary["counters"].items():
            lines.append(
                f"| `{name}` | {c['n']} | {c['min']:g} | {c['mean']:g} "
                f"| {c['max']:g} | {c['last']:g} |")
    if summary["instants"]:
        lines += ["", "| instant | count |", "|---|---:|"]
        for name, n in summary["instants"].items():
            lines.append(f"| `{name}` | {n} |")
    return "\n".join(lines) + "\n"
