"""The GRID_*.json artifact and its markdown summary table.

The port of `repro.grid.report` (pure Python, the same schema).

``grid_document`` assembles the structured artifact — schema-tagged so
``scripts/check_bench.py`` can validate it exactly like the
``BENCH_*.json`` family — and ``markdown_report`` renders the human
view (also reachable as ``python scripts/make_report.py --grid``).
"""
from __future__ import annotations

from typing import Mapping

GRID_SCHEMA = "fednc-grid-v1"

#: the coordinate keys every scenario entry records
AXIS_NAMES = ("strategy", "straggler", "delay_spread", "p_dropout",
              "population", "kernel", "adversary")
#: Prop.-1 measurement fields every simulator scenario must carry
#: (null allowed only under dropout, where FedAvg never completes)
DRAW_RATIO_FIELDS = ("fednc_draws_mean", "fedavg_draws_mean",
                     "draw_ratio")


def grid_document(config: dict, scenarios: Mapping[str, dict]) -> dict:
    """Assemble the schema-tagged artifact check_bench validates (the
    reference's document of a grid that is not the full one)."""
    return {
        "schema": GRID_SCHEMA,
        "config": {**config, "full": False},
        "scenarios": dict(scenarios),
    }


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


def markdown_report(doc: dict) -> str:
    """Render one GRID_*.json document as markdown tables."""
    cfg = doc.get("config", {})
    lines = [
        "# Scenario grid report",
        "",
        f"schema `{doc.get('schema', '?')}` · "
        f"K={cfg.get('clients_per_round', '?')} · "
        f"rounds={cfg.get('rounds', '?')} · "
        f"base_seed={cfg.get('base_seed', '?')} · "
        f"{len(doc.get('scenarios', {}))} scenarios",
        "",
        "## Scenarios",
        "",
        "| scenario | strategy | straggler | delay | dropout | pop "
        "| kernel | adversary | draw ratio | FedAvg/K·H(K) "
        "| time speedup | decode rate | leak rate | wall s |",
        "|---|---|---|---:|---:|---:|---|---|---:|---:|---:|---:"
        "|---:|---:|",
    ]
    for name, e in doc.get("scenarios", {}).items():
        ax = e.get("axes", {})
        decode = e.get("decode_rate", e.get("fednc_decode_rate"))
        lines.append(
            "| " + " | ".join([
                f"`{name}`", ax.get("strategy", "?"),
                ax.get("straggler", "?"),
                _fmt(ax.get("delay_spread")), _fmt(ax.get("p_dropout")),
                _fmt(ax.get("population")), ax.get("kernel", "?"),
                ax.get("adversary", "none"),
                _fmt(e.get("draw_ratio")),
                _fmt(e.get("fedavg_inflation")),
                _fmt(e.get("time_speedup")),
                _fmt(decode), _fmt(e.get("full_leak_rate")),
                _fmt(e.get("wall_s")),
            ]) + " |")
    sweep = doc.get("delay_sweep")
    if sweep:
        lines += [
            "",
            "## Delay-reordered sweep (FedAvg inflation over K·H(K))",
            "",
            f"K={sweep.get('clients_per_round', '?')}, "
            f"K·H(K)={_fmt(sweep.get('kh_k'))}; per-client reorder "
            "offsets break the blind-box i.i.d. assumption, so the "
            "FedAvg collector pays *more* than the coupon bound while "
            "FedNC's rank law is order-invariant:",
            "",
            "| reorder spread | FedAvg draws | inflation vs K·H(K) "
            "| FedNC draws | draw ratio |",
            "|---:|---:|---:|---:|---:|",
        ]
        for i, d in enumerate(sweep.get("spreads", [])):
            lines.append(
                f"| {_fmt(d)} | {_fmt(sweep['fedavg_draws_mean'][i])} "
                f"| {_fmt(sweep['inflation'][i])}x "
                f"| {_fmt(sweep['fednc_draws_mean'][i])} "
                f"| {_fmt(sweep['draw_ratio'][i])} |")
    cc = doc.get("compute_coupling")
    if cc:
        lines += [
            "",
            "## Compute-coupled arrivals",
            "",
            f"per-round decode clock with local-training compute folded "
            f"into the schedule: coupled "
            f"{_fmt(cc.get('sim_time_mean'))}s vs network-only "
            f"{_fmt(cc.get('sim_time_network_mean'))}s "
            f"(strict domination: "
            f"{_fmt(cc.get('dominates', cc.get('compute_dominates')))}"
            ").",
        ]
    return "\n".join(lines) + "\n"
