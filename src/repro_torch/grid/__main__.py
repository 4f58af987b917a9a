"""``python -m repro_torch.grid`` — run a scenario grid from the command line.

    PYTHONPATH=src python -m repro_torch.grid --smoke --outdir <dir>
    PYTHONPATH=src python -m repro_torch.grid --device cpu \
        --strategies fednc_stream fedavg hier:4 \
        --stragglers lognormal pareto --populations 1000 100000 \
        --rounds 30 --jobs 2 --out mygrid --outdir <dir>

Writes ``GRID_torch_<out>.json`` (schema ``fednc-grid-v1``, validated
by ``scripts/check_bench.py``) and ``GRID_torch_<out>.md`` (the
markdown summary) into ``--outdir``; the ``torch`` infix keeps a run
from the repository root clear of the reference's ``GRID_<out>.*``.  The engine, hierarchy and async cells run
on ``--device`` (``cuda`` by default; without a card the run fails
unless ``--device cpu`` is given).  The smoke grid is the reference's
with the port's kernel names (``cuda_packed``, ``cuda_packed_seeded``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch import obs

from .execute import run_grid
from .report import grid_document, markdown_report
from .spec import GridAxes


def smoke_axes() -> GridAxes:
    """The smoke grid: small enough to finish in about a minute on two
    CPU cores yet covering the StreamDecoder, the blind-box collector,
    and — via the ``engine`` cells — both the materialized and the
    seeded GF-kernel families end-to-end.  The adversary axis
    rides the engine cells (it collapses to ``none`` everywhere else),
    adding an eavesdropper cell validated against the closed-form leak
    probability and a byzantine cell exercising detection + recovery
    per kernel family."""
    return GridAxes(
        strategy=("fednc_stream", "fedavg", "engine"),
        straggler=("exponential", "pareto"),
        population=(2_000,),
        kernel=("cuda_packed", "cuda_packed_seeded"),
        adversary=("none", "eavesdrop:0.6", "byzantine:0.05"),
        clients_per_round=32,
        rounds=10,
        base_seed=7,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.grid",
        description="declarative FedNC scenario-grid runner")
    ap.add_argument("--smoke", action="store_true",
                    help="run the 10-cell smoke grid "
                         "(GRID_torch_smoke.json)")
    ap.add_argument("--strategies", nargs="+",
                    default=["fednc_stream", "fedavg"])
    ap.add_argument("--stragglers", nargs="+",
                    default=["exponential", "pareto"])
    ap.add_argument("--delay-spreads", nargs="+", type=float,
                    default=[0.0])
    ap.add_argument("--dropouts", nargs="+", type=float, default=[0.0])
    ap.add_argument("--populations", nargs="+", type=int,
                    default=[10_000])
    ap.add_argument("--kernels", nargs="+", default=["auto"])
    ap.add_argument("--adversaries", nargs="+", default=["none"],
                    help="adversary axis values: none, eavesdrop:p, "
                         "collude:c, byzantine:b")
    ap.add_argument("--clients-per-round", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=2,
                    help="worker processes (1 = in-process)")
    ap.add_argument("--device", default="cuda",
                    help="where the coding and training cells run "
                         "(cuda or cpu)")
    ap.add_argument("--out", default=None,
                    help="artifact suffix: GRID_torch_<out>.json/.md "
                         "(default: 'smoke' with --smoke, else 'cli')")
    ap.add_argument("--outdir", default=".",
                    help="directory for the GRID_torch_* artifacts")
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="also write the merged Chrome trace "
                         "(default PATH: TRACE_grid_torch_<out>.json)")
    args = ap.parse_args(argv)

    if args.smoke:
        axes = smoke_axes()
        out = args.out or "smoke"
    else:
        axes = GridAxes(
            strategy=tuple(args.strategies),
            straggler=tuple(args.stragglers),
            delay_spread=tuple(args.delay_spreads),
            p_dropout=tuple(args.dropouts),
            population=tuple(args.populations),
            kernel=tuple(args.kernels),
            adversary=tuple(args.adversaries),
            clients_per_round=args.clients_per_round,
            rounds=args.rounds, base_seed=args.seed)
        out = args.out or "cli"

    specs = axes.expand()
    print(f"grid: {len(specs)} scenarios, jobs={args.jobs}", flush=True)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    trace_path = None
    if args.trace is not None:
        trace_path = (pathlib.Path(args.trace) if args.trace
                      else outdir / f"TRACE_grid_torch_{out}.json")
    with obs.timed("grid.run", cat="grid") as sw:
        results = run_grid(
            specs, jobs=args.jobs, trace_path=trace_path,
            device=args.device,
            progress=lambda s: print(f"  {s}", flush=True))

    doc = grid_document(axes.config(), results)
    doc["wall_s"] = sw.dur_s
    json_path = outdir / f"GRID_torch_{out}.json"
    md_path = outdir / f"GRID_torch_{out}.md"
    json_path.write_text(json.dumps(doc, indent=2))
    md_path.write_text(markdown_report(doc))
    print(f"wrote {json_path} and {md_path} ({sw.dur_s:.1f}s total)")
    if trace_path is not None:
        print(f"wrote {trace_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
