"""Decode-server CLI.

    PYTHONPATH=src python -m repro_torch.serve --jobs 12 --K 16 --L 64
    PYTHONPATH=src python -m repro_torch.serve --device cpu

Builds (or loads, ``--trace``) a multi-tenant arrival trace, replays
it through the continuous-batching DecodeServer on the card (or on the
CPU with ``--device cpu``, through the kernels' plain versions), and
prints the throughput / latency report.  ``--sequential`` switches the
bank to the one-launch-per-job baseline; ``--json`` dumps the report.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from .server import serve_trace
from .trace import ServeTrace, poisson_multitenant_trace


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Multi-tenant continuous-batching decode server")
    ap.add_argument("--jobs", type=int, default=12,
                    help="tenant rounds in the generated trace")
    ap.add_argument("--K", type=int, default=16,
                    help="generation size per job")
    ap.add_argument("--L", type=int, default=64,
                    help="payload symbols per packet")
    ap.add_argument("--extra", type=int, default=6,
                    help="redundant packets per job beyond K")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson round-start rate")
    ap.add_argument("--gap", default="exponential",
                    help="straggler profile for packet gaps")
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent jobs held in the decoder bank")
    ap.add_argument("--g-tick", type=int, default=8,
                    help="max packets per job per scheduler tick")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true",
                    help="per-job dispatch baseline (no batching)")
    ap.add_argument("--device", default="cuda",
                    help="where the payloads are decoded (cuda or cpu)")
    ap.add_argument("--trace", default=None,
                    help="serve a recorded trace JSON instead")
    ap.add_argument("--save-trace", default=None,
                    help="record the generated trace to this path")
    ap.add_argument("--json", default=None,
                    help="write the report JSON here")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.trace:
        trace = ServeTrace.load(args.trace)
    else:
        trace = poisson_multitenant_trace(
            args.jobs, args.K, args.L, rate=args.rate, gap=args.gap,
            extra_packets=args.extra, seeded="mixed", seed=args.seed,
            device=args.device)
    if args.save_trace:
        trace.save(args.save_trace)
    rep = serve_trace(trace, slots=args.slots, g_tick=args.g_tick,
                      batched=not args.sequential, device=args.device)
    p50, p99 = rep.latency_percentiles()
    doc = {
        "mode": "sequential" if args.sequential else "batched",
        "device": args.device,
        "jobs": rep.jobs, "completed": rep.completed,
        "packets": rep.packets_ingested,
        "late_dropped": rep.late_dropped,
        "ticks": rep.ticks, "dispatches": rep.dispatches,
        "max_concurrent": rep.max_concurrent,
        "wall_s": rep.wall_s,
        "packets_per_s": rep.packets_per_s,
        "p50_latency_s": p50, "p99_latency_s": p99,
        "completions": [{"job": c.job, "k": c.k,
                         "arrivals": c.arrivals,
                         "payload_sha": c.payload_sha}
                        for c in rep.completions],
    }
    print(f"served {rep.jobs} jobs ({rep.completed} complete) "
          f"mode={doc['mode']} slots={args.slots} g_tick={args.g_tick}")
    print(f"packets={rep.packets_ingested} ticks={rep.ticks} "
          f"dispatches={rep.dispatches} "
          f"max_concurrent={rep.max_concurrent}")
    print(f"{rep.packets_per_s:,.0f} packets/s  "
          f"p50={p50 * 1e3:.1f} ms  p99={p99 * 1e3:.1f} ms")
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(doc, indent=2))
        print(f"wrote {args.json}")
    return doc


if __name__ == "__main__":
    main()
