"""CLI: merge and summarize Chrome trace files.

    PYTHONPATH=src python -m repro_torch.obs TRACE_serve.json
    PYTHONPATH=src python -m repro_torch.obs TRACE_a.json TRACE_b.json \\
        --merge TRACE_all.json --json
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.report import (
    load_trace,
    markdown_summary,
    merge_events,
    summarize,
    validate_trace,
)
from repro_torch.obs.trace import save_events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="validate, merge, and summarize Chrome trace files")
    ap.add_argument("traces", nargs="+", help="TRACE_*.json files")
    ap.add_argument("--merge", metavar="OUT",
                    help="write the merged trace document to OUT")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of markdown")
    args = ap.parse_args(argv)

    lists = []
    for path in args.traces:
        events = load_trace(path)
        errors = validate_trace(events)
        if errors:
            for e in errors[:10]:
                print(f"{path}: {e}", file=sys.stderr)
            return 1
        lists.append(events)
    events = merge_events(*lists)

    if args.merge:
        save_events(events, args.merge)
        print(f"wrote {args.merge} ({len(events)} events)",
              file=sys.stderr)

    s = summarize(events)
    if args.json:
        print(json.dumps(s, indent=2))
    else:
        title = " + ".join(args.traces)
        print(markdown_summary(s, title=title), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
