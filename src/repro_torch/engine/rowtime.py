"""Host time per coding row of the reduced-basis step (`engine.select`).

    PYTHONPATH=src python -m repro_torch.engine.rowtime [--K 64] [--trials 30]

Times three callers of `reduce_row`/`insert_row` on the host, on
the CPU device (no card work), over GF(2^8) with K + 8 coded rows of a
uniform random matrix per trial:

* ``rank_ingest`` — a rank-only `StreamDecoder` (L = 0) ingesting the
  rows as one block: the network simulator's decoder;
* ``payload_plan`` — the host plan of one block of a decoder that
  carries a payload (`stream._BlockPlan`: [B | T] and the tripwire's
  residuals), without the payload product that follows it on the card;
* ``select`` — `incremental_select`, the engine's n > K selection.

Prints one JSON object: microseconds per row for each, the median over
the trials.  The calls it makes have kept their signatures since the
stream decoder was ported, so the same file can time an older checkout
(copy it into that checkout's ``repro_torch/engine/`` and run it with
that checkout's ``src`` on ``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import obs


def _median_us_per_row(fn, rows: torch.Tensor, trials: int) -> float:
    fn(rows)                                        # warm the caches
    times = []
    for _ in range(trials):
        t0 = obs.clock()
        fn(rows)
        times.append(obs.clock() - t0)
    return float(np.median(times)) / rows.shape[0] * 1e6


def measure(K: int = 64, trials: int = 30, s: int = 8, seed: int = 0
            ) -> dict:
    """Microseconds per row for each caller (see the module docstring)."""
    from repro_torch.core.gf import get_field
    from repro_torch.engine.select import incremental_select
    from repro_torch.engine.stream import StreamDecoder, _BlockPlan

    rng = np.random.default_rng(seed)
    A = rng.integers(0, 1 << s, (K + 8, K)).astype(np.uint8)
    A_t = torch.from_numpy(A)
    field = get_field(s)
    B0 = torch.zeros((K, K), dtype=torch.uint8)
    filled0 = torch.zeros((K,), dtype=torch.bool)

    def rank_ingest(rows):
        StreamDecoder(K, 0, s, device="cpu").ingest(rows)

    def payload_plan(rows):
        _BlockPlan(field, B0, filled0, rows, tripwire=True)

    return {
        "K": K, "rows": K + 8, "s": s, "trials": trials,
        "us_per_row": {
            "rank_ingest": _median_us_per_row(rank_ingest, A_t, trials),
            "payload_plan": _median_us_per_row(payload_plan, A_t, trials),
            "select": _median_us_per_row(
                lambda rows: incremental_select(rows, s), A_t, trials),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.engine.rowtime",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--trials", type=int, default=30)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.K, args.trials)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
