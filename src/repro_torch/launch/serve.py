"""Serving launcher: the multi-tenant rank-K decode server.

    PYTHONPATH=src python -m repro_torch.launch.serve --jobs 12 --K 16 --L 64

The port of `repro.launch.serve`: "serving" in this repo means decoding
many concurrent federated rounds, which is `repro_torch.serve` (the
continuous-batching `DecoderBank`); this module forwards to that CLI so
the launch entry point works as the reference's does.  The LM serve
*step* lives in `repro_torch.launch.steps.make_serve_step`.
"""
from __future__ import annotations

from repro_torch.serve.cli import build_parser, main

__all__ = ["build_parser", "main"]

if __name__ == "__main__":
    main()
