"""repro_torch.serve — the multi-tenant decode server on the card.

The port of `repro.serve`:

trace.py     — ServeJob/ServeTrace arrival streams (JSON round-trip)
               and the Poisson multi-tenant workload generator built
               on repro_torch.sim's straggler distributions.
scheduler.py — FifoScheduler: per-slot FIFO queues drained into
               fixed-shape padded tick blocks (continuous batching).
server.py    — DecodeServer over engine.DecoderBank: one batched
               kernel launch per tick across every in-flight round,
               rank-K completion events, waiting-job admission;
               serve_trace offline replay driver -> ServeReport.
cli.py       — `python -m repro_torch.serve`: build/load a trace, serve
               it, print and optionally dump the report.
"""
from .scheduler import FifoScheduler
from .server import (DecodeServer, JobCompletion, ServeReport,
                     payload_digest, serve_trace)
from .trace import (ServeJob, ServeTrace, job_packets,
                    poisson_multitenant_trace)

__all__ = [
    "DecodeServer", "FifoScheduler", "JobCompletion", "ServeJob",
    "ServeReport", "ServeTrace", "job_packets", "payload_digest",
    "poisson_multitenant_trace", "serve_trace",
]
