"""Multi-tenant arrival traces: the decode server's input format.

The port of `repro.serve.trace`.  A *trace* is the interleaved packet
stream a decode server hears when many federated rounds (jobs) are in
flight at once: for every packet, an arrival time, the job it belongs
to, its coding metadata, and its coded payload.  Coding metadata is
always recorded as the 32-bit row seed that generated the coefficients
(`repro_torch.core.seeds`); whether a packet *ships* that seed (the
seeded wire format) or the materialized K-symbol row it expands to is a
per-job property (``ServeJob.seeded``), so one trace exercises both wire
formats side by side.

:func:`poisson_multitenant_trace` builds the benchmark/test workload:
job round-starts form a Poisson process, and each job's packets arrive
with gaps drawn from a straggler distribution (`repro_torch.sim`),
merged across tenants into one time-ordered stream.

Traces serialize to JSON (:meth:`ServeTrace.save` / ``load``,
``fednc-serve-trace-v1``, the reference's format), so a recorded trace —
the committed fixture ``tests/data/serve_trace.json`` among them —
replays bit-identically in either package.
"""
from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.gf import get_field
from repro_torch.core.packets import packet_wire_bytes
from repro_torch.core.seeds import expand_rows
from repro_torch.engine.engine import resolve_device
from repro_torch.kernels.gf_matmul import gf_matmul_packed
from repro_torch.sim import STRAGGLER_PROFILES, DistSpec

TRACE_SCHEMA = "fednc-serve-trace-v1"


@dataclass(frozen=True)
class ServeJob:
    """One tenant round: generation size K, payload width L, wire format."""

    job: int
    K: int
    L: int
    seeded: bool          # ships 4-byte seeds (True) or K-symbol rows
    t_start: float        # round start on the trace clock


@dataclass
class ServeTrace:
    """A recorded multi-tenant packet stream, in arrival order."""

    s: int
    jobs: list[ServeJob]
    times: np.ndarray        # (G,) nondecreasing trace clock
    job_of: np.ndarray       # (G,) job id per packet
    row_seeds: np.ndarray    # (G,) uint32 coefficient seed per packet
    payloads: np.ndarray     # (G, max_l) uint8, zero-padded per packet
    extra: dict = field(default_factory=dict)   # fixture expectations etc.

    @property
    def n_packets(self) -> int:
        return int(self.times.shape[0])

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def max_k(self) -> int:
        return max(j.K for j in self.jobs)

    @property
    def max_l(self) -> int:
        return max(j.L for j in self.jobs)

    def packet_indices(self, job: int) -> np.ndarray:
        """Trace positions of one job's packets, in arrival order."""
        return np.nonzero(self.job_of == job)[0]

    def wire_bytes(self) -> int:
        """Total bytes this trace occupies on the wire (header+payload,
        per each job's format)."""
        total = 0
        for j in self.jobs:
            n = int(self.packet_indices(j.job).shape[0])
            total += n * packet_wire_bytes(j.K, j.L, self.s,
                                           seeded=j.seeded)
        return total

    # -- JSON round trip (regression fixtures) ----------------------------

    def to_json(self) -> str:
        doc = {
            "schema": TRACE_SCHEMA,
            "s": self.s,
            "jobs": [{"job": j.job, "K": j.K, "L": j.L,
                      "seeded": j.seeded, "t_start": j.t_start}
                     for j in self.jobs],
            "times": [float(t) for t in self.times],
            "job_of": [int(j) for j in self.job_of],
            "row_seeds": [int(x) for x in self.row_seeds],
            "payloads": [[int(b) for b in row] for row in self.payloads],
            "extra": self.extra,
        }
        return json.dumps(doc, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "ServeTrace":
        doc = json.loads(text)
        if doc.get("schema") != TRACE_SCHEMA:
            raise ValueError(f"not a serve trace: {doc.get('schema')!r}")
        jobs = [ServeJob(job=j["job"], K=j["K"], L=j["L"],
                         seeded=j["seeded"], t_start=j["t_start"])
                for j in doc["jobs"]]
        return cls(
            s=doc["s"], jobs=jobs,
            times=np.asarray(doc["times"], np.float64),
            job_of=np.asarray(doc["job_of"], np.int64),
            row_seeds=np.asarray(doc["row_seeds"], np.uint32),
            payloads=np.asarray(doc["payloads"], np.uint8).reshape(
                len(doc["times"]), -1),
            extra=doc.get("extra", {}),
        )

    def save(self, path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "ServeTrace":
        return cls.from_json(pathlib.Path(path).read_text())


def _per_job(value, n_jobs: int, name: str) -> list:
    if isinstance(value, (int, np.integer, bool, np.bool_)):
        return [value] * n_jobs
    out = list(value)
    if len(out) != n_jobs:
        raise ValueError(f"{name} must be scalar or length {n_jobs}")
    return out


def job_packets(seed: int, job: int, K: int, L: int, s: int = 8
                ) -> torch.Tensor:
    """Job `job`'s (K, L) packet matrix in the trace generated with
    `seed`: uniform GF(2^s) symbols from a CPU `torch.Generator` seeded
    from (seed, job), on the host."""
    state = np.random.SeedSequence([int(seed), int(job)]).generate_state(2)
    gen = torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))
    return get_field(s).random_elements(gen, (K, L))


def poisson_multitenant_trace(
        n_jobs: int, K, L, s: int = 8, *,
        rate: float = 4.0, gap: str | DistSpec = "exponential",
        extra_packets: int = 6, seeded="mixed",
        duplicate_rate: float = 0.0, seed: int = 0,
        device="cuda") -> ServeTrace:
    """The benchmark workload: Poisson round starts, straggler gaps.

    `n_jobs` tenant rounds start at exponential(1/`rate`) spacing; job
    j uploads ``K_j + extra_packets`` coded tuples whose inter-arrival
    gaps are drawn from the `gap` straggler distribution
    (`repro_torch.sim.STRAGGLER_PROFILES` name or a DistSpec).  `K`/`L`
    may be scalars or per-job sequences; ``seeded="mixed"`` alternates
    the wire format per job (or pass a bool / per-job sequence).
    ``duplicate_rate`` re-sends the previous packet (same seed, same
    payload) with that probability.

    Times, job ids, seeds and duplicates come from one
    ``np.random.default_rng(seed)`` drawn in the reference's order, so
    ``times``, ``job_of`` and ``row_seeds`` equal the reference's for
    equal arguments.  Job j's packets are :func:`job_packets`, drawn
    from a torch generator: their bytes differ from the reference's
    `jax.random` payloads, whose stream no other framework reproduces
    (and which changed under jax 0.9.0).  The coded payloads
    C = rows(seeds)·P are computed by the packed GF kernel on `device`
    (its plain version on the CPU) and kept on the host.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Ks = _per_job(K, n_jobs, "K")
    Ls = _per_job(L, n_jobs, "L")
    if seeded == "mixed":
        seeds_flag = [j % 2 == 0 for j in range(n_jobs)]
    else:
        seeds_flag = [bool(x) for x in _per_job(seeded, n_jobs,
                                                "seeded")]
    gap_spec = (STRAGGLER_PROFILES[gap] if isinstance(gap, str)
                else gap)
    starts = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n_jobs))

    jobs: list[ServeJob] = []
    times, job_of, row_seeds, payloads = [], [], [], []
    max_l = max(Ls)
    for j in range(n_jobs):
        k, l = int(Ks[j]), int(Ls[j])
        n = k + int(extra_packets)
        jobs.append(ServeJob(job=j, K=k, L=l, seeded=seeds_flag[j],
                             t_start=float(starts[j])))
        seeds_j = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        if duplicate_rate > 0:
            dup = rng.random(n) < duplicate_rate
            dup[0] = False
            idx = np.arange(n)
            idx[dup] = idx[dup] - 1
            seeds_j = seeds_j[idx]
        P = job_packets(seed, j, k, l, s).to(dev)
        A = expand_rows(seeds_j, k, s).to(dev)
        C = gf_matmul_packed(A, P, s=s).cpu().numpy()
        t = starts[j] + np.cumsum(gap_spec.sample(rng, n))
        pad = np.zeros((n, max_l), np.uint8)
        pad[:, :l] = C
        times.append(t)
        job_of.append(np.full(n, j, np.int64))
        row_seeds.append(seeds_j)
        payloads.append(pad)

    times = np.concatenate(times)
    order = np.argsort(times, kind="stable")
    return ServeTrace(
        s=s, jobs=jobs,
        times=times[order],
        job_of=np.concatenate(job_of)[order],
        row_seeds=np.concatenate(row_seeds)[order],
        payloads=np.concatenate(payloads)[order],
    )
