"""DecodeServer: many federated rounds decoded by one bank on the card.

The port of `repro.serve.server`.  Each *job* (one federated round)
owns a slot in a `repro_torch.engine.DecoderBank` — its private
reduced-basis [B | Y] state — while a `FifoScheduler` coalesces whatever
packets arrived since the last tick, across ALL jobs, into one padded
block per tick.  The server's inner loop is: drain queues -> one bank
tick (one `gf_matmul_packed_batched` launch, or one launch per job in
the sequential baseline) -> scan the rank trajectories for jobs that
just hit rank K -> emit a :class:`JobCompletion`, free the slot, admit
the next waiting job.  Seeded and materialized wire formats coexist per
packet (`use_seed` in the tick block), and packets for already-complete
jobs are counted and dropped.

:func:`serve_trace` is the offline driver: replay a recorded
`ServeTrace` as fast as the server can take it and report throughput
(packets/s) and per-job completion latency percentiles.  Unlike the
reference, a job whose packets run out below rank K does not hold its
slot for good: at the end of the trace its slot is closed and the jobs
waiting behind it are served (a job completes iff an isolated
`StreamDecoder` decodes its packets).
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.seeds import expand_rows
from repro_torch.engine.stream import DecoderBank

from .scheduler import FifoScheduler
from .trace import ServeTrace


def payload_digest(arr) -> str:
    """Stable 16-hex digest of a decoded payload (fixture pinning).

    Takes a numpy array or a tensor on any device (copied to the host);
    equal bytes give the reference's digest."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr, np.uint8))
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]


@dataclass(frozen=True)
class JobCompletion:
    """Emitted the tick a job's basis reaches rank K."""

    job: int
    k: int
    l: int
    arrivals: int        # packets ingested when rank K was reached
    latency_s: float     # wall time from submit to completion tick
    payload_sha: str     # payload_digest of the decoded (k, l) matrix


@dataclass
class ServeReport:
    """What one served trace looked like from the server's side."""

    jobs: int
    completed: int
    packets_offered: int
    packets_ingested: int
    late_dropped: int
    ticks: int
    dispatches: int
    wall_s: float
    max_concurrent: int
    completions: list[JobCompletion] = field(default_factory=list)
    metrics: Optional[dict] = None   # fednc-metrics-v1 snapshot

    @property
    def packets_per_s(self) -> float:
        return self.packets_ingested / max(self.wall_s, 1e-12)

    def latency_percentiles(self) -> tuple[float, float]:
        """(p50, p99) job completion latency in seconds."""
        if not self.completions:
            return (float("nan"), float("nan"))
        lat = np.array([c.latency_s for c in self.completions])
        return (float(np.percentile(lat, 50)),
                float(np.percentile(lat, 99)))


@dataclass
class _JobState:
    k: int
    l: int
    slot: Optional[int] = None
    arrivals: int = 0          # valid packets ingested so far
    offered: int = 0
    t_submit: float = 0.0
    backlog: list = field(default_factory=list)   # offers while waiting
    done: Optional[JobCompletion] = None
    payload: Optional[np.ndarray] = None


class DecodeServer:
    """Continuous-batching multi-tenant rank-K decode server."""

    def __init__(self, slots: int, K: int, L: int, s: int = 8,
                 g_tick: int = 8, batched: bool = True, device="cuda"):
        self.bank = DecoderBank(slots, K, L, s, device=device)
        self.sched = FifoScheduler(slots, K, L, g_tick)
        self.batched = bool(batched)
        self._slot_job = np.full((slots,), -1, np.int64)
        self._jobs: dict[int, _JobState] = {}
        self._waiting: deque[int] = deque()
        m = self.metrics = obs.MetricsRegistry()
        self._m_ticks = m.counter("serve.ticks")
        self._m_ingested = m.counter("serve.packets_ingested")
        self._m_late = m.counter("serve.late_dropped")
        self._m_depth = m.gauge("serve.queue_depth")
        self._m_busy = m.gauge("serve.slots_busy")
        # batch-size buckets in packets (powers of two up to a full
        # slots x g_tick block); latency buckets log-spaced 10us..100s
        self._m_batch = m.histogram(
            "serve.ingest_batch",
            bounds=[2 ** i for i in range(11)])
        self._m_latency = m.histogram("serve.job_latency_s")

    @property
    def ticks(self) -> int:
        return self._m_ticks.value

    @property
    def late_dropped(self) -> int:
        return self._m_late.value

    @property
    def packets_ingested(self) -> int:
        return self._m_ingested.value

    @property
    def max_concurrent(self) -> int:
        return int(self._m_busy.max or 0)

    # -- job lifecycle ----------------------------------------------------

    def submit(self, job: int, k: int, l: Optional[int] = None) -> None:
        """Admit a round: slot it if one is free, else queue it."""
        job = int(job)
        if job in self._jobs:
            raise ValueError(f"job {job} already submitted")
        st = _JobState(k=int(k), l=self.bank.L if l is None else int(l),
                       t_submit=obs.clock())
        self._jobs[job] = st
        free = np.nonzero(self._slot_job < 0)[0]
        if free.size:
            self._place(job, int(free[0]))
        else:
            self._waiting.append(job)

    def _place(self, job: int, slot: int) -> None:
        st = self._jobs[job]
        self.bank.open(slot, st.k, st.l)
        self._slot_job[slot] = job
        st.slot = slot
        self._m_busy.set(int(np.sum(self._slot_job >= 0)))
        for seed, row, payload in st.backlog:
            self.sched.enqueue(slot, seed=seed, payload=payload, row=row)
        st.backlog.clear()

    def offer(self, job: int, payload, *, seed: int = 0,
              row=None) -> bool:
        """Hand the server one coded tuple for `job`.

        `row=None` means the seeded wire format (`seed` is expanded at
        the tick); a materialized (k,) `row` means the classic format.
        Returns False if the job already completed (the packet is
        dropped and counted in ``late_dropped``)."""
        st = self._jobs[int(job)]
        if st.done is not None:
            self._m_late.inc()
            return False
        st.offered += 1
        if st.slot is None:
            st.backlog.append((int(seed), row, payload))
        else:
            self.sched.enqueue(st.slot, seed=seed, payload=payload,
                               row=row)
        return True

    def result(self, job: int) -> np.ndarray:
        """Decoded (k, l) payload matrix of a completed job (host)."""
        st = self._jobs[int(job)]
        if st.payload is None:
            raise ValueError(f"job {job} has not completed")
        return st.payload

    def completion(self, job: int) -> Optional[JobCompletion]:
        return self._jobs[int(job)].done

    @property
    def completions(self) -> list[JobCompletion]:
        return sorted((st.done for st in self._jobs.values()
                       if st.done is not None),
                      key=lambda c: c.job)

    # -- the serving loop -------------------------------------------------

    def tick(self) -> bool:
        """One scheduler tick: drain queues, one bank tick, emit
        completions, admit waiting jobs.  False if idle."""
        tr = obs.get_tracer()
        depth = self.sched.pending
        if depth == 0:
            return False
        self._m_depth.set(depth)
        self._m_busy.set(int(np.sum(self._slot_job >= 0)))
        if tr.enabled:
            tr.counter("serve.queue_depth", depth)
            tr.counter("serve.slots_busy",
                       int(np.sum(self._slot_job >= 0)))
        block = self.sched.next_block()
        if block is None:                      # pragma: no cover
            return False
        rows, seeds, use, valid, C = block
        batch = int(valid.sum())
        with tr.span("serve.ingest", cat="serve", packets=batch) as sp:
            ranks = self.bank.ingest(
                rows=rows, seeds=seeds, use_seed=use, valid=valid, C=C,
                batched=self.batched)
            sp.fence(self.bank.state_buffers)      # the tick's launch
        self._m_ticks.inc()
        self._m_ingested.inc(batch)
        self._m_batch.observe(batch)
        freed = []
        for slot in np.nonzero(valid.any(axis=1))[0]:
            job = int(self._slot_job[slot])
            st = self._jobs[job]
            if st.done is None and (ranks[slot] >= st.k).any():
                p0 = int(np.argmax(ranks[slot] >= st.k))
                arrivals = st.arrivals + int(valid[slot, : p0 + 1].sum())
                st.payload = self.bank.payload(slot).cpu().numpy()
                latency = obs.clock() - st.t_submit
                st.done = JobCompletion(
                    job=job, k=st.k, l=st.l, arrivals=arrivals,
                    latency_s=latency,
                    payload_sha=payload_digest(st.payload))
                self._m_latency.observe(latency)
                tr.instant("serve.complete", cat="serve", job=job,
                           arrivals=arrivals)
                self._m_late.inc(self.sched.clear(slot))
                self.bank.close(slot)
                self._slot_job[slot] = -1
                freed.append(slot)
            st.arrivals += int(valid[slot].sum())
        for slot in freed:
            if self._waiting:
                self._place(self._waiting.popleft(), int(slot))
        return True

    def drain(self, max_ticks: int = 1_000_000) -> int:
        """Tick until every queue is empty; returns ticks run."""
        n = 0
        while n < max_ticks and self.tick():
            n += 1
        return n

    def _retire_starved(self) -> int:
        """Close the slots of jobs that hold one with an empty queue and
        rank below k — once the offers are over they can never finish —
        and give the slots to waiting jobs.  Returns the slots freed."""
        rank = self.bank.rank
        freed = [int(slot) for slot in np.nonzero(self._slot_job >= 0)[0]
                 if self.sched.queue_depth(slot) == 0
                 and rank[slot] < self._jobs[int(self._slot_job[slot])].k]
        for slot in freed:
            self._jobs[int(self._slot_job[slot])].slot = None
            self.bank.close(slot)
            self._slot_job[slot] = -1
            if self._waiting:
                self._place(self._waiting.popleft(), slot)
        return len(freed)


def serve_trace(trace: ServeTrace, *, slots: int = 8,
                g_tick: int = 8, batched: bool = True,
                device="cuda") -> ServeReport:
    """Replay a recorded trace through a DecodeServer at full speed.

    Jobs are submitted when their first packet arrives; a tick fires
    whenever some slot's queue reaches `g_tick`.  At the end of the
    trace the server drains; then the slots of jobs that can never
    finish (queue empty, rank below k) are closed, the waiting jobs
    placed, and the server drains again, until no job waits.  Given the
    same trace, the per-job decoded payloads and completion arrival
    counts are independent of `g_tick`, `slots` and `batched` — only the
    wall-clock numbers change.
    """
    srv = DecodeServer(slots, trace.max_k, trace.max_l, s=trace.s,
                       g_tick=g_tick, batched=batched, device=device)
    rows_at: dict[int, np.ndarray] = {}
    for job in trace.jobs:
        if not job.seeded:
            idx = trace.packet_indices(job.job)
            A = expand_rows(trace.row_seeds[idx], job.K, trace.s).numpy()
            for p, i in enumerate(idx):
                rows_at[int(i)] = A[p]
    offered = 0
    with obs.timed("serve.trace", cat="serve",
                   jobs=trace.n_jobs) as sw:
        for i in range(trace.n_packets):
            j = int(trace.job_of[i])
            meta = trace.jobs[j]
            if j not in srv._jobs:
                srv.submit(j, meta.K, meta.L)
            srv.offer(j, trace.payloads[i, : meta.L],
                      seed=int(trace.row_seeds[i]), row=rows_at.get(i))
            offered += 1
            while srv.sched.max_depth >= g_tick:
                srv.tick()
        srv.drain()
        while srv._waiting and srv._retire_starved():
            srv.drain()
        sw.fence(srv.bank.state_buffers)
    comps = srv.completions
    return ServeReport(
        jobs=trace.n_jobs, completed=len(comps),
        packets_offered=offered,
        packets_ingested=srv.packets_ingested,
        late_dropped=srv.late_dropped,
        ticks=srv.ticks, dispatches=srv.bank.dispatches,
        wall_s=sw.dur_s, max_concurrent=srv.max_concurrent,
        completions=comps, metrics=srv.metrics.snapshot())
