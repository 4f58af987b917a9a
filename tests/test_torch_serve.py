"""The port's multi-tenant decode server.

The serving contract (the reference's, `tests/test_serve.py`): any
interleaving of many jobs' packets — any per-job order, duplicate and
dependent rows, dropped rows (enough to starve a job below rank K),
mixed seeded and materialized wire formats, more jobs than slots —
decodes every completable job byte for byte, at the same completion
arrival count, as an isolated per-job `StreamDecoder`, and no other.
Here the isolated decoder is the port's, held against the reference's
in `tests/test_torch_stream.py`.  The reference server breaks this
contract when a starved job holds the only slot (ROADMAP R2); the port
must not, and the failing example is pinned below.

The inputs are numpy arrays from a seed: the fuzzed traces draw their
structure in the reference's order and their payloads from numpy, and
the committed fixture ``tests/data/serve_trace.json`` carries the
reference's own completions.  On this CPU the bank runs its kernels'
plain versions.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro.serve import poisson_multitenant_trace as jtrace
from repro_torch.core.gf import get_field
from repro_torch.core.seeds import expand_rows
from repro_torch.engine import StreamDecoder
from repro_torch.serve import (DecodeServer, FifoScheduler, ServeJob,
                               ServeTrace, job_packets, payload_digest,
                               poisson_multitenant_trace, serve_trace)

DATA = pathlib.Path(__file__).resolve().parent / "data"
S = 8
CPU = "cpu"


def _sig(report):
    """The deterministic completion signature of a served trace."""
    return [(c.job, c.arrivals, c.payload_sha) for c in report.completions]


def _fuzz_trace(n_jobs, case_seed, *, dup=0.0, drop=0.0):
    """An adversarial trace + per-job truth, drawn in the order of the
    reference test's `_fuzz_trace` (so a case seed gives the same jobs,
    drops and interleaving) with numpy payloads.  Returns ``(trace,
    truth P per job, (seeds, rows, C) per job)``."""
    rng = np.random.default_rng(case_seed)
    field = get_field(S)
    metas, per_job, truth = [], [], []
    for j in range(n_jobs):
        k, l = int(rng.integers(2, 7)), int(rng.integers(1, 20))
        n = k + int(rng.integers(1, 5))
        seeds_j = rng.integers(0, 1 << 32, n).astype(np.uint32)
        if dup and n > 1:
            di = rng.random(n) < dup
            di[0] = False
            idx = np.arange(n)
            idx[di] -= 1
            seeds_j = seeds_j[idx]
        P = np.random.default_rng(case_seed * 131 + j).integers(
            0, 256, (k, l)).astype(np.uint8)
        A = expand_rows(seeds_j, k, S).numpy()
        C = field.matmul(torch.from_numpy(A), torch.from_numpy(P)).numpy()
        if drop and n > 1:
            keep = rng.random(n) > drop
            keep[int(rng.integers(n))] = True
            seeds_j, A, C = seeds_j[keep], A[keep], C[keep]
        metas.append(ServeJob(job=j, K=k, L=l,
                              seeded=bool(rng.random() < 0.5), t_start=0.0))
        per_job.append((seeds_j, A, C))
        truth.append(P)
    job_seq = np.repeat(np.arange(n_jobs), [len(p[0]) for p in per_job])
    rng.shuffle(job_seq)
    G = len(job_seq)
    max_l = max(m.L for m in metas)
    row_seeds = np.zeros(G, np.uint32)
    payloads = np.zeros((G, max_l), np.uint8)
    ptr = np.zeros(n_jobs, int)
    for i, j in enumerate(job_seq):
        p = ptr[j]
        ptr[j] += 1
        row_seeds[i] = per_job[j][0][p]
        payloads[i, : metas[j].L] = per_job[j][2][p]
    trace = ServeTrace(s=S, jobs=metas,
                       times=np.arange(G, dtype=np.float64),
                       job_of=job_seq.astype(np.int64),
                       row_seeds=row_seeds, payloads=payloads)
    return trace, truth, per_job


def _serve_fuzz_case(n_jobs, slots, g_tick, case_seed, dup, drop):
    """Serve a fuzzed trace; every job completes iff its isolated
    StreamDecoder decodes, with equal arrivals and payload; batched
    and sequential agree.  Returns the number of jobs decoded."""
    trace, truth, per_job = _fuzz_trace(
        n_jobs, case_seed, dup=0.3 if dup else 0.0,
        drop=0.25 if drop else 0.0)
    rep = serve_trace(trace, slots=slots, g_tick=g_tick, batched=True,
                      device=CPU)
    by_job = {c.job: c for c in rep.completions}
    decoded = 0
    for j, meta in enumerate(trace.jobs):
        seeds_j, A, C = per_job[j]
        dec = StreamDecoder(K=meta.K, L=meta.L, s=S, device=CPU)
        if len(seeds_j):
            dec.ingest(seeds_j if meta.seeded else A, C)
        ok, P_hat = dec.decode()
        assert (j in by_job) == ok, f"job {j}: server {j in by_job}, " \
                                    f"isolated decoder {ok}"
        if ok:
            decoded += 1
            c = by_job[j]
            assert c.arrivals == dec.decoded_at
            assert c.payload_sha == payload_digest(P_hat)
            assert c.payload_sha == payload_digest(truth[j])
    rep_seq = serve_trace(trace, slots=slots, g_tick=g_tick, batched=False,
                          device=CPU)
    assert _sig(rep) == _sig(rep_seq)
    assert rep.dispatches == rep.ticks
    return decoded


def test_starved_jobs_do_not_block_the_queue():
    """The reference's failing example (ROADMAP R2): with one slot, jobs
    0 and 1 never reach rank K; job 2 waits behind them and must still
    decode."""
    trace, _, per_job = _fuzz_trace(3, 26, dup=0.3, drop=0.25)
    ranks = []
    for j, meta in enumerate(trace.jobs):
        dec = StreamDecoder(K=meta.K, s=S)             # rank only
        dec.ingest(per_job[j][1])
        ranks.append(dec.rank)
    assert [r < m.K for r, m in zip(ranks, trace.jobs, strict=True)] == \
        [True, True, False], "the example no longer starves jobs 0 and 1"
    assert _serve_fuzz_case(3, 1, 1, 26, True, True) == 1


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@hypothesis.settings(max_examples=15, deadline=None)
@hypothesis.given(n_jobs=st.integers(1, 6), slots=st.integers(1, 4),
                  g_tick=st.integers(1, 6), case_seed=st.integers(0, 2**30),
                  dup=st.booleans(), drop=st.booleans())
@hypothesis.example(n_jobs=3, slots=1, g_tick=1, case_seed=26, dup=True,
                    drop=True)
def test_serve_interleaving_property(n_jobs, slots, g_tick, case_seed, dup,
                                     drop):
    _serve_fuzz_case(n_jobs, slots, g_tick, case_seed, dup, drop)


# ---------------------------------------------------------------------------
# the committed fixture: the reference's own completions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g_tick,batched", [(1, True), (4, True), (8, True),
                                            (4, False)])
def test_fixture_reproduces_the_reference_completions(g_tick, batched):
    trace = ServeTrace.load(DATA / "serve_trace.json")
    expected = trace.extra["expected"]
    rep = serve_trace(trace, slots=4, g_tick=g_tick, batched=batched,
                      device=CPU)
    assert rep.completed == len(expected)
    for c in rep.completions:
        e = expected[str(c.job)]
        assert (c.arrivals, c.payload_sha) == (e["arrivals"],
                                               e["payload_sha"])
    assert rep.metrics["schema"] == "fednc-metrics-v1"
    assert rep.metrics["metrics"]["serve.ticks"]["value"] == rep.ticks


# ---------------------------------------------------------------------------
# the generator, the JSON format, the scheduler and the server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_jobs=6, K=[3, 5, 4, 6, 3, 5], L=[8, 16, 12, 20, 8, 16],
         extra_packets=3, seeded="mixed", duplicate_rate=0.2, seed=42),
    dict(n_jobs=5, K=4, L=7, extra_packets=2, seeded=True, gap="pareto",
         rate=2.0, seed=3),
])
def test_generator_draws_the_reference_times_jobs_and_seeds(kw):
    n = kw.pop("n_jobs")
    t = poisson_multitenant_trace(n, device=CPU, **kw)
    j = jtrace(n, **kw)
    np.testing.assert_array_equal(t.times, j.times)
    np.testing.assert_array_equal(t.job_of, j.job_of)
    np.testing.assert_array_equal(t.row_seeds, j.row_seeds)
    assert [vars(x) for x in t.jobs] == [vars(x) for x in j.jobs]
    assert t.wire_bytes() == j.wire_bytes()
    # the payloads are the port's P through the coding rows
    f = get_field(8)
    for meta in t.jobs:
        idx = t.packet_indices(meta.job)
        P = job_packets(kw["seed"], meta.job, meta.K, meta.L)
        A = expand_rows(t.row_seeds[idx], meta.K)
        assert torch.equal(torch.from_numpy(t.payloads[idx, :meta.L]),
                           f.matmul(A, P))


def test_json_roundtrip_serves_identically(tmp_path):
    trace = poisson_multitenant_trace(5, K=4, L=16, extra_packets=3,
                                      seed=13, device=CPU)
    trace.save(tmp_path / "trace.json")
    loaded = ServeTrace.load(tmp_path / "trace.json")
    np.testing.assert_array_equal(loaded.payloads, trace.payloads)
    assert _sig(serve_trace(trace, device=CPU)) == \
        _sig(serve_trace(loaded, device=CPU))
    with pytest.raises(ValueError):
        ServeTrace.from_json('{"schema": "other"}')


def test_completion_invariant_to_tick_slots_and_mode():
    trace = poisson_multitenant_trace(
        6, K=[3, 4, 5, 3, 4, 5], L=[8, 10, 6, 8, 10, 6],
        extra_packets=3, duplicate_rate=0.15, seed=5, device=CPU)
    ref = None
    for slots, g_tick, batched in [(2, 1, True), (3, 4, True), (6, 8, True),
                                   (4, 2, False), (6, 1, False)]:
        rep = serve_trace(trace, slots=slots, g_tick=g_tick, batched=batched,
                          device=CPU)
        assert rep.completed == 6
        assert ref is None or _sig(rep) == ref, (slots, g_tick, batched)
        ref = _sig(rep)


def test_scheduler_front_packed_fifo():
    sched = FifoScheduler(slots=2, K=4, L=6, g_tick=2)
    for i in range(3):
        sched.enqueue(0, seed=i, payload=np.full(6, i, np.uint8))
    sched.enqueue(1, seed=99, payload=np.arange(6, dtype=np.uint8),
                  row=np.array([1, 2, 3], np.uint8))
    assert sched.pending == 4 and sched.max_depth == 3
    rows, seeds, use, valid, C = sched.next_block()
    assert rows.shape == (2, 2, 4) and C.shape == (2, 2, 6)
    assert seeds[0].tolist() == [0, 1] and use[0].all()
    assert valid[0].tolist() == [True, True]
    assert valid[1].tolist() == [True, False]
    assert not use[1, 0] and rows[1, 0].tolist() == [1, 2, 3, 0]
    assert sched.pending == 1
    _, seeds2, _, valid2, _ = sched.next_block()
    assert seeds2[0, 0] == 2 and valid2.sum() == 1
    assert sched.next_block() is None
    with pytest.raises(ValueError):
        FifoScheduler(1, 2, 2, g_tick=0)


def _job(k, l, seeds, key):
    P = np.random.default_rng(key).integers(0, 256, (k, l)).astype(np.uint8)
    C = get_field(S).matmul(expand_rows(seeds, k, S),
                            torch.from_numpy(P)).numpy()
    return P, C


def test_ticks_do_not_cross_contaminate_slots():
    k, l = 4, 8
    srv = DecodeServer(slots=3, K=k, L=l, s=S, g_tick=2, device=CPU)
    for j in range(3):
        srv.submit(j, k, l)
    for j in (1, 2):
        seeds = np.uint32([100 + j])
        _, C = _job(k, l, seeds, j)
        srv.offer(j, C[0], seed=int(seeds[0]))
    srv.drain()
    frozen = [(srv.bank.basis(j).clone(), srv.bank.rank[j]) for j in (1, 2)]
    seeds0 = np.arange(1, k + 2, dtype=np.uint32)
    P0, C0 = _job(k, l, seeds0, 9)
    for g in range(k + 1):
        srv.offer(0, C0[g], seed=int(seeds0[g]))
    srv.drain()
    assert srv.completion(0) is not None
    np.testing.assert_array_equal(srv.result(0), P0)
    for (B_before, r_before), j in zip(frozen, (1, 2), strict=True):
        assert torch.equal(srv.bank.basis(j), B_before)
        assert srv.bank.rank[j] == r_before


def test_mixed_wire_formats_within_one_job():
    k, l = 5, 12
    seeds = np.arange(10, 10 + k, dtype=np.uint32)
    A = expand_rows(seeds, k, S).numpy()
    P, C = _job(k, l, seeds, 3)
    srv = DecodeServer(slots=1, K=k, L=l, s=S, g_tick=3, device=CPU)
    srv.submit(0, k, l)
    for g in range(k):
        if g % 2:
            srv.offer(0, C[g], seed=int(seeds[g]))        # seeded
        else:
            srv.offer(0, C[g], row=A[g])                   # materialized
    srv.drain()
    c = srv.completion(0)
    assert c is not None and c.arrivals == k
    np.testing.assert_array_equal(srv.result(0), P)


def test_late_packets_dropped_and_slot_reused():
    k, l = 3, 4
    srv = DecodeServer(slots=1, K=k, L=l, s=S, g_tick=2, device=CPU)
    mats = []
    for j in range(3):
        seeds = (np.arange(k + 2) + 50 * (j + 1)).astype(np.uint32)
        P, C = _job(k, l, seeds, 20 + j)
        mats.append((seeds, C, P))
        srv.submit(j, k, l)
    assert srv.max_concurrent == 1
    for j, (seeds, C, _) in enumerate(mats):
        for g in range(k + 2):                 # 2 redundant packets
            srv.offer(j, C[g], seed=int(seeds[g]))
        srv.drain()
    for j, (_, _, P) in enumerate(mats):
        assert srv.completion(j) is not None
        np.testing.assert_array_equal(srv.result(j), P)
    assert srv.max_concurrent == 1
    assert srv.late_dropped > 0
    c = srv.completions[0]
    assert srv.offer(0, mats[0][1][0], seed=int(mats[0][0][0])) is False
    assert srv.completions[0] == c
    with pytest.raises(ValueError):
        srv.submit(0, k, l)
    with pytest.raises(ValueError):
        srv.bank.open(0, k=k + 1)              # above the bank's K


def test_cli_serves_on_the_cpu(tmp_path, capsys):
    from repro_torch.serve.cli import main

    out = tmp_path / "report.json"
    doc = main(["--jobs", "4", "--K", "4", "--L", "12", "--device", "cpu",
                "--save-trace", str(tmp_path / "t.json"), "--json",
                str(out)])
    assert doc["completed"] == doc["jobs"] == 4
    assert doc["dispatches"] == doc["ticks"]
    seq = main(["--trace", str(tmp_path / "t.json"), "--device", "cpu",
                "--sequential"])
    assert [c["payload_sha"] for c in seq["completions"]] == \
        [c["payload_sha"] for c in doc["completions"]]
    assert "packets/s" in capsys.readouterr().out
