"""The port's per-arrival decoder against the JAX package's.

`repro_torch.engine.stream` (StreamDecoder, DecoderBank, stream_decode)
keeps the reduced basis on the host and moves the payload block with
one packed-kernel launch per reference dispatch, through the [B | T]
transform.  Held here against `repro.engine.stream` on the reference's
own inputs (numpy arrays from a seed): ranks, `decoded_at`, the basis B
and the payload block Y after every step, the tripwire counters and
the decoded packets.  GF arithmetic is exact: every comparison has
tolerance 0.  On this CPU the port's wrappers run their kernels' plain
versions; the launches are counted by wrapping the module's kernels.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import rlnc as jrlnc
from repro.core.gf import get_field as jget_field
from repro.core.seeds import expand_rows_jit
from repro.engine import DecoderBank as JBank
from repro.engine import StreamDecoder as JStream
from repro.engine import stream_decode as jstream_decode
from repro.engine.select import reduce_insert as jreduce_insert
from repro_torch.core.rlnc import EncodedBatch, SeededBatch
from repro_torch.engine import stream as tstream
from repro_torch.engine import DecoderBank, StreamDecoder, stream_decode
from repro_torch.kernels import gf_matmul as tgm
from repro_torch.kernels import ref as tref


def _coded(seed: int, K: int, L: int, s: int, n: int):
    """(P, A, C) from a seed: n coded rows with a duplicate (row 3 =
    row 1) and a combination (row 5 = row 0 ^ row 2) among them."""
    rng = np.random.default_rng(seed)
    f = jget_field(s)
    P = rng.integers(0, 1 << s, (K, L)).astype(np.uint8)
    A = rng.integers(0, 1 << s, (n, K)).astype(np.uint8)
    A[3] = A[1]
    A[5] = A[0] ^ A[2]
    C = np.array(f.matmul(jnp.asarray(A), jnp.asarray(P)))
    return P, A, C


def _same_state(j, t):
    np.testing.assert_array_equal(np.asarray(j._B), t.basis().numpy())
    np.testing.assert_array_equal(np.asarray(j._Y),
                                  t._Y().numpy())
    assert j.rank == t.rank
    assert j.decoded_at == t.decoded_at
    assert j.arrivals == t.arrivals
    assert j.inconsistent == t.inconsistent
    assert j.first_inconsistent_at == t.first_inconsistent_at


@pytest.fixture
def launches(monkeypatch):
    """Count the stream module's kernel calls (on the CPU the wrappers
    run their plain versions, which count no launch)."""
    calls = {"packed": 0, "batched": 0, "rows": []}

    def packed(A, P, **kw):
        calls["packed"] += 1
        calls["rows"].append(tuple(A.shape))
        return tgm.gf_matmul_packed(A, P, **kw)

    def batched(A, P, **kw):
        calls["batched"] += 1
        return tgm.gf_matmul_packed_batched(A, P, **kw)

    monkeypatch.setattr(tstream, "gf_matmul_packed", packed)
    monkeypatch.setattr(tstream, "gf_matmul_packed_batched", batched)
    return calls


# ---------------------------------------------------------------------------
# StreamDecoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 4, 8])
def test_push_matches_reference_arrival_by_arrival(s):
    K, L = 5, 37
    P, A, C = _coded(s, K, L, s, 11)
    j = JStream(K=K, L=L, s=s)
    t = StreamDecoder(K=K, L=L, s=s, device="cpu")
    for g in range(A.shape[0]):
        assert j.push(jnp.asarray(A[g]), jnp.asarray(C[g])) == \
            t.push(A[g], C[g])
        _same_state(j, t)
    ok_j, P_j = j.decode()
    ok_t, P_t = t.decode()
    assert ok_j == ok_t
    if ok_t:
        np.testing.assert_array_equal(P_t.numpy(), np.asarray(P_j))
        np.testing.assert_array_equal(P_t.numpy(), P)


@pytest.mark.parametrize("s", [1, 4, 8])
def test_ingest_blocks_and_tripwire_match_reference(s):
    """Pushes, then blocks; a corrupted dependent arrival inside a block
    names itself in first_inconsistent_at."""
    K, L = 6, 29
    P, A, C = _coded(10 + s, K, L, s, 14)
    C[5, 7] ^= 1                      # row 5 is dependent: corrupt it
    j = JStream(K=K, L=L, s=s)
    t = StreamDecoder(K=K, L=L, s=s, device="cpu")
    for g in range(2):
        j.push(jnp.asarray(A[g]), jnp.asarray(C[g]))
        t.push(A[g], C[g])
    for lo, hi in ((2, 7), (7, 10), (10, 14)):
        r_j = j.ingest(jnp.asarray(A[lo:hi]), jnp.asarray(C[lo:hi]))
        r_t = t.ingest(A[lo:hi], C[lo:hi])
        np.testing.assert_array_equal(r_t, np.asarray(r_j))
        _same_state(j, t)
    assert t.first_inconsistent_at == 6 and t.tampered


def test_seeded_push_and_ingest_with_partial_col_mask():
    K, L, s = 6, 21, 8
    rng = np.random.default_rng(3)
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    seeds = rng.integers(0, 2**32, 12, dtype=np.uint64).astype(np.uint32)
    mask = np.array([1, 1, 0, 1, 1, 1], bool)
    A = np.array(expand_rows_jit(jnp.asarray(seeds), K, s))
    A_m = A * mask
    C = np.array(jget_field(s).matmul(jnp.asarray(A_m), jnp.asarray(P)))
    j = JStream(K=K, L=L, s=s)
    t = StreamDecoder(K=K, L=L, s=s, device="cpu")
    j.push(jnp.asarray(A_m[0]), jnp.asarray(C[0]))
    t.push(A_m[0], C[0])
    r_j = j.ingest_seeded(jnp.asarray(seeds[1:]), jnp.asarray(C[1:]),
                          col_mask=jnp.asarray(mask))
    r_t = t.ingest_seeded(seeds[1:], C[1:], col_mask=mask)
    np.testing.assert_array_equal(r_t, np.asarray(r_j))
    _same_state(j, t)
    assert t.rank == K - 1 and not t.complete     # column 2 is absent
    # a scalar seed pushes a regenerated row; a 1-D block ingests seeds
    j2 = JStream(K=K, L=L, s=s)
    t2 = StreamDecoder(K=K, L=L, s=s, device="cpu")
    C_full = np.array(jget_field(s).matmul(jnp.asarray(A), jnp.asarray(P)))
    j2.push(jnp.uint32(seeds[0]), jnp.asarray(C_full[0]))
    t2.push(int(seeds[0]), C_full[0])
    np.testing.assert_array_equal(
        t2.ingest(torch.from_numpy(seeds[1:].astype(np.int64)), C_full[1:]),
        np.asarray(j2.ingest(jnp.asarray(seeds[1:]),
                             jnp.asarray(C_full[1:]))))
    _same_state(j2, t2)
    np.testing.assert_array_equal(t2.decode()[1].numpy(), P)


def test_rank_only_decoder_launches_nothing(launches):
    K, s = 7, 4
    _, A, _ = _coded(5, K, 3, s, 12)
    j = JStream(K=K, L=0, s=s)
    t = StreamDecoder(K=K, L=0, s=s)        # no device needed at L = 0
    for g in range(3):
        assert j.push(jnp.asarray(A[g])) == t.push(A[g])
    np.testing.assert_array_equal(t.ingest(A[3:]),
                                  np.asarray(j.ingest(jnp.asarray(A[3:]))))
    assert t.decoded_at == j.decoded_at
    assert t.decode()[1].shape == (K, 0)
    assert launches["packed"] == 0


def test_detect_flags_a_tampered_arrival_after_complete(launches):
    K, L, s = 4, 19, 8
    P, A, C = _coded(8, K, L, s, 10)
    bad = C[9].copy()
    bad[0] ^= 0x40
    for detect in (False, True):
        j = JStream(K=K, L=L, s=s, detect=detect)
        t = StreamDecoder(K=K, L=L, s=s, detect=detect, device="cpu")
        for g in range(9):
            j.push(jnp.asarray(A[g]), jnp.asarray(C[g]))
            t.push(A[g], C[g])
        assert t.complete
        before = launches["packed"]
        j.push(jnp.asarray(A[9]), jnp.asarray(bad))
        t.push(A[9], bad)
        _same_state(j, t)
        assert t.tampered == detect
        # COMPLETE without detect: a no-op; with detect: one launch of
        # the tripwire row alone (Y keeps its buffer)
        assert launches["packed"] - before == int(detect)
        if detect:
            assert launches["rows"][-1] == (1, K + 1)
        np.testing.assert_array_equal(t.decode()[1].numpy(), P)


def test_one_launch_per_push_and_per_block(launches):
    """An independent arrival launches (K) x (K + 1); a dependent one
    while FILLING only its tripwire row; a block one launch of
    (K + dependents) x (K + g)."""
    K, L, s = 5, 12, 8
    _, A, C = _coded(4, K, L, s, 9)
    t = StreamDecoder(K=K, L=L, s=s, device="cpu")
    for g in range(4):                      # row 3 duplicates row 1
        t.push(A[g], C[g])
    assert launches["rows"] == [(K, K + 1)] * 3 + [(1, K + 1)]
    t.ingest(A[4:], C[4:])      # 2 rows reach rank K, 3 are dependent
    assert launches["packed"] == 5
    assert launches["rows"][-1] == (K + 3, K + 5)


@pytest.mark.parametrize("seeded", [False, True])
def test_stream_decode_matches_reference(seeded):
    K, L, s = 5, 33, 8
    P, A, C = _coded(21, K, L, s, 9)
    order = np.random.default_rng(2).permutation(9)
    if seeded:
        seeds = np.random.default_rng(1).integers(
            0, 2**32, 9, dtype=np.uint64).astype(np.uint32)
        A = np.array(expand_rows_jit(jnp.asarray(seeds), K, s))
        C = np.array(jget_field(s).matmul(jnp.asarray(A), jnp.asarray(P)))
        jb = jrlnc.SeededBatch(seeds=jnp.asarray(seeds), C=jnp.asarray(C),
                               K=K)
        tb = SeededBatch(seeds=torch.from_numpy(seeds.astype(np.int64)),
                         C=torch.from_numpy(C), K=K)
    else:
        jb = jrlnc.EncodedBatch(A=jnp.asarray(A), C=jnp.asarray(C))
        tb = EncodedBatch(A=torch.from_numpy(A), C=torch.from_numpy(C))
    for o in (None, order):
        ok_j, P_j, n_j = jstream_decode(jb, s, order=o)
        ok_t, P_t, n_t = stream_decode(tb, s, order=o, device="cpu")
        assert (ok_t, n_t) == (ok_j, n_j)
        np.testing.assert_array_equal(P_t.numpy(), np.asarray(P_j))


def test_stream_decode_runs_on_the_card_unless_asked():
    """Its device defaults to cuda: a CPU batch decodes on the CPU only
    when asked to; otherwise the call raises (no card here: resolving
    the device fails; on a card the payloads' device differs)."""
    K, L, s = 3, 9, 8
    P, A, C = _coded(5, K, L, s, 7)
    tb = EncodedBatch(A=torch.from_numpy(A), C=torch.from_numpy(C))
    with pytest.raises((RuntimeError, ValueError)):
        stream_decode(tb, s)
    ok, P_hat, _ = stream_decode(tb, s, device="cpu")
    assert ok and np.array_equal(P_hat.numpy(), P)


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@hypothesis.settings(max_examples=12, deadline=None)
@hypothesis.given(perm_seed=st.integers(0, 2**31), split=st.integers(0, 10),
                  s=st.sampled_from([1, 4, 8]))
def test_any_arrival_order_matches_reference(perm_seed, split, s):
    """Property: in any arrival order, pushed then ingested from any
    split point, the port's states equal the reference's."""
    K, L = 4, 9
    _, A, C = _coded(7, K, L, s, 10)
    order = np.random.default_rng(perm_seed).permutation(10)
    A, C = A[order], C[order]
    j = JStream(K=K, L=L, s=s)
    t = StreamDecoder(K=K, L=L, s=s, device="cpu")
    for g in range(split):
        j.push(jnp.asarray(A[g]), jnp.asarray(C[g]))
        t.push(A[g], C[g])
    if split < 10:
        np.testing.assert_array_equal(
            t.ingest(A[split:], C[split:]),
            np.asarray(j.ingest(jnp.asarray(A[split:]),
                                jnp.asarray(C[split:]))))
    _same_state(j, t)


# ---------------------------------------------------------------------------
# DecoderBank
# ---------------------------------------------------------------------------

def _tick_block(rng, J, g, K, L, s, valid_rate=0.7):
    rows = rng.integers(0, 1 << s, (J, g, K)).astype(np.uint8)
    rows[0, 1] = rows[0, 0]                       # a duplicate
    seeds = rng.integers(0, 2**32, (J, g), dtype=np.uint64).astype(
        np.uint32)
    use = rng.random((J, g)) < 0.5
    valid = rng.random((J, g)) < valid_rate
    C = rng.integers(0, 1 << s, (J, g, L)).astype(np.uint8)
    return rows, seeds, use, valid, C


@pytest.mark.parametrize("batched", [True, False])
def test_bank_matches_reference_over_ticks(batched, launches):
    """Ticks with valid padding, mixed use_seed, per-slot k and l,
    open/close reuse: ranks, bases, payloads and dispatches equal the
    reference bank's; one batched launch per tick."""
    J, K, L, s, g = 3, 5, 14, 8, 4
    rng = np.random.default_rng(11)
    jb = JBank(J, K, L, s)
    tb = DecoderBank(J, K, L, s, device="cpu")
    for bank in (jb, tb):
        bank.open(0, k=5)
        bank.open(1, k=3, l=9)
        bank.open(2, k=4, col_mask=np.array([1, 0, 1, 1], bool))
    for tick in range(6):
        if tick == 3:                        # slot 1 reused by a new job
            for bank in (jb, tb):
                bank.close(1)
                bank.open(1, k=4, l=11)
        rows, seeds, use, valid, C = _tick_block(rng, J, g, K, L, s)
        r_j = jb.ingest(rows=jnp.asarray(rows), seeds=jnp.asarray(seeds),
                        use_seed=jnp.asarray(use), valid=jnp.asarray(valid),
                        C=jnp.asarray(C), batched=batched)
        r_t = tb.ingest(rows=rows, seeds=seeds, use_seed=use, valid=valid,
                        C=C, batched=batched)
        np.testing.assert_array_equal(r_t, np.asarray(r_j))
        np.testing.assert_array_equal(tb.rank, np.asarray(jb.rank))
        np.testing.assert_array_equal(tb.complete, np.asarray(jb.complete))
        for slot in range(J):
            np.testing.assert_array_equal(tb.basis(slot).numpy(),
                                          np.asarray(jb.basis(slot)))
            np.testing.assert_array_equal(tb.payload(slot).numpy(),
                                          np.asarray(jb.payload(slot)))
    assert tb.dispatches == jb.dispatches
    np.testing.assert_array_equal(tb.target, jb.target)
    np.testing.assert_array_equal(tb.open_slots, jb.open_slots)
    if batched:
        assert launches["batched"] == 6 and launches["packed"] == 0
    else:
        assert launches["batched"] == 0
        assert launches["packed"] <= tb.dispatches


def test_bank_batched_and_sequential_agree_on_one_bank():
    """Alternating modes on one bank (slots then sit in different
    buffers) decodes what a single mode does."""
    J, K, L, s, g = 4, 4, 10, 8, 3
    rng = np.random.default_rng(5)
    ticks = [_tick_block(rng, J, g, K, L, s, valid_rate=0.9)
             for _ in range(5)]
    banks = {}
    for mode in ("batched", "sequential", "mixed"):
        bank = banks[mode] = DecoderBank(J, K, L, s, device="cpu")
        for slot in range(J):
            bank.open(slot, k=K)
        for i, (rows, seeds, use, valid, C) in enumerate(ticks):
            valid = valid.copy()
            valid[i % J] = False           # a slot without work each tick
            b = {"batched": True, "sequential": False}.get(mode, i % 2 == 0)
            bank.ingest(rows=rows, seeds=seeds, use_seed=use, valid=valid,
                        C=C, batched=b)
    for slot in range(J):
        want = banks["batched"].payload(slot)
        for mode in ("sequential", "mixed"):
            assert torch.equal(banks[mode].payload(slot), want)
            assert torch.equal(banks[mode].basis(slot),
                               banks["batched"].basis(slot))


# ---------------------------------------------------------------------------
# the [B | T] design, emulated in numpy against the reference step
# ---------------------------------------------------------------------------

def _np_tables(s):
    f = jget_field(s)
    exp, log = np.asarray(f.exp).astype(np.int64), np.asarray(f.log)
    q = 1 << s
    v = np.arange(q)
    mul = exp[log[v][:, None] + log[v][None, :]].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0
    inv = np.zeros(q, np.uint8)
    for a in range(1, q):
        inv[a] = int(np.nonzero(mul[a] == 1)[0][0])
    return mul, inv


def _np_block(mul, inv, B, filled, rows, K):
    """The [B | T] step in numpy: (B, filled, T, residual rows, the
    positions of the dependent arrivals)."""
    g = rows.shape[0]
    T = np.zeros((K, K + g), np.uint8)
    T[:, :K] = np.eye(K, dtype=np.uint8)
    B, filled = B.copy(), filled.copy()
    resid, dependent = [], []

    def vecmat(c, M):
        return np.bitwise_xor.reduce(mul[c[:, None], M], axis=0)

    for i, a in enumerate(rows):
        unit = np.zeros(K + g, np.uint8)
        unit[K + i] = 1
        co = np.where(filled, a, 0)
        red_a = a ^ vecmat(co, B)
        red_t = unit ^ vecmat(co, T)
        if red_a.any():
            piv = int(np.argmax(red_a != 0))
            new_a = mul[red_a, inv[red_a[piv]]]
            new_t = mul[red_t, inv[red_a[piv]]]
            fac = B[:, piv].copy()
            B ^= mul[fac[:, None], new_a[None, :]]
            T ^= mul[fac[:, None], new_t[None, :]]
            B[piv], T[piv] = new_a, new_t
            filled[piv] = True
        else:
            resid.append(red_t)
            dependent.append(i)
    return (B, filled, T, np.array(resid, np.uint8).reshape(-1, K + g),
            dependent)


@pytest.mark.parametrize("s", [1, 4, 8])
def test_numpy_bt_emulation_matches_reference_reduce_insert(s):
    """T·[Y; C] is the reference's Y after the same arrivals, and each
    dependent arrival's residual row R·[Y; C] is nonzero exactly where
    the reference's reduce_insert reports it inconsistent."""
    K, L = 5, 23
    f = jget_field(s)
    mul, inv = _np_tables(s)
    P, A, C = _coded(30 + s, K, L, s, 9)
    C[3, 2] ^= 1                          # corrupt the duplicate row
    # a basis state from the first two arrivals, then a block of seven
    B, Y = jnp.zeros((K, K), jnp.uint8), jnp.zeros((K, L), jnp.uint8)
    filled = jnp.zeros((K,), jnp.bool_)
    for g in range(2):
        B, Y, filled, _, _ = jreduce_insert(f, B, Y, filled,
                                            jnp.asarray(A[g]),
                                            jnp.asarray(C[g]))
    B0, Y0, f0 = np.asarray(B), np.asarray(Y), np.asarray(filled)
    bads = []
    for g in range(2, 9):
        B, Y, filled, _, bad = jreduce_insert(f, B, Y, filled,
                                              jnp.asarray(A[g]),
                                              jnp.asarray(C[g]))
        bads.append(bool(bad))
    Bn, fn, T, R, dependent = _np_block(mul, inv, B0, f0, A[2:9], K)
    Z = np.concatenate([Y0, C[2:9]])
    np.testing.assert_array_equal(Bn, np.asarray(B))
    np.testing.assert_array_equal(fn, np.asarray(filled))
    np.testing.assert_array_equal(
        np.asarray(f.matmul(jnp.asarray(T), jnp.asarray(Z))), np.asarray(Y))
    flags = np.asarray(f.matmul(jnp.asarray(R), jnp.asarray(Z))).any(axis=1)
    assert flags.tolist() == [bads[i] for i in dependent]
    assert not any(bads[i] for i in range(7) if i not in dependent)
    assert 1 in dependent and flags[dependent.index(1)]   # row 3, corrupted
    # the port's plan computes the same T and residuals
    plan = tstream._BlockPlan(tstream.get_field(s), torch.tensor(B0),
                              torch.tensor(f0), torch.tensor(A[2:9]),
                              tripwire=True)
    np.testing.assert_array_equal(plan.T.numpy(), T)
    np.testing.assert_array_equal(plan.R.numpy(), R)


# ---------------------------------------------------------------------------
# the batched kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 4, 8])
def test_batched_plain_version_is_the_packed_one_per_slot(s):
    rng = np.random.default_rng(s)
    J, n, K, L = 3, 6, 9, 1031
    A = torch.from_numpy(rng.integers(0, 1 << s, (J, n, K)).astype(np.uint8))
    wide = torch.from_numpy(
        rng.integers(0, 1 << s, (J, K + 4, L + 5)).astype(np.uint8))
    P = wide[:, 2:2 + K, 3:3 + L]             # strided view of each slot
    out = torch.zeros((J, n + 2, L + 7), dtype=torch.uint8)
    got = tgm.gf_matmul_packed_batched(A, P, s=s, out=out[:, 1:1 + n, 2:2 + L])
    for j in range(J):
        want = tref.gf_matmul_packed_ref(A[j], P[j], s)
        assert torch.equal(got[j], want)
        assert torch.equal(want, tref.gf_matmul_ref(A[j], P[j], s))
    assert not out[:, 0].any() and not out[:, n + 1:].any()
    assert not out[:, :, :2].any() and not out[:, :, 2 + L:].any()
    assert tgm.gf_matmul_packed_batched.launches == 0     # plain version
    with pytest.raises(ValueError):
        tgm.gf_matmul_packed_batched(A[:2], P, s=s)        # batch sizes
    with pytest.raises(ValueError):
        tgm.gf_matmul_packed_batched(A[:, :, :4], P, s=s)  # K differs
