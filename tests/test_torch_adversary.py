"""The port's `adversary/` (spec, eavesdrop, replayed seeds) and the
`core.channel.Eavesdropper` against the JAX package.

Every input is the reference's own: coding matrices and seed headers
drawn by the reference (or numpy), the reference's
`multi_edge_coding_matrix`, and numpy-seeded coin flips that both
packages draw in the same order.  Ranks, reports, seeds and junk bytes
are compared exactly.  The views run over the port's rank-only
`StreamDecoder` (L = 0, on the host); the replay attack runs through a
payload decoder on the CPU, where the kernel wrappers run their plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adversary as jadv
from repro.core import channel as jchannel
from repro.core import rlnc as jrlnc
from repro.engine import CodingEngine as JEngine
from repro.engine import EngineConfig as JConfig
from repro.engine import StreamDecoder as JStream
from repro_torch import adversary as tadv
from repro_torch.core import channel as tchannel
from repro_torch.core.rlnc import EncodedBatch, SeededBatch
from repro_torch.engine import StreamDecoder

S = 8

SPECS = ["none", "", "eavesdrop:0.6", "eavesdrop:0", "eavesdrop:1",
         "collude:1", "collude:4", "byzantine:0.05", "byzantine:1"]
BAD_SPECS = ["eavesdrop:1.5", "collude:0", "collude:2.5", "byzantine:-0.1",
             "tamper:0.5", "eavesdrop"]


def _np(x) -> np.ndarray:
    """A writable host copy of a JAX array."""
    return np.array(x)


# ---------------------------------------------------------------------------
# AdversarySpec: the grid axis value
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", SPECS)
def test_spec_parses_every_kind_as_the_reference(text):
    j, t = jadv.AdversarySpec.parse(text), tadv.AdversarySpec.parse(text)
    assert (t.kind, t.param, t.none, t.tag, str(t)) == (
        j.kind, j.param, j.none, j.tag, str(j))
    if t.kind == "collude":
        assert t.count == j.count
    assert tadv.KINDS == jadv.KINDS


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jadv.AdversarySpec.parse(bad)
    with pytest.raises(ValueError):
        tadv.AdversarySpec.parse(bad)


# ---------------------------------------------------------------------------
# edge taps on the reference's stacked hierarchical matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edges,spare", [([(0, 1), (2,)], 1),
                                         ([(0, 1, 2), (3, 4), (5, 6, 7)], 2),
                                         ([tuple(range(6))], 0)])
def test_edge_row_slices_equal_reference(edges, spare):
    assert tadv.edge_row_slices(edges, spare) == jadv.edge_row_slices(
        edges, spare)


@pytest.mark.parametrize("tapped", [(), (0,), (1, 2), (2, 0, 2), (0, 1, 2)])
def test_tap_edges_on_the_reference_matrix(tapped):
    edges = [(0, 1, 2), (3, 4), (5, 6, 7)]
    K, spare = 8, 2
    n_out = [len(e) + spare for e in edges]
    A = _np(JEngine(JConfig(s=S)).multi_edge_coding_matrix(
        jax.random.PRNGKey(3), edges, K, n_out))
    want = jadv.tap_edges(A, edges, tapped, spare_per_edge=spare)
    for given in (A, torch.from_numpy(A)):
        got = tadv.tap_edges(given, edges, tapped, spare_per_edge=spare)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, _np(want))
    jv, tv = jadv.EavesdropperView(K=K), tadv.EavesdropperView(K=K)
    assert tv.observe(got) == jv.observe(want)
    assert tv.report() == jv.report()
    if len(set(tapped)) < len(edges):
        assert tv.rank < K                      # the structural wall


# ---------------------------------------------------------------------------
# EavesdropperView on the reference's rows and seed headers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("colluders", [(), (0, 3)])
@pytest.mark.parametrize("headers", ["rows", "seeds"])
def test_view_observe_equals_reference(s, colluders, headers):
    K = 6
    if headers == "rows":
        rows = _np(jrlnc.random_coding_matrix(jax.random.PRNGKey(s), 9, K,
                                              s))
        rows[4] = rows[1]                       # a dependent capture
    else:
        rows = np.random.default_rng(s).integers(0, 1 << 32, 9,
                                                 dtype=np.uint32)
    jv = jadv.EavesdropperView(K=K, s=s, colluders=colluders)
    tv = tadv.EavesdropperView(K=K, s=s, colluders=colluders)
    for part in (rows[:2], rows[2:2], rows[2:5], rows[5:]):
        assert tv.observe(part) == jv.observe(part)
        assert tv.report() == jv.report()
        np.testing.assert_array_equal(tv._dec.basis().numpy(),
                                      _np(jv._dec.basis()))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.6, 1.0])
@pytest.mark.parametrize("colluders", [(), (1,), (0, 2, 4)])
@pytest.mark.parametrize("headers", ["rows", "seeds"])
def test_view_intercept_equals_reference(p, colluders, headers):
    K, n = 8, 12
    jv = jadv.EavesdropperView(K=K, s=S, seed=11, p_intercept=p,
                               colluders=colluders)
    tv = tadv.EavesdropperView(K=K, s=S, seed=11, p_intercept=p,
                               colluders=colluders)
    for r in range(3):
        if headers == "rows":
            rows = _np(jrlnc.random_coding_matrix(
                jax.random.PRNGKey(r), n, K, S))
        else:
            rows = _np(JEngine(JConfig(s=S, kernel="jnp_packed_seeded")
                           ).coding_seeds(jax.random.PRNGKey(r), n))
        assert tv.intercept(rows) == jv.intercept(rows)
        rep = tv.report()
        assert rep == jv.report()
        assert set(rep) == {"intercepted", "colluders", "rank", "full_leak",
                            "sources_recovered", "residual_entropy_bits"}
    assert tv.residual_entropy_bits(L=7) == jv.residual_entropy_bits(L=7)
    assert tv.full_leak == jv.full_leak


def test_view_rejects_a_colluder_outside_the_generation():
    with pytest.raises(ValueError, match="outside"):
        tadv.EavesdropperView(K=4, colluders=(4,))


def test_zero_rows_are_plain_dependent_arrivals():
    """`intercept` feeds missed tuples as zero rows: the decoder must
    take each as a dependent arrival — rank, basis and `inconsistent`
    unchanged — on the rank-only path and on a payload decoder."""
    K = 5
    A = _np(jrlnc.random_coding_matrix(jax.random.PRNGKey(0), 3, K, S))
    zeros = np.zeros((4, K), np.uint8)
    jd, td = JStream(K=K, L=0, s=S), StreamDecoder(K=K, L=0, s=S)
    for dec in (jd, td):
        dec.ingest(A)
    before = td.basis().clone()
    np.testing.assert_array_equal(td.ingest(zeros), [3, 3, 3, 3])
    np.testing.assert_array_equal(_np(jd.ingest(zeros)), [3, 3, 3, 3])
    assert td.push(zeros[0]) == jd.push(zeros[0]) == 3
    assert torch.equal(td.basis(), before)
    assert (td.rank, td.inconsistent, td.arrivals) == (
        jd.rank, jd.inconsistent, jd.arrivals) == (3, 0, 8)
    P = np.random.default_rng(1).integers(0, 256, (K, 16)).astype(np.uint8)
    C = _np(jrlnc.encode(jnp.asarray(P), jnp.asarray(A), S, impl="jnp").C)
    dec = StreamDecoder(K=K, L=16, s=S, detect=True, device="cpu")
    dec.ingest(A, C)
    np.testing.assert_array_equal(
        dec.ingest(zeros, np.zeros((4, 16), np.uint8)), [3, 3, 3, 3])
    assert (dec.rank, dec.inconsistent, dec.tampered) == (3, 0, False)


# ---------------------------------------------------------------------------
# the one-shot Eavesdropper of core.channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.4, 0.8, 1.0])
@pytest.mark.parametrize("n,K", [(6, 6), (12, 6), (3, 6)])
def test_eavesdropper_reports_equal_reference(p, n, K):
    A = _np(jrlnc.random_coding_matrix(jax.random.PRNGKey(n), n, K, S))
    C = np.random.default_rng(n).integers(0, 256, (n, 4)).astype(np.uint8)
    je, te = jchannel.Eavesdropper(p, seed=5), tchannel.Eavesdropper(p,
                                                                     seed=5)
    for _ in range(3):
        assert te.attack_encoded(EncodedBatch(torch.from_numpy(A),
                                              torch.from_numpy(C)), S) == \
            je.attack_encoded(jrlnc.EncodedBatch(jnp.asarray(A),
                                                 jnp.asarray(C)), S)
        assert te.attack_plain(n) == je.attack_plain(n)


# ---------------------------------------------------------------------------
# replayed seed headers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count,seed", [(0, 0), (1, 3), (4, 8)])
def test_replayed_seed_batch_equals_reference(count, seed):
    K, L, n = 8, 32, 12
    eng = JEngine(JConfig(s=S, kernel="jnp_packed_seeded"))
    P = np.random.default_rng(6).integers(0, 256, (K, L)).astype(np.uint8)
    jb = eng.encode_seeded(jnp.asarray(P),
                           eng.coding_seeds(jax.random.PRNGKey(7), n))
    tb = SeededBatch(seeds=torch.from_numpy(_np(jb.seeds).astype(np.int64)),
                     C=torch.from_numpy(_np(jb.C)), K=K)
    ja = jadv.replayed_seed_batch(jb, count, s=S, seed=seed)
    ta = tadv.replayed_seed_batch(tb, count, s=S, seed=seed)
    np.testing.assert_array_equal(ta.seeds.numpy(),
                                  _np(ja.seeds).astype(np.int64))
    np.testing.assert_array_equal(ta.C.numpy(), _np(ja.C))
    assert ta.K == ja.K == K
    jd = JStream(K=K, L=L, s=S, detect=True)
    td = StreamDecoder(K=K, L=L, s=S, detect=True, device="cpu")
    np.testing.assert_array_equal(td.ingest(ta.seeds, ta.C),
                                  _np(jd.ingest(ja.seeds, ja.C)))
    assert (td.inconsistent, td.first_inconsistent_at, td.decoded_at) == (
        jd.inconsistent, jd.first_inconsistent_at, jd.decoded_at)
    assert td.inconsistent == count and td.tampered == (count > 0)
    ok, P_hat = td.decode()
    assert ok and torch.equal(P_hat, torch.from_numpy(P))


def test_adversary_exports_what_the_reference_exports():
    assert sorted(tadv.__all__) == sorted(jadv.__all__)
    assert tadv.MODES == jadv.MODES
