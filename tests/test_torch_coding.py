"""The port's network-coding tier against the JAX package: relay
recoding, RowMix / RowTamper / stage-wise rounds, `decode_verified`,
the byzantine channel, the multi-edge round and the hierarchical round.

Coding matrices, mixing matrices, seeds and payloads are drawn with
numpy and handed to both engines; channels that draw only from numpy
(erasure, byzantine) are built twice from one seed, so both engines see
the same plan.  A multi-hop plan's hop matrices come from each
framework's own generator, so the tests hand the reference's composed R
to both.  Everything compared is GF data: byte-exact, with equal ok
flags, `verified` flags, channel reports and dispatch counts.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary import ByzantineChannel as JByzantine
from repro.core import channel as jchannel
from repro.core.rlnc import EncodedBatch as JBatch
from repro.core.rlnc import SeededBatch as JSeeded
from repro.engine import CodingEngine as JEngine
from repro.engine import EngineConfig as JConfig
from repro_torch.adversary import (ByzantineChannel, apply_tamper,
                                   rounds_to_recovery)
from repro_torch.core import channel as tchannel
from repro_torch.core import fednc as tfednc
from repro_torch.core import hierarchy as thier
from repro_torch.core import packets as tpackets
from repro_torch.core import rlnc as trlnc
from repro_torch.core import seeds as tseeds
from repro_torch.core.gf import get_field
from repro_torch.core.rlnc import EncodedBatch, SeededBatch
from repro_torch.engine import CodingEngine, EngineConfig

S = 8


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _engines(s: int = S, kernel: str = "auto", chunk_l: int = 64):
    return (JEngine(JConfig(s=s, kernel=kernel, chunk_l=chunk_l)),
            CodingEngine(EngineConfig(s=s, kernel=kernel, chunk_l=chunk_l),
                         device="cpu"))


def _report(r):
    return None if r is None else (r.sent, r.delivered, bool(r.decodable),
                                   r.distinct_sources)


def _same_round(got, want, d_port: int, d_ref: int) -> None:
    """ok, report, verified, packets and dispatch count all agree."""
    assert got.ok == bool(want.ok)
    assert _report(got.report) == _report(want.report)
    assert got.verified == want.verified
    assert d_port == d_ref
    if want.ok:
        np.testing.assert_array_equal(got.packets.numpy(),
                                      np.asarray(want.packets))
    else:
        assert got.packets is None


class _Mix:
    """A channel whose plan is a fixed relay mix R (both frameworks)."""

    def __init__(self, plan):
        self.plan = plan

    def plan_transform(self, n, s):
        return self.plan


class _StageOnly:
    """A channel without `plan_transform`: forces the stage-wise path."""

    def __init__(self, inner):
        self.inner = inner

    def transmit_encoded(self, batch, s):
        return self.inner.transmit_encoded(batch, s)


# ---------------------------------------------------------------------------
# relay recoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("s", [1, 8])
def test_recode_with_matches_reference(s, seeded):
    K, n, n_out, L = 4, 6, 7, 150
    rng = _rng("recode", s, seeded)
    P = rng.integers(0, 1 << s, (K, L)).astype(np.uint8)
    R = rng.integers(0, 1 << s, (n_out, n)).astype(np.uint8)
    jeng = JEngine(JConfig(s=s, kernel="auto", chunk_l=64))
    teng = CodingEngine(EngineConfig(s=s, kernel="cuda", chunk_l=64),
                        device="cpu")
    if seeded:
        seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        jb = jeng.encode(jnp.asarray(P), jnp.asarray(seeds))
        tb = teng.encode(_t(P), tseeds.as_seeds(seeds))
        assert isinstance(jb, JSeeded) and isinstance(tb, SeededBatch)
    else:
        A = rng.integers(0, 1 << s, (n, K)).astype(np.uint8)
        jb = jeng.encode(jnp.asarray(P), jnp.asarray(A))
        tb = teng.encode(_t(P), _t(A))
    d_ref, d_port = jeng.dispatch_count, teng.dispatch_count
    want = jeng.recode_with(jnp.asarray(R), jb)
    got = teng.recode_with(_t(R), tb)
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(want.A))
    np.testing.assert_array_equal(got.C.numpy(), np.asarray(want.C))
    assert teng.dispatch_count - d_port == jeng.dispatch_count - d_ref
    ok, P_hat = teng.decode(got)
    assert ok and torch.equal(P_hat, _t(P))


def test_recode_draws_relay_rows_and_still_decodes():
    K, L = 5, 90
    P = _t(_rng("relay").integers(0, 256, (K, L)).astype(np.uint8))
    eng = CodingEngine(EngineConfig(s=S, chunk_l=32), device="cpu")
    g = torch.Generator().manual_seed(4)
    batch = eng.encode(P, eng.coding_matrix(g, K + 1, K))
    relay = eng.recode(batch, g, n_out=K + 2)
    assert relay.A.shape == (K + 2, K) and relay.C.shape == (K + 2, L)
    # the module-level adapter runs the same engine on the batch's device
    relay2 = trlnc.recode(batch, g, K + 2, S)
    for out in (relay, relay2):
        ok, P_hat = eng.decode(out)
        assert ok and torch.equal(P_hat, P)
    both = batch.concat(relay)
    assert both.n == 2 * K + 3 and torch.equal(both.C[K + 1:], relay.C)
    sb = SeededBatch(seeds=tseeds.as_seeds([1, 2]), C=P[:2], K=K)
    assert sb.concat(sb).n == 4
    with pytest.raises(ValueError, match="generation sizes"):
        sb.concat(SeededBatch(seeds=sb.seeds, C=sb.C, K=K + 1))


def test_multi_hop_channel_matches_reference_given_its_mix():
    """The numpy draw of `base` is the reference's; the hop matrices are
    torch draws from it, so the stage-wise recode is compared on the
    reference's composed R."""
    K, n, L, eta = 4, 6, 70, 3
    rng = _rng("multihop")
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    A = rng.integers(0, 256, (n, K)).astype(np.uint8)
    jeng, teng = _engines()
    jch, tch = jchannel.MultiHopChannel(eta, seed=9), \
        tchannel.MultiHopChannel(eta, seed=9)
    R_ref = np.asarray(jchannel.MultiHopChannel(eta, seed=9)
                       .plan_transform(n, S).R)
    # the port's own plan: one numpy draw, η torch hop matrices from it
    own = tchannel.MultiHopChannel(eta, seed=9)
    base = int(np.random.default_rng(9).integers(0, 2**31 - 1))
    want_R = torch.eye(n, dtype=torch.uint8)
    f = get_field(S)
    for h in range(eta):
        want_R = f.matmul(f.random_elements(
            torch.Generator().manual_seed(base + h), (n, n)), want_R)
    assert torch.equal(own.plan_transform(n, S).R, want_R)
    tch.plan_transform = lambda n_, s_: tchannel.RowMix(_t(R_ref))
    jb = jeng.encode(jnp.asarray(P), jnp.asarray(A))
    tb = teng.encode(_t(P), _t(A))
    want, rep_w = jch.transmit_encoded(jb, S, engine=jeng)
    got, rep_g = tch.transmit_encoded(tb, S, engine=teng)
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(want.A))
    np.testing.assert_array_equal(got.C.numpy(), np.asarray(want.C))
    assert _report(rep_g) == _report(rep_w)
    # the default engine follows the batch's device (the CPU here)
    got2, _ = tchannel.MultiHopChannel(eta, seed=9).transmit_encoded(tb, S)
    ok, P_hat = teng.decode(got2)
    assert ok and torch.equal(P_hat, _t(P))


# ---------------------------------------------------------------------------
# fused rounds: RowMix, stage-wise fallback, decode_verified
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_l", [0, 64])
@pytest.mark.parametrize("seeded", [False, True])
def test_rowmix_round_matches_reference(seeded, chunk_l):
    K, n, L = 5, 7, 301
    rng = _rng("rowmix", seeded, chunk_l)
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    R = rng.integers(0, 256, (n, n)).astype(np.uint8)
    kernel = "auto_seeded" if seeded else "auto"
    jeng, teng = _engines(kernel=kernel, chunk_l=chunk_l)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if seeded:
        A = np.asarray(jeng.expand_seeds(jnp.asarray(seeds), K))
    else:
        A = rng.integers(0, 256, (n, K)).astype(np.uint8)
    want = jeng._run_round(jnp.asarray(P), jnp.asarray(A),
                           _Mix(jchannel.RowMix(jnp.asarray(R))),
                           seeds=jnp.asarray(seeds) if seeded else None)
    got = teng._run_round(_t(P), _t(A), _Mix(tchannel.RowMix(_t(R))),
                          seeds=tseeds.as_seeds(seeds) if seeded else None)
    _same_round(got, want, teng.dispatch_count, jeng.dispatch_count)
    assert got.ok and torch.equal(got.packets, _t(P))


def test_rowmix_round_singular_mix_fails_like_reference():
    K, n, L = 4, 5, 40
    rng = _rng("rowmix-singular")
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    A = rng.integers(0, 256, (n, K)).astype(np.uint8)
    R = np.zeros((n, n), np.uint8)
    R[:, 0] = rng.integers(1, 256, n)                # rank 1
    jeng, teng = _engines()
    want = jeng._run_round(jnp.asarray(P), jnp.asarray(A),
                           _Mix(jchannel.RowMix(jnp.asarray(R))))
    got = teng._run_round(_t(P), _t(A), _Mix(tchannel.RowMix(_t(R))))
    _same_round(got, want, teng.dispatch_count, jeng.dispatch_count)
    assert not got.ok


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("chan", ["erasure", "erasure_lossy", "blindbox"])
def test_stagewise_round_matches_reference(chan, verify):
    K, n, L = 5, 8, 200
    rng = _rng("stagewise", chan, verify)
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    A = rng.integers(0, 256, (n, K)).astype(np.uint8)
    make = {"erasure": ("ErasureChannel", (0.25,), 3),
            "erasure_lossy": ("ErasureChannel", (0.7,), 0),
            "blindbox": ("BlindBoxChannel", (9,), 4)}[chan]
    jeng, teng = _engines()
    name, args, seed = make
    want = jeng._run_round(jnp.asarray(P), jnp.asarray(A), _StageOnly(
        getattr(jchannel, name)(*args, seed=seed)), verify=verify)
    got = teng._run_round(_t(P), _t(A), _StageOnly(
        getattr(tchannel, name)(*args, seed=seed)), verify=verify)
    _same_round(got, want, teng.dispatch_count, jeng.dispatch_count)
    # the fused plan of the same channel gives the same bytes
    fused = CodingEngine(EngineConfig(s=S, chunk_l=64), device="cpu")
    fused = fused._run_round(_t(P), _t(A),
                             getattr(tchannel, name)(*args, seed=seed))
    assert fused.ok == got.ok
    if got.ok:
        assert torch.equal(fused.packets, got.packets)


@pytest.mark.parametrize("case", ["honest", "flipped", "square", "short",
                                  "singular"])
def test_decode_verified_matches_reference(case):
    K, L = 4, 120
    n = {"square": K, "short": K - 1}.get(case, K + 3)
    rng = _rng("verified", case)
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    A = rng.integers(0, 256, (n, K)).astype(np.uint8)
    if case == "singular":
        A[:, 1] = 0
    jeng, teng = _engines()
    C = np.asarray(jeng.encode(jnp.asarray(P), jnp.asarray(A)).C).copy()
    if case == "flipped":
        C[n - 1, 7] ^= 0x40                          # a redundant row
    d_ref, d_port = jeng.dispatch_count, teng.dispatch_count
    ok_r, P_r, v_r = jeng.decode_verified(JBatch(A=jnp.asarray(A),
                                                 C=jnp.asarray(C)))
    ok_t, P_t, v_t = teng.decode_verified(EncodedBatch(A=_t(A), C=_t(C)))
    assert (ok_t, v_t) == (bool(ok_r), v_r)
    assert teng.dispatch_count - d_port == jeng.dispatch_count - d_ref
    if ok_r:
        np.testing.assert_array_equal(P_t.numpy(), np.asarray(P_r))
    else:
        assert P_t is None
    expect = {"honest": True, "flipped": False, "square": None}
    if case in expect:
        assert v_t is expect[case]


# ---------------------------------------------------------------------------
# the byzantine channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("mode", ["flip", "forge", "both"])
def test_byzantine_round_matches_reference(mode, verify, seeded):
    K, n, L = 5, 9, 257
    kernel = "auto_seeded" if seeded else "auto"
    jeng, teng = _engines(kernel=kernel)
    flagged = 0
    for trial in range(3):
        rng = _rng("byz", mode, verify, seeded, trial)
        P = rng.integers(0, 256, (K, L)).astype(np.uint8)
        seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        if seeded:
            A = np.asarray(jeng.expand_seeds(jnp.asarray(seeds), K))
        else:
            A = rng.integers(0, 256, (n, K)).astype(np.uint8)
        jch = JByzantine(0.3, seed=trial, mode=mode)
        tch = ByzantineChannel(0.3, seed=trial, mode=mode)
        plan_j = JByzantine(0.3, seed=trial, mode=mode).plan_transform(n, S)
        plan_t = ByzantineChannel(0.3, seed=trial, mode=mode) \
            .plan_transform(n, S)
        np.testing.assert_array_equal(plan_t.idx, plan_j.idx)
        want = jeng._run_round(jnp.asarray(P), jnp.asarray(A), jch,
                               seeds=jnp.asarray(seeds) if seeded else None,
                               verify=verify)
        got = teng._run_round(_t(P), _t(A), tch,
                              seeds=tseeds.as_seeds(seeds) if seeded
                              else None, verify=verify)
        _same_round(got, want, teng.dispatch_count, jeng.dispatch_count)
        assert tch.corrupted == jch.corrupted
        flagged += got.verified is False
        # the fused round == the stage-wise oracle of the same channel
        stage = CodingEngine(EngineConfig(s=S, chunk_l=64), device="cpu")
        batch, rep = ByzantineChannel(0.3, seed=trial, mode=mode) \
            .transmit_encoded(stage.encode(_t(P), _t(A)), S)
        ok, P_hat, ver = stage.decode_verified(batch)
        assert ok == got.ok
        if ok:
            assert torch.equal(P_hat, got.packets)
            if verify:
                assert ver == got.verified
    if verify:
        assert flagged > 0                           # corruption detected


def test_apply_tamper_matches_reference():
    from repro.adversary import apply_tamper as j_apply
    K, n, L = 4, 7, 33
    rng = _rng("tamper")
    A = rng.integers(0, 256, (n, K)).astype(np.uint8)
    C = rng.integers(0, 256, (n, L)).astype(np.uint8)
    for mode in ("flip", "forge", "both"):
        plan_j = JByzantine(0.5, seed=2, mode=mode).plan_transform(n, S)
        plan_t = ByzantineChannel(0.5, seed=2, mode=mode).plan_transform(n, S)
        want = j_apply(JBatch(A=jnp.asarray(A), C=jnp.asarray(C)), plan_j, S)
        got = apply_tamper(EncodedBatch(A=_t(A), C=_t(C)), plan_t, S)
        np.testing.assert_array_equal(got.A.numpy(), np.asarray(want.A))
        np.testing.assert_array_equal(got.C.numpy(), np.asarray(want.C))
    with pytest.raises(ValueError, match="mode"):
        ByzantineChannel(0.1, mode="replay")
    with pytest.raises(ValueError, match="rate"):
        ByzantineChannel(1.5)


def test_rounds_to_recovery_accepts_a_correct_decode():
    K, L = 5, 80
    P = _t(_rng("recovery").integers(0, 256, (K, L)).astype(np.uint8))
    eng = CodingEngine(EngineConfig(s=S, extra_tuples=3, chunk_l=32),
                       device="cpu")
    for mode in ("flip", "forge", "both"):
        out = rounds_to_recovery(eng, P, torch.Generator().manual_seed(1),
                                 ByzantineChannel(0.2, seed=5, mode=mode))
        assert out["accepted"] and out["correct"], (mode, out)
    out = rounds_to_recovery(eng, P, torch.Generator().manual_seed(1),
                             ByzantineChannel(1.0, seed=5, mode="flip"),
                             max_rounds=3)
    assert out == {"rounds": 3, "flagged": 3, "rank_failures": 0,
                   "accepted": False, "correct": False}


# ---------------------------------------------------------------------------
# the multi-edge round and the hierarchical round
# ---------------------------------------------------------------------------

EDGES = [(0, 1, 2), (3, 4), (5,)]


@pytest.mark.parametrize("wan", ["none", "erasure", "mix"])
def test_multi_edge_matrix_round_matches_reference(wan):
    K, L, spare = 6, 211, 1
    P = _rng("edges", wan).integers(0, 256, (K, L)).astype(np.uint8)
    jeng, teng = _engines()
    n_out = [len(e) + spare for e in EDGES]
    A = np.asarray(jeng.multi_edge_coding_matrix(jax.random.PRNGKey(3),
                                                 EDGES, K, n_out))
    n = A.shape[0]
    R = _rng("edges-R").integers(0, 256, (n, n)).astype(np.uint8)
    chans = {"none": (None, None),
             "erasure": (jchannel.ErasureChannel(0.2, seed=1),
                         tchannel.ErasureChannel(0.2, seed=1)),
             "mix": (_Mix(jchannel.RowMix(jnp.asarray(R))),
                     _Mix(tchannel.RowMix(_t(R))))}[wan]
    want = jeng._run_round(jnp.asarray(P), jnp.asarray(A), chans[0])
    got = teng._run_round(_t(P), _t(A), chans[1])
    _same_round(got, want, teng.dispatch_count, jeng.dispatch_count)


def test_multi_edge_coding_matrix_support():
    K = 6
    eng = CodingEngine(EngineConfig(s=S), device="cpu")
    n_out = [len(e) + 2 for e in EDGES]
    A = eng.multi_edge_coding_matrix(torch.Generator().manual_seed(0), EDGES,
                                     K, n_out)
    assert A.shape == (sum(n_out), K) and A.dtype == torch.uint8
    row = 0
    for e, ids in enumerate(EDGES):
        block = A[row:row + n_out[e]]
        outside = [c for c in range(K) if c not in ids]
        assert not block[:, outside].any()
        assert block[:, list(ids)].any()
        row += n_out[e]
    # the per-edge reference draws the same blocks from the same stream
    g = torch.Generator().manual_seed(0)
    cfg = tfednc.FedNCConfig(s=S)
    P = torch.zeros((K, 8), dtype=torch.uint8)
    blocks = [thier.edge_encode(P, thier.EdgeGroup(ids), K, n_out[e], cfg, g)
              for e, ids in enumerate(EDGES)]
    assert torch.equal(torch.cat([b.A for b in blocks]), A)


def _clients(K: int, seed: int):
    """K small parameter trees (two leaves) made with numpy."""
    rng = np.random.default_rng(seed)
    return [{"b": _t(rng.standard_normal(7).astype(np.float32)),
             "w": _t(rng.standard_normal((5, 9)).astype(np.float32))}
            for _ in range(K)]


@pytest.mark.parametrize("wan", ["none", "multihop", "erasure"])
@pytest.mark.parametrize("s", [1, 8])
def test_hierarchical_round_fused_equals_per_edge_and_fedavg(s, wan):
    K = 6
    clients = _clients(K, seed=s)
    weights = [3.0, 1.0, 2.0, 5.0, 1.0, 4.0]
    want = tfednc.fedavg_round(clients, weights, None).global_params
    cfg = tfednc.FedNCConfig(s=s, kernel_impl="cuda", chunk_l=128)
    # generator seed 8 reaches rank K under all three WANs, also at s=1,
    # where a random binary edge block is singular more often
    outs = []
    for fused in (True, False):
        chan = {"none": None,
                "multihop": tchannel.MultiHopChannel(2, seed=3),
                "erasure": tchannel.ErasureChannel(0.1, seed=2)}[wan]
        outs.append(thier.hierarchical_fednc_round(
            clients, weights, None, cfg, torch.Generator().manual_seed(8),
            num_edges=3, spare_per_edge=2, wan_channel=chan, fused=fused,
            device="cpu"))
    fused, staged = outs
    assert fused.decoded and staged.decoded
    assert _report(fused.report) == _report(staged.report)
    for res in outs:
        for a, b in zip(tpackets.tree_flatten(res.global_params)[0],
                        tpackets.tree_flatten(want)[0], strict=True):
            assert torch.equal(a, b)


def test_encode_clients_and_decode_and_aggregate_equal_fedavg():
    K = 4
    clients = _clients(K, seed=21)
    weights = [1.0, 2.0, 3.0, 4.0]
    cfg = tfednc.FedNCConfig(s=4, extra_tuples=2, chunk_l=64)
    batch, spec = tfednc.encode_clients(clients, cfg,
                                        torch.Generator().manual_seed(2),
                                        device="cpu")
    assert batch.n == K + 2
    res = tfednc.decode_and_aggregate(batch[torch.tensor([5, 0, 3, 2, 4])],
                                      spec, weights, None, cfg, device="cpu")
    want = tfednc.fedavg_round(clients, weights, None).global_params
    assert res.decoded and res.n_aggregated == K
    for a, b in zip(tpackets.tree_flatten(res.global_params)[0],
                    tpackets.tree_flatten(want)[0], strict=True):
        assert torch.equal(a, b)
    P, spec2 = tfednc.packetize_clients(clients, cfg, device="cpu")
    agg = tfednc.aggregate_decoded(P, spec2, weights)
    for a, b in zip(tpackets.tree_flatten(agg)[0],
                    tpackets.tree_flatten(want)[0], strict=True):
        assert torch.equal(a, b)
    short = tfednc.decode_and_aggregate(batch[:K - 1], spec, weights, "prev",
                                        cfg, device="cpu")
    assert not short.decoded and short.global_params == "prev"
