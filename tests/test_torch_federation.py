"""repro_torch.federation (and the core pieces it needs) against repro's.

Strategies first, on the same client parameters (made with numpy,
carried across with `params_from_jax`) and copies of one numpy
generator: every strategy must consume the generator as the reference
does, and every coded aggregate must equal the reference's bit for
bit (the quantized one within dequantization's 1e-6) and the port's
own `fedavg_round`.  Then whole runs of `run_experiment` and
`run_async_experiment` at image size 8, 6 clients, 3 per round, 2
rounds, trained with SGD (whose trajectories stay together; see
tests/test_torch_cnn.py): the same cohorts and batches, the same
decode outcomes and arrival counts, and losses within 1e-3.

A port coding matrix comes from a torch generator, so which rounds
decode would differ from the reference's.  These tests run the
reference first and hand each coding matrix it drew to the port in
the same order (`shared_coding`); nothing is redrawn.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import channel as jchannel
from repro.core import coupon as jcoupon
from repro.core import fednc as jfednc
from repro.core import rlnc as jrlnc
from repro.core import security as jsecurity
from repro.data import iid_partition, make_image_dataset
from repro.federation import async_rounds as jasync
from repro.federation import rounds as jrounds
from repro.federation import server as jserver
from repro.federation.client import LocalTrainer as JLocalTrainer
from repro.models import cnn as jcnn
from repro.sim import STRAGGLER_PROFILES as J_PROFILES
from repro.sim.compute import ComputeModel as JComputeModel
from repro_torch import optim as topt
from repro_torch.core import channel as tchannel
from repro_torch.core import coupon as tcoupon
from repro_torch.core import fednc as tfednc
from repro_torch.core import packets as tpackets
from repro_torch.core import rlnc as trlnc
from repro_torch.core import security as tsecurity
from repro_torch.federation import async_rounds as tasync
from repro_torch.federation import rounds as trounds
from repro_torch.federation import server as tserver
from repro_torch.federation.client import LocalTrainer
from repro_torch.models import cnn as tcnn
from repro_torch.sim import STRAGGLER_PROFILES as T_PROFILES
from repro_torch.sim.compute import ComputeModel

IMAGE = 8
K = 4                      # clients in a strategy's cohort
N_CLIENTS, PER_ROUND, ROUNDS = 6, 3, 2


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

@pytest.fixture
def shared_coding(monkeypatch):
    """Record every coding matrix the reference draws; the port's draws
    replay them in order."""
    drawn = []

    def record(key, n, k, s):
        A = jrlnc_draw(key, n, k, s)
        drawn.append(np.asarray(A))
        return A

    def replay(generator, n, k, s):
        A = drawn.pop(0)
        assert A.shape == (n, k)
        return torch.from_numpy(A.copy()).to(generator.device)

    jrlnc_draw = jrlnc.random_coding_matrix
    for mod in (jrlnc, jserver):
        monkeypatch.setattr(mod, "random_coding_matrix", record)
    monkeypatch.setattr(trlnc, "random_coding_matrix", replay)
    yield drawn
    assert not drawn, "the port drew fewer coding matrices"


@pytest.fixture(scope="module")
def clients():
    layout = jax.eval_shape(
        lambda: jcnn.init_cnn(jax.random.PRNGKey(0), image_size=IMAGE))
    rng = np.random.default_rng(5)
    return [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(x.dtype), layout)
        for _ in range(K)]


WEIGHTS = np.array([0.1, 0.4, 0.3, 0.2], np.float32)


def _port(tree):
    return tpackets.params_from_jax(tree, device="cpu")


def _leaves(tree):
    """The leaves of a JAX or a port tree (both in sorted-key order)."""
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in jax.tree_util.tree_leaves(tree)]


def _equal(a, b, atol=0.0):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _aggregate_both(jstrat, tstrat, clients, seed=3, **kw):
    """One aggregate per package from copies of one generator; returns
    (reference result, port result, next draw of each generator)."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jstrat.aggregate(clients, WEIGHTS, clients[0], rj, **kw)
    got = tstrat.aggregate([_port(c) for c in clients], WEIGHTS,
                           _port(clients[0]), rt, **kw)
    assert rt.integers(0, 2**31) == rj.integers(0, 2**31)   # same stream
    return want, got


def _same_report(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert vars(got) == vars(want)


def _fedavg(clients):
    return tfednc.fedavg_round([_port(c) for c in clients], WEIGHTS,
                               None).global_params


# ---------------------------------------------------------------------------
# strategies on the same clients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channel", ["none", "blind_box", "erasure"])
def test_fedavg_strategy_matches(clients, channel):
    make = {"none": lambda m: None,
            "blind_box": lambda m: m.BlindBoxChannel(budget=K, seed=1),
            "erasure": lambda m: m.ErasureChannel(0.3, seed=2)}[channel]
    want, got = _aggregate_both(
        jserver.FedAvgStrategy(channel=make(jchannel)),
        tserver.FedAvgStrategy(channel=make(tchannel)), clients)
    assert (got.decoded, got.n_aggregated) == (want.decoded,
                                               want.n_aggregated)
    _same_report(got.report, want.report)
    _equal(got.global_params, want.global_params)


@pytest.mark.parametrize("s,channel,bits", [
    (8, "blind_box", 0), (1, "blind_box", 0), (8, "none", 8),
    (4, "erasure", 0)])
def test_fednc_strategy_matches(clients, shared_coding, s, channel, bits):
    make = {"none": lambda m: None,
            "blind_box": lambda m: m.BlindBoxChannel(budget=K + 1, seed=1),
            "erasure": lambda m: m.ErasureChannel(0.2, seed=4)}[channel]
    jcfg = jfednc.FedNCConfig(s=s, quantize_bits=bits, extra_tuples=1)
    tcfg = tfednc.FedNCConfig(s=s, quantize_bits=bits, extra_tuples=1)
    want, got = _aggregate_both(
        jserver.FedNCStrategy(config=jcfg, channel=make(jchannel)),
        tserver.FedNCStrategy(config=tcfg, channel=make(tchannel),
                              device="cpu"), clients, seed=s)
    assert (got.decoded, got.n_aggregated) == (want.decoded,
                                               want.n_aggregated)
    _same_report(got.report, want.report)
    _equal(got.global_params, want.global_params, atol=1e-6 if bits else 0)
    if got.decoded and not bits:
        _equal(got.global_params, _fedavg(clients))


@pytest.mark.parametrize("overrides", [
    {"quantize_bits": 8}, {"systematic": True}, {"coding_density": 0.5},
    {"quantize_bits": 8, "systematic": True}])
def test_fednc_strategy_blind_box_honors_its_config(clients, monkeypatch,
                                                    overrides):
    """Under the blind box the port's FedNCStrategy packetizes, draws
    and dequantizes through the config (the reference's ignores it,
    ROADMAP.md §3 R5): on the coding matrix the reference's
    `fednc_round` draws for the same config and `budget` tuples, both
    decode to the same aggregate (quantized: within dequantization's
    1e-6), which is FedAvg of the (dequantized) updates bit for bit; the
    matrix the port encodes with is systematic or sparse as asked."""
    from repro.engine import engine as jengine
    from repro_torch.engine import engine as tengine
    budget = K + 2
    drawn, used = [], []
    jdraw = jengine.CodingEngine.coding_matrix

    def record(self, key, n, k):
        A = jdraw(self, key, n, k)
        drawn.append(np.asarray(A))
        return A

    monkeypatch.setattr(jengine.CodingEngine, "coding_matrix", record)
    want = jfednc.fednc_round(
        clients, WEIGHTS, clients[0],
        jfednc.FedNCConfig(s=8, extra_tuples=budget - K, **overrides),
        jax.random.PRNGKey(3))
    assert len(drawn) == 1 and drawn[0].shape == (budget, K)
    tencode = tengine.CodingEngine.encode

    def spy(self, P, A):
        used.append(A.numpy().copy())
        return tencode(self, P, A)

    monkeypatch.setattr(tengine.CodingEngine, "coding_matrix",
                        lambda self, g, n, k: torch.from_numpy(drawn.pop().copy()))
    monkeypatch.setattr(tengine.CodingEngine, "encode", spy)
    port_clients = [_port(c) for c in clients]
    got = tserver.FedNCStrategy(
        config=tfednc.FedNCConfig(s=8, **overrides),
        channel=tchannel.BlindBoxChannel(budget=budget, seed=1),
        device="cpu").aggregate(port_clients, WEIGHTS, port_clients[0],
                                np.random.default_rng(3))
    assert not drawn and want.decoded and got.decoded
    assert got.n_aggregated == K and got.report.delivered == budget
    bits = overrides.get("quantize_bits", 0)
    _equal(got.global_params, want.global_params, atol=1e-6 if bits else 0)
    if bits:
        port_clients = [tpackets.dequantize_pytree(
            *tpackets.quantize_pytree(c, bits=bits)) for c in port_clients]
    _equal(got.global_params, tfednc.fedavg_round(
        port_clients, WEIGHTS, None).global_params)
    A = used[0]
    if overrides.get("systematic"):
        np.testing.assert_array_equal(A[:K], np.eye(K, dtype=np.uint8))
    if "coding_density" in overrides:
        assert (A == 0).any() and (A != 0).any(axis=1).all()


@pytest.mark.parametrize("s,coupled", [(8, False), (8, True), (1, True)])
def test_async_strategy_matches(clients, shared_coding, s, coupled):
    kw = {}
    if coupled:
        kw["compute_times"] = JComputeModel().times(
            np.random.default_rng(7), K)
    strat = {"budget": K + 3}
    want, got = _aggregate_both(
        jserver.AsyncFedNCStrategy(
            config=jfednc.FedNCConfig(s=s),
            schedule_fn=jasync.blind_box_schedule(J_PROFILES["pareto"]),
            **strat),
        tserver.AsyncFedNCStrategy(
            config=tfednc.FedNCConfig(s=s),
            schedule_fn=tasync.blind_box_schedule(T_PROFILES["pareto"]),
            device="cpu", **strat), clients, seed=11 + s, **kw)
    assert vars(got.report) == vars(want.report)
    assert got.report.consumed >= K or not got.decoded
    assert (got.decoded, got.n_aggregated) == (want.decoded,
                                               want.n_aggregated)
    _equal(got.global_params, want.global_params)
    if got.decoded:
        _equal(got.global_params, _fedavg(clients))


def test_async_strategy_quantized_matches(clients, shared_coding):
    want, got = _aggregate_both(
        jserver.AsyncFedNCStrategy(config=jfednc.FedNCConfig(
            s=8, quantize_bits=8)),
        tserver.AsyncFedNCStrategy(config=tfednc.FedNCConfig(
            s=8, quantize_bits=8), device="cpu"), clients, seed=2)
    assert vars(got.report) == vars(want.report) and got.decoded
    _equal(got.global_params, want.global_params, atol=1e-6)


def test_quantized_encode_and_decode_match(clients, shared_coding):
    """`encode_clients` / `decode_and_aggregate` carry the qspecs."""
    jcfg = jfednc.FedNCConfig(s=4, quantize_bits=8, extra_tuples=2)
    tcfg = tfednc.FedNCConfig(s=4, quantize_bits=8, extra_tuples=2)
    jb, jspec, jq = jfednc.encode_clients(clients, jcfg,
                                          jax.random.PRNGKey(1))
    tb, tspec, tq = tfednc.encode_clients(
        [_port(c) for c in clients], tcfg, torch.Generator(), device="cpu")
    np.testing.assert_array_equal(tb.C.numpy(), np.asarray(jb.C))
    assert [q.zeros for q in tq] == [q.zeros for q in jq]
    want = jfednc.decode_and_aggregate(jb, jspec, WEIGHTS, None, jcfg,
                                       qspecs=jq)
    got = tfednc.decode_and_aggregate(tb, tspec, WEIGHTS, None, tcfg,
                                      qspecs=tq, device="cpu")
    assert got.decoded == want.decoded
    _equal(got.global_params, want.global_params, atol=1e-6)


@pytest.mark.parametrize("s,jkernel,tkernel", [(8, "auto", "auto"),
                                               (1, "jnp", "cuda")])
def test_hierarchical_strategy_equals_fedavg(clients, s, jkernel, tkernel):
    """The port's XOR kernel (`cuda` at s = 1; its plain version here)
    or packed kernel; the edge matrices are the port's own draws."""
    want, got = _aggregate_both(
        jserver.HierarchicalFedNCStrategy(
            config=jfednc.FedNCConfig(s=s, kernel_impl=jkernel),
            spare_per_edge=2),
        tserver.HierarchicalFedNCStrategy(
            config=tfednc.FedNCConfig(s=s, kernel_impl=tkernel),
            spare_per_edge=2, device="cpu"), clients, seed=4)
    assert got.decoded, got.report
    assert got.n_aggregated == K
    _equal(got.global_params, _fedavg(clients))


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def _he_init(rng):
    """`init_cnn`'s distribution drawn with numpy (as in
    tests/test_torch_cnn.py)."""
    layout = jax.eval_shape(
        lambda: jcnn.init_cnn(jax.random.PRNGKey(0), image_size=IMAGE))
    p = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), layout)
    for name, layer in p.items():
        fan_in = int(np.prod(layer["w"].shape[:-1]))
        scale = np.sqrt(2.0 / fan_in) if name != "fc" else 1 / np.sqrt(fan_in)
        layer["w"] = (scale * rng.standard_normal(layer["w"].shape)
                      ).astype(np.float32)
        for key in ("bn_scale", "bn_var"):
            if key in layer:
                layer[key] = np.ones_like(layer[key])
    return p


class _Recorder:
    """A trainer that notes every batch it is handed."""

    def __init__(self, trainer):
        self.trainer, self.local_epochs = trainer, trainer.local_epochs
        self.seen = []

    def train(self, params, it):
        got = list(it)
        self.seen.append([(float(x.sum()), y.tolist()) for x, y in got])
        return self.trainer.train(params, iter(got))


@pytest.fixture(scope="module")
def setting():
    ds = make_image_dataset(96, size=IMAGE, noise=1.0, seed=0)
    test = make_image_dataset(40, size=IMAGE, noise=1.0, seed=99)
    parts = iid_partition(ds.labels, N_CLIENTS, seed=1)
    init = _he_init(np.random.default_rng(6))
    jtrainer = JLocalTrainer(
        loss_fn=lambda p, b: jcnn.cnn_loss(p, b, train=True),
        optimizer=jopt.sgd(0.05), local_epochs=1,
        state_merge=jcnn.merge_bn_stats)
    ttrainer = LocalTrainer(
        loss_fn=lambda p, b: tcnn.cnn_loss(p, b, train=True),
        optimizer=topt.sgd(0.05), local_epochs=1,
        state_merge=tcnn.merge_bn_stats, device="cpu")
    return ds, test, parts, init, jtrainer, ttrainer


def _experiments(setting, jstrat, tstrat):
    ds, test, parts, _, jtrainer, ttrainer = setting
    out = []
    for mod, strat, trainer, acc in (
            (jrounds, jstrat, jtrainer, jcnn.cnn_accuracy),
            (trounds, tstrat, ttrainer, tcnn.cnn_accuracy)):
        out.append(mod.FLExperiment(
            trainer=_Recorder(trainer), strategy=strat, partitions=parts,
            dataset=ds, test_set=test, eval_fn=acc,
            clients_per_round=PER_ROUND, batch_size=8, seed=3))
    return out


def _same_runs(jexp, texp, jlogs, tlogs):
    assert texp.trainer.seen == jexp.trainer.seen      # cohorts, batches
    assert len(tlogs) == len(jlogs) == ROUNDS
    for got, want in zip(tlogs, jlogs, strict=True):
        assert (got.round, got.decoded, got.n_aggregated) == (
            want.round, want.decoded, want.n_aggregated)
        assert abs(got.train_loss - want.train_loss) <= 1e-3
        assert 0.0 <= got.test_acc <= 1.0 and got.wall_s > 0
        assert abs(got.test_acc - want.test_acc) <= 1 / 40 + 1e-9


@pytest.mark.parametrize("name", ["fedavg", "fedavg_blind_box",
                                  "fednc_blind_box_s1"])
def test_run_experiment_matches(setting, shared_coding, name):
    strategies = {
        "fedavg": lambda m, **kw: m.FedAvgStrategy(),
        "fedavg_blind_box": lambda m, **kw: m.FedAvgStrategy(
            channel=(jchannel if m is jserver else tchannel)
            .BlindBoxChannel(budget=PER_ROUND)),
        "fednc_blind_box_s1": lambda m, **kw: m.FedNCStrategy(
            config=(jfednc if m is jserver else tfednc).FedNCConfig(s=1),
            channel=(jchannel if m is jserver else tchannel)
            .BlindBoxChannel(budget=PER_ROUND), **kw),
    }
    jexp, texp = _experiments(setting, strategies[name](jserver),
                              strategies[name](tserver, device="cpu")
                              if name.startswith("fednc")
                              else strategies[name](tserver))
    init = setting[3]
    jlogs = jrounds.run_experiment(jexp, init, ROUNDS)
    tlogs = trounds.run_experiment(texp, _port(init), ROUNDS)
    _same_runs(jexp, texp, jlogs, tlogs)
    assert trounds.final_accuracy(tlogs) == pytest.approx(
        jrounds.final_accuracy(jlogs), abs=1 / 40 + 1e-9)


def test_run_async_experiment_matches(setting, shared_coding):
    kw = dict(budget=PER_ROUND + 4)
    jexp, texp = _experiments(
        setting,
        jserver.AsyncFedNCStrategy(
            config=jfednc.FedNCConfig(s=8),
            schedule_fn=jasync.blind_box_schedule(J_PROFILES["pareto"]),
            **kw),
        tserver.AsyncFedNCStrategy(
            config=tfednc.FedNCConfig(s=8),
            schedule_fn=tasync.blind_box_schedule(T_PROFILES["pareto"]),
            device="cpu", **kw))
    init = setting[3]
    jlogs = jasync.run_async_experiment(jexp, init, ROUNDS,
                                        compute=JComputeModel())
    tlogs = tasync.run_async_experiment(texp, _port(init), ROUNDS,
                                        compute=ComputeModel())
    _same_runs(jexp, texp, jlogs, tlogs)
    for got, want in zip(tlogs, jlogs, strict=True):
        assert (got.consumed, got.sim_time, got.sim_time_network) == (
            want.consumed, want.sim_time, want.sim_time_network)
        assert got.sim_time >= got.sim_time_network > 0


def test_fl_spans_are_emitted(setting):
    from repro_torch import obs
    _, texp = _experiments(setting, jserver.FedAvgStrategy(),
                           tserver.FedAvgStrategy())
    tracer = obs.set_tracer(obs.Tracer())
    try:
        trounds.run_experiment(texp, _port(setting[3]), 1)
    finally:
        obs.set_tracer(obs.NULL_TRACER)
    names = [e["name"] for e in tracer.to_document()["traceEvents"]
             if e.get("ph") == "X"]
    assert names.count("fl.local_train") == PER_ROUND
    assert names.count("fl.round") == 1


# ---------------------------------------------------------------------------
# core pieces: closed forms, Monte-Carlo, schedules, compute, blind box
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K_,s", [(1, 1), (4, 1), (10, 8), (6, 4)])
def test_closed_forms_equal(K_, s):
    for name in ("singular_probability_uniform",):
        assert getattr(tsecurity, name)(K_, s) == getattr(jsecurity, name)(
            K_, s)
    for eta in (1, 3, 100):
        assert tsecurity.error_probability_bound(s, eta) == \
            jsecurity.error_probability_bound(s, eta)
    for n in (K_ - 1, K_, K_ + 3):
        assert tsecurity.full_rank_probability(n, K_, s) == \
            jsecurity.full_rank_probability(n, K_, s)
        assert tsecurity.eavesdropper_leak_probability(n, K_, 0.4, s) == \
            jsecurity.eavesdropper_leak_probability(n, K_, 0.4, s)
    assert tsecurity.eavesdropper_full_leak_probability(K_, 0.7, s) == \
        jsecurity.eavesdropper_full_leak_probability(K_, 0.7, s)
    assert tsecurity.fedavg_expected_leak(K_, 0.3) == \
        jsecurity.fedavg_expected_leak(K_, 0.3)
    for name in ("harmonic", "expected_draws_fedavg",
                 "expected_draws_fedavg_asymptotic"):
        assert getattr(tcoupon, name)(K_) == getattr(jcoupon, name)(K_)
    assert tcoupon.expected_draws_fednc(K_, s) == \
        jcoupon.expected_draws_fednc(K_, s)


@pytest.mark.parametrize("K_,s,trials", [(4, 1, 40), (5, 8, 12), (3, 2, 25)])
def test_simulated_draws_equal(K_, s, trials):
    np.testing.assert_array_equal(
        tcoupon.simulate_fednc_draws(K_, s, trials, seed=3),
        jcoupon.simulate_fednc_draws(K_, s, trials, seed=3))
    np.testing.assert_array_equal(
        tcoupon.simulate_fedavg_draws(K_, trials, seed=3),
        jcoupon.simulate_fedavg_draws(K_, trials, seed=3))


def test_simulate_error_probability_matches(shared_coding):
    """η = 1: no recoding hop, so a trial fails iff its coding matrix
    is singular; with the reference's matrices the rates are equal."""
    want = jsecurity.simulate_error_probability(4, 1, 1, 12, seed=2)
    got = tsecurity.simulate_error_probability(4, 1, 1, 12, seed=2,
                                               device="cpu")
    assert got == want and 0 < got < 1


def test_simulate_error_probability_through_hops():
    rate = tsecurity.simulate_error_probability(3, 1, 3, 20, seed=0,
                                                device="cpu")
    assert 0 < rate <= 1


@pytest.mark.parametrize("model", [
    dict(), dict(measured_scale=2.5), dict(flops_per_second=3.0)])
def test_compute_model_times_equal(model):
    wall = np.array([0.5, 1.5, 0.0, 2.0])
    want = JComputeModel(**model).times(np.random.default_rng(4), 4,
                                        measured_wall=wall)
    got = ComputeModel(**model).times(np.random.default_rng(4), 4,
                                      measured_wall=wall)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all()


@pytest.mark.parametrize("profile", sorted(T_PROFILES))
def test_arrival_schedules_equal(profile):
    want = jasync.blind_box_schedule(J_PROFILES[profile], rate_scale=2.0)(
        9, np.random.default_rng(1))
    got = tasync.blind_box_schedule(T_PROFILES[profile], rate_scale=2.0)(
        9, np.random.default_rng(1))
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.order, want.order)
    assert [got.time_of(g) for g in range(1, 10)] == [
        want.time_of(g) for g in range(1, 10)]
    off = np.linspace(0, 3, 9)
    np.testing.assert_array_equal(got.offset_by(off).order,
                                  want.offset_by(off).order)
    with pytest.raises(ValueError):
        got.time_of(10)
    with pytest.raises(ValueError):
        got.offset_by(off[:3])


def test_blind_box_receive_matches():
    packets = np.arange(24, dtype=np.uint8).reshape(4, 6)
    jb, tb = (jchannel.BlindBoxChannel(budget=6, seed=3),
              tchannel.BlindBoxChannel(budget=6, seed=3))
    dj, ij, rj = jb.receive_plain(packets)
    dt, it_, rt = tb.receive_plain(torch.from_numpy(packets))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it_, ij)
    assert vars(rt) == vars(rj)
    A = np.random.default_rng(0).integers(0, 2, (6, 4)).astype(np.uint8)
    bj, repj = jb.receive_encoded(
        lambda n: jrlnc.EncodedBatch(A=A[:n], C=A[:n]), 4, 1)
    bt, rept = tb.receive_encoded(
        lambda n: trlnc.EncodedBatch(A=torch.from_numpy(A[:n]),
                                     C=torch.from_numpy(A[:n])), 4, 1)
    assert vars(rept) == vars(repj)
    np.testing.assert_array_equal(bt.A.numpy(), np.asarray(bj.A))


def test_async_report_fields():
    rep = tchannel.AsyncChannelReport(sent=5, delivered=3, decodable=True,
                                      consumed=3, sim_time=1.5)
    ref = jchannel.AsyncChannelReport(sent=5, delivered=3, decodable=True,
                                      consumed=3, sim_time=1.5)
    assert list(vars(rep)) == list(vars(ref))
    assert np.isnan(rep.sim_time_network)
    assert copy.copy(rep).consumed == 3
