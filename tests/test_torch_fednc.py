"""repro_torch's FedNC round against repro's, on the paper CNN.

Client parameters are made once with numpy and handed to both packages
(`params_from_jax` carries the JAX layout across untouched).  The
packets are GF data and compare byte-exact.  The aggregates are float32
sums: both packages compute Σ_k w_k·x_k as separate, rounded float32
multiplies and adds in the same term order (weights normalised in
numpy float32), so they are compared bit-exact too; within the port,
FedNC == FedAvg bit for bit is the paper's zero-accuracy-cost claim.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import channel as jchannel
from repro.core import fednc as jfednc
from repro.core import packets as jpackets
from repro.models import cnn as jcnn
from repro_torch.core import channel as tchannel
from repro_torch.core import fednc as tfednc
from repro_torch.core import packets as tpackets
from repro_torch.models import cnn as tcnn

K = 4
IMAGE = 8              # small image: the fc layer shrinks, convs stay
CHUNK = 1 << 18        # the default chunk width: 5 chunks, a ragged last one


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def clients():
    """K CNN parameter trees as numpy (the JAX layout), made with numpy."""
    layout = jax.eval_shape(
        lambda: jcnn.init_cnn(jax.random.PRNGKey(0), image_size=IMAGE))
    rng = np.random.default_rng(0)
    return [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(x.dtype), layout)
        for _ in range(K)]


def _port(trees):
    return [tpackets.params_from_jax(t, device="cpu") for t in trees]


def test_init_cnn_matches_reference_layout():
    ref = jax.eval_shape(
        lambda: jcnn.init_cnn(jax.random.PRNGKey(0), image_size=32))
    got = tcnn.init_cnn(torch.Generator().manual_seed(0), image_size=32)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_leaves, _ = tpackets.tree_flatten(got)
    assert len(got_leaves) == len(ref_leaves) == 38
    for (path, r), t in zip(ref_leaves, got_leaves, strict=True):
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).split(".")[-1] == str(r.dtype), path
    assert sum(t.numel() for t in got_leaves) == 309_290
    assert got["conv0"]["w"].shape == (3, 3, 3, 32)        # HWIO


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_packets_match_reference_bytes(clients, s):
    P_ref, spec_ref = jpackets.pytrees_to_packets(clients, s=s)
    P, spec = tpackets.pytrees_to_packets(_port(clients), s=s)
    assert P.dtype == torch.uint8
    np.testing.assert_array_equal(P.numpy(), np.asarray(P_ref))
    assert spec.n_bytes == spec_ref.n_bytes
    assert spec.shapes == spec_ref.shapes
    back = tpackets.packets_to_pytrees(P, spec)
    for k in range(K):
        for got, want in zip(tpackets.tree_flatten(back)[0],
                             _leaves(clients[k]), strict=True):
            np.testing.assert_array_equal(got[k].numpy(), want)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_symbol_split_matches_reference(s):
    b = np.random.default_rng(s).integers(0, 256, 77).astype(np.uint8)
    sym = tpackets.bytes_to_symbols(torch.from_numpy(b), s)
    np.testing.assert_array_equal(
        sym.numpy(), np.asarray(jpackets.bytes_to_symbols(b, s)))
    np.testing.assert_array_equal(
        tpackets.symbols_to_bytes(sym, s).numpy(), b)


@pytest.mark.parametrize("kernel", ["auto", "auto_seeded"])
def test_fednc_round_matches_reference(clients, kernel):
    weights = [3.0, 1.0, 2.0, 5.0]
    extra = 2
    # seed 7 at p=0.3 delivers 5 of the 6 tuples: a decodable erasure
    ref = jfednc.fednc_round(
        clients, weights, clients[0],
        jfednc.FedNCConfig(kernel_impl=kernel, extra_tuples=extra,
                           chunk_l=CHUNK),
        jax.random.PRNGKey(1), channel=jchannel.ErasureChannel(0.3, seed=7))
    got = tfednc.fednc_round(
        _port(clients), weights, None,
        tfednc.FedNCConfig(kernel_impl=kernel, extra_tuples=extra,
                           chunk_l=CHUNK),
        torch.Generator().manual_seed(1),
        channel=tchannel.ErasureChannel(0.3, seed=7), device="cpu")
    assert ref.decoded and got.decoded
    assert (got.report.sent, got.report.delivered) == \
        (ref.report.sent, ref.report.delivered) == (K + extra, K + 1)
    for a, b in zip(tpackets.tree_flatten(got.global_params)[0],
                    _leaves(ref.global_params), strict=True):
        np.testing.assert_array_equal(a.numpy(), b)   # bit-exact float32


def test_fedavg_matches_reference_with_and_without_erasures(clients):
    weights = [1.0, 2.0, 3.0, 4.0]
    for ch in (None, 5):
        ref = jfednc.fedavg_round(
            clients, weights, clients[0],
            channel=None if ch is None else jchannel.ErasureChannel(0.4, ch))
        got = tfednc.fedavg_round(
            _port(clients), weights, None,
            channel=None if ch is None else tchannel.ErasureChannel(0.4, ch))
        assert got.n_aggregated == ref.n_aggregated
        for a, b in zip(tpackets.tree_flatten(got.global_params)[0],
                        _leaves(ref.global_params), strict=True):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("kernel", ["auto", "auto_seeded"])
def test_port_fednc_equals_port_fedavg(clients, kernel):
    params = _port(clients)
    weights = [5.0, 1.0, 1.0, 2.0]
    got = tfednc.fednc_round(
        params, weights, None,
        tfednc.FedNCConfig(kernel_impl=kernel, extra_tuples=1, chunk_l=CHUNK),
        torch.Generator().manual_seed(3), device="cpu")
    want = tfednc.fedavg_round(params, weights, None)
    assert got.decoded and got.n_aggregated == K
    for a, b in zip(tpackets.tree_flatten(got.global_params)[0],
                    tpackets.tree_flatten(want.global_params)[0],
                    strict=True):
        assert torch.equal(a, b)


def test_undecodable_round_keeps_previous_model(clients):
    prev = {"sentinel": torch.zeros(1)}
    got = tfednc.fednc_round(
        _port(clients), [1.0] * K, prev, tfednc.FedNCConfig(),
        torch.Generator().manual_seed(0),
        channel=tchannel.ErasureChannel(0.99, seed=0), device="cpu")
    assert not got.decoded and got.global_params is prev
    assert got.report.delivered < K
