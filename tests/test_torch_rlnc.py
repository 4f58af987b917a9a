"""The port's `core/rlnc.py` function API and `core/packets.py` leftovers
against the JAX package.

The seed wire format (`pack_seed_packet` / `unpack_seed_packet`), the
single-tree packets (`pytree_to_packet`, `packet_to_pytree`,
`stack_packets`) and `rlnc.encode` / `encode_seeded` / `decode` /
`decodable` / `select_rows` / `select_decodable_rows` run on the
reference's own arrays (numpy from a seed, or the reference's coding
matrices): GF data byte for byte.  The float baseline
(`float_encode` / `float_decode`) holds within rtol 1e-5 on the
reference's Gaussian coefficients.  On this CPU the kernel facade runs
each kernel's plain version.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import packets as jpackets
from repro.core import rlnc as jrlnc
from repro.core.seeds import expand_rows_jit
from repro_torch.core import packets as tpackets
from repro_torch.core import rlnc as trlnc
from repro_torch.core import seeds as tseeds
from repro_torch.core.rlnc import EncodedBatch


def _np(x) -> np.ndarray:
    """A writable host copy of a JAX array."""
    return np.array(x)


# ---------------------------------------------------------------------------
# the seed wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 0x12345678, 0xFFFFFFFF])
def test_seed_packet_bytes_equal_reference(s, seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    payload = rng.integers(0, 1 << s, 40).astype(np.uint8)
    want = _np(jpackets.pack_seed_packet(np.uint32(seed),
                                         jnp.asarray(payload), s))
    got = tpackets.pack_seed_packet(seed, torch.from_numpy(payload), s)
    np.testing.assert_array_equal(got.numpy(), want)
    jseed, jpay = jpackets.unpack_seed_packet(jnp.asarray(want), s)
    tseed, tpay = tpackets.unpack_seed_packet(torch.from_numpy(want), s)
    assert tseed == int(jseed) == seed
    np.testing.assert_array_equal(tpay.numpy(), _np(jpay))
    np.testing.assert_array_equal(tpay.numpy(), payload)


def test_seed_packet_takes_the_ports_seed_tensors():
    seeds = tseeds.as_seeds(np.array([7, 0xDEADBEEF], np.uint32))
    payload = torch.arange(6, dtype=torch.uint8)
    for seed in seeds:
        buf = tpackets.pack_seed_packet(seed, payload, 8)
        assert buf.shape == (tpackets.SEED_WIRE_BYTES + 6,)
        assert tpackets.unpack_seed_packet(buf, 8)[0] == int(seed)


# ---------------------------------------------------------------------------
# single-tree packets
# ---------------------------------------------------------------------------

def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "conv": {"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                 "b": rng.standard_normal((4,)).astype(np.float32)},
        "count": np.array(rng.integers(-5, 5), np.int32),
        "mask": rng.integers(0, 255, (5,)).astype(np.uint8),
        "half": rng.standard_normal((3,)).astype(ml_dtypes.bfloat16),
        "layers": [rng.standard_normal((2,)).astype(np.float32),
                   rng.integers(0, 9, (2, 2)).astype(np.int32)],
    }


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_pytree_to_packet_equals_reference(s):
    tree = _tree(s)
    want, jspec = jpackets.pytree_to_packet(
        jax.tree_util.tree_map(jnp.asarray, tree), s)
    ttree = tpackets.params_from_jax(tree, "cpu")
    got, spec = tpackets.pytree_to_packet(ttree, s)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert spec.n_bytes == jspec.n_bytes
    assert spec.shapes == jspec.shapes
    back = tpackets.packet_to_pytree(got, spec)
    for a, b in zip(tpackets.tree_flatten(back)[0],
                    tpackets.tree_flatten(ttree)[0], strict=True):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    assert torch.equal(tpackets.pytree_to_packet(back, s)[0], got)


def test_single_packets_stack_to_the_batched_matrix():
    trees = [tpackets.params_from_jax(_tree(i), "cpu") for i in range(3)]
    packets = [tpackets.pytree_to_packet(t, 4)[0] for t in trees]
    P, _ = tpackets.pytrees_to_packets(trees, 4)
    assert torch.equal(tpackets.stack_packets(packets), P)
    with pytest.raises(ValueError, match="equal length"):
        tpackets.stack_packets([packets[0], packets[1][:-1]])


# ---------------------------------------------------------------------------
# the rlnc function API on the reference's matrices
# ---------------------------------------------------------------------------

def _coding(s: int, n: int, K: int, L: int, seed: int):
    """(P, A): numpy payload and the reference's own coding matrix."""
    A = _np(jrlnc.random_coding_matrix(jax.random.PRNGKey(seed), n, K, s))
    P = np.random.default_rng(seed).integers(0, 1 << s, (K, L)
                                             ).astype(np.uint8)
    return P, A


@pytest.mark.parametrize("impl", ["auto", "cuda_packed", "table", "clmul",
                                  "cuda"])
@pytest.mark.parametrize("s", [1, 4, 8])
def test_encode_decode_equal_reference(s, impl):
    P, A = _coding(s, 9, 6, 37, seed=s)
    jb = jrlnc.encode(jnp.asarray(P), jnp.asarray(A), s, impl="jnp")
    tb = trlnc.encode(torch.from_numpy(P), torch.from_numpy(A), s,
                      impl=impl)
    np.testing.assert_array_equal(tb.C.numpy(), _np(jb.C))
    np.testing.assert_array_equal(tb.A.numpy(), A)
    assert trlnc.decodable(tb, s) == bool(jrlnc.decodable(jb, s))
    jok, jsel = jrlnc.select_rows(jb, s)
    tok, tsel = trlnc.select_rows(tb, s)
    assert tok == bool(jok)
    np.testing.assert_array_equal(tsel.A.numpy(), _np(jsel.A))
    np.testing.assert_array_equal(tsel.C.numpy(), _np(jsel.C))
    legacy = trlnc.select_decodable_rows(tb, s)
    np.testing.assert_array_equal(legacy.C.numpy(), tsel.C.numpy())
    jdok, jP = jrlnc.decode(jsel, s)
    tdok, tP = trlnc.decode(tsel, s)
    assert tdok == bool(jdok)
    if tdok:
        np.testing.assert_array_equal(tP.numpy(), _np(jP))
        np.testing.assert_array_equal(tP.numpy(), P)


@pytest.mark.parametrize("impl", ["auto_seeded", "cuda_packed_seeded",
                                  "table_seeded"])
@pytest.mark.parametrize("s", [2, 8])
def test_encode_seeded_equals_reference(s, impl):
    P = np.random.default_rng(s).integers(0, 1 << s, (5, 29)
                                          ).astype(np.uint8)
    seeds = np.random.default_rng(100 + s).integers(
        0, 1 << 32, 7, dtype=np.uint32)
    jb = jrlnc.encode_seeded(jnp.asarray(P), jnp.asarray(seeds), s,
                             impl="jnp_seeded")
    tb = trlnc.encode_seeded(torch.from_numpy(P), seeds, s, impl=impl)
    np.testing.assert_array_equal(tb.C.numpy(), _np(jb.C))
    assert tb.K == jb.K == 5
    np.testing.assert_array_equal(tb.seeds.numpy(),
                                  seeds.astype(np.int64))
    np.testing.assert_array_equal(tb.expand(s).A.numpy(),
                                  _np(expand_rows_jit(jnp.asarray(seeds),
                                                      5, s)))
    ok, sel = trlnc.select_rows(tb.expand(s), s)
    if ok:
        assert torch.equal(trlnc.decode(sel, s)[1], torch.from_numpy(P))


def test_decode_rejects_non_square_and_reports_singular():
    P, A = _coding(8, 4, 4, 10, seed=3)
    tb = trlnc.encode(torch.from_numpy(P), torch.from_numpy(A), 8)
    with pytest.raises(ValueError, match="square"):
        trlnc.decode(tb[:3], 8)
    A[1] = A[0]                                   # singular
    tb = trlnc.encode(torch.from_numpy(P), torch.from_numpy(A), 8)
    jok, _ = jrlnc.decode(jrlnc.EncodedBatch(jnp.asarray(A),
                                             jnp.asarray(tb.C.numpy())), 8)
    assert trlnc.decode(tb, 8) == (False, None)
    assert not bool(jok)
    assert not trlnc.decodable(tb, 8)


def test_random_coding_seeds_expand_like_the_kernel():
    g = torch.Generator().manual_seed(5)
    seeds = trlnc.random_coding_seeds(g, 6)
    assert seeds.dtype == torch.int64 and seeds.shape == (6,)
    assert int(seeds.min()) >= 0 and int(seeds.max()) < 1 << 32
    P = torch.randint(0, 256, (4, 11), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    sb = trlnc.encode_seeded(P, seeds, 8, impl="table_seeded")
    mat = trlnc.encode(P, sb.expand(8).A, 8, impl="table")
    assert torch.equal(sb.C, mat.C)


@pytest.mark.parametrize("K,L", [(4, 16), (10, 300)])
def test_float_baseline_within_rtol(K, L):
    A = _np(jrlnc.float_coding_matrix(jax.random.PRNGKey(K), K, K))
    P = np.random.default_rng(L).standard_normal((K, L)).astype(np.float32)
    jC = _np(jrlnc.float_encode(jnp.asarray(P), jnp.asarray(A)))
    tC = trlnc.float_encode(torch.from_numpy(P), torch.from_numpy(A))
    np.testing.assert_allclose(tC.numpy(), jC, rtol=1e-5, atol=1e-6)
    jok, jP = jrlnc.float_decode(jnp.asarray(A), jnp.asarray(jC))
    tok, tP = trlnc.float_decode(torch.from_numpy(A), torch.from_numpy(jC))
    assert tok == bool(jok)
    np.testing.assert_allclose(tP.numpy(), _np(jP), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tP.numpy(), P, rtol=1e-4, atol=1e-4)


def test_float_coding_matrix_draws_on_the_generator():
    A = trlnc.float_coding_matrix(torch.Generator().manual_seed(0), 3, 5)
    assert A.shape == (3, 5) and A.dtype == torch.float32
    B = trlnc.float_coding_matrix(torch.Generator().manual_seed(0), 3, 5)
    assert torch.equal(A, B)


def test_encoded_batch_from_the_function_api_indexes_and_concats():
    P, A = _coding(8, 6, 3, 8, seed=9)
    tb = trlnc.encode(torch.from_numpy(P), torch.from_numpy(A), 8)
    both = tb[:2].concat(tb[2:])
    assert isinstance(both, EncodedBatch)
    assert torch.equal(both.C, tb.C) and torch.equal(both.A, tb.A)
