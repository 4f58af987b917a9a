"""repro_torch.core.gf against repro.core.gf, byte for byte.

Inputs are drawn with numpy from fixed seeds and handed to both
packages.  GF arithmetic is exact, so every comparison is byte-exact —
including the result of a singular solve, which both packages compute
with the same pivot rule and the ``inv(0) = 0`` sentinel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gf as jgf
from repro_torch.core import gf as tgf

FIELDS = [1, 2, 3, 4, 5, 6, 7, 8]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("s", FIELDS)
def test_tables_match_reference(s):
    e_ref, l_ref = jgf._build_tables(s)
    e, lg = tgf._build_tables(s)
    np.testing.assert_array_equal(e, e_ref)
    np.testing.assert_array_equal(lg, l_ref)
    f = tgf.get_field(s)
    np.testing.assert_array_equal(f.exp.numpy(), e_ref)
    np.testing.assert_array_equal(f.log.numpy(), l_ref)
    assert tgf.PRIMITIVE_POLY == jgf.PRIMITIVE_POLY


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_mul_inv_matmul_match_reference(s):
    rng = np.random.default_rng(100 + s)
    q = 1 << s
    a = rng.integers(0, q, 500).astype(np.uint8)
    b = rng.integers(0, q, 500).astype(np.uint8)
    jf, tf = jgf.get_field(s), tgf.get_field(s)
    np.testing.assert_array_equal(tf.mul(_t(a), _t(b)).numpy(),
                                  np.asarray(jf.mul(a, b)))
    np.testing.assert_array_equal(tf.inv(_t(a)).numpy(),
                                  np.asarray(jf.inv(a)))
    A = rng.integers(0, q, (5, 7)).astype(np.uint8)
    B = rng.integers(0, q, (7, 33)).astype(np.uint8)
    np.testing.assert_array_equal(tf.matmul(_t(A), _t(B)).numpy(),
                                  np.asarray(jf.matmul(A, B)))
    # the identity and zero behave as field elements must
    nz = a[a != 0]
    assert (tf.mul(_t(nz), tf.inv(_t(nz))).numpy() == 1).all()
    assert int(tf.inv(torch.tensor([0], dtype=torch.uint8))[0]) == 0


def _singular_cases(rng, K, q):
    """Random, duplicated-row, zero-column and rank-1 K x K matrices."""
    A = rng.integers(0, q, (K, K)).astype(np.uint8)
    dup = A.copy()
    dup[K - 1] = dup[0]
    zero_col = A.copy()
    zero_col[:, K // 2] = 0
    rank1 = np.outer(rng.integers(1, q, K), np.ones(K)).astype(np.uint8)
    return [A, dup, zero_col, rank1, np.zeros((K, K), np.uint8)]


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [1, 3, 6])
def test_ge_solve_invert_rank_match_reference(s, K):
    rng = np.random.default_rng(K * 10 + s)
    q = 1 << s
    jf, tf = jgf.get_field(s), tgf.get_field(s)
    C = rng.integers(0, q, (K, 9)).astype(np.uint8)
    ref_rank = jax.jit(lambda A: jgf.rank(jf, A))     # one trace per shape
    for A in _singular_cases(rng, K, q):
        ok_r, X_r = jgf.ge_solve(jf, A, C)
        ok_t, X_t = tgf.ge_solve(tf, _t(A), _t(C))
        assert ok_t == bool(ok_r)
        np.testing.assert_array_equal(X_t.numpy(), np.asarray(X_r))
        ok_r, I_r = jgf.invert(jf, jnp.asarray(A))
        ok_t, I_t = tgf.invert(tf, _t(A))
        assert ok_t == bool(ok_r)
        np.testing.assert_array_equal(I_t.numpy(), np.asarray(I_r))
        assert tgf.rank(tf, _t(A)) == int(ref_rank(A))
        if ok_t:
            eye = tf.matmul(_t(A), I_t).numpy()
            np.testing.assert_array_equal(eye, np.eye(K, dtype=np.uint8))


@pytest.mark.parametrize("shape", [(3, 7), (7, 3), (5, 5)])
def test_rank_of_rectangular_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    jf, tf = jgf.get_field(8), tgf.get_field(8)
    A = rng.integers(0, 256, shape).astype(np.uint8)
    A[-1] = A[0]                                   # one dependent row
    assert tgf.rank(tf, _t(A)) == int(jgf.rank(jf, A))


def test_random_elements_range_and_device():
    g = torch.Generator().manual_seed(0)
    f = tgf.get_field(4)
    x = f.random_elements(g, (64, 3))
    assert x.dtype == torch.uint8 and x.shape == (64, 3)
    assert int(x.max()) < 16
    y = f.random_nonzero(g, (64,))
    assert int(y.min()) >= 1 and int(y.max()) < 16
