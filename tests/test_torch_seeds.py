"""repro_torch.core.seeds against Random123 and repro.core.seeds.

The Threefry stream is the one random stream both packages must share:
a seed names the same coding row everywhere.  Byte-exact throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seeds as jseeds
from repro_torch.core import seeds as tseeds

# (key0, key1, ctr0, ctr1) -> (out0, out1), Threefry-2x32 20 rounds,
# from the Random123 kat_vectors file (the vectors tests/test_seeded.py
# pins the reference to).
THREEFRY_KAT = [
    ((0x00000000, 0x00000000, 0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]

#: edge seeds plus random ones across the whole 32-bit range, many of
#: them >= 2^31 (where a signed 32-bit view would go negative)
SEEDS = np.concatenate([
    np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1], np.uint32),
    np.random.default_rng(1234).integers(0, 2**32, 58,
                                         dtype=np.uint64).astype(np.uint32),
])


@pytest.mark.parametrize("kat", THREEFRY_KAT, ids=["zeros", "ones", "pi"])
def test_threefry_known_answer(kat):
    (k0, k1, x0, x1), want = kat
    y0, y1 = tseeds.threefry2x32(k0, k1, x0, x1)
    assert (int(y0), int(y1)) == want


def test_threefry_matches_reference_vectorized():
    rng = np.random.default_rng(7)
    k0, x0, x1 = (rng.integers(0, 2**32, 200, dtype=np.uint64)
                  .astype(np.uint32) for _ in range(3))
    r0, r1 = jseeds.threefry2x32(k0, jseeds.KEY_SALT, x0, x1)
    t0, t1 = tseeds.threefry2x32(tseeds.as_seeds(k0), tseeds.KEY_SALT,
                                 tseeds.as_seeds(x0), tseeds.as_seeds(x1))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(r0, np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(r1, np.int64))
    assert tseeds.KEY_SALT == int(jseeds.KEY_SALT)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("K", [1, 3, 4, 5, 17, 64])
def test_expand_rows_matches_reference(K, s):
    want = np.asarray(jseeds.expand_rows_jit(jnp.asarray(SEEDS), K, s))
    got = tseeds.expand_rows(tseeds.as_seeds(SEEDS), K, s)
    assert got.dtype == torch.uint8 and got.shape == (len(SEEDS), K)
    np.testing.assert_array_equal(got.numpy(), want)


def test_coeff_words_match_reference():
    want = np.asarray(jseeds.coeff_words(jnp.asarray(SEEDS), 5), np.int64)
    np.testing.assert_array_equal(
        tseeds.coeff_words(tseeds.as_seeds(SEEDS), 5).numpy(), want)


def test_expand_rows_prefix_and_rejects_2d():
    seeds = tseeds.as_seeds(SEEDS[:8])
    long = tseeds.expand_rows(seeds, 40)
    assert torch.equal(tseeds.expand_rows(seeds, 9), long[:, :9])
    with pytest.raises(ValueError, match=r"seeds must be \(N,\)"):
        tseeds.expand_rows(seeds[None, :], 4)


def test_draw_seeds_are_32_bit_int64():
    g = torch.Generator().manual_seed(0)
    s = tseeds.draw_seeds(g, 1000)
    assert s.dtype == torch.int64 and s.shape == (1000,)
    assert int(s.min()) >= 0 and int(s.max()) < 2**32
    assert int(s.max()) >= 2**31      # the upper half of the range is drawn
