"""The port's GF kernels: plain versions against the Pallas kernels, and
the CUDA kernels against their plain versions on the card.

Covered: the lane-packed ladder and its seeded variant
(`gf_matmul_packed*`), the unpacked carry-less multiply
(`gf_matmul_unpacked`, plain version `gf_matmul_clmul_ref`) and the
GF(2) masked XOR (`gf2_matmul`, plain version `gf2_matmul_ref`).  The
flash-attention kernel's plain version is held against the reference
in `tests/test_torch_attention.py`; its card test is here.

On this CPU the JAX kernels run as their own tests run them
(``interpret=True``), and the port's wrappers take their plain PyTorch
versions because the tensors lie on the CPU.  GF arithmetic is exact:
every comparison is byte-exact.

The tests marked ``cuda`` need an NVIDIA card and nvcc; they decide
inside a fixture, so every worker collects the same tests, and skip
here.  JAX is imported inside a fixture too, so this file also runs on
a machine with the card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import seeds as tseeds
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gf2_xor as tgx
from repro_torch.kernels import gf_matmul as tgm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (n, K, L): ragged L (L % 4 != 0), n != K both ways, one > 512-word tile
SHAPES = [(3, 3, 17), (5, 3, 1030), (2, 6, 2051)]


@pytest.fixture(scope="module")
def jref():
    """The JAX reference kernels, imported here and not at module level."""
    jax = pytest.importorskip("jax")
    from repro.core import seeds as jseeds
    from repro.kernels import gf2_xor as jgx
    from repro.kernels import gf_matmul as jgm
    from repro.kernels import ops as jops
    from repro.kernels import ref as jr
    return SimpleNamespace(jnp=jax.numpy, gm=jgm, gx=jgx, ops=jops, ref=jr,
                           seeds=jseeds)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _draw(seed: int, n: int, K: int, L: int, s: int):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 1 << s, (n, K)).astype(np.uint8)
    P = rng.integers(0, 1 << s, (K, L)).astype(np.uint8)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return A, P, seeds


@pytest.mark.parametrize("L", [1, 4, 5, 17, 1030])
def test_pack_unpack_match_reference(jref, L):
    P = np.random.default_rng(L).integers(0, 256, (3, L)).astype(np.uint8)
    W_ref = np.asarray(jref.gm.pack_lanes(P))
    W = tgm.pack_lanes(torch.from_numpy(P))
    assert W.dtype == torch.int32
    np.testing.assert_array_equal(W.numpy(), W_ref)
    np.testing.assert_array_equal(tgm.unpack_lanes(W, L).numpy(), P)
    x = np.array([0x7F7F7F7F, -0x01010102, 0x40804080, -1], np.int32)
    for s in range(1, 9):
        want = np.asarray(jref.gm._xtime_packed(jref.jnp.asarray(x), s))
        got = tgm._xtime_packed(torch.from_numpy(x), s).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("n,K,L", SHAPES)
def test_packed_plain_matches_pallas(jref, s, n, K, L):
    A, P, _ = _draw(n * 100 + K * 10 + s, n, K, L, s)
    want = np.asarray(jref.gm.gf_matmul_pallas_packed(A, P, s=s,
                                                      interpret=True))
    got = tref.gf_matmul_packed_ref(torch.from_numpy(A),
                                    torch.from_numpy(P), s)
    np.testing.assert_array_equal(got.numpy(), want)
    # the table oracle agrees with both, and with the reference's oracle
    table = tref.gf_matmul_ref(torch.from_numpy(A), torch.from_numpy(P), s)
    np.testing.assert_array_equal(table.numpy(), want)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("n,K,L", SHAPES)
def test_seeded_plain_matches_pallas(jref, s, n, K, L):
    _, P, seeds = _draw(n * 100 + K * 10 + s + 1, n, K, L, s)
    want = np.asarray(jref.gm.gf_matmul_pallas_packed_seeded(
        jref.jnp.asarray(seeds), P, s=s, interpret=True))
    ts = tseeds.as_seeds(seeds)
    got = tref.gf_matmul_packed_seeded_ref(ts, torch.from_numpy(P), s)
    np.testing.assert_array_equal(got.numpy(), want)
    table = tref.gf_matmul_seeded_ref(ts, torch.from_numpy(P), s)
    np.testing.assert_array_equal(table.numpy(), want)


def test_zero_width_payload(jref):
    A, P, seeds = _draw(0, 4, 3, 0, 8)
    want = np.asarray(jref.gm.gf_matmul_pallas_packed(A, P, s=8))
    for got in (tref.gf_matmul_packed_ref(torch.from_numpy(A),
                                          torch.from_numpy(P), 8),
                tref.gf_matmul_packed_seeded_ref(tseeds.as_seeds(seeds),
                                                 torch.from_numpy(P), 8),
                tgm.gf_matmul_packed(torch.from_numpy(A),
                                     torch.from_numpy(P))):
        assert got.shape == want.shape == (4, 0)


def test_plain_versions_take_strided_column_views():
    """`_stream` hands the kernels column slices of a wider P."""
    A, P, seeds = _draw(5, 4, 4, 301, 8)
    wide = torch.from_numpy(P)
    view = wide[:, 3:257]
    dense = view.contiguous()
    A_t, s_t = torch.from_numpy(A), tseeds.as_seeds(seeds)
    assert torch.equal(tgm.gf_matmul_packed(A_t, view),
                       tgm.gf_matmul_packed(A_t, dense))
    assert torch.equal(tgm.gf_matmul_packed_seeded(s_t, view),
                       tgm.gf_matmul_packed_seeded(s_t, dense))


def test_out_takes_a_column_view_of_a_wider_output():
    """`_stream` hands the wrappers its output's chunk columns as `out`:
    C lands in those columns, the rest of the tensor stays untouched."""
    A, P, seeds = _draw(6, 5, 4, 301, 8)
    A_t, P_t = torch.from_numpy(A), torch.from_numpy(P)
    s_t = tseeds.as_seeds(seeds)
    for fn, rows, want in (
            (tgm.gf_matmul_packed, A_t,
             tref.gf_matmul_packed_ref(A_t, P_t, 8)),
            (tgm.gf_matmul_packed_seeded, s_t,
             tref.gf_matmul_packed_seeded_ref(s_t, P_t, 8))):
        wide = torch.full((5, 310), 7, dtype=torch.uint8)
        got = fn(rows, P_t, s=8, out=wide[:, 3:304])
        assert got.data_ptr() == wide[:, 3:304].data_ptr()
        assert torch.equal(wide[:, 3:304], want)
        assert (wide[:, :3] == 7).all() and (wide[:, 304:] == 7).all()


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    A, P, seeds = _draw(9, 5, 4, 99, 8)
    before = tgm.launch_counts()
    A_t, P_t = torch.from_numpy(A), torch.from_numpy(P)
    s_t = tseeds.as_seeds(seeds)
    assert torch.equal(tgm.gf_matmul_packed(A_t, P_t, s=8),
                       tref.gf_matmul_packed_ref(A_t, P_t, 8))
    assert torch.equal(tgm.gf_matmul_packed_seeded(s_t, P_t, s=8),
                       tref.gf_matmul_packed_seeded_ref(s_t, P_t, 8))
    assert tgm.launch_counts() == before


def test_wrappers_reject_bad_operands():
    P = torch.zeros((3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="A must be"):
        tgm.gf_matmul_packed(torch.zeros((2, 4), dtype=torch.uint8), P)
    with pytest.raises(ValueError, match="A must be"):
        tgm.gf_matmul_packed(torch.zeros((2, 3), dtype=torch.int32), P)
    with pytest.raises(TypeError, match="P must be"):
        tgm.gf_matmul_packed(torch.zeros((2, 3), dtype=torch.uint8),
                             P.to(torch.int32))
    with pytest.raises(ValueError, match="unsupported field"):
        tgm.gf_matmul_packed(torch.zeros((2, 3), dtype=torch.uint8), P, s=9)
    with pytest.raises(ValueError, match="seeds must be"):
        tgm.gf_matmul_packed_seeded(torch.zeros((2,), dtype=torch.int32), P)
    A = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="out must be"):
        tgm.gf_matmul_packed(A, P, out=torch.empty((2, 7), dtype=torch.uint8))
    with pytest.raises(ValueError, match="out must be"):
        tgm.gf_matmul_packed_seeded(torch.zeros((2,), dtype=torch.int64), P,
                                    out=torch.empty((2, 8)))
    with pytest.raises(ValueError, match="unit column stride"):
        tgm.gf_matmul_packed(A, P, out=torch.empty((8, 2),
                                                   dtype=torch.uint8).T)


# ---------------------------------------------------------------------------
# the unpacked kernels: carry-less multiply and the GF(2) XOR
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("s", range(1, 9))
@pytest.mark.parametrize("n,K,L", SHAPES)
def test_clmul_plain_matches_pallas(jref, s, n, K, L):
    A, P, _ = _draw(n * 1000 + K * 10 + s + 2, n, K, L, s)
    want = np.asarray(jref.gm.gf_matmul_pallas(A, P, s=s, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jref.ref.gf_matmul_clmul_ref(A, P, s)), want)
    got = tref.gf_matmul_clmul_ref(_t(A), _t(P), s)
    np.testing.assert_array_equal(got.numpy(), want)
    # on s-bit symbols the clmul formulation is the field product
    np.testing.assert_array_equal(
        tref.gf_matmul_ref(_t(A), _t(P), s).numpy(), want)


@pytest.mark.parametrize("s", range(1, 9))
def test_clmul_plain_matches_pallas_on_bytes_above_the_field(jref, s):
    """Bytes >= 2^s are not masked: A's byte shifts whole, P's bits at
    or above s are never read, and the low byte of the lane is kept."""
    rng = np.random.default_rng(40 + s)
    A = rng.integers(0, 256, (4, 5)).astype(np.uint8)
    P = rng.integers(0, 256, (5, 37)).astype(np.uint8)
    want = np.asarray(jref.gm.gf_matmul_pallas(A, P, s=s, interpret=True))
    got = tgm.gf_matmul_unpacked(_t(A), _t(P), s=s)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jref.ref.gf_matmul_clmul_ref(A, P, s)), want)


def _unpacked_kernel_emulated(A: np.ndarray, P: np.ndarray, s: int
                              ) -> np.ndarray:
    """`gf_matmul_unpacked_kernel<S>`'s lane arithmetic in numpy uint32:
    4 symbols per word in two registers of two 16-bit lanes (symbols
    0, 2 and 1, 3) masked to s bits, rungs P << j for A's 8 bits,
    select-and-XOR, one reduction per output, repacked to bytes."""
    from repro_torch.core.gf import PRIMITIVE_POLY
    lane16 = np.uint32(0x00010001)

    def reduce_lanes16(acc):
        for i in range(2 * s - 2, s - 1, -1):
            acc = acc ^ (((acc >> np.uint32(i)) & lane16)
                         * np.uint32(PRIMITIVE_POLY[s] << (i - s)))
        return acc

    n, K = A.shape
    L = P.shape[1]
    Pp = np.zeros((K, -(-L // 4) * 4), np.uint8)
    Pp[:, :L] = P
    W = Pp.view("<u4")
    sym_mask = np.uint32(((1 << s) - 1) * 0x00010001)
    acc02 = np.zeros((n, W.shape[1]), np.uint32)
    acc13 = np.zeros_like(acc02)
    for k in range(K):
        r02, r13 = W[k] & sym_mask, (W[k] >> np.uint32(8)) & sym_mask
        for r in range(n):
            for j in range(8):
                m = np.uint32(0xFFFFFFFF * ((int(A[r, k]) >> j) & 1))
                acc02[r] ^= (r02 << np.uint32(j)) & m
                acc13[r] ^= (r13 << np.uint32(j)) & m
    word = ((reduce_lanes16(acc02) & np.uint32(0x00FF00FF))
            | ((reduce_lanes16(acc13) & np.uint32(0x00FF00FF))
               << np.uint32(8)))
    return np.ascontiguousarray(word).view(np.uint8)[:, :L]


@pytest.mark.parametrize("s", range(1, 9))
def test_unpacked_kernel_lane_arithmetic_matches_pallas(jref, s):
    """The CUDA kernel cannot run here; its arithmetic can.  Bytes
    0..255 on both sides, so the unmasked clmul semantics are held."""
    rng = np.random.default_rng(70 + s)
    A = rng.integers(0, 256, (3, 4)).astype(np.uint8)
    P = rng.integers(0, 256, (4, 23)).astype(np.uint8)
    want = np.asarray(jref.gm.gf_matmul_pallas(A, P, s=s, interpret=True))
    np.testing.assert_array_equal(_unpacked_kernel_emulated(A, P, s), want)


# the packed kernels' mask tile: packet rows whose masks a block holds
MASK_TILE = 32


def _packed_kernel_emulated(coeffs_of_tile, P: np.ndarray, s: int,
                            n: int) -> np.ndarray:
    """`gf_matmul_packed_kernel`'s order of work in numpy uint32: for
    each tile of MASK_TILE packet rows, the coefficients of the tile
    (`coeffs_of_tile(k0, kt)` -> (n, kt) bytes) expanded to 32-bit select
    masks, then per packet row the xtime ladder and one
    ``acc ^= rung & mask`` per (row, bit); repacked to bytes."""
    from repro_torch.core.gf import PRIMITIVE_POLY
    one = np.uint32(0x01010101)
    low = np.uint32(((1 << (s - 1)) - 1) * 0x01010101)
    red = np.uint32(PRIMITIVE_POLY[s] ^ (1 << s))

    def xtime(w):
        return ((w & low) << np.uint32(1)) ^ (
            ((w >> np.uint32(s - 1)) & one) * red)

    K, L = P.shape
    Pp = np.zeros((K, -(-L // 4) * 4), np.uint8)
    Pp[:, :L] = P
    W = Pp.view("<u4")
    acc = np.zeros((n, W.shape[1]), np.uint32)
    for k0 in range(0, K, MASK_TILE):
        kt = min(MASK_TILE, K - k0)
        coeff = coeffs_of_tile(k0, kt).astype(np.uint32)
        bits = (coeff[:, :, None] >> np.arange(8, dtype=np.uint32)) & 1
        masks = (np.uint32(0) - bits).astype(np.uint32)   # (n, kt, 8)
        for kk in range(kt):
            rung = W[k0 + kk]
            for i in range(s):
                acc ^= rung[None, :] & masks[:, kk, i, None]
                rung = xtime(rung)
    return np.ascontiguousarray(acc).view(np.uint8)[:, :L]


@pytest.mark.parametrize("s", range(1, 9))
def test_packed_kernel_mask_tiles_match_reference(jref, s):
    """The CUDA kernels cannot run here; their tiling of K through the
    select masks can.  K = 70 spans three mask tiles; the seeded tile
    regenerates Threefry words k0/4 .. (k0 + kt)/4 of each seed, as the
    kernel's counter does.  Held against the JAX package's plain
    versions of its Pallas kernels (in interpret mode the kernels
    compile anew for each K, ~10 s a call; the tests above hold them on
    `SHAPES`) and the table oracle."""
    rng = np.random.default_rng(90 + s)
    n, K, L = 5, 70, 29
    A = rng.integers(0, 1 << s, (n, K)).astype(np.uint8)
    P = rng.integers(0, 1 << s, (K, L)).astype(np.uint8)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jref.ref.gf_matmul_packed_ref(A, P, s))
    got = _packed_kernel_emulated(lambda k0, kt: A[:, k0:k0 + kt], P, s, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tref.gf_matmul_ref(_t(A), _t(P), s).numpy(),
                                  want)

    def seeded_tile(k0, kt):
        ctr = torch.arange(k0 // 4, k0 // 4 + -(-kt // 4))
        w0, _ = tseeds.threefry2x32(tseeds.as_seeds(seeds)[:, None],
                                    tseeds.KEY_SALT, ctr[None, :], 0)
        b = (w0[:, :, None] >> (8 * torch.arange(4))) & ((1 << s) - 1)
        return b.reshape(n, -1)[:, :kt].numpy()

    want = np.asarray(jref.ref.gf_matmul_packed_seeded_ref(
        jref.jnp.asarray(seeds), P, s))
    np.testing.assert_array_equal(
        _packed_kernel_emulated(seeded_tile, P, s, n), want)


# the XOR kernel's tiles: packet rows whose masks a block holds, most
# output rows per block
XOR_MASK_TILE, XOR_TILE_ROWS = 32, 16


def _gf2_kernel_emulated(A: np.ndarray, P: np.ndarray) -> np.ndarray:
    """`gf2_matmul_kernel<R>`'s order of work in numpy uint32: balanced
    row tiles of at most XOR_TILE_ROWS rows, R = the tile rounded up to
    4 with zero masks past n; per tile of XOR_MASK_TILE packet rows, bit
    0 of A expanded to 32-bit 0 / ~0 masks [k][row]; per packet row one
    ``acc ^= P_k & mask`` per row and word; only the tile's real rows
    stored, repacked to bytes."""
    n, K = A.shape
    L = P.shape[1]
    Pp = np.zeros((K, -(-L // 4) * 4), np.uint8)
    Pp[:, :L] = P
    W = Pp.view("<u4")
    tiles = -(-n // XOR_TILE_ROWS)
    tile = -(-n // tiles)
    R = -(-tile // 4) * 4
    out = np.zeros((n, W.shape[1]), np.uint32)
    for row0 in range(0, n, tile):
        rows = min(tile, n - row0)
        acc = np.zeros((R, W.shape[1]), np.uint32)
        for k0 in range(0, K, XOR_MASK_TILE):
            kt = min(XOR_MASK_TILE, K - k0)
            masks = np.zeros((kt, R), np.uint32)
            masks[:, :rows] = np.uint32(0) - (
                A[row0:row0 + rows, k0:k0 + kt].T.astype(np.uint32) & 1)
            for kk in range(kt):
                acc ^= W[k0 + kk][None, :] & masks[kk][:, None]
        out[row0:row0 + rows] = acc[:rows]
    return np.ascontiguousarray(out).view(np.uint8)[:, :L]


def test_gf2_kernel_mask_tiles_match_reference(jref):
    """The CUDA kernel cannot run here; its tiling can.  K = 70 spans
    three mask tiles, the last partial; n = 19 takes two
    balanced row tiles of 10 rows, each an R = 12 tile with two rows of
    zero masks.  A's bytes 0..255 (bit 0 read), P's raw bytes, ragged
    L; held against the JAX package's plain version of its Pallas
    kernel and the port's plain version."""
    rng = np.random.default_rng(95)
    n, K, L = 19, 70, 29
    A = rng.integers(0, 256, (n, K)).astype(np.uint8)
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    want = np.asarray(jref.ref.gf2_matmul_ref(A, P))
    np.testing.assert_array_equal(_gf2_kernel_emulated(A, P), want)
    np.testing.assert_array_equal(tref.gf2_matmul_ref(_t(A), _t(P)).numpy(),
                                  want)


@pytest.mark.parametrize("n,K,L", SHAPES)
def test_gf2_plain_matches_pallas(jref, n, K, L):
    rng = np.random.default_rng(n * 100 + K * 10 + L)
    A = rng.integers(0, 256, (n, K)).astype(np.uint8)    # bit 0 is read
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)    # raw bytes
    want = np.asarray(jref.gx.gf2_matmul_pallas(A, P, interpret=True))
    np.testing.assert_array_equal(np.asarray(jref.ref.gf2_matmul_ref(A, P)),
                                  want)
    np.testing.assert_array_equal(tref.gf2_matmul_ref(_t(A), _t(P)).numpy(),
                                  want)
    np.testing.assert_array_equal(tgx.gf2_matmul(_t(A), _t(P)).numpy(), want)
    # every bit-plane is an s=1 product of the coefficient bits
    for b in range(8):
        plane = tref.gf_matmul_ref(_t(A & 1), _t((P >> b) & 1), 1).numpy()
        np.testing.assert_array_equal((want >> b) & 1, plane)


@pytest.mark.parametrize("impl", ["auto", "table"])
def test_gf2_combine_matches_reference(jref, impl):
    rng = np.random.default_rng(7)
    A = rng.integers(0, 256, (6, 4)).astype(np.uint8)
    P = rng.integers(0, 256, (4, 301)).astype(np.uint8)
    want = np.asarray(jref.ops.gf2_combine(A, P, impl="jnp"))
    np.testing.assert_array_equal(
        tops.gf2_combine(_t(A), _t(P), impl=impl).numpy(), want)


def test_ops_gf_matmul_goes_through_the_registry():
    A, P, seeds = _draw(8, 4, 3, 50, 8)
    want = tref.gf_matmul_ref(_t(A), _t(P), 8)
    for impl in ("auto", "cuda", "clmul", "table", "cuda_packed"):
        assert torch.equal(tops.gf_matmul(_t(A), _t(P), s=8, impl=impl),
                           want), impl
    got = tops.gf_matmul(tseeds.as_seeds(seeds), _t(P), s=8,
                         impl="auto_seeded")
    assert torch.equal(got, tref.gf_matmul_seeded_ref(
        tseeds.as_seeds(seeds), _t(P), 8))
    with pytest.raises(ValueError, match="unknown impl"):
        tops.gf2_combine(_t(A), _t(P), impl="pallas")


@pytest.mark.parametrize("kernel", ["unpacked", "gf2"])
def test_unpacked_wrappers_write_only_their_out_columns(kernel):
    """The engine hands the wrappers its output's chunk columns."""
    rng = np.random.default_rng(11)
    A_t = _t(rng.integers(0, 256, (5, 4)).astype(np.uint8))
    P_t = _t(rng.integers(0, 256, (4, 301)).astype(np.uint8))
    if kernel == "unpacked":
        fn, want = (lambda A, P, out: tgm.gf_matmul_unpacked(A, P, s=8,
                                                            out=out),
                    tref.gf_matmul_clmul_ref(A_t, P_t, 8))
    else:
        fn, want = (lambda A, P, out: tgx.gf2_matmul(A, P, out=out),
                    tref.gf2_matmul_ref(A_t, P_t))
    wide = torch.full((5, 310), 7, dtype=torch.uint8)
    view = wide[:, 3:304]
    got = fn(A_t, P_t[:, :301], view)
    assert got.data_ptr() == view.data_ptr()
    assert torch.equal(view, want)
    assert (wide[:, :3] == 7).all() and (wide[:, 304:] == 7).all()
    # a strided column view of P takes the same path as a dense one
    P_wide = torch.cat([P_t, P_t], dim=1)
    assert torch.equal(fn(A_t, P_wide[:, :301], None), want)


def test_unpacked_wrappers_on_cpu_launch_nothing_and_check_operands():
    A = torch.zeros((2, 3), dtype=torch.uint8)
    P = torch.zeros((3, 8), dtype=torch.uint8)
    before = {**tgm.launch_counts(), **{f.__name__: f.launches
                                        for f in tgx.WRAPPERS}}
    assert tgm.gf_matmul_unpacked(A, P, s=4).shape == (2, 8)
    assert tgx.gf2_matmul(A, P).shape == (2, 8)
    assert tgx.gf2_matmul(A, P[:, :0]).shape == (2, 0)
    after = {**tgm.launch_counts(), **{f.__name__: f.launches
                                       for f in tgx.WRAPPERS}}
    assert after == before
    with pytest.raises(ValueError, match="over GF\\(2\\)"):
        tgx.gf2_matmul(A, P, s=8)
    with pytest.raises(ValueError, match="A must be"):
        tgx.gf2_matmul(torch.zeros((2, 4), dtype=torch.uint8), P)
    with pytest.raises(ValueError, match="unsupported field"):
        tgm.gf_matmul_unpacked(A, P, s=0)
    with pytest.raises(ValueError, match="out must be"):
        tgx.gf2_matmul(A, P, out=torch.empty((2, 7), dtype=torch.uint8))


def test_sass_census_counts_copies_and_takes_the_leanest_step():
    """`build.sass_census`'s parsing, which needs no card: a cp.async
    (LDGSTS) counts by width like a load, and of two basic blocks with
    as many selects the hottest is the one reaching them in fewer
    instructions (the XOR kernel's copied step, not its byte loads)."""
    from repro_torch.kernels import build
    assert build._opcode("LDGSTS", ".E.BYPASS.LTC128B.128",
                         "[R1], desc[UR4][R2.64]") == ["LDGSTS.128"]
    assert build._opcode("LDGSTS", ".E.LTC128B", "[R1], [R2.64]") == [
        "LDGSTS.32"]
    select = build._opcode("LOP3", ".LUT", "R4, R4, R5, R6, 0x78, !PT")
    assert select == ["LOP3", "LOP3.select"]
    body = [(0x00, ["LDG.U8"], ""), (0x10, ["LDG.U8"], ""),
            (0x20, select, ""), (0x30, ["BRA"], "0x40"),
            (0x40, ["LDS.128"], ""), (0x50, select, ""),
            (0x60, ["EXIT"], "")]
    hot = build._hot_block(body)
    assert (hot["LOP3.select"], hot["LDS.128"], hot["LDG.U8"],
            hot["instructions"]) == (1, 1, 0, 2)


def test_bringup_tells_the_gf_sources_apart():
    """`gf_bringup` checks and times a variant by the C interface its
    source exports."""
    from repro_torch.kernels import build, gf_bringup
    kinds = {name: gf_bringup.source_kind(
        (build.CSRC / f"{name}.cu").read_text())
        for name in ("gf_matmul", "gf2_xor")}
    assert kinds == {"gf_matmul": "gf_matmul", "gf2_xor": "gf2_xor"}
    assert gf_bringup.SOURCES["gf2_xor"]["census"].search(
        "gf2_matmul_kernel<8>")
    assert not gf_bringup.SOURCES["gf2_xor"]["census"].search(
        "gf2_matmul_kernel<12>")


# the paper CNN's row length: its rows are 8-byte aligned, never 16
CNN_L = 1_237_160


def _card_cases():
    """(n, K, L, column offset, extra columns) of a view into a wider P
    and a wider output, the width L + off + extra setting the row
    alignment: the old cases; 16-byte aligned views with L mod 16 in
    {1, 7, 15}; CNN rows (8-byte aligned) cut to a chunk and to the last
    chunk; n over one and several row tiles; K above the mask tile and
    above 3,072 (many mask tiles; the kernels have no K limit); L = 0."""
    return [(8, 8, 1 << 16, 0, 4), (10, 8, 1001, 0, 4), (19, 7, 1030, 3, 4),
            (3, 5, 4097, 4, 4), (8, 8, 4097, 0, 15), (5, 6, 2055, 0, 9),
            (8, 8, 1039, 0, 1), (10, 10, 1 << 18, 1 << 18, CNN_L - (2 << 18)),
            (10, 10, 188_584, CNN_L - 188_584, 0), (17, 7, 1030, 0, 2),
            (33, 9, 777, 4, 3), (9, 40, 3001, 16, 7), (3, 4099, 517, 0, 11),
            (4, 4, 0, 0, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_cuda_kernels_match_plain_versions(cuda_device, s):
    """Both CUDA kernels == their plain versions on the card, byte for
    byte (`_card_cases`): ragged L, n != K, n over several row tiles,
    strided, misaligned and 16-, 8- and 4-byte aligned column views, K
    above the mask tile and above 3,072, and L = 0 (no launch)."""
    g = torch.Generator(device=cuda_device).manual_seed(s)
    for n, K, L, off, extra in _card_cases():
        wide = torch.randint(0, 1 << s, (K, L + off + extra), generator=g,
                             device=cuda_device, dtype=torch.uint8)
        P = wide[:, off:off + L]
        A = torch.randint(0, 1 << s, (n, K), generator=g,
                          device=cuda_device, dtype=torch.uint8)
        seeds = torch.randint(0, 1 << 32, (n,), generator=g,
                              device=cuda_device, dtype=torch.int64)
        # the seeded result goes into a column view of a wider output,
        # as the engine's chunk loop hands it over
        wide_out = torch.zeros((n, L + off + extra), device=cuda_device,
                               dtype=torch.uint8)
        before = tgm.launch_counts()
        got = tgm.gf_matmul_packed(A, P, s=s)
        got_s = tgm.gf_matmul_packed_seeded(seeds, P, s=s,
                                            out=wide_out[:, off:off + L])
        torch.cuda.synchronize()
        launched = 1 if L else 0
        after = tgm.launch_counts()
        for name in ("gf_matmul_packed", "gf_matmul_packed_seeded"):
            assert after[name] == before[name] + launched
        assert torch.equal(got, tref.gf_matmul_packed_ref(A, P, s))
        assert torch.equal(got_s,
                           tref.gf_matmul_packed_seeded_ref(seeds, P, s))
        assert torch.equal(got_s, tgm.gf_matmul_packed(
            tseeds.expand_rows(seeds, K, s), P, s=s))
        if 0 < L <= 4097:                      # independent table oracle
            assert torch.equal(got, tref.gf_matmul_ref(A, P, s))
        assert not wide_out[:, :off].any() and \
            not wide_out[:, off + L:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 4, 8])
def test_cuda_batched_kernel_matches_plain_version(cuda_device, s):
    """The packed kernel's batched instance == a loop of the packed plain
    version, byte for byte: J = 1, 3 and 8 problems, ragged L, strided P
    views with 4- and 8-byte aligned rows, K above the mask tile and
    4,099; it writes nothing outside each problem's output view."""
    g = torch.Generator(device=cuda_device).manual_seed(10 + s)
    for J, n, K, L, off, extra in [(1, 8, 8, 1 << 12, 0, 0),
                                   (3, 10, 18, 4097, 4, 3),
                                   (8, 10, 18, 2051, 8, 5),
                                   (3, 5, 40, 1030, 3, 1),
                                   (2, 3, 4099, 517, 0, 11),
                                   (3, 4, 4, 0, 0, 4)]:
        wide = torch.randint(0, 1 << s, (J, K + 2, L + off + extra),
                             generator=g, device=cuda_device,
                             dtype=torch.uint8)
        P = wide[:, 1:1 + K, off:off + L]
        A = torch.randint(0, 1 << s, (J, n, K), generator=g,
                          device=cuda_device, dtype=torch.uint8)
        wide_out = torch.zeros((J, n + 2, L + off + extra),
                               device=cuda_device, dtype=torch.uint8)
        before = tgm.gf_matmul_packed_batched.launches
        got = tgm.gf_matmul_packed_batched(
            A, P, s=s, out=wide_out[:, 1:1 + n, off:off + L])
        torch.cuda.synchronize()
        assert tgm.gf_matmul_packed_batched.launches == before + (1 if L
                                                                  else 0)
        assert torch.equal(got, tref.gf_matmul_packed_batched_ref(A, P, s))
        for j in range(J):
            assert torch.equal(got[j], tgm.gf_matmul_packed(A[j], P[j], s=s))
        assert not wide_out[:, 0].any() and not wide_out[:, n + 1].any()
        assert not wide_out[:, :, :off].any() and \
            not wide_out[:, :, off + L:].any()


@pytest.mark.cuda
def test_cuda_stream_decoder_and_bank_match_the_cpu(cuda_device):
    """The per-arrival decoder and the bank on the card decode what they
    decode on the CPU, with one launch per push, block and tick."""
    from repro_torch.engine import DecoderBank, StreamDecoder

    rng = np.random.default_rng(0)
    K, L, J, gt = 6, 3001, 3, 4
    P = rng.integers(0, 256, (K, L)).astype(np.uint8)
    A = rng.integers(0, 256, (12, K)).astype(np.uint8)
    A[4] = A[1]
    C = tref.gf_matmul_ref(torch.from_numpy(A), torch.from_numpy(P), 8)
    dec = {d: StreamDecoder(K=K, L=L, device=d) for d in ("cpu", "cuda")}
    before = tgm.gf_matmul_packed.launches
    for d, x in dec.items():
        for i in range(3):
            x.push(A[i], C[i].to(d))
        x.ingest(A[3:], C[3:].to(d))
    assert tgm.gf_matmul_packed.launches == before + 4
    assert dec["cuda"].decoded_at == dec["cpu"].decoded_at
    assert torch.equal(dec["cuda"].decode()[1].cpu(), torch.from_numpy(P))
    ticks = [(rng.integers(0, 256, (J, gt, K)).astype(np.uint8),
              rng.integers(0, 256, (J, gt, L)).astype(np.uint8))
             for _ in range(3)]
    banks = {d: DecoderBank(J, K, L, device=d) for d in ("cpu", "cuda")}
    before = tgm.gf_matmul_packed_batched.launches
    for bank in banks.values():
        for j in range(J):
            bank.open(j, k=K)
        for rows, Cb in ticks:
            bank.ingest(rows=rows, C=Cb)
    assert tgm.gf_matmul_packed_batched.launches == before + len(ticks)
    for j in range(J):
        assert torch.equal(banks["cuda"].payload(j).cpu(),
                           banks["cpu"].payload(j))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 3, 4, 8])
def test_cuda_unpacked_kernels_match_plain_versions(cuda_device, s):
    """`gf_matmul_unpacked` (bytes 0..255, so >= 2^s too) and
    `gf2_matmul` (A bytes 0..255, raw P bytes) == their plain versions
    on the card, byte for byte: the cases of `_card_cases` and K = 1,
    each written into a column view of a wider output whose other
    columns stay untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(10 + s)
    for n, K, L, off, extra in _card_cases() + [(5, 1, 13, 0, 4)]:
        wide = torch.randint(0, 256, (K, L + off + extra), generator=g,
                             device=cuda_device, dtype=torch.uint8)
        P = wide[:, off:off + L]
        A = torch.randint(0, 256, (n, K), generator=g, device=cuda_device,
                          dtype=torch.uint8)
        wide_out, wide_out2 = (torch.zeros((n, L + off + extra),
                                           device=cuda_device,
                                           dtype=torch.uint8)
                               for _ in range(2))
        before = tgm.gf_matmul_unpacked.launches, tgx.gf2_matmul.launches
        got = tgm.gf_matmul_unpacked(A, P, s=s,
                                     out=wide_out[:, off:off + L])
        got2 = tgx.gf2_matmul(A, P, out=wide_out2[:, off:off + L])
        torch.cuda.synchronize()
        launched = 1 if L else 0
        assert (tgm.gf_matmul_unpacked.launches,
                tgx.gf2_matmul.launches) == (before[0] + launched,
                                             before[1] + launched)
        assert torch.equal(got, tref.gf_matmul_clmul_ref(A, P, s))
        assert torch.equal(got2, tref.gf2_matmul_ref(A, P))
        for out in (wide_out, wide_out2):
            assert not out[:, :off].any() and not out[:, off + L:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, {"rtol": 2e-4, "atol": 2e-4}),
    (torch.bfloat16, {"rtol": 1e-2, "atol": 1e-3})], ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain_version(cuda_device, dtype, tol):
    """The flash kernel == `flash_attention_ref` on the card: head_dim
    32, 64, 128; GQA groups 1 and 4; S = 1, ragged 100 and 2049, and at
    the bf16 kernel's 128-key tile's edges 129, 256 and 300;
    non-causal at S = 256; q, k, v as strided head slices of one fused
    tensor, and as views whose head stride (hd + 2 elements) TMA cannot
    read in place, which still launch the kernel once; and in bf16 the
    serving shape (4, 2048, 32, 8, 128).  Both accumulate in float32
    over the same tiles, and in bf16 both round P to bf16 before P·V
    after the same tensor-core sums of q·kᵀ, so in bf16 they differ by
    the output's rounding (one bf16 step, 2^-7 relative, at most)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [(2, S, H, KV, hd, True, 0) for hd in (32, 64, 128)
             for H, KV in ((4, 4), (8, 2)) for S in (1, 100, 2049)]
    cases += [(1, 256, 8, 2, 128, False, 0)]
    cases += [(2, S, 8, 2, hd, True, 0) for hd in (32, 64, 128)
              for S in (129, 256, 300)]
    cases += [(2, 300, 8, 2, hd, True, 2) for hd in (32, 128)]
    if dtype == torch.bfloat16:
        cases += [(4, 2048, 32, 8, 128, True, 0)]
    for B, S, H, KV, hd, causal, pad in cases:
        fused = torch.randn((B, S, H + 2 * KV, hd + pad), generator=g,
                            device=cuda_device).to(dtype)[..., :hd]
        q, k, v = fused[:, :, :H], fused[:, :, H:H + KV], fused[:, :, H + KV:]
        assert tfa.tma_ready(q) == (pad == 0)
        before = tfa.flash_attention.launches
        got = tfa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == before + 1
        want = tref.flash_attention_ref(q, k, v, causal=causal)
        assert got.dtype == dtype and got.shape == (B, S, H, hd)
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=f"{(B, S, H, KV, hd, pad)}")
