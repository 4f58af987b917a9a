"""The port's attention against the JAX package, on the CPU.

Covered: the flash kernel's plain version (`flash_attention_ref`, and
`ops.flash_attention`, whose wrapper runs it for CPU tensors) against
the reference's `_attend(causal=True, window=None, q_offset=0)` — the
oracle `tests/test_kernels.py` holds the Pallas kernel to, which cannot
itself run under this JAX — at that file's shapes, S = 1, ragged S, GQA
groups 1 and 4, and head_dim 32, 64 and 128; the wrapper's contract
(non-causal ragged S raises like the reference, unsupported head_dim
raises); the bf16 plain version (128 x 128 tiles, P rounded to bf16)
at the new tile's ragged and exact edges; the float32 plain version
still on the 64 x 32 tiles, bit for bit; the wrapper's TMA alignment
test; the port's `_attend` with a window and `kv_len`; and
`apply_self_attention` in train, prefill and decode mode on a float32
override of the reduced Qwen3-4B, with the reference's weights; the
train / prefill routes (the flash kernel while S <= window and the head
dim is an instance, `_attend_chunked` above CHUNK_THRESHOLD, `_attend`
otherwise) and `_attend_chunked` against the reference's; and the
reference's fault R7, which the port copies: a ``dense`` block's cache
ignores ``cfg.window`` (the reduced StarCoder2-15B).

Tolerances as `tests/test_kernels.py`: float32 rtol = atol = 2e-4
(summation order), bf16 rtol = atol = 5e-2 (one bf16 rounding of the
output, and of the inputs on the reference's side).
"""
import copy
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import packets as tpackets
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(scope="module")
def J():
    """The JAX reference, imported here and not at module level."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.kernels import flash_attention as jfa
    from repro.models import attention as jattn
    return SimpleNamespace(jax=jax, jnp=jax.numpy, attn=jattn, fa=jfa,
                           configs=jconfigs)


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _oracle(J, q, k, v, *, causal=True, dtype=None):
    """The reference's `_attend` on expanded K/V (as its callers do)."""
    groups = q.shape[2] // k.shape[2]
    cast = (lambda x: J.jnp.asarray(x, dtype)) if dtype else J.jnp.asarray
    return np.asarray(J.attn._attend(
        cast(q), J.attn._expand_kv(cast(k), groups),
        J.attn._expand_kv(cast(v), groups), causal=causal, window=None,
        q_offset=0), np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("S,H,hd", [(128, 2, 16), (192, 1, 32), (100, 2, 16)])
def test_plain_matches_oracle_at_the_kernel_tests_shapes(J, S, H, hd):
    """`tests/test_kernels.py`'s shapes (B = 2; head_dim 16 is below the
    CUDA kernel's instances, so only the plain version runs it)."""
    q, k, v = _qkv(S + H, 2, S, H, H, hd)
    got = tref.flash_attention_ref(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), _oracle(J, q, k, v), **F32_TOL)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("S", [1, 100])
def test_wrapper_matches_oracle(J, S, H, KV, hd):
    q, k, v = _qkv(S * hd + H, 2, S, H, KV, hd)
    want = _oracle(J, q, k, v)
    before = tfa.flash_attention.launches
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert tfa.flash_attention.launches == before      # CPU: plain version
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(
        tref.flash_attention_ref(_t(q), _t(k), _t(v)).numpy(), want,
        **F32_TOL)


@pytest.mark.parametrize("S,H,KV,hd", [(128, 2, 2, 32), (100, 8, 2, 64),
                                       (1, 4, 1, 128)])
def test_wrapper_matches_oracle_in_bf16(J, S, H, KV, hd):
    q, k, v = _qkv(7 + S, 1, S, H, KV, hd)
    want = _oracle(J, q, k, v, dtype=J.jnp.bfloat16)
    bf = torch.bfloat16
    got = tops.flash_attention(_t(q, bf), _t(k, bf), _t(v, bf))
    assert got.dtype == bf
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("S", [129, 256, 300])
def test_bf16_plain_matches_oracle_at_the_tile_edges(J, S):
    """The bf16 plain version (the tensor-core kernel's 128 x 128 tiles,
    bf16 P) one key past a tile, at two whole tiles and ragged in the
    third, causal; and non-causal at the whole tiles."""
    assert tref.FLASH_TILES[torch.bfloat16] == (128, 128)
    q, k, v = _qkv(11 + S, 1, S, 8, 2, 64)
    bf = torch.bfloat16
    got = tref.flash_attention_ref(_t(q, bf), _t(k, bf), _t(v, bf))
    assert got.dtype == bf and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               _oracle(J, q, k, v, dtype=J.jnp.bfloat16),
                               **BF16_TOL)
    if S % 128 == 0:
        got = tref.flash_attention_ref(_t(q, bf), _t(k, bf), _t(v, bf),
                                       causal=False)
        np.testing.assert_allclose(
            got.float().numpy(),
            _oracle(J, q, k, v, causal=False, dtype=J.jnp.bfloat16),
            **BF16_TOL)


def _flash_64x32(q, k, v):
    """The float32 plain version as it stood before the bf16 kernel had
    tiles of its own: 64 query rows x 32 keys, q scaled first, exp."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    fold = lambda x: x.float().permute(0, 2, 1, 3)
    expand = lambda x: x[:, :, :, None].expand(
        B, S, KV, H // KV, hd).reshape(B, S, H, hd)
    qf = fold(q) * (1.0 / math.sqrt(hd))
    kf = fold(expand(k))
    vf = fold(expand(v))
    out = torch.empty((B, H, S, hd), dtype=torch.float32)
    for q0 in range(0, S, 64):
        qt = qf[:, :, q0:q0 + 64]
        nq = qt.shape[2]
        qpos = torch.arange(q0, q0 + nq)[:, None]
        acc = torch.zeros((B, H, nq, hd), dtype=torch.float32)
        m = torch.full((B, H, nq), -1e30, dtype=torch.float32)
        l = torch.zeros((B, H, nq), dtype=torch.float32)
        for k0 in range(0, min(q0 + 64, S), 32):
            kt = kf[:, :, k0:k0 + 32]
            vt = vf[:, :, k0:k0 + 32]
            s = qt @ kt.transpose(-1, -2)
            kpos = torch.arange(k0, k0 + kt.shape[2])
            s = torch.where(kpos[None, :] <= qpos, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        out[:, :, q0:q0 + nq] = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.permute(0, 2, 1, 3).contiguous()


def test_f32_plain_keeps_the_64x32_tiles_bit_for_bit(monkeypatch):
    """The float32 plain version (the CUDA-core kernel's algorithm) is
    the 64 x 32 tiled computation it was, to the bit, on a fixed input
    that spans several tiles of each kind and a ragged end; on the bf16
    kernel's 128 x 128 tiles it would not be."""
    assert tref.FLASH_TILES[torch.float32] == (64, 32)
    q, k, v = (_t(x) for x in _qkv(21, 2, 150, 4, 2, 32))
    old = _flash_64x32(q, k, v)
    assert torch.equal(tref.flash_attention_ref(q, k, v), old)
    monkeypatch.setitem(tref.FLASH_TILES, torch.float32,
                        tref.FLASH_TILES[torch.bfloat16])
    assert not torch.equal(tref.flash_attention_ref(q, k, v), old)


def test_tma_alignment_test_of_the_wrapper():
    """`tma_ready`: contiguous and head-sliced views pass; a padded head
    dimension (head stride of 136 bytes) or a base 2 bytes off does not;
    a dimension of size 1 does not count its stride."""
    bf = torch.bfloat16
    fused = torch.zeros((2, 9, 12, 64), dtype=bf)
    assert tfa.tma_ready(fused) and tfa.tma_ready(fused[:, :, 8:10])
    assert not tfa.tma_ready(torch.zeros((2, 9, 4, 68), dtype=bf)[..., :64])
    flat = torch.zeros(2 * 9 * 4 * 64 + 1, dtype=bf)
    assert not tfa.tma_ready(flat[1:].view(2, 9, 4, 64))
    one = torch.zeros((1, 1, 4, 64), dtype=bf).as_strided(
        (1, 1, 4, 64), (3, 5, 64, 1))
    assert tfa.tma_ready(one)
    assert tfa._strides(one) == (256, 256, 64)


def test_non_causal_matches_oracle_and_ragged_raises_like_reference(J):
    q, k, v = _qkv(3, 1, 256, 4, 2, 32)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), _oracle(J, q, k, v, causal=False),
                               **F32_TOL)
    q, k, v = _qkv(4, 1, 100, 2, 2, 32)
    with pytest.raises(ValueError, match="non-causal") as ours:
        tops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    with pytest.raises(ValueError, match="non-causal") as theirs:
        J.fa.flash_attention(J.jnp.asarray(q), J.jnp.asarray(k),
                             J.jnp.asarray(v), causal=False)
    assert str(ours.value) == str(theirs.value)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (_t(x) for x in _qkv(5, 1, 8, 4, 2, 48))
    with pytest.raises(ValueError, match="head_dim 48"):
        tops.flash_attention(q, k, v)
    q, k, v = (_t(x) for x in _qkv(5, 1, 8, 6, 4, 32))
    with pytest.raises(ValueError, match="multiple of 4 KV"):
        tops.flash_attention(q, k, v)
    q, k, v = (_t(x) for x in _qkv(5, 1, 8, 4, 2, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="k and v"):
        tops.flash_attention(q, k[:, :4], v[:, :4])


def test_plain_version_takes_strided_views(J):
    """q, k, v as head slices of one fused projection (not contiguous)."""
    rng = np.random.default_rng(9)
    qkv = rng.standard_normal((2, 70, 8 + 2 * 2, 32)).astype(np.float32)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    t = torch.from_numpy(qkv)
    got = tops.flash_attention(t[:, :, :8], t[:, :, 8:10], t[:, :, 10:])
    np.testing.assert_allclose(got.numpy(), _oracle(J, q, k, v), **F32_TOL)


@pytest.mark.parametrize("causal,window,q_offset,kv_len", [
    (True, None, 0, None), (True, 5, 0, None), (True, 4, 3, None),
    (False, None, 0, 9), (True, None, 2, 11)])
def test_attend_matches_reference(J, causal, window, q_offset, kv_len):
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 13, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, 13, 4, 32)).astype(np.float32)
    want = J.attn._attend(J.jnp.asarray(q), J.jnp.asarray(k),
                          J.jnp.asarray(v), causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len)
    got = tattn._attend(_t(q), _t(k), _t(v), causal=causal, window=window,
                        q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.fixture(scope="module")
def layer(J):
    """One self-attention layer of the reduced Qwen3-4B (float32) in both
    packages, with the reference's weights."""
    jcfg = J.configs.reduced_config("qwen3_4b").with_overrides(
        dtype=J.jnp.float32)
    tcfg = tconfigs.reduced_config("qwen3_4b").with_overrides(
        dtype=torch.float32)
    jp = J.attn.init_self_attention(J.jax.random.PRNGKey(11), jcfg)
    tp = tpackets.params_from_jax(J.jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp)


def _x(seed, B, S):
    return np.random.default_rng(seed).standard_normal((B, S, 256)).astype(
        np.float32)


def test_apply_self_attention_train_matches_reference(J, layer):
    x = _x(12, 2, 45)
    want, _ = J.attn.apply_self_attention(layer.jp, J.jnp.asarray(x),
                                          layer.jcfg, window=None)
    got, cache = tattn.apply_self_attention(layer.tp, _t(x), layer.tcfg,
                                            window=None)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("S,slots,window", [
    (20, 20, None),    # prefill fills the cache exactly
    (13, 17, None),    # room left for decode
    (13, 8, 8),        # a windowed ring that wraps: rolled on fill
])
def test_apply_self_attention_prefill_then_decode_matches_reference(
        J, layer, S, slots, window):
    B = 2
    x = _x(13 + S, B, S)
    jc = J.attn.make_kv_cache(layer.jcfg, B, slots, window)
    tc = tattn.make_kv_cache(layer.tcfg, B, slots, window, device="cpu")
    want, jc = J.attn.apply_self_attention(layer.jp, J.jnp.asarray(x),
                                           layer.jcfg, window=window,
                                           cache=jc)
    got, tc = tattn.apply_self_attention(layer.tp, _t(x), layer.tcfg,
                                         window=window, cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert tc["pos"] == int(jc["pos"]) == S
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **F32_TOL)
    for step in range(3):                 # decode, wrapping the ring
        x1 = _x(100 + step, B, 1)
        want, jc = J.attn.apply_self_attention(
            layer.jp, J.jnp.asarray(x1), layer.jcfg, window=window, cache=jc)
        got, tc = tattn.apply_self_attention(
            layer.tp, _t(x1), layer.tcfg, window=window,
            cache=copy.copy(tc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        assert tc["pos"] == int(jc["pos"]) == S + step + 1
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   **F32_TOL)


# ---------------------------------------------------------------------------
# windowed and chunked routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,chunk", [(None, 16), (9, 16), (9, 7)])
def test_attend_chunked_matches_reference(J, window, chunk):
    """`_attend_chunked` against the reference's at a small chunk: with
    and without a window, S a multiple of the chunk and ragged (the
    reference pads the last chunk, the port runs it short)."""
    q, k, v = _qkv(21, 2, 48, 4, 4, 16)
    want = J.attn._attend_chunked(J.jnp.asarray(q), J.jnp.asarray(k),
                                  J.jnp.asarray(v), causal=True,
                                  window=window, chunk=chunk)
    got = tattn._attend_chunked(_t(q), _t(k), _t(v), causal=True,
                                window=window, chunk=chunk)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _count_flash(monkeypatch):
    """Count `ops.flash_attention` calls from the attention module (the
    CPU wrapper launches nothing, so its own count stays 0)."""
    calls = []
    real = tops.flash_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tattn.ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("window", [None, 8])
def test_apply_self_attention_above_the_threshold_matches_reference(
        J, layer, monkeypatch, window):
    """Above CHUNK_THRESHOLD (set to 16 in both modules for the test)
    a windowed prefill takes `_attend_chunked` in both packages; without
    a window the port takes the flash kernel, whose function is the
    same.  Outputs and the filled cache against the reference's."""
    monkeypatch.setattr(J.attn, "CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "Q_CHUNK", 16)
    monkeypatch.setattr(J.attn, "Q_CHUNK", 16)
    chunked = []
    real = tattn._attend_chunked
    monkeypatch.setattr(tattn, "_attend_chunked",
                        lambda *a, **kw: chunked.append(1) or real(*a, **kw))
    flash = _count_flash(monkeypatch)
    B, S = 2, 40
    x = _x(22, B, S)
    jc = J.attn.make_kv_cache(layer.jcfg, B, S + 2, window)
    tc = tattn.make_kv_cache(layer.tcfg, B, S + 2, window, device="cpu")
    want, jc = J.attn.apply_self_attention(layer.jp, J.jnp.asarray(x),
                                           layer.jcfg, window=window,
                                           cache=jc)
    got, tc = tattn.apply_self_attention(layer.tp, _t(x), layer.tcfg,
                                         window=window, cache=tc)
    assert (len(chunked), len(flash)) == ((1, 0) if window else (0, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **F32_TOL)


@pytest.mark.parametrize("S,window,route", [
    (24, 24, "flash"),        # S == window: the window's mask is vacuous
    (17, 24, "flash"),
    (25, 24, "attend"),       # S > window: the window masks keys
])
def test_window_route_matches_attend_with_the_window(J, layer, monkeypatch,
                                                     S, window, route):
    """Train with a window: the port's route (flash while S <= window,
    `_attend` above) equals the reference's `_attend` with the window."""
    flash = _count_flash(monkeypatch)
    x = _x(23 + S, 2, S)
    want, _ = J.attn.apply_self_attention(layer.jp, J.jnp.asarray(x),
                                          layer.jcfg, window=window)
    got, _ = tattn.apply_self_attention(layer.tp, _t(x), layer.tcfg,
                                        window=window)
    assert len(flash) == (route == "flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_head_dim_without_a_kernel_instance_takes_attend(J, monkeypatch):
    """A head dim the flash kernel has no instance for (RecurrentGemma's
    256; 48 here) takes `_attend`, also without a window."""
    flash = _count_flash(monkeypatch)
    q, k, v = _qkv(24, 2, 20, 4, 2, 48)
    got = tattn._causal_attention(_t(q), _t(k), _t(v), window=None)
    assert flash == []
    np.testing.assert_allclose(got.numpy(), _oracle(J, q, k, v), **F32_TOL)


def test_dense_cache_ignores_the_config_window_as_the_reference_r7(J):
    """R7 (ROADMAP.md §3), copied: a ``dense`` block's cache is sized by
    prefill's `window` argument, not by ``cfg.window``, so with
    ``window=None`` and a prompt longer than the config's window (the
    reduced StarCoder2-15B's 64) cached decode attends every slot while
    a fresh forward applies the window.  The port decodes as the
    reference does, and both differ from the fresh forward."""
    from repro.models import transformer as jtf
    from repro.models.layers import norm_apply as jnorm

    from repro_torch.models import transformer as ttf
    jcfg = J.configs.reduced_config("starcoder2_15b").with_overrides(
        dtype=J.jnp.float32)
    tcfg = tconfigs.reduced_config("starcoder2_15b").with_overrides(
        dtype=torch.float32)
    assert tcfg.window == 64
    jparams = jtf.init_lm(J.jax.random.PRNGKey(5), jcfg)
    tparams = ttf.lm_params_from_jax(
        J.jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    S = 70
    toks = np.random.default_rng(25).integers(
        0, tcfg.vocab_size, (1, S + 1)).astype(np.int32)
    _, jcache = jtf.prefill(jparams, J.jnp.asarray(toks[:, :S]), jcfg,
                            cache_len=S + 1)
    _, tcache = ttf.prefill(tparams, torch.from_numpy(toks[:, :S]).long(),
                            tcfg, cache_len=S + 1)
    assert all(c["k"].shape[1] == S + 1 for c in tcache)
    jdec, _ = jtf.decode_step(jparams, J.jnp.asarray(toks[:, S:]), jcache,
                              jcfg)
    tdec, _ = ttf.decode_step(tparams, torch.from_numpy(toks[:, S:]).long(),
                              tcache, tcfg)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), **F32_TOL)
    h, _ = jtf.forward_hidden(jparams, J.jnp.asarray(toks), jcfg)
    fresh = np.asarray(jtf._lm_logits(
        jparams, jnorm(jparams["final_norm"], h[:, -1:], jcfg.norm), jcfg))
    assert np.abs(np.asarray(jdec) - fresh).max() > 1e-2
