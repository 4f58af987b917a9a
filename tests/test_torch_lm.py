"""The port's LM serving path against the JAX package, on the CPU.

Covered: the layers (norms, RoPE, each MLP activation), carrying a JAX
parameter tree across (`params_from_jax`, `lm_params_from_jax`: bf16
bits exact, lists, the scanned groups unstacked per layer), the config
registry, and the reduced Qwen3-4B end to end — `forward_hidden`,
`prefill` of a ragged prompt (S = 37) and four greedy decode steps
through `make_serve_step` — with the reference's weights carried across
(the two packages' random draws differ, so weights are never redrawn).

Tolerances: float32 (`with_overrides(dtype=float32)` on both sides)
rtol = atol = 2e-4, the kernels' float32 tolerance; bf16 rtol = 0.08,
atol = 0.05, as `tests/test_models.py` holds bf16 decode against a
fresh forward.  On the CPU the attention of prefill and forward runs
the flash kernel's plain version (`kernels.ref.flash_attention_ref`);
the JAX side runs `_attend`.
"""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import packets as tpackets
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0.08, atol=0.05)
PROMPT = 37
DECODE_STEPS = 4


@pytest.fixture(scope="module")
def J():
    """The JAX reference, imported here and not at module level."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import layers as jlayers
    from repro.models import transformer as jtf
    return SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                           steps=jsteps, layers=jlayers, tf=jtf)


def _np_tree(J, tree):
    return J.jax.tree_util.tree_map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_reference(J, kind, dtype):
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 5, 64)) + 0.5).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jp = {"scale": J.jnp.asarray(scale, dtype)}
    if kind == "layernorm":
        jp["bias"] = J.jnp.asarray(bias, dtype)
    want = J.layers.norm_apply(jp, J.jnp.asarray(x, dtype), kind)
    tp = tpackets.params_from_jax(_np_tree(J, jp), device="cpu")
    got = tlayers.norm_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                             kind)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(J, theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = (np.arange(9)[None, :] + np.array([[0], [2070]])).astype(np.int32)
    want = J.layers.apply_rope(J.jnp.asarray(x), J.jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(
        tlayers.rope_freqs(32, theta).numpy(),
        np.asarray(J.layers.rope_freqs(32, theta)), rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(J, act):
    jp = J.layers.mlp_init(J.jax.random.PRNGKey(3), 32, 48, act,
                           dtype=J.jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 7, 32)).astype(
        np.float32)
    want = J.layers.mlp_apply(jp, J.jnp.asarray(x), act)
    tp = tpackets.params_from_jax(_np_tree(J, jp), device="cpu")
    got = tlayers.mlp_apply(tp, torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_embed_and_dense_match_reference(J):
    jp = J.layers.embed_init(J.jax.random.PRNGKey(4), 50, 16)
    tok = np.array([[0, 49, 7], [3, 3, 1]], np.int32)
    tp = tpackets.params_from_jax(_np_tree(J, jp), device="cpu")
    got = tlayers.embed_apply(tp, torch.from_numpy(tok).long())
    want = J.layers.embed_apply(jp, J.jnp.asarray(tok))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    jd = J.layers.dense_init(J.jax.random.PRNGKey(5), 16, 8, bias=True,
                             dtype=J.jnp.float32)
    td = tpackets.params_from_jax(_np_tree(J, jd), device="cpu")
    x = np.random.default_rng(5).standard_normal((3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.dense_apply(td, torch.from_numpy(x)).numpy(),
        np.asarray(J.layers.dense_apply(jd, J.jnp.asarray(x))), **F32_TOL)


# ---------------------------------------------------------------------------
# carrying parameters across
# ---------------------------------------------------------------------------

def test_params_from_jax_takes_bf16_leaves_and_lists_bit_for_bit(J):
    """A bf16 tree with lists and tuples, leaves as numpy's bfloat16
    extension dtype or as uint16 views (named by `bf16_bits`): every bit
    survives."""
    rng = np.random.default_rng(6)
    leaf = lambda *s: J.jnp.asarray(rng.standard_normal(s), J.jnp.bfloat16)
    tree = {"a": [leaf(3, 4), {"w": leaf(5)}], "b": (leaf(2, 2),),
            "e": [], "c": J.jnp.arange(4, dtype=J.jnp.int32)}
    np_tree = _np_tree(J, tree)
    as_u16 = J.jax.tree_util.tree_map(
        lambda x: x.view(np.uint16) if x.dtype.name == "bfloat16" else x,
        np_tree)
    for given in (np_tree, as_u16):
        got = tpackets.params_from_jax(given, device="cpu",
                                       bf16_bits=given is as_u16)
        assert isinstance(got["a"], list) and isinstance(got["b"], tuple)
        assert got["e"] == []
        pairs = [(got["a"][0], np_tree["a"][0]),
                 (got["a"][1]["w"], np_tree["a"][1]["w"]),
                 (got["b"][0], np_tree["b"][0])]
        for t, want in pairs:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want.view(np.int16))
        assert got["c"].dtype == torch.int32
        np.testing.assert_array_equal(got["c"].numpy(), np_tree["c"])


@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
def test_params_from_jax_keeps_16_bit_integer_leaves_without_bf16_bits(dtype):
    """Unless the caller names bf16 views, a 16-bit integer leaf stays
    the integer it is and is not bit-cast to bf16."""
    leaf = np.array([[1, 2], [300, 7]], dtype)
    got = tpackets.params_from_jax({"i": [leaf]}, device="cpu")["i"][0]
    assert got.dtype == {np.int16: torch.int16, np.uint16: torch.uint16}[dtype]
    np.testing.assert_array_equal(got.to(torch.int32).numpy(), leaf)


def test_tree_map_keeps_lists_and_tuples_in_order():
    """The tree helpers walk lists and tuples in order, as JAX does, so
    an LM tree (its ``decoder`` is a list) maps and flattens."""
    tree = {"b": [torch.ones(2), (torch.zeros(1),)], "a": torch.arange(3.0),
            "e": []}
    leaves, _ = tpackets.tree_flatten(tree)
    assert [t.shape[0] for t in leaves] == [3, 2, 1]
    got = tpackets.tree_map(lambda t: t + 1, tree)
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    assert got["e"] == []
    assert torch.equal(got["b"][1][0], torch.ones(1))
    assert torch.equal(got["a"], torch.arange(1.0, 4.0))


@pytest.fixture(scope="module")
def reduced(J):
    """The reduced Qwen3-4B in both packages, bf16 and float32, with the
    reference's weights (drawn once, in JAX)."""
    out = {}
    for name, jdt, tdt in (("bf16", J.jnp.bfloat16, torch.bfloat16),
                           ("f32", J.jnp.float32, torch.float32)):
        jcfg = J.configs.reduced_config("qwen3_4b").with_overrides(dtype=jdt)
        tcfg = tconfigs.reduced_config("qwen3-4b").with_overrides(dtype=tdt)
        jparams = J.tf.init_lm(J.jax.random.PRNGKey(0), jcfg)
        np_params = _np_tree(J, jparams)
        out[name] = SimpleNamespace(
            jcfg=jcfg, tcfg=tcfg, jparams=jparams, np_params=np_params,
            tparams=ttf.lm_params_from_jax(np_params, tcfg, device="cpu"))
    return out


def test_lm_params_from_jax_is_bit_exact_per_layer(J, reduced):
    m = reduced["bf16"]
    cfg, tp, npp = m.tcfg, m.tparams, m.np_params
    assert len(tp["decoder"]) == cfg.num_layers == 2
    for i, layer in enumerate(tp["decoder"]):
        jl = J.jax.tree_util.tree_map(lambda x, i=i: x[i],
                                      npp["decoder"]["scan"]["b0"])
        jleaves = J.jax.tree_util.tree_flatten_with_path(jl)[0]
        tleaves, _ = tpackets.tree_flatten(layer)
        assert len(tleaves) == len(jleaves) == 11
        for (path, want), got in zip(jleaves, tleaves, strict=True):
            assert tuple(got.shape) == want.shape, path
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
    assert tp["decoder"][0]["attn"]["wq"]["w"].shape == (256, 8 * 32)
    assert tp["decoder"][1]["mlp"]["down"]["w"].shape == (512, 256)
    for key in ("embed", "final_norm", "lm_head"):
        for got, want in zip(tpackets.tree_flatten(tp[key])[0],
                             J.jax.tree_util.tree_leaves(npp[key]),
                             strict=True):
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
    # the port's own init has the same layout
    own = ttf.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    for a, b in zip(_lm_leaves(own), _lm_leaves(tp), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype


def _lm_leaves(params: dict) -> list:
    """Every tensor of the port's LM tree (its decoder is a list)."""
    out = []
    for key in sorted(params):
        parts = params[key] if key == "decoder" else [params[key]]
        for part in parts:
            out += tpackets.tree_flatten(part)[0]
    return out


def test_configs_match_reference_and_unported_ones_raise(J):
    """Every ported config (Qwen3-4B, Qwen3-8B, Qwen2-72B), full and
    reduced, equals the reference's field for field; an unported one
    raises and names its milestone in ROADMAP.md."""
    import dataclasses
    assert tconfigs.PORTED == ("qwen3_4b", "qwen3_8b", "qwen2_72b")
    for arch in tconfigs.PORTED:
        for getter in ("get_config", "reduced_config"):
            jc = getattr(J.configs, getter)(arch)
            tc = getattr(tconfigs, getter)(arch.replace("_", "-"))
            for f in dataclasses.fields(jc):
                if f.name != "dtype":
                    assert getattr(tc, f.name) == getattr(jc, f.name), \
                        (arch, getter, f.name)
            for prop in ("resolved_head_dim", "padded_vocab"):
                assert getattr(tc, prop) == getattr(jc, prop), prop
            assert tc.dtype == torch.bfloat16
            tc.validate()
    assert tconfigs.get_config("qwen2-72b").qkv_bias
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 M3"):
        tconfigs.get_config("xlstm-125m")
    with pytest.raises(ValueError, match="unknown"):
        tconfigs.get_config("no-such-model")
    assert tconfigs.list_architectures() == J.configs.list_architectures()


# ---------------------------------------------------------------------------
# the reduced Qwen3-4B end to end
# ---------------------------------------------------------------------------

def _tol(name):
    return F32_TOL if name == "f32" else BF16_TOL


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_forward_hidden_matches_reference(J, reduced, name):
    m = reduced[name]
    toks = _tokens(m.tcfg, 2, PROMPT, 7)
    want, _ = J.tf.forward_hidden(m.jparams, J.jnp.asarray(toks), m.jcfg)
    got, aux = ttf.forward_hidden(m.tparams, torch.from_numpy(toks).long(),
                                  m.tcfg)
    assert got.shape == (2, PROMPT, 256) and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))


def _greedy_agrees(tokens, ref_logits, ref_tokens, margin):
    """Equal greedy tokens wherever the reference's top-2 margin exceeds
    `margin` (closer calls may flip within the tolerance)."""
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > margin
    np.testing.assert_array_equal(np.asarray(tokens)[clear],
                                  np.asarray(ref_tokens)[clear])


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_prefill_and_serve_steps_match_reference(J, reduced, name):
    m = reduced[name]
    tol = _tol(name)
    B, cache_len = 2, PROMPT + DECODE_STEPS
    toks = _tokens(m.tcfg, B, PROMPT, 8)
    jl, jcache = J.steps.make_prefill_step(m.jcfg, cache_len=cache_len)(
        m.jparams, {"tokens": J.jnp.asarray(toks)})
    tl, tcache = tsteps.make_prefill_step(m.tcfg, cache_len=cache_len)(
        m.tparams, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (B, 1, m.tcfg.padded_vocab)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    assert len(tcache) == 2 and all(c["pos"] == PROMPT for c in tcache)
    np.testing.assert_allclose(
        _f32(tcache[1]["k"]), _f32(jcache["scan"]["b0"]["k"][1]), **tol)

    jserve = J.steps.make_serve_step(m.jcfg)
    tserve = tsteps.make_serve_step(m.tcfg)
    vocab = m.tcfg.vocab_size
    # both sides are fed the reference's greedy token (teacher forcing),
    # so one close call cannot send the two sequences apart
    tok = np.asarray(J.jnp.argmax(jl[..., :vocab], axis=-1), np.int32)
    for _ in range(DECODE_STEPS):
        jlog, _ = J.tf.decode_step(m.jparams, J.jnp.asarray(tok), jcache,
                                   m.jcfg)
        jnxt, jlp, jcache = jserve(m.jparams, jcache, J.jnp.asarray(tok))
        ttok = torch.tensor(tok, dtype=torch.long)
        tlog, _ = ttf.decode_step(m.tparams, ttok, copy.deepcopy(tcache),
                                  m.tcfg)
        tnxt, tlp, tcache = tserve(m.tparams, tcache, ttok)
        assert tnxt.dtype == torch.int32 and tnxt.shape == (B, 1)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **tol)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **tol)
        _greedy_agrees(tnxt.numpy(), _f32(jlog)[..., :vocab],
                       np.asarray(jnxt), 2 * tol["atol"])
        assert int(tnxt.max()) < vocab       # padding columns masked
        tok = np.asarray(jnxt)
    assert all(c["pos"] == cache_len for c in tcache)
    np.testing.assert_allclose(
        _f32(tcache[0]["v"]), _f32(jcache["scan"]["b0"]["v"][0]), **tol)
