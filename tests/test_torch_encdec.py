"""The port's cross-attention, encoder and memory path against the JAX
package, on the CPU.

Covered: `precompute_cross_kv` / `apply_cross_attention` (Sq != M, GQA
8/2); the ``enc``, ``xattn`` and ``dec`` blocks through `apply_block`
(``enc`` without a cache: the reference has no ``enc`` cache; ``xattn``
and ``dec`` without one, then prefill into one and decode with
``memory=None`` reading the cross K/V from it); `run_encoder`;
`lm_params_from_jax` on the encoder's stack and the 0-d gates;
`forward_hidden`, `lm_loss` (and its gradient) with ``batch["memory"]``;
`make_prefill_step` with a "memory" leaf and four serve steps; the
memory split across clients; the train driver on the reduced
SeamlessM4T-medium; and R8, the reference's causal encoder (ROADMAP.md
§3), in both packages.  The models are the reduced Llama-3.2-Vision-90B
(4 ``dense`` + 1 ``xattn``, GQA 8/2) and the reduced SeamlessM4T-medium
(2 ``enc`` + 2 ``dec``), with the reference's weights carried across.

The ``xattn`` gates start at 0 in both packages, and tanh(0) = 0 hides
the image; every test sets them non-zero (GATE_ATTN, GATE_MLP) in the
numpy tree both sides are built from.

Tolerances, those of `tests/test_torch_lm.py`: float32 rtol = atol =
2e-4; bf16 rtol 0.08, atol 0.05.
"""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import packets as tpackets
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0.08, atol=0.05)
GATE_ATTN, GATE_MLP = 0.9, -0.6      # tanh: 0.716, -0.537
VISION, SEAMLESS = "llama3_2_vision_90b", "seamless_m4t_medium"
PROMPT = 13
DECODE_STEPS = 4


@pytest.fixture(scope="module")
def J():
    """The JAX reference, imported here and not at module level."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import attention as jattn
    from repro.models import transformer as jtf
    return SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                           steps=jsteps, attn=jattn, tf=jtf)


def _np_tree(J, tree):
    return J.jax.tree_util.tree_map(np.asarray, tree)


def _fields(value):
    """A config field for comparison across the two packages: a nested
    config (MoEConfig, MLAConfig; each package has its own class) as
    the dict of its fields."""
    import dataclasses
    return (dataclasses.asdict(value) if dataclasses.is_dataclass(value)
            else value)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _dtypes(J, name):
    return {"f32": (J.jnp.float32, torch.float32),
            "bf16": (J.jnp.bfloat16, torch.bfloat16)}[name]


def _tol(name):
    return F32_TOL if name == "f32" else BF16_TOL


def _set_gates(tree):
    """`tree` (numpy) with every ``gate_attn`` / ``gate_mlp`` set to
    GATE_ATTN / GATE_MLP, in the leaf's dtype and shape (0-d, or (G,)
    when stacked)."""
    if isinstance(tree, dict):
        gates = {"gate_attn": GATE_ATTN, "gate_mlp": GATE_MLP}
        return {k: (np.full_like(v, gates[k]) if k in gates
                    else _set_gates(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_set_gates(v) for v in tree)
    return tree


def _both(J, np_tree, device="cpu"):
    """A numpy tree as the reference's jnp tree and the port's tensors."""
    return (J.jax.tree_util.tree_map(J.jnp.asarray, np_tree),
            tpackets.params_from_jax(np_tree, device=device))


def _memory(cfg, B, M, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, M, cfg.d_model)).astype(np.float32)


def _as(J, x: np.ndarray, jdt, tdt):
    return J.jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


_MODELS: dict = {}


def _reduced(J, arch, name):
    """The reduced `arch` in both packages with the reference's weights
    (drawn once, in JAX) and non-zero gates."""
    if (arch, name) not in _MODELS:
        jdt, tdt = _dtypes(J, name)
        jcfg = J.configs.reduced_config(arch).with_overrides(dtype=jdt)
        tcfg = tconfigs.reduced_config(arch).with_overrides(dtype=tdt)
        np_params = _set_gates(_np_tree(
            J, J.tf.init_lm(J.jax.random.PRNGKey(0), jcfg)))
        _MODELS[arch, name] = SimpleNamespace(
            jcfg=jcfg, tcfg=tcfg, np_params=np_params,
            jparams=J.jax.tree_util.tree_map(J.jnp.asarray, np_params),
            tparams=ttf.lm_params_from_jax(np_params, tcfg, device="cpu"))
    return _MODELS[arch, name]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_configs_build_and_the_m4_ones_still_raise(J):
    """Both M5 configs build in the port, full and reduced, equal to the
    reference's; their layer kinds are the reference's.  Arctic-480B and
    DeepSeek-V2-236B, which raised until M4 was ported, build now and
    equal the reference's; an unknown name raises."""
    import dataclasses
    for arch, alias in ((VISION, "llama-3.2-vision-90b"),
                        (SEAMLESS, "seamless-m4t-medium")):
        for getter in ("get_config", "reduced_config"):
            jc = getattr(J.configs, getter)(arch)
            tc = getattr(tconfigs, getter)(alias)
            for f in dataclasses.fields(jc):
                if f.name != "dtype":
                    assert _fields(getattr(tc, f.name)) == _fields(
                        getattr(jc, f.name)), \
                        (arch, getter, f.name)
            assert tc.padded_vocab == jc.padded_vocab
            tc.validate()
    vision = tconfigs.get_config("llama-3.2-vision-90b")
    assert ttf.layer_kinds(vision) == (["dense"] * 4 + ["xattn"]) * 20
    assert ttf.layer_kinds(vision.with_overrides(num_layers=20)).count(
        "xattn") == 4
    seamless = tconfigs.get_config("seamless-m4t-medium")
    assert ttf.layer_kinds(seamless) == ["dec"] * 12
    assert ttf.layer_kinds(ttf.encoder_config(seamless)) == ["enc"] * 12
    assert seamless.padded_vocab == 256256
    # the M4 configs build now and equal the reference's field for field
    for arch in ("arctic-480b", "deepseek-v2-236b"):
        jc = J.configs.get_config(arch)
        tc = tconfigs.get_config(arch)
        for f in dataclasses.fields(jc):
            if f.name != "dtype":
                assert _fields(getattr(tc, f.name)) == _fields(
                        getattr(jc, f.name)), (arch, f)
        tc.validate()
    with pytest.raises(ValueError, match="unknown"):
        tconfigs.get_config("no-such-model")


@pytest.mark.parametrize("arch", [VISION, SEAMLESS])
def test_lm_params_from_jax_carries_encoder_and_gates_bit_for_bit(J, arch):
    """The reduced model in bf16: every leaf of every decoder and
    encoder layer, ``enc_norm`` and the rest is the reference's bit for
    bit; a stacked (G,) gate becomes one 0-d tensor a layer; the port's
    own init has the same layout, with gates 0 as the reference's."""
    m = _reduced(J, arch, "bf16")
    tp, npp = m.tparams, m.np_params
    stacks = [("decoder", m.tcfg)]
    if m.tcfg.encoder_layers:
        stacks.append(("encoder", ttf.encoder_config(m.tcfg)))
    for key, cfg in stacks:
        prefix, pattern, _ = cfg.decoder_layer_kinds()
        jlayers = list(npp[key]["prefix"])
        for gi in range(cfg.n_scan_groups()):
            jlayers += [J.jax.tree_util.tree_map(lambda x, gi=gi: x[gi],
                                                 npp[key]["scan"][f"b{j}"])
                        for j in range(len(pattern))]
        jlayers += list(npp[key]["suffix"])
        assert len(tp[key]) == len(jlayers) == cfg.num_layers
        for i, layer in enumerate(tp[key]):
            jleaves = J.jax.tree_util.tree_flatten_with_path(jlayers[i])[0]
            tleaves, _ = tpackets.tree_flatten(layer)
            assert len(tleaves) == len(jleaves), (key, i)
            for (path, want), got in zip(jleaves, tleaves, strict=True):
                where = (key, i, J.jax.tree_util.keystr(path))
                assert got.dtype == torch.bfloat16, where
                assert tuple(got.shape) == np.shape(want), where
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(),
                    np.asarray(want).view(np.int16), err_msg=str(where))
    rest = ["embed", "final_norm", "lm_head"] + (
        ["enc_norm"] if m.tcfg.encoder_layers else [])
    assert sorted(tp) == sorted(rest + [s for s, _ in stacks])
    for key in rest:
        for got, want in zip(tpackets.tree_flatten(tp[key])[0],
                             J.jax.tree_util.tree_leaves(npp[key]),
                             strict=True):
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
    # a uint16 view of the tree gives the same bits
    bits = J.jax.tree_util.tree_map(lambda x: x.view(np.uint16), npp)
    again = ttf.lm_params_from_jax(bits, m.tcfg, device="cpu")
    for a, b in zip(_leaves(again), _leaves(tp), strict=True):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                                  b.view(torch.int16))
    own = ttf.init_lm(torch.Generator().manual_seed(0), m.tcfg, device="cpu")
    for a, b in zip(_leaves(own), _leaves(tp), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    gates = [t for layer in own["decoder"] for k, t in layer.items()
             if k.startswith("gate_")]
    assert len(gates) == 2 * ttf.layer_kinds(m.tcfg).count("xattn")
    assert all(t.shape == () and float(t) == 0.0 for t in gates)
    carried = [float(layer[k]) for layer in tp["decoder"]
               for k in ("gate_attn", "gate_mlp") if k in layer]
    assert carried == pytest.approx([GATE_ATTN, GATE_MLP] * (
        len(carried) // 2), abs=1e-2)


def _leaves(params: dict) -> list:
    """Every tensor of the port's LM tree (its stacks are lists)."""
    out = []
    for key in sorted(params):
        parts = params[key] if key in ("decoder", "encoder") else \
            [params[key]]
        for part in parts:
            out += tpackets.tree_flatten(part)[0]
    return out


# ---------------------------------------------------------------------------
# cross-attention and the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_cross_attention_matches_reference(J, name):
    """`precompute_cross_kv` and `apply_cross_attention` (from `mem_kv`
    and from `memory`) at Sq = 7 queries against M = 16 memory
    positions, GQA 8/2, hd 32."""
    jdt, tdt = _dtypes(J, name)
    jcfg = J.configs.reduced_config(VISION).with_overrides(dtype=jdt)
    tcfg = tconfigs.reduced_config(VISION).with_overrides(dtype=tdt)
    assert (tcfg.num_heads, tcfg.num_kv_heads) == (8, 2)
    jp, tp = _both(J, _np_tree(J, J.attn.init_cross_attention(
        J.jax.random.PRNGKey(4), jcfg)))
    rng = np.random.default_rng(4)
    jx, tx = _as(J, rng.standard_normal((2, 7, 256)).astype(np.float32),
                 jdt, tdt)
    jm, tm = _as(J, _memory(tcfg, 2, 16, 5), jdt, tdt)
    want_kv = J.attn.precompute_cross_kv(jp, jm, jcfg)
    got_kv = tattn.precompute_cross_kv(tp, tm, tcfg)
    for key in ("k", "v"):
        assert got_kv[key].shape == (2, 16, 2, 32)
        assert got_kv[key].dtype == tdt
        np.testing.assert_allclose(_f32(got_kv[key]), _f32(want_kv[key]),
                                   **_tol(name))
    want = J.attn.apply_cross_attention(jp, jx, jcfg, mem_kv=want_kv)
    got = tattn.apply_cross_attention(tp, tx, tcfg, mem_kv=got_kv)
    assert got.shape == (2, 7, 256) and got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))
    direct = tattn.apply_cross_attention(tp, tx, tcfg, memory=tm)
    assert torch.equal(direct, got)


BLOCKS = [(VISION, "xattn"), (SEAMLESS, "dec"), (SEAMLESS, "enc")]


@pytest.mark.parametrize("arch, kind", BLOCKS)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_block_matches_reference(J, arch, kind, name):
    """`apply_block` of one block with non-zero gates: without a cache
    (the training path); for ``xattn`` and ``dec`` also prefill of S = 9
    into an empty cache with the memory (M = 16), then one decode step
    with ``memory=None`` reading the cross K/V from the cache; outputs
    and every cache field against the reference's."""
    jdt, tdt = _dtypes(J, name)
    jcfg = J.configs.reduced_config(arch).with_overrides(dtype=jdt)
    tcfg = tconfigs.reduced_config(arch).with_overrides(dtype=tdt)
    tol = _tol(name)
    jp, tp = _both(J, _set_gates(_np_tree(J, J.tf.init_block(
        J.jax.random.PRNGKey(6), kind, jcfg))))
    if kind == "xattn":
        assert float(tp["gate_attn"]) != 0 and tp["gate_attn"].shape == ()
    rng = np.random.default_rng(7)
    B, S, M, d = 2, 9, 16, tcfg.d_model
    jx, tx = _as(J, rng.standard_normal((B, S, d)).astype(np.float32),
                 jdt, tdt)
    jm, tm = _as(J, _memory(tcfg, B, M, 8), jdt, tdt)
    mem = (None, None) if kind == "enc" else (jm, tm)
    want, jc, _ = J.tf.apply_block(kind, jp, jx, jcfg, memory=mem[0])
    got, tc, aux = ttf.apply_block(kind, tp, tx, tcfg, memory=mem[1])
    assert jc is None and tc is None and aux == 0.0
    assert got.shape == (B, S, d) and got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    if kind == "enc":
        return

    cache_len = S + 1
    jcache = J.tf.make_block_cache(kind, jcfg, B, cache_len, None, M)
    tcache = ttf.make_block_cache(kind, tcfg, B, cache_len, None, M,
                                  device="cpu")
    want, jcache, _ = J.tf.apply_block(kind, jp, jx, jcfg, cache=jcache,
                                       memory=jm)
    got, tcache, _ = ttf.apply_block(kind, tp, tx, tcfg, cache=tcache,
                                     memory=tm)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    _caches_close(tcache, jcache, tol)
    jx1, tx1 = _as(J, rng.standard_normal((B, 1, d)).astype(np.float32),
                   jdt, tdt)
    want, jcache, _ = J.tf.apply_block(kind, jp, jx1, jcfg, cache=jcache)
    got, tcache, _ = ttf.apply_block(kind, tp, tx1, tcfg, cache=tcache)
    assert got.shape == (B, 1, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    _caches_close(tcache, jcache, tol)
    if kind == "dec":
        assert tcache["self"]["pos"] == S + 1


def _caches_close(got, want, tol, where=""):
    """A port cache (nested dicts; "pos" an int) against the
    reference's, field by field."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), where
        for key in got:
            _caches_close(got[key], want[key], tol, f"{where}.{key}")
    elif isinstance(got, int):
        assert got == int(want), where
    else:
        assert tuple(got.shape) == want.shape, where
        np.testing.assert_allclose(_f32(got), _f32(want), **tol,
                                   err_msg=where)


# ---------------------------------------------------------------------------
# the encoder, the LM, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_run_encoder_matches_reference(J, name):
    m = _reduced(J, SEAMLESS, name)
    jdt, tdt = _dtypes(J, name)
    jm, tm = _as(J, _memory(m.tcfg, 2, 16, 9), jdt, tdt)
    want = J.tf.run_encoder(m.jparams, jm, m.jcfg)
    got = ttf.run_encoder(m.tparams, tm, m.tcfg)
    assert got.shape == (2, 16, m.tcfg.d_model) and got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))


def test_encoder_is_causal_in_both_packages_r8(J):
    """R8 (ROADMAP.md §3): the reference's ``enc`` block is documented as
    bidirectional but its self-attention masks causally.  Changing the
    last of 16 frames moves only the last encoder position, in the
    reference and in the port alike (float32)."""
    m = _reduced(J, SEAMLESS, "f32")
    mem = _memory(m.tcfg, 1, 16, 10)
    other = mem.copy()
    other[:, -1] = np.random.default_rng(11).standard_normal(
        m.tcfg.d_model)
    outs = []
    for run in (lambda x: np.asarray(J.tf.run_encoder(
                    m.jparams, J.jnp.asarray(x), m.jcfg)),
                lambda x: ttf.run_encoder(m.tparams, torch.from_numpy(x),
                                          m.tcfg).numpy()):
        a, b = run(mem), run(other)
        np.testing.assert_array_equal(a[:, :15], b[:, :15])
        assert np.abs(a[:, 15] - b[:, 15]).max() > 0.1
        outs.append(a)
    np.testing.assert_allclose(outs[1], outs[0], **F32_TOL)


CASES = [pytest.param(arch, name, id=f"{arch}-{name}")
         for arch in (VISION, SEAMLESS) for name in ("f32", "bf16")]


@pytest.mark.parametrize("arch, name", CASES)
def test_forward_hidden_and_lm_loss_with_memory_match_reference(
        J, arch, name):
    """`forward_hidden` over `_memory_states` of ``batch["memory"]`` (the
    encoder's states for SeamlessM4T, the embeddings as given for the
    VLM) and `lm_loss` with the memory in the batch (ignored labels
    included); the hidden states move when the memory does."""
    m = _reduced(J, arch, name)
    jdt, tdt = _dtypes(J, name)
    toks = _tokens(m.tcfg, 2, PROMPT, 12)
    labels = _tokens(m.tcfg, 2, PROMPT, 13)
    labels[0, :3] = -1
    jm, tm = _as(J, _memory(m.tcfg, 2, m.tcfg.num_frontend_tokens, 14),
                 jdt, tdt)
    jbatch = {"tokens": J.jnp.asarray(toks), "labels": J.jnp.asarray(labels),
              "memory": jm}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long(), "memory": tm}
    want, _ = J.tf.forward_hidden(
        m.jparams, jbatch["tokens"], m.jcfg,
        memory=J.tf._memory_states(m.jparams, jbatch, m.jcfg))
    tmem = ttf._memory_states(m.tparams, tbatch, m.tcfg)
    got, aux = ttf.forward_hidden(m.tparams, tbatch["tokens"], m.tcfg,
                                  memory=tmem)
    assert got.shape == (2, PROMPT, m.tcfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))
    moved, _ = ttf.forward_hidden(
        m.tparams, tbatch["tokens"], m.tcfg, memory=ttf._memory_states(
            m.tparams, {"memory": -tm}, m.tcfg))
    assert float((moved.float() - got.float()).abs().max()) > 0.1
    jloss, _ = J.tf.lm_loss(m.jparams, jbatch, m.jcfg)
    loss, parts = ttf.lm_loss(m.tparams, tbatch, m.tcfg)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-5 if name == "f32" else 1e-2)
    assert float(parts["aux"]) == 0.0


@pytest.mark.parametrize("arch", [VISION, SEAMLESS])
def test_lm_loss_gradients_with_memory_match_reference(J, arch):
    """The gradient of `lm_loss` with memory (remat on both sides) on
    every leaf (the encoder's and the gates' included) against
    `jax.grad` of the reference's, float32: each leaf within 1e-4
    relative plus 1e-5 of its largest entry (summation order)."""
    m = _reduced(J, arch, "f32")
    toks = _tokens(m.tcfg, 2, PROMPT, 15)
    mem = _memory(m.tcfg, 2, m.tcfg.num_frontend_tokens, 16)
    jbatch = {"tokens": J.jnp.asarray(toks), "labels": J.jnp.asarray(toks),
              "memory": J.jnp.asarray(mem)}
    jgrads = J.jax.grad(lambda p: J.tf.lm_loss(p, jbatch, m.jcfg)[0])(
        m.jparams)
    leaves, treedef = tpackets.tree_flatten(m.tparams)
    live = [t.detach().requires_grad_() for t in leaves]
    loss, _ = ttf.lm_loss(tpackets.tree_unflatten(treedef, live), {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(toks).long(),
        "memory": torch.from_numpy(mem)}, m.tcfg, remat=True)
    grads = torch.autograd.grad(loss, live)
    want = tpackets.tree_flatten(ttf.lm_params_from_jax(
        _np_tree(J, jgrads), m.tcfg, device="cpu"))[0]
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want, strict=True)):
        assert g.shape == w.shape
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch, name", CASES)
def test_prefill_with_memory_and_serve_steps_match_reference(J, arch, name):
    """`make_prefill_step` on {"tokens", "memory"} (cache PROMPT +
    DECODE_STEPS), then DECODE_STEPS greedy `make_serve_step`s fed the
    reference's tokens, and `decode_step`'s logits each step: logits,
    log-probs and every layer's cache (self KV, cross K/V) against the
    reference's."""
    m = _reduced(J, arch, name)
    jdt, tdt = _dtypes(J, name)
    tol = _tol(name)
    B, cache_len = 2, PROMPT + DECODE_STEPS
    M = m.tcfg.num_frontend_tokens
    toks = _tokens(m.tcfg, B, PROMPT, 17)
    jm, tm = _as(J, _memory(m.tcfg, B, M, 18), jdt, tdt)
    jl, jcache = J.steps.make_prefill_step(m.jcfg, cache_len=cache_len)(
        m.jparams, {"tokens": J.jnp.asarray(toks), "memory": jm})
    tl, tcache = tsteps.make_prefill_step(m.tcfg, cache_len=cache_len)(
        m.tparams, {"tokens": torch.from_numpy(toks).long(), "memory": tm})
    assert tl.shape == (B, 1, m.tcfg.padded_vocab)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    _stack_caches_close(J, tcache, jcache, m.tcfg, tol)
    cross = [c["cross"] if "cross" in c else c for c in tcache
             if "pos" not in c]
    assert cross and all(c["k"].shape == (B, M, m.tcfg.num_kv_heads,
                                          m.tcfg.resolved_head_dim)
                         for c in cross)

    jserve = J.steps.make_serve_step(m.jcfg)
    tserve = tsteps.make_serve_step(m.tcfg)
    vocab = m.tcfg.vocab_size
    tok = np.asarray(J.jnp.argmax(jl[..., :vocab], axis=-1), np.int32)
    for _ in range(DECODE_STEPS):
        jlog, _ = J.tf.decode_step(m.jparams, J.jnp.asarray(tok), jcache,
                                   m.jcfg)
        jnxt, jlp, jcache = jserve(m.jparams, jcache, J.jnp.asarray(tok))
        ttok = torch.tensor(tok, dtype=torch.long)
        tlog, _ = ttf.decode_step(m.tparams, ttok, copy.deepcopy(tcache),
                                  m.tcfg)
        tnxt, tlp, tcache = tserve(m.tparams, tcache, ttok)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **tol)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **tol)
        assert int(tnxt.max()) < vocab
        tok = np.asarray(jnxt)
    _stack_caches_close(J, tcache, jcache, m.tcfg, tol)


def _stack_caches_close(J, tcache, jcache, cfg, tol):
    """Every layer's cache against the reference's stacked one."""
    prefix, pattern, _ = cfg.decoder_layer_kinds()
    jlayers = list(jcache["prefix"])
    for gi in range(cfg.n_scan_groups()):
        jlayers += [J.jax.tree_util.tree_map(lambda x, gi=gi: x[gi],
                                             jcache["scan"][f"b{j}"])
                    for j in range(len(pattern))]
    jlayers += list(jcache["suffix"])
    assert len(tcache) == len(jlayers) == cfg.num_layers
    for i, (got, want) in enumerate(zip(tcache, jlayers, strict=True)):
        _caches_close(got, want, tol, where=f"layer {i}")


def test_cached_decode_with_memory_equals_a_fresh_forward():
    """The port on its own (float32, random weights, non-zero gates):
    the logits of the last of 4 cached decode steps equal a fresh
    `forward_hidden` over the grown sequence with the same memory (the
    encoder re-run for SeamlessM4T), within F32_TOL; with the memory
    replaced they differ."""
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-medium"):
        cfg = tconfigs.reduced_config(arch).with_overrides(
            dtype=torch.float32)
        params = ttf.init_lm(torch.Generator().manual_seed(1), cfg,
                             device="cpu")
        for layer in params["decoder"]:
            if "gate_attn" in layer:
                layer["gate_attn"].fill_(GATE_ATTN)
                layer["gate_mlp"].fill_(GATE_MLP)
        g = torch.Generator().manual_seed(2)
        seq = torch.randint(0, cfg.vocab_size, (2, PROMPT + 4), generator=g)
        mem = torch.randn((2, cfg.num_frontend_tokens, cfg.d_model),
                          generator=g)
        _, cache = ttf.prefill(params, seq[:, :PROMPT], cfg,
                               cache_len=PROMPT + 4, memory=mem)
        for i in range(PROMPT, PROMPT + 4):
            dec, cache = ttf.decode_step(params, seq[:, i:i + 1], cache, cfg)
        h, _ = ttf.forward_hidden(params, seq, cfg, memory=ttf._memory_states(
            params, {"memory": mem}, cfg))
        fresh = ttf._lm_logits(params, h[:, -1:], cfg)
        torch.testing.assert_close(dec, fresh, **F32_TOL)
        # another draw (a permutation of the memory positions would not
        # do: cross-attention is invariant to it)
        other, _ = ttf.prefill(params, seq[:, :PROMPT], cfg,
                               cache_len=PROMPT,
                               memory=torch.randn(mem.shape, generator=g))
        first, _ = ttf.prefill(params, seq[:, :PROMPT], cfg,
                               cache_len=PROMPT, memory=mem)
        assert float((other - first).abs().max()) > 1e-2, arch


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_client_gradients_split_the_memory_with_the_batch():
    """`client_gradients` cuts every batch leaf, the memory included,
    into K client shards along the batch axis: client i's loss is
    `lm_loss` of examples [i·b, (i+1)·b) with their own memory, and
    changing one client's memory moves only its loss (the reduced
    Llama-3.2-Vision, float32)."""
    cfg = tconfigs.reduced_config("llama-3.2-vision-90b").with_overrides(
        dtype=torch.float32)
    params = ttf.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu")
    for layer in params["decoder"]:
        if "gate_attn" in layer:
            layer["gate_attn"].fill_(GATE_ATTN)
            layer["gate_mlp"].fill_(GATE_MLP)
    K, b, S = 2, 2, 8
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (K * b, S), generator=g)
    mem = torch.randn((K * b, cfg.num_frontend_tokens, cfg.d_model),
                      generator=g)
    batch = {"tokens": toks, "labels": toks, "memory": mem}
    losses, grads = tsteps.client_gradients(params, batch, cfg, K)
    for i in range(K):
        shard = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        want, _ = ttf.lm_loss(params, shard, cfg)
        torch.testing.assert_close(losses[i], want.detach(), rtol=1e-6,
                                   atol=0)
    assert grads["decoder"][4]["gate_attn"].shape == (K,)
    moved = dict(batch, memory=mem.clone())
    moved["memory"][b:] += 1.0
    losses2, _ = tsteps.client_gradients(params, moved, cfg, K)
    assert float(losses2[0]) == float(losses[0])
    assert abs(float(losses2[1]) - float(losses[1])) > 1e-4


def test_train_driver_runs_seamless_on_the_cpu(capsys):
    """`python -m repro_torch.launch.train --arch seamless-m4t-medium
    --reduced --device cpu --steps 2`: the driver feeds zero memory of
    (batch, num_frontend_tokens, d_model), the encoder runs inside each
    client's loss, two finite losses."""
    run = ttrain.main(["--arch", "seamless-m4t-medium", "--reduced",
                       "--device", "cpu", "--steps", "2", "--batch", "4",
                       "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=seamless-m4t-medium-smoke device=cpu" in out
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert run.opt_state.step == 2
    assert len(run.params["encoder"]) == 2
