"""The port's LM training path against the JAX package, on the CPU.

Covered: `float_inv` and `aggregate_gradients` (every mode, with and
without `code_in_bf16`, float32 and bf16 leaves, a leaf whose size is
not a multiple of K) on the reference's own mixing matrix; `lm_loss`
and its gradient on every leaf of the reduced Qwen3-4B, Qwen3-8B,
Qwen2-72B, xLSTM-125M and RecurrentGemma-9B in float32 and bf16 (labels
with -1, S = 520, not a multiple of LOSS_CHUNK) with the reference's
weights, and remat on == off exactly; one `make_train_step` step per
mode with the reference's A, and a `fednc_blocked` step of the reduced
xLSTM-125M; the driver `launch.train`, with no `--arch` its default
xLSTM-125M; AdamW, the aggregation and the checkpoint on RG-LRU's
float32 ``lam`` among bf16 leaves; the checkpoint format; and the flash
attention Function's backward against autodiff of the reference's
`_attend`.

Tolerances, stated per test: float32 paths agree to summation order
(the reference's XLA and torch's CPU kernels sum in other orders);
bf16 paths also differ by the roundings of two different programs (the
port's attention rounds P to bf16 before P·V, as its kernel does; the
reference's `_attend` does not), so bf16 is held to a share of each
leaf's scale.  The mixing matrix is the reference's `_mix_matrix(key,
K)`, handed to both sides: `jax.random` draws cannot be made in torch.
"""
import gc
import json
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import load_pytree, restore, save_pytree
from repro_torch.core import packets as tpackets
from repro_torch.core.dist import mix_matrix
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.optim import sgd as tsgd

ARCHS = ("qwen3_4b", "qwen3_8b", "qwen2_72b", "xlstm_125m",
         "recurrentgemma_9b")
# float32 against the reference: summation order only (measured: at
# most 3.1e-6 of a leaf's largest gradient)
F32_GRAD = dict(rtol=1e-4, scale=1e-5)
# bf16 against the reference: the two programs round differently
# (measured: at most 2.7% of a leaf's largest gradient)
BF16_GRAD = dict(rtol=0.05, scale=0.05)
S_LOSS = 520          # one full LOSS_CHUNK and a ragged one
# xLSTM's loss runs its sLSTM step by step over S on both sides; at
# S_LOSS that one case took ~200 s of a loaded test run, so it runs at
# S_SLSTM (the LM head's chunks are covered at S_LOSS by the others, the
# mLSTM's chunks and their gradient by tests/test_torch_ssm.py)
S_SLSTM = 40


@pytest.fixture(scope="module")
def J():
    """The JAX reference, imported here and not at module level."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.checkpoint import ckpt as jckpt
    from repro.launch import steps as jsteps
    from repro.models import attention as jattn
    from repro.models import transformer as jtf
    from repro.optim import sgd as jsgd
    return SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                           steps=jsteps, tf=jtf, attn=jattn, ckpt=jckpt,
                           sgd=jsgd)


def _np_tree(J, tree):
    return J.jax.tree_util.tree_map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_to_scale(got, want, *, rtol, scale, what=""):
    """|got - want| <= rtol·|want| + scale·max|want| elementwise."""
    got, want = _f32(got), _f32(want)
    atol = scale * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _mix(J, K, seed=0) -> np.ndarray:
    """The reference's mixing matrix for `K` clients."""
    return np.asarray(J.steps._mix_matrix(J.jax.random.PRNGKey(seed), K))


# ---------------------------------------------------------------------------
# float_inv and aggregate_gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 4, 8, 16])
def test_float_inv_matches_reference(J, K):
    """The same A, the same pivots: the port's Gauss–Jordan equals the
    reference's to float32 rounding (rtol 1e-5 of the inverse's scale:
    both run the same elementwise steps, XLA may fuse a multiply-add),
    and A·A⁻¹ = I."""
    A = _mix(J, K, seed=K)
    want = np.asarray(J.steps.float_inv(J.jnp.asarray(A)))
    got = tsteps.float_inv(torch.from_numpy(A.copy()))
    assert got.dtype == torch.float32 and got.shape == (K, K)
    _close_to_scale(got, want, rtol=1e-5, scale=1e-5)
    np.testing.assert_allclose(A.astype(np.float64) @ got.double().numpy(),
                               np.eye(K), atol=1e-4)


def test_float_inv_pivots_on_a_zero_diagonal():
    """A zero on the diagonal is pivoted away, as the reference's
    partial pivoting does."""
    A = torch.tensor([[0.0, 2.0, 1.0], [1.0, 0.0, 0.0], [3.0, 1.0, 0.0]])
    got = tsteps.float_inv(A)
    np.testing.assert_allclose((A @ got).numpy(), np.eye(3), atol=1e-6)


def _grad_stack(K, seed=3):
    """A tree of (K, ...) per-client gradients: a matrix leaf, a vector
    leaf and a leaf whose size (3 x 7 = 21) is no multiple of K."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (K, 16, 8), "b": (K, 8), "odd": (K, 3, 7)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("mode", tsteps.AGG_MODES)
@pytest.mark.parametrize("code_in_bf16", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [4, 5])
def test_aggregate_gradients_matches_reference(J, mode, code_in_bf16,
                                               dtype, K):
    """Each mode on the reference's A (drawn from its key, handed to the
    port): float32 leaves to 1e-5 of the leaf's scale (rtol 1e-4), bf16
    leaves within one bf16 step (rtol 2^-7 plus 2^-7 of the scale: one
    rounding of the coded packets or of the mean may fall either way).
    Decoded in float32, every coded mean is also the plain mean within
    the reference's own bound (tests/test_system.py: rtol 2e-2, atol
    2e-3); packets coded in bf16 carry bf16 rounding through A⁻¹, which
    that bound does not cover."""
    key = J.jax.random.PRNGKey(11)
    grads = _grad_stack(K)
    jgrads = {k: J.jnp.asarray(v, dtype) for k, v in grads.items()}
    tgrads = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in grads.items()}
    want = J.steps.aggregate_gradients(jgrads, key, K, mode,
                                       code_in_bf16=code_in_bf16)
    A = torch.from_numpy(np.asarray(J.steps._mix_matrix(key, K)))
    got = tsteps.aggregate_gradients(tgrads, None, K, mode, A=A,
                                     code_in_bf16=code_in_bf16)
    tol = (dict(rtol=1e-4, scale=1e-5) if dtype == "float32"
           else dict(rtol=2 ** -7, scale=2 ** -7))
    plain = tsteps.aggregate_gradients(tgrads, None, K, "plain")
    for name in grads:
        assert got[name].dtype == tgrads[name].dtype
        assert got[name].shape == tgrads[name].shape[1:]
        _close_to_scale(got[name], np.asarray(want[name], np.float32),
                        **tol, what=name)
        if not (code_in_bf16 and dtype == "bfloat16"):
            np.testing.assert_allclose(_f32(got[name]), _f32(plain[name]),
                                       rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("mode", ["fednc_naive", "fednc_blocked"])
@pytest.mark.parametrize("code_in_bf16", [False, True])
def test_aggregate_gradients_in_column_slabs_changes_nothing(
        monkeypatch, mode, code_in_bf16):
    """A leaf coded AGG_COLUMNS columns at a time (here 16: ragged last
    slabs, of leaves whose sizes are no multiple of K) gives the
    mean of one whole-leaf product: each column is coded on its own, so
    only the BLAS kernel a width picks may differ, in float32 rounding
    (1e-6 of the leaf's scale; a bf16 leaf may also round one step the
    other way, rtol 2^-7)."""
    rng = np.random.default_rng(8)
    grads = {"w": torch.from_numpy(rng.standard_normal((5, 9, 7)).astype(
        np.float32)).to(torch.bfloat16),
        "b": torch.from_numpy(rng.standard_normal((5, 40)).astype(
            np.float32))}
    A = torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32))
    whole = tsteps.aggregate_gradients(grads, None, 5, mode, A=A,
                                       code_in_bf16=code_in_bf16)
    monkeypatch.setattr(tsteps, "AGG_COLUMNS", 16)
    slabs = tsteps.aggregate_gradients(grads, None, 5, mode, A=A,
                                       code_in_bf16=code_in_bf16)
    for k in grads:
        assert slabs[k].dtype == grads[k].dtype
        _close_to_scale(slabs[k], whole[k], scale=1e-6,
                        rtol=2 ** -7 if k == "w" else 1e-6)


def test_aggregate_gradients_draws_from_the_generator():
    """Without A the coded modes draw `core.dist.mix_matrix` from the host
    generator: the same seed gives the same mean as that matrix given;
    an unknown mode raises."""
    grads = {k: torch.from_numpy(v) for k, v in _grad_stack(4).items()}
    drawn = tsteps.aggregate_gradients(
        grads, torch.Generator().manual_seed(5), 4, "fednc_naive")
    A = mix_matrix(torch.Generator().manual_seed(5), 4)
    given = tsteps.aggregate_gradients(grads, None, 4, "fednc_naive", A=A)
    for k in grads:
        assert torch.equal(drawn[k], given[k])
    with pytest.raises(ValueError, match="unknown aggregation mode"):
        tsteps.aggregate_gradients(grads, None, 4, "mean")


# ---------------------------------------------------------------------------
# lm_loss and its gradient
# ---------------------------------------------------------------------------

def _model(J, arch, name):
    jdt, tdt = {"f32": (J.jnp.float32, torch.float32),
                "bf16": (J.jnp.bfloat16, torch.bfloat16)}[name]
    jcfg = J.configs.reduced_config(arch).with_overrides(dtype=jdt)
    tcfg = tconfigs.reduced_config(arch).with_overrides(dtype=tdt)
    jparams = J.tf.init_lm(J.jax.random.PRNGKey(0), jcfg)
    tparams = ttf.lm_params_from_jax(_np_tree(J, jparams), tcfg,
                                     device="cpu")
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                           tparams=tparams)


def _lm_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :7] = -1                 # ignored positions
    labels[-1, -3:] = -1
    return {"tokens": tokens, "labels": labels}


def _port_loss_and_grads(params, batch, cfg, remat=True):
    leaves, treedef = tpackets.tree_flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, parts = ttf.lm_loss(tpackets.tree_unflatten(treedef, live), tb,
                              cfg, remat=remat)
    return loss, parts, torch.autograd.grad(loss, live)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_lm_loss_and_grads_match_reference(J, arch, name):
    """`lm_loss` and its gradient on every leaf against
    `jax.value_and_grad` of the reference's (remat on both sides), S =
    520 (xLSTM-125M: S_SLSTM) with ignored labels.  float32:
    the loss to 1e-6 relative, each
    gradient leaf to F32_GRAD; bf16: the loss to 1e-3 relative (it is
    summed in float32 from logits of one bf16 head product), each leaf
    to BF16_GRAD."""
    m = _model(J, arch, name)
    batch = _lm_batch(m.tcfg, 2, S_SLSTM if arch == "xlstm_125m"
                      else S_LOSS, seed=1)
    (jloss, jparts), jgrads = J.jax.value_and_grad(
        lambda p: J.tf.lm_loss(p, {k: J.jnp.asarray(v)
                                   for k, v in batch.items()}, m.jcfg),
        has_aux=True)(m.jparams)
    loss, parts, grads = _port_loss_and_grads(m.tparams, batch, m.tcfg)
    assert set(parts) == {"xent", "aux"} and float(parts["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-6 if name == "f32" else 1e-3)
    np.testing.assert_allclose(float(parts["xent"]), float(jparts["xent"]),
                               rtol=1e-6 if name == "f32" else 1e-3)
    want = tpackets.tree_flatten(
        ttf.lm_params_from_jax(_np_tree(J, jgrads), m.tcfg, device="cpu"))[0]
    tol = F32_GRAD if name == "f32" else BF16_GRAD
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want, strict=True)):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close_to_scale(g, w, **tol, what=f"leaf {i}")


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_lm_loss_remat_changes_nothing(J, name):
    """remat recomputes the same operations: loss and every gradient
    are bit for bit those without it."""
    m = _model(J, "qwen3_4b", name)
    batch = _lm_batch(m.tcfg, 2, 40, seed=2)
    on = _port_loss_and_grads(m.tparams, batch, m.tcfg, remat=True)
    off = _port_loss_and_grads(m.tparams, batch, m.tcfg, remat=False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[2], off[2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["xlstm_125m", "recurrentgemma_9b"])
def test_lm_loss_remat_changes_nothing_through_recurrent_blocks(J, arch):
    """Checkpointing recomputes the recurrent blocks (the sLSTM's loop,
    the chunkwise mLSTM, the RG-LRU scan) with the same operations: loss
    and every gradient bit for bit those without remat (float32)."""
    m = _model(J, arch, "f32")
    batch = _lm_batch(m.tcfg, 2, 40, seed=2)
    on = _port_loss_and_grads(m.tparams, batch, m.tcfg, remat=True)
    off = _port_loss_and_grads(m.tparams, batch, m.tcfg, remat=False)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[2], off[2], strict=True):
        assert torch.equal(a, b)


def test_lm_loss_ignores_all_masked_labels(J):
    """Labels < 0 carry no loss; with none valid the count is clamped
    to one, as the reference's, and the loss is 0."""
    m = _model(J, "qwen3_4b", "f32")
    batch = _lm_batch(m.tcfg, 2, 9, seed=3)
    batch["labels"][:] = -1
    loss, parts, _ = _port_loss_and_grads(m.tparams, batch, m.tcfg)
    assert float(loss) == 0.0 and float(parts["xent"]) == 0.0


# ---------------------------------------------------------------------------
# the train step and the driver
# ---------------------------------------------------------------------------

def _check_train_step(J, arch, mode):
    """One step of the reduced `arch` in float32, K = 4 clients of a
    global batch of 8 x 24, the reference's A: the mean client loss to
    1e-6 relative and every parameter after the step to F32_GRAD's
    share of its scale."""
    m = _model(J, arch, "f32")
    K, key = 4, J.jax.random.PRNGKey(7)
    batch = _lm_batch(m.tcfg, 8, 24, seed=4)
    jstep = J.steps.make_train_step(m.jcfg, J.sgd(0.5), num_clients=K,
                                    agg_mode=mode)
    jopt = J.sgd(0.5)
    jparams, _, jloss = jstep(m.jparams, jopt.init(m.jparams),
                              {k: J.jnp.asarray(v) for k, v in batch.items()},
                              key)
    opt = tsgd(0.5)
    step = tsteps.make_train_step(m.tcfg, opt, num_clients=K, agg_mode=mode,
                                  kshard_grads=True)
    A = torch.from_numpy(np.asarray(J.steps._mix_matrix(key, K)))
    params, state, loss = step(
        m.tparams, opt.init(m.tparams),
        {k: torch.from_numpy(v).long() for k, v in batch.items()}, None, A=A)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = tpackets.tree_flatten(
        ttf.lm_params_from_jax(_np_tree(J, jparams), m.tcfg, device="cpu"))[0]
    for i, (p, w) in enumerate(zip(tpackets.tree_flatten(params)[0], want,
                                   strict=True)):
        _close_to_scale(p, w, **F32_GRAD, what=f"leaf {i}")


@pytest.mark.parametrize("mode", tsteps.AGG_MODES)
def test_train_step_matches_reference(J, mode):
    """One step of the reduced Qwen3-4B per aggregation mode
    (`_check_train_step`).  SGD (lr 0.5), so the step moves each weight
    by its aggregated gradient: Adam's first step is sign(g)·lr, where
    a gradient within rounding of zero could flip between two correct
    float32 programs."""
    _check_train_step(J, "qwen3_4b", mode)


def test_xlstm_train_step_matches_reference(J):
    """One `fednc_blocked` step of the reduced xLSTM-125M (an mLSTM and
    an sLSTM block), as `test_train_step_matches_reference`."""
    _check_train_step(J, "xlstm_125m", "fednc_blocked")


def test_client_gradients_split_the_batch():
    """Client i's gradient is the gradient of its own shard of the
    global batch, written into row i of the stack."""
    cfg = tconfigs.reduced_config("qwen3-4b").with_overrides(
        dtype=torch.float32, num_layers=1)
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long()
             for k, v in _lm_batch(cfg, 4, 12, seed=5).items()}
    losses, stack = tsteps.client_gradients(params, batch, cfg, 2)
    for i in range(2):
        shard = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        loss, _, grads = _port_loss_and_grads(
            params, {k: v.numpy() for k, v in shard.items()}, cfg)
        assert torch.equal(losses[i], loss.detach())
        for s, g in zip(tpackets.tree_flatten(stack)[0], grads, strict=True):
            assert torch.equal(s[i], g)


def test_train_step_leaves_no_tensor_to_the_collector():
    """A train step frees its gradient stack and every tree it builds
    when they go out of scope: nothing it allocates waits in a reference
    cycle for the garbage collector (on the card, a full-width stack
    held that way ran the next step out of memory).  One step is taken
    first, since the first remat call in a process imports torch's
    compiler stack, which leaves a cycle of its own."""
    cfg = tconfigs.reduced_config("qwen3-4b").with_overrides(
        dtype=torch.float32, num_layers=1)
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long()
             for k, v in _lm_batch(cfg, 4, 12, seed=5).items()}
    opt = tsgd(0.1)
    state = opt.init(params)
    step = tsteps.make_train_step(cfg, opt, num_clients=2,
                                  agg_mode="fednc_blocked")
    gen = torch.Generator().manual_seed(0)
    params, state, _ = step(params, state, batch, gen)
    gc.collect()
    gc.disable()
    try:
        gc.set_debug(gc.DEBUG_SAVEALL)
        params, state, loss = step(params, state, batch, gen)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert bool(torch.isfinite(loss))
    assert held == []


def test_tree_unflatten_keeps_no_reference_to_its_leaves():
    leaves = [torch.zeros(3), torch.ones(2)]
    alive = weakref.ref(leaves[1])
    gc.disable()
    try:
        tree = tpackets.tree_unflatten({"a": None, "b": [None]}, leaves)
        assert tree["b"][0] is leaves[1]
        del tree, leaves
        assert alive() is None
    finally:
        gc.enable()


def test_train_driver_runs_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --arch qwen3-4b --reduced
    --device cpu --steps 3`: three finite losses, one synchronized wall
    a step, and a checkpoint that loads back bit for bit."""
    ck = str(tmp_path / "ck" / "lm")
    run = ttrain.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--seq", "32",
                       "--log-every", "1", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "arch=qwen3-4b-smoke device=cpu agg=fednc_blocked clients=4" in out
    assert out.count("step ") == 3 and "saved" in out
    assert len(run.losses) == len(run.step_s) == 3
    assert all(np.isfinite(run.losses)) and all(s > 0 for s in run.step_s)
    assert run.opt_state.step == 3
    back = load_pytree(ck, run.params)
    for a, b in zip(tpackets.tree_flatten(back)[0],
                    tpackets.tree_flatten(run.params)[0], strict=True):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    manifest = json.load(open(ck + ".manifest.json"))
    assert manifest["metadata"] == {"arch": "qwen3-4b-smoke", "steps": 3}


def test_train_driver_defaults_to_xlstm_125m(capsys):
    """`python -m repro_torch.launch.train --reduced --device cpu
    --steps 2`, with no --arch, trains the reference's default
    architecture, the reduced xLSTM-125M (K = 4, fednc_blocked): two
    finite losses.  A global batch of 4 x 16 tokens keeps the sLSTM's
    sequential loop short here."""
    run = ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "4", "--seq", "16"])
    out = capsys.readouterr().out
    assert ("arch=xlstm-125m-smoke device=cpu agg=fednc_blocked clients=4"
            in out)
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert run.opt_state.step == 2


def test_adamw_aggregation_and_checkpoint_keep_lam_float32(tmp_path):
    """RG-LRU's float32 ``lam`` among bf16 leaves: one AdamW
    `fednc_blocked` step of the reduced RecurrentGemma-9B keeps every
    leaf's dtype and moves ``lam`` by Adam's first step (~lr, far below
    bf16's step of 0.03125 at lam's magnitude, so a bf16 lam would not
    move), and `save_pytree` / `load_pytree` round-trip the trained tree
    bit for bit."""
    from repro_torch.optim import adamw
    cfg = tconfigs.reduced_config("recurrentgemma-9b")
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long()
             for k, v in _lm_batch(cfg, 4, 16, seed=6).items()}
    opt = adamw(1e-3)
    step = tsteps.make_train_step(cfg, opt, num_clients=2,
                                  agg_mode="fednc_blocked")
    new, _, loss = step(params, opt.init(params), batch,
                        torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(loss))
    for a, b in zip(tpackets.tree_flatten(params)[0],
                    tpackets.tree_flatten(new)[0], strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
    lam0 = params["decoder"][0]["rglru"]["lam"]
    lam1 = new["decoder"][0]["rglru"]["lam"]
    assert lam1.dtype == torch.float32
    moved = (lam1 - lam0).abs()
    assert 0 < float(moved.max()) < 2e-3
    save_pytree(str(tmp_path / "rg"), new)
    back = load_pytree(str(tmp_path / "rg"), new)
    for a, b in zip(tpackets.tree_flatten(back)[0],
                    tpackets.tree_flatten(new)[0], strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("argv, exc, match", [
    (["--arch", "arctic-480b", "--reduced", "--mesh-model", "4"],
     ValueError, "runs on one card"),
    (["--arch", "qwen3-4b", "--reduced", "--mesh-model", "2"], ValueError,
     "runs on one card"),
    (["--arch", "qwen3-4b", "--reduced", "--mesh-data", "4"], ValueError,
     "runs on one card"),
])
def test_train_driver_refuses_what_is_not_ported(argv, exc, match):
    with pytest.raises(exc, match=match):
        ttrain.main(argv + ["--device", "cpu", "--steps", "1"])


# ---------------------------------------------------------------------------
# checkpoint/
# ---------------------------------------------------------------------------

def _ckpt_tree(J):
    rng = np.random.default_rng(9)
    arrays = {"b": [rng.standard_normal((3, 2)).astype(np.float32),
                    {"z": rng.standard_normal(4).astype(np.float32),
                     "a": np.arange(5, dtype=np.int32)}],
              "a": rng.standard_normal((2, 2)).astype(np.float32),
              "h": rng.standard_normal(6).astype(np.float32)}
    jtree = J.jax.tree_util.tree_map(J.jnp.asarray, arrays)
    jtree["h"] = jtree["h"].astype(J.jnp.bfloat16)
    ttree = {"b": [torch.from_numpy(arrays["b"][0]),
                   {k: torch.from_numpy(v) for k, v in arrays["b"][1].items()}],
             "a": torch.from_numpy(arrays["a"]),
             "h": torch.from_numpy(arrays["h"]).to(torch.bfloat16)}
    return jtree, ttree


def test_checkpoint_format_matches_reference(J, tmp_path):
    """The same tree saved by both packages gives the same manifest
    text and the same npz (names, dtypes, values: bf16 widened to
    float32); each package loads the other's file."""
    jtree, ttree = _ckpt_tree(J)
    meta = {"arch": "x", "steps": 2}
    J.ckpt.save_pytree(str(tmp_path / "ref"), jtree, metadata=meta)
    save_pytree(str(tmp_path / "port.npz"), ttree, metadata=meta)
    assert (open(tmp_path / "ref.manifest.json").read()
            == open(tmp_path / "port.manifest.json").read())
    ref, port = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert ref.files == port.files == ["a", "b/0", "b/1/a", "b/1/z", "h"]
    for name in ref.files:
        assert ref[name].dtype == port[name].dtype
        np.testing.assert_array_equal(ref[name], port[name])
    assert port["h"].dtype == np.float32
    back = load_pytree(str(tmp_path / "ref"), ttree)
    for a, b in zip(tpackets.tree_flatten(back)[0],
                    tpackets.tree_flatten(ttree)[0], strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jback = J.ckpt.load_pytree(str(tmp_path / "port"), jtree)
    np.testing.assert_array_equal(np.asarray(jback["h"], np.float32),
                                  np.asarray(jtree["h"], np.float32))


def test_checkpoint_restores_an_optimizer_state_onto_a_device(tmp_path):
    """An AdamW state (a NamedTuple with an int step) round-trips, and
    `restore` places the leaves on the given device."""
    from repro_torch.optim import adamw
    params = {"w": torch.randn(3, 4).to(torch.bfloat16), "v": [torch.ones(2)]}
    state = adamw(1e-3).init(params)
    save_pytree(str(tmp_path / "s"), state)
    keys = json.load(open(tmp_path / "s.manifest.json"))["keys"]
    assert keys == ["slots/m/v/0", "slots/m/w", "slots/v/v/0", "slots/v/w",
                    "step"]
    back = restore(str(tmp_path / "s"), state, device="cpu")
    assert type(back) is type(state) and back.step == 0
    assert back.slots["m"]["w"].dtype == torch.float32
    assert torch.equal(back.slots["v"]["v"][0], state.slots["v"]["v"][0])


# ---------------------------------------------------------------------------
# flash attention's gradient (F1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 37, 130])
@pytest.mark.parametrize("H, KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_matches_autodiff_of_attend(J, S, H, KV, dtype):
    """The Function's dq, dk, dv (CPU: the plain forward and
    `attention_backward`) against `jax.vjp` of the reference's float32
    `_attend` (causal, K and V expanded to H heads inside, so GQA sums
    the groups) on the same input values: float32 within 2e-4, bf16
    within rtol 1e-2 / atol 1e-3 — the flash tolerances of PERF.md §2
    (bf16: one rounding of each gradient).  The bf16 inputs and dO are
    handed to the reference as float32 copies: autodiff through a bf16
    `_attend` rounds each query head's gradient to bf16 before the GQA
    sum, an error of its own program, not of the function."""
    B, hd = 2, 32
    rng = np.random.default_rng(S * H)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(tdt) for s in ((B, S, H, hd), (B, S, KV, hd),
                                       (B, S, KV, hd), (B, S, H, hd)))
    groups = H // KV

    def attend(q, k, v):
        expand = lambda x: J.jnp.repeat(x, groups, axis=2)
        return J.attn._attend(q, expand(k), expand(v), causal=True,
                              window=None, q_offset=0)

    _, vjp = J.jax.vjp(attend, *(J.jnp.asarray(_f32(x)) for x in (q, k, v)))
    want = vjp(J.jnp.asarray(_f32(do)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    tol = (dict(rtol=2e-4, atol=2e-4) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-3))
    for name, g, w in zip("qkv", got, want, strict=True):
        assert g.dtype == tdt
        np.testing.assert_allclose(_f32(g), _f32(w), **tol,
                                   err_msg=f"d{name}")


def test_flash_backward_chunks_change_nothing(monkeypatch):
    """The backward's query-row chunks (one row at a time here) give the
    gradient of one whole chunk to float32 rounding, causal and not."""
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 128, 8, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in
               ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    for causal in (True, False):
        whole = torch.autograd.grad(
            tfa.flash_attention(q, k, v, causal=causal).square().sum(),
            (q, k, v))
        monkeypatch.setattr(tfa, "BWD_CHUNK_ELEMS", B * H * S)
        rows = torch.autograd.grad(
            tfa.flash_attention(q, k, v, causal=causal).square().sum(),
            (q, k, v))
        monkeypatch.undo()
        for a, b in zip(rows, whole, strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_attention_parameters_get_gradients_through_flash(J):
    """A loss through `forward_hidden` gives every attention parameter
    of every layer a finite, non-zero gradient (the path F1 guards)."""
    m = _model(J, "qwen3_4b", "f32")
    batch = _lm_batch(m.tcfg, 2, 17, seed=6)
    params = m.tparams
    leaves, treedef = tpackets.tree_flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    tree = tpackets.tree_unflatten(treedef, live)
    h, _ = ttf.forward_hidden(tree, torch.from_numpy(batch["tokens"]).long(),
                              m.tcfg)
    h.float().square().mean().backward()
    for layer in tree["decoder"]:
        for name in ("wq", "wk", "wv", "wo", "qnorm", "knorm"):
            for t in tpackets.tree_flatten(layer["attn"][name])[0]:
                assert t.grad is not None, name
                assert bool(torch.isfinite(t.grad).all()), name
                assert float(t.grad.abs().max()) > 0, name
