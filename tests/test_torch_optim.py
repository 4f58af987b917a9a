"""repro_torch.optim against repro.optim.

The same parameter tree and the same five gradient trees, made with
numpy, go through both packages' optimizers.  Both compute in float32
in the same order, so they agree to float32 rounding: rtol 1e-5,
atol 1e-7 (transcendental functions and fused multiply-adds may differ
by an ulp between XLA and PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim import base as jbase
from repro_torch import optim as topt
from repro_torch.core.packets import params_from_jax, tree_flatten

TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 5


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((3, 4))).astype(np.float32),
            "b": {"w": (scale * rng.standard_normal(7)).astype(np.float32),
                  "z": np.zeros((2, 2), np.float32)}}


def _close(got, want, **tol):
    got_leaves = tree_flatten(got)[0]
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves, strict=True):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **(tol or TOL))


def _run(pkg, opt, params, grads, convert):
    """`len(grads)` steps of `opt` from `params`: (params, state)."""
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(convert(g), state, params)
        params = pkg.apply_updates(params, updates)
    return params, state


def _port(x):
    return params_from_jax(x, device="cpu")


def _jax(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


SCHEDULES = {
    "float": lambda mod: 3e-2,
    "cosine": lambda mod: mod.cosine_decay(3e-2, total_steps=4, floor=1e-3),
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {"beta": 0.8}), ("adam", {}),
    ("adamw", {"weight_decay": 0.1}),
])
def test_optimizer_five_steps_match(name, kw, sched):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** -k) for k in range(STEPS)]
    jo = getattr(jopt, name)(SCHEDULES[sched](jopt), **kw)
    to = getattr(topt, name)(SCHEDULES[sched](topt), **kw)
    jp, js = _run(jopt, jo, _jax(params), grads, _jax)
    tp, ts = _run(topt, to, _port(params), grads, _port)
    _close(tp, jp)
    assert ts.step == int(js.step) == STEPS
    if js.slots != ():
        _close(ts.slots, js.slots)


def test_bf16_momentum_state():
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jp, js = _run(jopt, jopt.momentum(0.1, state_dtype=jnp.bfloat16),
                  _jax(params), grads, _jax)
    tp, ts = _run(topt, topt.momentum(0.1, state_dtype=torch.bfloat16),
                  _port(params), grads, _port)
    assert all(x.dtype == torch.bfloat16 for x in tree_flatten(ts.slots)[0])
    _close(ts.slots, js.slots, rtol=0, atol=0)
    _close(tp, jp)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.5,)),
    ("cosine_decay", (1.0, 7, 0.1)),
    ("linear_warmup_cosine", (2e-3, 3, 11, 1e-4)),
])
def test_schedules_match(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in range(14):
        want = np.float32(jf(jnp.int32(step)))
        got = tf(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match(max_norm):
    tree = _tree(np.random.default_rng(3))
    jt = _jax(tree)
    np.testing.assert_allclose(float(topt.global_norm(_port(tree))),
                               float(jbase.global_norm(jt)), **TOL)
    _close(topt.clip_by_global_norm(_port(tree), max_norm),
           jbase.clip_by_global_norm(jt, max_norm))


def test_tree_zeros_like_keeps_dtype_and_device():
    tree = _port(_tree(np.random.default_rng(4)))
    zeros = topt.tree_zeros_like(tree, torch.bfloat16)
    for x, z in zip(tree_flatten(tree)[0], tree_flatten(zeros)[0],
                    strict=True):
        assert z.shape == x.shape and z.dtype == torch.bfloat16
        assert z.device == x.device and not z.any()
