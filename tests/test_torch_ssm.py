"""The port's recurrent blocks (`repro_torch.models.ssm`) against the JAX
package, on the CPU.

Covered, for each of RG-LRU, mLSTM and sLSTM in float32 and bf16: train
(no state), prefill (a fresh state in, the end state out) and three
one-token decode steps after the prefill, each output and every field
of each state against the reference's function on the reference's
weights (carried across with `params_from_jax`; `jax.random` draws
cannot be made in torch); `_mlstm_chunkwise` with S below one chunk,
S a multiple of the chunk and S ragged over 3 chunks, from a zero and
from a live state, and its gradient over 3 chunks; the Hillis–Steele
`linear_scan` against the recurrence step by step; and the port's own
consistency checks that
mirror `tests/test_models.py`: the chunkwise mLSTM's end state equals
its step-by-step decode's, RG-LRU's scan equals its decode.

Tolerances: float32 rtol = atol = 2e-4 (`F32_TOL`, summation order:
the scan combines in another order than XLA's `associative_scan`,
cumsum and einsum sum in other orders); bf16 rtol 0.08, atol 0.05
(`BF16_TOL`: the projections round to bf16 in two programs), as
`tests/test_torch_lm.py`.  The consistency checks keep the reference
test's own tolerances (2e-3 on states, 2e-2 on bf16 outputs).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import packets as tpackets
from repro_torch.models import ssm as tssm

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0.08, atol=0.05)
B, S = 2, 37
DECODE_STEPS = 3
KINDS = ("rglru", "mlstm", "slstm")
# the reduced config each block comes from
ARCH = {"rglru": "recurrentgemma_9b", "mlstm": "xlstm_125m",
        "slstm": "xlstm_125m"}
STATE_FIELDS = {"rglru": ("h", "conv"), "mlstm": ("C", "n", "m"),
                "slstm": ("c", "n", "m", "h")}


@pytest.fixture(scope="module")
def J():
    """The JAX reference, imported here and not at module level."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import ssm as jssm
    return SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                           ssm=jssm)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _block(J, kind, dtype):
    """(reference cfg, port cfg, reference params, port params, apply
    functions, state makers) of one block, the reference's weights."""
    jcfg = J.configs.reduced_config(ARCH[kind]).with_overrides(
        dtype=getattr(J.jnp, dtype))
    tcfg = tconfigs.reduced_config(ARCH[kind]).with_overrides(
        dtype=getattr(torch, dtype))
    jp = getattr(J.ssm, f"init_{kind}")(J.jax.random.PRNGKey(
        KINDS.index(kind)), jcfg)
    tp = tpackets.params_from_jax(J.jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
        japply=getattr(J.ssm, f"apply_{kind}"),
        tapply=getattr(tssm, f"apply_{kind}"),
        jstate=lambda b: getattr(J.ssm, f"make_{kind}_state")(jcfg, b),
        tstate=lambda b: getattr(tssm, f"make_{kind}_state")(
            tcfg, b, device="cpu"))


def _x(seed, shape, dtype, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _both(J, x, dtype):
    return (J.jnp.asarray(x, getattr(J.jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _states_close(kind, got, want, tol):
    for name in STATE_FIELDS[kind]:
        assert got[name].dtype == torch.float32, name
        assert tuple(got[name].shape) == np.asarray(want[name]).shape, name
        np.testing.assert_allclose(_f32(got[name]), _f32(want[name]), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_train_matches_reference(J, kind, dtype):
    m = _block(J, kind, dtype)
    jx, tx = _both(J, _x(1, (B, S, m.tcfg.d_model), dtype), dtype)
    want, jstate = m.japply(m.jp, jx, m.jcfg)
    got, state = m.tapply(m.tp, tx, m.tcfg)
    assert jstate is None and state is None
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_prefill_then_decode_matches_reference(J, kind, dtype):
    """Prefill from a fresh state, then DECODE_STEPS one-token steps:
    each output and every state field, field by field."""
    m = _block(J, kind, dtype)
    tol = _tol(dtype)
    jx, tx = _both(J, _x(2, (B, S, m.tcfg.d_model), dtype), dtype)
    want, jst = m.japply(m.jp, jx, m.jcfg, state=m.jstate(B))
    got, st = m.tapply(m.tp, tx, m.tcfg, state=m.tstate(B))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    _states_close(kind, st, jst, tol)
    for step in range(DECODE_STEPS):
        jx1, tx1 = _both(J, _x(10 + step, (B, 1, m.tcfg.d_model), dtype),
                         dtype)
        want, jst = m.japply(m.jp, jx1, m.jcfg, state=jst)
        got, st = m.tapply(m.tp, tx1, m.tcfg, state=st)
        assert got.shape == (B, 1, m.tcfg.d_model)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol,
                                   err_msg=f"decode step {step}")
        _states_close(kind, st, jst, tol)


def test_rglru_prefill_shorter_than_the_conv_keeps_a_zero_history(J):
    """With S < conv_width - 1 the reference's prefill keeps a zero
    conv state (and the port copies it); h is the scan's last."""
    m = _block(J, "rglru", "float32")
    jx, tx = _both(J, _x(3, (B, 2, m.tcfg.d_model), "float32"), "float32")
    _, jst = m.japply(m.jp, jx, m.jcfg, state=m.jstate(B))
    _, st = m.tapply(m.tp, tx, m.tcfg, state=m.tstate(B))
    assert not bool(st["conv"].any())
    _states_close("rglru", st, jst, F32_TOL)


@pytest.mark.parametrize("S_c", [5, 16, 19])
@pytest.mark.parametrize("live_state", [False, True])
def test_mlstm_chunkwise_matches_reference(J, S_c, live_state):
    """`_mlstm_chunkwise` at chunk 8: S below one chunk (5), a multiple
    of it (16) and ragged over 3 chunks (19), from the zero state and
    from a live one: h and the end state."""
    H, dh, chunk = 2, 16, 8
    rng = np.random.default_rng(S_c)
    q, k, v = (rng.standard_normal((B, S_c, H, dh)).astype(np.float32)
               for _ in range(3))
    log_i = rng.standard_normal((B, H, S_c)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rng.standard_normal(
        (B, H, S_c))))).astype(np.float32)
    if live_state:
        state = {"C": rng.standard_normal((B, H, dh, dh)).astype(np.float32),
                 "n": rng.standard_normal((B, H, dh)).astype(np.float32),
                 "m": rng.standard_normal((B, H)).astype(np.float32)}
    else:
        state = {"C": np.zeros((B, H, dh, dh), np.float32),
                 "n": np.zeros((B, H, dh), np.float32),
                 "m": np.full((B, H), -1e30, np.float32)}
    args = (q, k, v, log_i, log_f)
    jh, jst = J.ssm._mlstm_chunkwise(
        *(J.jnp.asarray(a) for a in args),
        {k_: J.jnp.asarray(a) for k_, a in state.items()}, chunk=chunk)
    th, tst = tssm._mlstm_chunkwise(
        *(torch.from_numpy(a) for a in args),
        {k_: torch.from_numpy(a) for k_, a in state.items()}, chunk=chunk)
    assert th.shape == (B, S_c, H, dh) and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    _states_close("mlstm", tst, jst, F32_TOL)


def test_mlstm_chunkwise_gradients_match_reference(J):
    """The gradient of a loss through `_mlstm_chunkwise` (S ragged over
    3 chunks of 8, from a live state) with respect to q, k, v, the gates
    and the state, against `jax.grad` of the reference's: the chunk loop
    and its carried state differentiate as `lax.scan` does (F32_TOL)."""
    H, dh, chunk, S_c = 2, 16, 8, 19
    rng = np.random.default_rng(7)
    args = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S_c, H, dh),) * 3 + ((B, H, S_c),)]
    args.append(np.log(1 / (1 + np.exp(-rng.standard_normal(
        (B, H, S_c))))).astype(np.float32))
    state = [rng.standard_normal(s).astype(np.float32)
             for s in ((B, H, dh, dh), (B, H, dh), (B, H))]
    w = rng.standard_normal((B, S_c, H, dh)).astype(np.float32)

    def jloss(*xs):
        st = dict(zip(("C", "n", "m"), xs[5:]))
        h, end = J.ssm._mlstm_chunkwise(*xs[:5], st, chunk=chunk)
        return ((h * w).sum() + end["C"].sum() + end["n"].sum()
                + end["m"].sum())

    want = J.jax.grad(jloss, argnums=tuple(range(8)))(
        *(J.jnp.asarray(a) for a in args + state))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args + state]
    h, end = tssm._mlstm_chunkwise(*leaves[:5],
                                   dict(zip(("C", "n", "m"), leaves[5:])),
                                   chunk=chunk)
    loss = ((h * torch.from_numpy(w)).sum() + end["C"].sum()
            + end["n"].sum() + end["m"].sum())
    got = torch.autograd.grad(loss, leaves)
    for i, (g, wnt) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **F32_TOL,
                                   err_msg=f"argument {i}")


@pytest.mark.parametrize("S_s", [1, 2, 7, 64, 100])
def test_linear_scan_matches_the_recurrence(S_s):
    """The log-depth scan == h_t = a_t·h_{t-1} + b_t step by step, to
    float32 rounding (the sums run in another order)."""
    rng = np.random.default_rng(S_s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, S_s, 5)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((3, S_s, 5)).astype(np.float32))
    h = torch.zeros(3, 5)
    want = []
    for t in range(S_s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(tssm.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_mlstm_chunkwise_matches_recurrent():
    """mLSTM: the chunked-parallel prefill's end state == step-by-step
    decode's (the same math on two schedules; the port's own weights),
    at `tests/test_models.py`'s shape and tolerance."""
    cfg = tconfigs.reduced_config("xlstm_125m")
    p = tssm.init_mlstm(torch.Generator().manual_seed(2), cfg, device="cpu")
    Bc, Sc = 2, 19
    x = torch.from_numpy(_x(4, (Bc, Sc, cfg.d_model), "bfloat16", 0.3)).to(
        cfg.dtype)
    _, st_par = tssm.apply_mlstm(
        p, x, cfg, state=tssm.make_mlstm_state(cfg, Bc, device="cpu"))
    st = tssm.make_mlstm_state(cfg, Bc, device="cpu")
    for t in range(Sc):
        _, st = tssm.apply_mlstm(p, x[:, t:t + 1], cfg, state=st)
    for name in ("C", "n"):
        np.testing.assert_allclose(st_par[name].numpy(), st[name].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_rglru_scan_matches_decode():
    """RG-LRU: the scan's outputs and last state == decode's token by
    token (the port's own weights, `tests/test_models.py`'s shape and
    tolerance)."""
    cfg = tconfigs.reduced_config("recurrentgemma_9b")
    p = tssm.init_rglru(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert p["lam"].dtype == torch.float32
    assert 3.0 <= float(p["lam"].min()) and float(p["lam"].max()) < 8.0
    Bc, Sc = 2, 11
    x = torch.from_numpy(_x(5, (Bc, Sc, cfg.d_model), "bfloat16")).to(
        cfg.dtype)
    y_par, st_par = tssm.apply_rglru(
        p, x, cfg, state=tssm.make_rglru_state(cfg, Bc, device="cpu"))
    st = tssm.make_rglru_state(cfg, Bc, device="cpu")
    ys = []
    for t in range(Sc):
        y, st = tssm.apply_rglru(p, x[:, t:t + 1], cfg, state=st)
        ys.append(y)
    np.testing.assert_allclose(_f32(y_par), _f32(torch.cat(ys, 1)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(st_par["h"].numpy(), st["h"].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st_par["conv"].numpy(), st["conv"].numpy(),
                               rtol=0, atol=0)


def test_slstm_prefill_matches_decode():
    """sLSTM: one prefill call == the same tokens one decode step at a
    time, exactly (the prefill is that loop)."""
    cfg = tconfigs.reduced_config("xlstm_125m")
    p = tssm.init_slstm(torch.Generator().manual_seed(4), cfg, device="cpu")
    x = torch.from_numpy(_x(6, (2, 9, cfg.d_model), "bfloat16")).to(cfg.dtype)
    y_par, st_par = tssm.apply_slstm(
        p, x, cfg, state=tssm.make_slstm_state(cfg, 2, device="cpu"))
    st = tssm.make_slstm_state(cfg, 2, device="cpu")
    for t in range(9):
        _, st = tssm.apply_slstm(p, x[:, t:t + 1], cfg, state=st)
    for name in STATE_FIELDS["slstm"]:
        assert torch.equal(st_par[name], st[name]), name
