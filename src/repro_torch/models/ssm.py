"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin), mLSTM and sLSTM
(xLSTM), each with a parallel train / prefill path and an O(1)-per-token
decode path that carries explicit recurrent state.

The port of `repro.models.ssm`, in plain PyTorch: the reference runs
all of it in plain jnp, outside any Pallas kernel.  Parameters and
states are the reference's dicts, leaf for leaf; RG-LRU's ``lam``, every
recurrent state and every gate computation are float32 whatever the
model's dtype, as in the reference.

- RG-LRU: the reference's `jax.lax.associative_scan` of
  h_t = a_t·h_{t-1} + b_t is a log-depth Hillis–Steele scan over time
  here (`linear_scan`: ceil(log2 S) passes, each one elementwise step
  over the whole sequence), not a loop over S.  It computes the same
  sums in another order, so it agrees with the reference to float32
  rounding, not bit for bit.
- mLSTM: the chunkwise-parallel form (`_mlstm_chunkwise`, quadratic
  only inside a chunk of MLSTM_CHUNK steps), a Python loop over the
  chunks where the reference runs `lax.scan`; decode is the one-step
  recurrence.
- sLSTM: sequential by design (its normaliser and max state do not
  associate), a Python loop over S where the reference runs `lax.scan`.

Where the reference's arithmetic takes a dtype from JAX's promotion
rules, the port takes the same one: mLSTM's k is the bf16 projection
divided by a numpy float64 scalar, which JAX promotes to float32, so
k is float32 here too.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_apply, dense_init, norm_apply, norm_init


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

_C_RGLRU = 8.0


def init_rglru(g: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """RG-LRU parameters at the reference's scales; ``lam`` is float32,
    uniform on [3, 8), so that a = sigmoid(lam)^(8r) spreads over
    (0.9, 0.999)."""
    d, w = cfg.d_model, cfg.resolved_lru_width
    kw = {"dtype": cfg.dtype, "device": device}
    lam = torch.rand((w,), generator=g, dtype=torch.float32,
                     device=device) * 5.0 + 3.0
    conv_w = torch.randn((cfg.conv_width, w), generator=g,
                         dtype=torch.float32, device=device) * 0.1
    return {
        "w_in": dense_init(g, d, w, **kw),
        "w_gate": dense_init(g, d, w, **kw),        # GeGLU branch
        "conv_w": conv_w.to(cfg.dtype),
        "lam": lam,
        "w_a": dense_init(g, w, w, **kw),           # recurrence gate
        "w_x": dense_init(g, w, w, **kw),           # input gate
        "w_out": dense_init(g, w, d, **kw),
    }


def make_rglru_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    w = cfg.resolved_lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=torch.float32, device=device),
    }


def _rglru_gates(p: dict, u: torch.Tensor):
    """u: (..., w) post-conv branch input -> (a, bx) gate terms, float32.
    `F.softplus` is linear above 20 where `jax.nn.softplus` is not; at
    lam in [3, 8) the two agree to float32 rounding."""
    r = torch.sigmoid(dense_apply(p["w_a"], u).float())
    i = torch.sigmoid(dense_apply(p["w_x"], u).float())
    log_a = -_C_RGLRU * r * F.softplus(p["lam"])    # log a_t < 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = mult * i * u.float()
    return a, bx


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over dim 1 from h_{-1} = 0, for (B, S, w)
    a and b: a Hillis–Steele scan of the pairs (a, b) under
    (a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2), ceil(log2 S) passes."""
    S = a.shape[1]
    step = 1
    while step < S:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return b


def apply_rglru(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None):
    """x: (B, S, d) -> (y, new_state).  state None: train; state and
    S > 1: prefill (fresh state out); state and S == 1: decode."""
    S = x.shape[1]
    u = dense_apply(p["w_in"], x)                               # (B, S, w)
    gate = F.gelu(dense_apply(p["w_gate"], x), approximate="tanh")
    cw = cfg.conv_width
    if state is None or S > 1:
        # causal depthwise conv over time, in float32
        upad = F.pad(u.float(), (0, 0, cw - 1, 0))
        conv = 0
        for i in range(cw):
            conv = conv + upad[:, i:i + S] * p["conv_w"][i].float()
        a, bx = _rglru_gates(p, conv.to(x.dtype))
        h = linear_scan(a, bx)                                  # (B, S, w)
        new_state = None
        if state is not None:                                   # prefill
            new_state = {
                "h": h[:, -1],
                "conv": (upad[:, S:S + cw - 1] if S >= cw - 1
                         else torch.zeros_like(state["conv"])),
            }
    else:
        # decode: one step
        hist = torch.cat([state["conv"], u.float()], dim=1)     # (B, cw, w)
        conv = 0
        for i in range(cw):
            conv = conv + hist[:, i] * p["conv_w"][i].float()
        a, bx = _rglru_gates(p, conv[:, None].to(x.dtype))     # (B, 1, w)
        h = a * state["h"][:, None] + bx
        new_state = {"h": h[:, 0], "conv": hist[:, 1:]}
    y = dense_apply(p["w_out"], h.to(x.dtype) * gate)
    return y, new_state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory, exponential gating
# ---------------------------------------------------------------------------

MLSTM_CHUNK = 256
MLSTM_PROJ = 2.0           # the block's up-projection (the reference's)


def init_mlstm(g: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    d = cfg.d_model
    di = int(d * MLSTM_PROJ)
    H = cfg.num_heads
    if di % H:
        raise ValueError(f"mLSTM width {di} is not a multiple of {H} heads")
    kw = {"dtype": cfg.dtype, "device": device}
    return {
        "w_up": dense_init(g, d, 2 * di, **kw),
        "wq": dense_init(g, di, di, **kw),
        "wk": dense_init(g, di, di, **kw),
        "wv": dense_init(g, di, di, **kw),
        "w_i": dense_init(g, di, H, **kw),
        "w_f": dense_init(g, di, H, **kw),
        "norm": norm_init(di, "rmsnorm", **kw),
        "w_down": dense_init(g, di, d, **kw),
    }


def make_mlstm_state_from(B: int, H: int, dh: int, device="cuda") -> dict:
    return {
        "C": torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((B, H, dh), dtype=torch.float32, device=device),
        "m": torch.full((B, H), -1e30, dtype=torch.float32, device=device),
    }


def make_mlstm_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    di = int(cfg.d_model * MLSTM_PROJ)
    H = cfg.num_heads
    return make_mlstm_state_from(batch, H, di // H, device)


def apply_mlstm(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None):
    """x: (B, S, d) -> (y, new_state); modes as `apply_rglru`."""
    B, S, _ = x.shape
    H = cfg.num_heads
    a, g = dense_apply(p["w_up"], x).chunk(2, dim=-1)          # (B, S, di)
    di = a.shape[-1]
    dh = di // H
    q = dense_apply(p["wq"], a).reshape(B, S, H, dh)
    # the reference divides by a numpy float64, which promotes to float32
    k = dense_apply(p["wk"], a).float().reshape(B, S, H, dh) / float(
        np.sqrt(dh))
    v = dense_apply(p["wv"], a).reshape(B, S, H, dh)
    log_i = dense_apply(p["w_i"], a).float().transpose(1, 2)   # (B, H, S)
    log_f = F.logsigmoid(dense_apply(p["w_f"], a).float()).transpose(1, 2)

    if state is None or S > 1:
        st0 = state or make_mlstm_state_from(B, H, dh, x.device)
        h, end_state = _mlstm_chunkwise(q, k, v, log_i, log_f, st0)
        new_state = end_state if state is not None else None
    else:
        # recurrent decode step
        C, n, m_prev = state["C"], state["n"], state["m"]
        li = log_i[:, :, 0]
        lf = log_f[:, :, 0]
        m_new = torch.maximum(lf + m_prev, li)                  # (B, H)
        fprime = torch.exp(lf + m_prev - m_new)
        iprime = torch.exp(li - m_new)
        kh = k[:, 0].float()                                    # (B, H, dh)
        vh = v[:, 0].float()
        qh = q[:, 0].float()
        C = (fprime[..., None, None] * C
             + iprime[..., None, None] * torch.einsum("bhd,bhe->bhde", kh, vh))
        n = fprime[..., None] * n + iprime[..., None] * kh
        num = torch.einsum("bhde,bhd->bhe", C, qh)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qh).abs(),
                            torch.exp(-m_new)) + 1e-6
        h = (num / den[..., None])[:, None]                     # (B, 1, H, dh)
        new_state = {"C": C, "n": n, "m": m_new}

    hflat = h.reshape(B, S, di).to(x.dtype)
    out = norm_apply(p["norm"], hflat) * F.silu(g)
    return dense_apply(p["w_down"], out), new_state


def _mlstm_chunkwise(q, k, v, log_i, log_f, state: dict,
                     chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM (linear in S, quadratic only within a
    chunk).  q/k/v: (B, S, H, dh); log_i/log_f: (B, H, S).  Returns
    (h: (B, S, H, dh) float32, end_state).

    S is padded to a multiple of the chunk; a padded step has
    log_i = -1e30 and log_f = 0, so it adds nothing to the state.  The
    in-chunk mask is -inf; the diagonal is always live, so no row of
    the stabiliser is -inf and no -inf - -inf arises."""
    B, S, H, dh = q.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        zpad = lambda x: F.pad(x, (0, 0, 0, 0, 0, pad))
        q, k, v = zpad(q), zpad(k), zpad(v)
        log_i = F.pad(log_i, (0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, pad))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    C, n, m_run = state["C"], state["n"], state["m"]
    hs = []
    for c0 in range(0, S + pad, L):
        qc = q[:, c0:c0 + L].float()
        kc = k[:, c0:c0 + L].float()
        vc = v[:, c0:c0 + L].float()
        li = log_i[..., c0:c0 + L]
        lf = log_f[..., c0:c0 + L]
        Fc = torch.cumsum(lf, dim=-1)          # (B, H, L): in-chunk Σ log f
        # intra-chunk decay: D[t, s] = F_t - F_s + li_s (s <= t)
        Dl = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
        Dl = torch.where(mask, Dl, float("-inf"))
        intra_max = Dl.amax(dim=-1)                   # (B, H, L)
        inter_log = Fc + m_run[..., None]             # carry-in weight per t
        m_t = torch.maximum(intra_max, inter_log)
        D = torch.exp(Dl - m_t[..., None])            # (B, H, L, L)
        w_inter = torch.exp(inter_log - m_t)          # (B, H, L)

        scores = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * D
        num = (torch.einsum("bhqk,bkhd->bqhd", scores, vc)
               + torch.einsum("bhde,bqhd,bhq->bqhe", C, qc, w_inter))
        den = (scores.sum(-1)
               + torch.einsum("bhd,bqhd,bhq->bhq", n, qc, w_inter))
        den = torch.maximum(den.abs(), torch.exp(-m_t)) + 1e-6
        hs.append(num / den.transpose(1, 2)[..., None])     # (B, L, H, dh)

        # end-of-chunk state update
        Ftot = Fc[..., -1]                                        # (B, H)
        m_new = torch.maximum(Ftot + m_run,
                              (Ftot[..., None] - Fc + li).amax(dim=-1))
        w_old = torch.exp(Ftot + m_run - m_new)
        w_s = torch.exp(Ftot[..., None] - Fc + li - m_new[..., None])
        C = (w_old[..., None, None] * C
             + torch.einsum("bkhd,bkhe,bhk->bhde", kc, vc, w_s))
        n = w_old[..., None] * n + torch.einsum("bkhd,bhk->bhd", kc, w_s)
        m_run = m_new
    h = torch.cat(hs, dim=1)[:, :S]
    return h, {"C": C, "n": n, "m": m_run}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar memory, exponential gating, recurrent weights
# ---------------------------------------------------------------------------

SLSTM_PROJ = 4.0 / 3.0     # the block's up-projection (the reference's)


def init_slstm(g: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    d = cfg.d_model
    dff = int(d * SLSTM_PROJ)
    kw = {"dtype": cfg.dtype, "device": device}
    return {
        "w_gates": dense_init(g, d, 4 * d, **kw),               # i, f, z, o
        "r_gates": dense_init(g, d, 4 * d, scale=1.0 / np.sqrt(d),
                              **kw),                                # recurrent
        "norm": norm_init(d, "rmsnorm", **kw),
        "w_up": dense_init(g, d, dff, **kw),
        "w_down": dense_init(g, dff, d, **kw),
    }


def make_slstm_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    shape = (batch, cfg.d_model)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(),
            "m": torch.full(shape, -1e30, dtype=torch.float32, device=device),
            "h": z.clone()}


def _slstm_step(p: dict, carry: tuple, xt: torch.Tensor) -> tuple:
    """One sLSTM timestep.  xt: (B, d)."""
    c, n, m, h = carry
    gates = (dense_apply(p["w_gates"], xt).float()
             + dense_apply(p["r_gates"], h.to(xt.dtype)).float())
    gi, gf, gz, go = gates.chunk(4, dim=-1)
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + m, gi)
    ip = torch.exp(gi - m_new)
    fp = torch.exp(log_f + m - m_new)
    c = fp * c + ip * torch.tanh(gz)
    n = fp * n + ip
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return c, n, m_new, h


def apply_slstm(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None):
    """x: (B, S, d) -> (y, new_state).  Sequential over S by design."""
    B, S, _ = x.shape
    st = state or make_slstm_state(cfg, B, x.device)
    carry = (st["c"], st["n"], st["m"], st["h"])
    hs = []
    for t in range(S):
        carry = _slstm_step(p, carry, x[:, t])
        hs.append(carry[3])
    hs = torch.stack(hs, dim=1)                                  # (B, S, d)
    y = norm_apply(p["norm"], hs.to(x.dtype))
    y = dense_apply(p["w_down"],
                    F.gelu(dense_apply(p["w_up"], y), approximate="tanh"))
    new_state = None
    if state is not None:
        new_state = dict(zip(("c", "n", "m", "h"), carry))
    return y, new_state
