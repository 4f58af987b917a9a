"""Mixture-of-Experts: token-choice top-k routing with a per-group
expert capacity, shared experts (DeepSeek-V2) and a parallel dense
residual MLP (Arctic).

The port of `repro.models.moe`, holding its function:

- tokens are routed in groups of about TARGET_GROUP (`apply_moe`): a
  group is a chunk of ``chunk_s`` positions of every sequence,
  flattened batch-major, and each group has its own capacity
  C = ceil(T·top_k / E · capacity_factor) slots per expert
  (`_capacity`).  So a decode step, one group of B tokens, gets other
  capacities than a fresh forward over the whole sequence, and drops
  other (token, choice) pairs (ROADMAP.md §3 R9);
- the router is float32 (its weight and its input), softmax, top-k (the
  lower expert first among equal probabilities, as `jax.lax.top_k`); the
  k gates are divided by their sum (+ 1e-9) before any drop and are not
  renormalised after it;
- a (token, choice) pair's slot is the number of earlier pairs that
  chose the same expert, in the flattened (T·k) order, token-major and
  choice-minor (token 0's second choice outranks token 1's first); a
  pair whose slot is >= C is dropped (its gate becomes 0);
- each expert computes silu(x·w_gate) · (x·w_up) · w_down (SwiGLU
  whatever `cfg.act` is) on its (C, d) slots, empty slots included, so
  expert FLOPs scale with E·C as in the reference;
- the combine weights are the gates rounded to `cfg.dtype`, summed in
  float32 and rounded once;
- the load-balance loss is E · sum(frac_tokens · frac_probs) ·
  router_aux_weight, frac_tokens counting the first choice before
  drops, frac_probs the mean probability; `apply_moe` averages it over
  groups.

The reference dispatches and combines through one-hot einsums (a (T, E,
C) tensor a group: (8,192, 128, 160) for Arctic); the port gathers the
kept tokens into their (expert, slot) rows and gathers each pair's
expert output back by index, which computes the same sums.  The expert
products are `torch.bmm` over (E, C, d) and stay plain PyTorch, as the
reference leaves them to XLA: no TPU kernel stands behind them.  The
reference's mesh knob for the dispatched activations (`MOE_ACT_SPEC`)
has nothing to pin on the port's one-card mesh (`launch.mesh`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import dense_apply, dense_init, mlp_apply, mlp_init

TARGET_GROUP = 8192    # tokens routed together


def _expert_stack(g: torch.Generator, E: int, d_in: int, d_out: int,
                  scale: float, dtype, device) -> torch.Tensor:
    """(E, d_in, d_out) standard normal x scale in `dtype`, drawn one
    expert at a time: a float32 draw of Arctic's whole (128, 7,168,
    4,864) stack would be 17.9 GB."""
    w = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
    if w.is_meta:           # shapes only (a plan): there is nothing to draw
        return w
    for e in range(E):
        w[e] = (torch.randn((d_in, d_out), generator=g, dtype=torch.float32,
                            device=device) * scale).to(dtype)
    return w


def init_moe(g: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's layout and scales: ``router`` float32 (scale
    0.02), ``w_gate`` / ``w_up`` (E, d, ff) at 1/sqrt(d), ``w_down`` (E,
    ff, d) at 1/sqrt(ff), ``shared`` (num_shared_experts x the residual
    width) and ``residual`` MLPs in `cfg.dtype`."""
    mc: MoEConfig = cfg.moe
    d, ff, E = cfg.d_model, mc.d_ff_expert, mc.num_experts
    kw = {"dtype": cfg.dtype, "device": device}
    p = {
        "router": dense_init(g, d, E, scale=0.02, dtype=torch.float32,
                             device=device),
        "w_gate": _expert_stack(g, E, d, ff, 1.0 / np.sqrt(d), **kw),
        "w_up": _expert_stack(g, E, d, ff, 1.0 / np.sqrt(d), **kw),
        "w_down": _expert_stack(g, E, ff, d, 1.0 / np.sqrt(ff), **kw),
    }
    if mc.num_shared_experts > 0:
        shared_ff = mc.num_shared_experts * (mc.d_ff_residual or ff)
        p["shared"] = mlp_init(g, d, shared_ff, cfg.act, **kw)
    if mc.dense_residual:
        p["residual"] = mlp_init(g, d, mc.d_ff_residual or ff, cfg.act, **kw)
    return p


def _capacity(T: int, E: int, top_k: int, factor: float) -> int:
    return max(1, int(math.ceil(T * top_k / E * factor)))


def _route(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """The routing of one token group xt (T, d): (probs (T, E) float32,
    gates (T, k) normalised, dropped pairs 0, experts (T, k), slots
    (T, k), capacity C).  A pair is dropped where its slot is >= C."""
    mc: MoEConfig = cfg.moe
    T = xt.shape[0]
    E, k = mc.num_experts, mc.top_k
    C = _capacity(T, E, k, mc.capacity_factor)

    logits = dense_apply(p["router"], xt.float())                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # the top k with `jax.lax.top_k`'s tie order, the lower expert first
    # among equal probabilities (`torch.topk` promises no order there)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]       # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # slot of each (token, choice) pair within its expert: the count of
    # earlier pairs in the flattened token-major order with that expert,
    # its rank among its expert's pairs after a stable sort by expert (the
    # reference's one-hot cumsum over (T·k, E) gives the same counts; as a
    # scan over 49,152 x 160 int64 it took 19 ms a layer of DeepSeek-V2's
    # prefill, `chip_smoke.py` phase 14 on an H100 80GB HBM3 at 700 W)
    flat = gate_idx.reshape(T * k)
    order = torch.argsort(flat, stable=True)
    # pairs per expert (`bincount` would sync with the host on the card)
    counts = flat.new_zeros(E).scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts       # first sorted pair each
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(T * k, device=xt.device) - starts[flat[order]]
    pos = pos.reshape(T, k)
    return probs, gate_vals * (pos < C), gate_idx, pos, C


def _route_group(p: dict, xt: torch.Tensor, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route one token group.  xt: (T, d) -> (y: (T, d), aux scalar)."""
    mc: MoEConfig = cfg.moe
    T, d = xt.shape
    E, k = mc.num_experts, mc.top_k
    probs, gate_vals, gate_idx, pos, C = _route(p, xt, cfg)
    keep = (pos < C).reshape(T * k)
    flat, pos = gate_idx.reshape(T * k), pos.reshape(T * k)

    # dispatch: each kept pair's token into its (expert, slot) row; the
    # dropped pairs write a spare row E·C that is cut off (no boolean
    # index, so no host sync)
    row = torch.where(keep, flat * C + pos, E * C)                # (T·k,)
    xe = xt.new_zeros((E * C + 1, d))
    xe[row] = xt.repeat_interleave(k, dim=0)
    xe = xe[:E * C].reshape(E, C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(E * C, d)
    # combine: each pair's expert row (a dropped pair reads row 0 with a
    # gate of 0) weighted by its gate rounded to the model's dtype
    picked = ye[torch.where(keep, row, 0)].reshape(T, k, d)
    comb = gate_vals.to(xt.dtype).float()
    y = (comb[..., None] * picked.float()).sum(1).to(xt.dtype)

    # load-balance auxiliary loss (Switch / GShard)
    frac_tokens = F.one_hot(gate_idx[:, 0], E).float().mean(0)
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs) * mc.router_aux_weight
    return y, aux


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  The sequence is cut into chunks of
    ``chunk_s`` positions (at most TARGET_GROUP // B, dividing S); each
    chunk of every sequence, flattened batch-major, is one routing
    group, and aux is the mean over groups."""
    B, S, d = x.shape
    chunk_s = max(1, min(S, TARGET_GROUP // B))
    while S % chunk_s:
        chunk_s -= 1
    ys, auxs = [], []
    for c0 in range(0, S, chunk_s):
        yc, aux_c = _route_group(
            p, x[:, c0:c0 + chunk_s].reshape(B * chunk_s, d), cfg)
        ys.append(yc.reshape(B, chunk_s, d))
        auxs.append(aux_c)
    out = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    aux = auxs[0] if len(auxs) == 1 else torch.stack(auxs).mean()

    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    if "residual" in p:
        out = out + mlp_apply(p["residual"], x, cfg.act)
    return out, aux
