"""Shared neural building blocks (functional init/apply style).

The port of `repro.models.layers`.  Parameters are plain nested dicts
of tensors, as in the reference, so a JAX parameter tree carries across
leaf for leaf (`transformer.lm_params_from_jax`).  Init functions draw
from an explicit `torch.Generator` (on the device they draw on) with
the reference's scales; the draws are not the reference's bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(g: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               dtype=torch.bfloat16, device="cuda") -> dict:
    scale = scale if scale is not None else (1.0 / np.sqrt(d_in))
    w = torch.randn((d_in, d_out), generator=g, dtype=torch.float32,
                    device=device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.bfloat16,
              device="cuda") -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, computed in float32 and
    cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def mlp_init(g: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.bfloat16, device="cuda") -> dict:
    kw = {"dtype": dtype, "device": device}
    if act in ("swiglu", "geglu"):
        return {"gate": dense_init(g, d_model, d_ff, **kw),
                "up": dense_init(g, d_model, d_ff, **kw),
                "down": dense_init(g, d_ff, d_model, **kw)}
    return {"up": dense_init(g, d_model, d_ff, **kw),          # gelu
            "down": dense_init(g, d_ff, d_model, **kw)}


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU MLP.  GELU is the tanh approximation, which
    is `jax.nn.gelu`'s default."""
    if act == "swiglu":
        h = F.silu(dense_apply(p["gate"], x)) * dense_apply(p["up"], x)
    elif act == "geglu":
        h = (F.gelu(dense_apply(p["gate"], x), approximate="tanh")
             * dense_apply(p["up"], x))
    elif act == "gelu":
        h = F.gelu(dense_apply(p["up"], x), approximate="tanh")
    else:
        raise ValueError(act)
    return dense_apply(p["down"], h)


def embed_init(g: torch.Generator, vocab: int, d_model: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    table = torch.randn((vocab, d_model), generator=g, dtype=torch.float32,
                        device=device) * 0.02
    return {"table": table.to(dtype)}


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card
    # would be a host-to-device copy, and a stream sync, per call
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / theta ** exponent


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    the two halves of each head (not interleaved pairs), angles in
    float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
