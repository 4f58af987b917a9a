"""Self-attention (GQA, RoPE, QK-norm, bias, sliding window) with the
train / prefill / decode KV-cache paths, and cross-attention.

The port of the GQA and cross-attention parts of
`repro.models.attention`.  Train and
prefill (causal, query i against keys j <= i, and with a window also
j > i - window) take one of three routes, chosen per call
(`_causal_attention`):

- **the flash kernel** (`kernels.ops.flash_attention`) when the head
  dim is one of its instances (`HEAD_DIMS`) and there is no window or
  S <= window.  With S <= window the window's mask j > i - window is
  vacuous (i - window < 0 <= j), so this is the same function as the
  reference's windowed `_attend`.  The kernel indexes the KV head of
  each query head instead of expanding K and V; its backward is the
  exact gradient of `_attend` (`kernels.flash_attention.
  attention_backward`), so training through it gives q, k and v the
  reference's gradients;
- **`_attend_chunked`** above CHUNK_THRESHOLD tokens otherwise, as the
  reference: Q_CHUNK queries at a time against all S keys, so the
  (S, S) scores never exist at once;
- **`_attend`**, the plain masked softmax in float32, otherwise (a
  window shorter than S, or a head dim the kernel has no instance for,
  such as RecurrentGemma's 256).

Decode is `_attend` of one query against the ring-buffer cache, as the
reference computes it outside any kernel.  MLA is not ported yet.

Cross-attention (VLM image layers, the enc-dec decoder) projects the
memory (frontend embeddings or encoder states) to K and V once
(`precompute_cross_kv`), and every query attends every memory position:
`_attend` with ``causal=False``, no window and no RoPE, in float32 as
the reference computes it (never the causal flash kernel).

The KV cache is a dict {"k", "v": (B, slots, KV, hd), "pos": int}.
Unlike the reference's functional update, prefill and decode write
into the cache's tensors in place (a full-width cache is gigabytes);
the returned dict shares them, so a cache is used once and then
replaced by the one returned.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS

from .config import ModelConfig
from .layers import apply_rope, dense_apply, dense_init, norm_apply, norm_init

MASK_VALUE = -1e30
CHUNK_THRESHOLD = 8192   # direct attention below, q-chunked above
Q_CHUNK = 512


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet; "
                               f"see ROADMAP.md §1 M4 (MoE and MLA)")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_self_attention(g: torch.Generator, cfg: ModelConfig,
                        device="cuda") -> dict:
    if cfg.mla is not None:
        raise _not_ported("MLA attention")
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    kw = {"dtype": cfg.dtype, "device": device}
    p = {
        "wq": dense_init(g, d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(g, d, KV * hd, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(g, d, KV * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(g, H * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["qnorm"] = norm_init(hd, "rmsnorm", **kw)
        p["knorm"] = norm_init(hd, "rmsnorm", **kw)
    return p


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, KV*groups, hd) by repetition (GQA)."""
    if groups == 1:
        return k
    B, T, KV, hd = k.shape
    return k[:, :, :, None].expand(B, T, KV, groups, hd).reshape(
        B, T, KV * groups, hd)


def _attend(q, k, v, *, causal: bool, window: Optional[int], q_offset,
            kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,T,H,hd).  Masked softmax attention in
    float32, cast back to q's dtype.

    q_offset: absolute position of q[0] minus position of k[0] (so
    query i attends keys j with j <= i + q_offset, and, with a window,
    j > i + q_offset - window).
    kv_len: optional valid length of k/v (ring-buffer decode).
    """
    Sq, hd = q.shape[1], q.shape[3]
    T = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((Sq, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
        if window is not None:
            mask &= kj > qi - window
    if kv_len is not None:
        mask &= kj < kv_len
    scores = torch.where(mask[None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _attend_chunked(q, k, v, *, causal: bool, window: Optional[int],
                    chunk: int = 0) -> torch.Tensor:
    """`_attend` with q_offset = 0, one chunk of queries at a time
    against all keys, so the (S, S) scores never exist at once.  Each
    query row is computed as in `_attend`; the reference pads the last
    chunk with zero queries and slices them off, the port runs it
    short.  K and V are made float32 once, not once a chunk."""
    chunk = chunk or Q_CHUNK
    kf, vf = k.float(), v.float()
    return torch.cat([_attend(q[:, c0:c0 + chunk], kf, vf, causal=causal,
                              window=window, q_offset=c0)
                      for c0 in range(0, q.shape[1], chunk)], dim=1)


def _causal_attention(q, k, v, *, window: Optional[int]) -> torch.Tensor:
    """Train / prefill attention of (B, S, H, hd) queries against
    (B, S, KV, hd) keys and values: the flash kernel, `_attend_chunked`
    or `_attend`, as the module's docstring says."""
    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    if hd in HEAD_DIMS and (window is None or S <= window):
        return ops.flash_attention(q, k, v, causal=True)
    groups = H // k.shape[2]
    kf, vf = _expand_kv(k, groups), _expand_kv(v, groups)
    if S > CHUNK_THRESHOLD:
        return _attend_chunked(q, kf, vf, causal=True, window=window)
    return _attend(q, kf, vf, causal=True, window=window, q_offset=0)


# ---------------------------------------------------------------------------
# self-attention: train / prefill / decode
# ---------------------------------------------------------------------------

def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int], device="cuda") -> dict:
    """An empty cache.  Windowed caches are ring buffers of `window`
    slots; full caches hold max_len slots."""
    if cfg.mla is not None:
        raise _not_ported("the MLA cache")
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    slots = min(window, max_len) if window else max_len
    shape = (batch, slots, KV, hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def apply_self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                         window: Optional[int],
                         cache: Optional[dict] = None,
                         positions: Optional[torch.Tensor] = None):
    """Returns (y, new_cache).  cache=None -> train (no cache out).
    x: (B, S, d).  S>1 with cache -> prefill (fills cache);
    S==1 with cache -> single-token decode."""
    if cfg.mla is not None:
        raise _not_ported("MLA attention")
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    groups = H // KV
    if positions is None:
        base = cache["pos"] if cache is not None else 0
        positions = base + torch.arange(S, device=x.device)[None, :]

    q = dense_apply(p["wq"], x).reshape(B, S, H, hd)
    k = dense_apply(p["wk"], x).reshape(B, S, KV, hd)
    v = dense_apply(p["wv"], x).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = norm_apply(p["qnorm"], q)
        k = norm_apply(p["knorm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None or S > 1:
        out = _causal_attention(q, k, v, window=window)
        new_cache = None
        if cache is not None:       # prefill: persist the (ring) tail
            new_cache = _fill_cache(cache, k, v, S)
    else:
        new_cache = _append_cache(cache, k, v)
        kv_len = min(new_cache["pos"], new_cache["k"].shape[1])
        kf = _expand_kv(new_cache["k"], groups)
        vf = _expand_kv(new_cache["v"], groups)
        # ring buffer: softmax is permutation-invariant given the
        # validity mask; window recency is enforced by the buffer size
        out = _attend(q, kf, vf, causal=False, window=None, q_offset=0,
                      kv_len=kv_len)
    y = dense_apply(p["wo"], out.reshape(B, S, H * hd))
    return y, new_cache


def _fill_cache(cache: dict, k, v, S: int) -> dict:
    """Prefill: write the last `slots` keys/values into the ring buffer
    (in place), aligned so absolute position p occupies slot p % slots
    (decode then continues the ring seamlessly).  pos records the
    absolute count."""
    slots = cache["k"].shape[1]
    take = min(S, slots)
    kt = k[:, S - take:]
    vt = v[:, S - take:]
    if take == slots and S % slots:
        kt = torch.roll(kt, S % slots, dims=1)
        vt = torch.roll(vt, S % slots, dims=1)
    cache["k"][:, :take].copy_(kt)
    cache["v"][:, :take].copy_(vt)
    return {"k": cache["k"], "v": cache["v"], "pos": S}


def _append_cache(cache: dict, k, v) -> dict:
    """Decode: write one token at pos % slots (ring), in place."""
    idx = cache["pos"] % cache["k"].shape[1]
    cache["k"][:, idx:idx + 1].copy_(k)
    cache["v"][:, idx:idx + 1].copy_(v)
    return {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + 1}


# ---------------------------------------------------------------------------
# cross-attention (VLM image layers, enc-dec decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(g: torch.Generator, cfg: ModelConfig,
                         device="cuda") -> dict:
    """K and V from frontend / encoder memory; the self-attention head
    layout, no bias."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    kw = {"dtype": cfg.dtype, "device": device}
    return {
        "wq": dense_init(g, d, H * hd, **kw),
        "wk": dense_init(g, d, KV * hd, **kw),
        "wv": dense_init(g, d, KV * hd, **kw),
        "wo": dense_init(g, H * hd, d, **kw),
    }


def precompute_cross_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig
                        ) -> dict:
    """Project memory (B, M, d) to {"k", "v": (B, M, KV, hd)} once (the
    decode steps reuse them)."""
    B, M, _ = memory.shape
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": dense_apply(p["wk"], memory).reshape(B, M, KV, hd),
            "v": dense_apply(p["wv"], memory).reshape(B, M, KV, hd)}


def apply_cross_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                          memory: Optional[torch.Tensor] = None,
                          mem_kv: Optional[dict] = None) -> torch.Tensor:
    """x (B, S, d) attends every position of the memory: `mem_kv`
    (`precompute_cross_kv`), or `memory` projected here."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    groups = H // KV
    if mem_kv is None:
        mem_kv = precompute_cross_kv(p, memory, cfg)
    q = dense_apply(p["wq"], x).reshape(B, S, H, hd)
    kf = _expand_kv(mem_kv["k"], groups)
    vf = _expand_kv(mem_kv["v"], groups)
    out = _attend(q, kf, vf, causal=False, window=None, q_offset=0)
    return dense_apply(p["wo"], out.reshape(B, S, H * hd))
