"""Self-attention (GQA, RoPE, QK-norm, bias, sliding window; MLA) with
the train / prefill / decode KV-cache paths, and cross-attention.

The port of `repro.models.attention`.  GQA train and prefill (causal,
query i against keys j <= i, and with a window also j > i - window)
take one of three routes, chosen per call (`_causal_attention`):

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
reference computes it outside any kernel.

MLA (DeepSeek-V2's multi-head latent attention, `_apply_mla`) caches
the normed latent ``ckv`` (B, slots, r) and the shared RoPE key
``krope`` (B, slots, rd).  Its default path expands them at every call
into per-head keys [w_uk·ckv | krope] (nd + rd wide) and values
w_uv·ckv (vd wide) and calls `_attend` / `_attend_chunked` directly,
never the flash kernel: the query and value head dims differ (192 and
128 at full width), which the kernel does not take.  The absorbed path
(``absorbed=True``) scores in the latent space (`_latent_attend`).
Both are float32 plain PyTorch, as the reference computes them in jnp
outside any Pallas kernel.

Cross-attention (VLM image layers, the enc-dec decoder) projects the
memory (frontend embeddings or encoder states) to K and V once
(`precompute_cross_kv`), and every query attends every memory position:
`_attend` with ``causal=False``, no window and no RoPE, in float32 as
the reference computes it (never the causal flash kernel).

The KV cache is a dict {"k", "v": (B, slots, KV, hd), "pos": int}, or
for MLA {"ckv", "krope", "pos"}.  Unlike the reference's functional
update, prefill and decode write into the cache's tensors in place (a
full-width cache is gigabytes); the returned dict shares them, so a
cache is used once and then replaced by the one returned.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS

from .config import MLAConfig, ModelConfig
from .layers import apply_rope, dense_apply, dense_init, norm_apply, norm_init

MASK_VALUE = -1e30
CHUNK_THRESHOLD = 8192   # direct attention below, q-chunked above
Q_CHUNK = 512


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_self_attention(g: torch.Generator, cfg: ModelConfig,
                        device="cuda") -> dict:
    if cfg.mla is not None:
        return _init_mla(g, cfg, device)
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


def _init_mla(g: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qd = m.nope_head_dim + m.rope_head_dim
    kw = {"dtype": cfg.dtype, "device": device}
    return {
        "w_dq": dense_init(g, d, m.q_lora_rank, **kw),
        "q_norm": norm_init(m.q_lora_rank, "rmsnorm", **kw),
        "w_uq": dense_init(g, m.q_lora_rank, H * qd, **kw),
        "w_dkv": dense_init(g, d, m.kv_lora_rank, **kw),
        "kv_norm": norm_init(m.kv_lora_rank, "rmsnorm", **kw),
        "w_uk": dense_init(g, m.kv_lora_rank, H * m.nope_head_dim, **kw),
        "w_uv": dense_init(g, m.kv_lora_rank, H * m.v_head_dim, **kw),
        "w_kr": dense_init(g, d, m.rope_head_dim, **kw),
        "wo": dense_init(g, H * m.v_head_dim, d, **kw),
    }


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
    scale = 1.0 / np.sqrt(q.shape[3])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _score_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len, device=q.device)
    scores = torch.where(mask[None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _score_mask(Sq: int, T: int, *, causal: bool, window: Optional[int],
                q_offset, kv_len: Optional[int], device) -> torch.Tensor:
    """(Sq, T) bool: which keys each query attends (`_attend`'s rule)."""
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    kj = torch.arange(T, device=device)[None, :]
    mask = torch.ones((Sq, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
        if window is not None:
            mask &= kj > qi - window
    if kv_len is not None:
        mask &= kj < kv_len
    return mask


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
    slots = min(window, max_len) if window else max_len
    if cfg.mla is not None:
        m = cfg.mla
        kw = {"dtype": cfg.dtype, "device": device}
        return {"ckv": torch.zeros((batch, slots, m.kv_lora_rank), **kw),
                "krope": torch.zeros((batch, slots, m.rope_head_dim), **kw),
                "pos": 0}
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
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
        return _apply_mla(p, x, cfg, window=window, cache=cache,
                          positions=positions)
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
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _latent_attend(q_lat, q_rope, ckv, krope, *, scale: float,
                   causal: bool, window: Optional[int], q_offset,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Absorbed-MLA attention: scores in the latent space, K/V never
    expanded per head.  q_lat: (B,Sq,H,r), q_rope: (B,Sq,H,rd),
    ckv: (B,T,r), krope: (B,T,rd).  Returns out_lat (B,Sq,H,r) in
    q_lat's dtype, computed in float32 with `_attend`'s mask."""
    ckv = ckv.float()
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), ckv)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                             krope.float())) * scale
    mask = _score_mask(q_lat.shape[1], ckv.shape[1], causal=causal,
                       window=window, q_offset=q_offset, kv_len=kv_len,
                       device=q_lat.device)
    scores = torch.where(mask[None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkr->bqhr", probs, ckv)
    return out.to(q_lat.dtype)


def _latent_attend_chunked(q_lat, q_rope, ckv, krope, *, scale: float,
                           causal: bool, window: Optional[int],
                           chunk: int = 0) -> torch.Tensor:
    """`_latent_attend` with q_offset = 0, one chunk of queries at a
    time (as `_attend_chunked`)."""
    chunk = chunk or Q_CHUNK
    ckv, krope = ckv.float(), krope.float()
    return torch.cat([
        _latent_attend(q_lat[:, c0:c0 + chunk], q_rope[:, c0:c0 + chunk],
                       ckv, krope, scale=scale, causal=causal, window=window,
                       q_offset=c0)
        for c0 in range(0, q_lat.shape[1], chunk)], dim=1)


def _apply_mla(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int], cache: Optional[dict],
               positions: Optional[torch.Tensor]):
    """MLA's train / prefill / decode, as `apply_self_attention`.
    Queries: w_dq, q_norm, w_uq, split nope | rope, RoPE on the rope
    part.  Keys: the normed latent ckv = kv_norm(w_dkv·x) and one shared
    RoPE'd key krope = w_kr·x.  Decode writes them at pos % slots and
    attends the whole (ring) cache, non-causally, up to kv_len; prefill
    attends causally (with the window) and writes the ring's tail."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    nd, rd, vd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    if positions is None:
        base = cache["pos"] if cache is not None else 0
        positions = base + torch.arange(S, device=x.device)[None, :]

    cq = norm_apply(p["q_norm"], dense_apply(p["w_dq"], x))
    q = dense_apply(p["w_uq"], cq).reshape(B, S, H, nd + rd)
    q_nope = q[..., :nd]
    q_rope = apply_rope(q[..., nd:], positions, cfg.rope_theta)
    ckv = norm_apply(p["kv_norm"], dense_apply(p["w_dkv"], x))  # (B,S,r)
    krope = apply_rope(dense_apply(p["w_kr"], x).reshape(B, S, 1, rd),
                       positions, cfg.rope_theta)[:, :, 0]      # (B,S,rd)

    decode = cache is not None and S == 1
    kv_len = None
    if decode:
        slots = cache["ckv"].shape[1]
        idx = cache["pos"] % slots
        cache["ckv"][:, idx:idx + 1].copy_(ckv)
        cache["krope"][:, idx:idx + 1].copy_(krope)
        cache = {"ckv": cache["ckv"], "krope": cache["krope"],
                 "pos": cache["pos"] + 1}
        ckv_all, krope_all = cache["ckv"], cache["krope"]
        kv_len = min(cache["pos"], slots)
    else:
        ckv_all, krope_all = ckv, krope
    causal = not decode
    win = window if causal else None
    chunked = causal and S > CHUNK_THRESHOLD
    T = ckv_all.shape[1]
    scale = 1.0 / np.sqrt(nd + rd)
    if m.absorbed:
        r = m.kv_lora_rank
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                             p["w_uk"]["w"].reshape(r, H, nd))
        if chunked:
            out_lat = _latent_attend_chunked(q_lat, q_rope, ckv_all,
                                             krope_all, scale=scale,
                                             causal=True, window=window)
        else:
            out_lat = _latent_attend(q_lat, q_rope, ckv_all, krope_all,
                                     scale=scale, causal=causal, window=win,
                                     q_offset=0, kv_len=kv_len)
        out = torch.einsum("bqhr,rhv->bqhv", out_lat,
                           p["w_uv"]["w"].reshape(r, H, vd))
    else:
        # per-head keys [w_uk·ckv | krope] and values w_uv·ckv from the
        # whole latent cache; q and v head dims differ, so `_attend`
        # (scale 1/sqrt(nd + rd)) and never the flash kernel
        k_nope = dense_apply(p["w_uk"], ckv_all).reshape(B, T, H, nd)
        vv = dense_apply(p["w_uv"], ckv_all).reshape(B, T, H, vd)
        k_full = torch.cat([k_nope, krope_all[:, :, None, :].expand(
            B, T, H, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        if chunked:
            out = _attend_chunked(q_full, k_full, vv, causal=True,
                                  window=window)
        else:
            out = _attend(q_full, k_full, vv, causal=causal, window=win,
                          q_offset=0, kv_len=kv_len)
    y = dense_apply(p["wo"], out.reshape(B, S, H * vd))

    if cache is not None and not decode:    # prefill: the (ring) tail
        slots = cache["ckv"].shape[1]
        take = min(S, slots)
        ct, rt = ckv[:, S - take:], krope[:, S - take:]
        if take == slots and S % slots:
            ct = torch.roll(ct, S % slots, dims=1)
            rt = torch.roll(rt, S % slots, dims=1)
        cache["ckv"][:, :take].copy_(ct)
        cache["krope"][:, :take].copy_(rt)
        cache = {"ckv": cache["ckv"], "krope": cache["krope"], "pos": S}
    return y, cache


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
