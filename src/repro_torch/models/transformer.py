"""Model assembly: the decoder stack, the encoder, prefill / decode
caches, the LM and its loss.

The port of `repro.models.transformer` for the block kinds ``"dense"``
(GQA self-attention + dense MLP: Qwen3-4B, Qwen3-8B, Qwen2-72B,
StarCoder2-15B), ``"local"`` (the same with the config's sliding window:
RecurrentGemma's attention layers), ``"rglru"`` (RG-LRU + dense MLP),
``"mlstm"`` and ``"slstm"`` (xLSTM's blocks, `models.ssm`), ``"xattn"``
(gated cross-attention to the memory + gated MLP: Llama-3.2-Vision's
image layers), ``"enc"`` (the encoder's block), ``"dec"`` (self-
and cross-attention + MLP: SeamlessM4T's decoder), and ``"moe"`` /
``"moe_residual"`` (self-attention + the routed MoE of `models.moe`,
with shared experts or a dense residual MLP: DeepSeek-V2, Arctic).  A
config with ``mla`` runs MLA in every self-attention block, its dense
prefix layer included.

Every block returns its auxiliary loss beside x and its cache (the MoE
load-balance loss; 0.0 for the others), and `apply_decoder_stack` sums
it over the layers, under remat too (the checkpointed function returns
x and the loss).  `forward_hidden` returns the sum and `lm_loss` adds
it to the cross-entropy.

The memory is what cross-attention reads: a VLM's projected patch
embeddings as given (the frontend is a stub, as in the reference), or
for an encoder-decoder config (``encoder_layers > 0``) the encoder's
states over the given frame embeddings (`run_encoder`).  The ``enc``
block's self-attention is causal: the reference's passes no mask of its
own and its self-attention always masks causally (ROADMAP.md §3 R8),
and the port computes the same function.

The reference stacks the repeated groups' parameters and runs them with
`lax.scan`; the port keeps one parameter dict per layer in
``params["decoder"]`` (and ``params["encoder"]``: a list in layer
order: prefix, the groups unrolled, suffix) and runs them in a Python
loop.  Decode caches are a list of per-layer caches in the same order:
a KV cache (a dict with "pos") for self-attention blocks, the recurrent
state dict for the others, the memory's {"k", "v"} for ``xattn`` and
{"self": KV cache, "cross": {"k", "v"}} for ``dec``.
`lm_params_from_jax` carries a reference `init_lm` tree across.

Modes:
  train    — full sequence, no cache (`forward_hidden`, `lm_loss`);
             ``remat`` recomputes each block's activations in the
             backward pass (`torch.utils.checkpoint`, the reference's
             `jax.checkpoint` of its scan body)
  prefill  — full sequence, fills decode caches, returns last logits
  decode   — one token through the ring-buffer and recurrent caches
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.packets import params_from_jax

from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .config import ModelConfig
from .layers import (dense_apply, dense_init, embed_apply, embed_init,
                     mlp_apply, mlp_init, norm_apply, norm_init)

BLOCK_KINDS = ("dense", "local", "rglru", "mlstm", "slstm", "enc",
               "xattn", "dec", "moe", "moe_residual")
MOE_KINDS = ("moe", "moe_residual")
# leaves the reference keeps in float32 whatever the model's dtype, by
# the tail of their key path: RG-LRU's ``lam`` and the MoE router's
# weight (any other ``w`` is cast to the model's dtype)
FLOAT32_LEAVES = (("lam",), ("router", "w"))
LOSS_CHUNK = 512    # seq positions per LM-head chunk (bounds logits memory)


def _check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The block kind of every decoder layer, in order: prefix, the
    repeated groups unrolled, suffix."""
    prefix, pattern, suffix = cfg.decoder_layer_kinds()
    return list(prefix) + list(pattern) * cfg.n_scan_groups() + list(suffix)


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def init_block(g: torch.Generator, kind: str, cfg: ModelConfig,
               device="cuda") -> dict:
    """One block's parameters.  An ``xattn`` block's 0-d gates start at
    0, as the reference's: tanh(0) = 0, so a fresh ``xattn`` layer adds
    nothing to the residual stream."""
    _check_kind(kind)
    d = cfg.d_model
    kw = {"dtype": cfg.dtype, "device": device}
    if kind in ("mlstm", "slstm"):
        init = ssm.init_mlstm if kind == "mlstm" else ssm.init_slstm
        return {"ln": norm_init(d, cfg.norm, **kw),
                "core": init(g, cfg, device=device)}
    if kind == "xattn":
        return {
            "ln1": norm_init(d, cfg.norm, **kw),
            "xattn": attn.init_cross_attention(g, cfg, device),
            "gate_attn": torch.zeros((), **kw),
            "ln2": norm_init(d, cfg.norm, **kw),
            "mlp": mlp_init(g, d, cfg.d_ff, cfg.act, **kw),
            "gate_mlp": torch.zeros((), **kw),
        }
    if kind == "dec":
        return {
            "ln1": norm_init(d, cfg.norm, **kw),
            "attn": attn.init_self_attention(g, cfg, device),
            "ln2": norm_init(d, cfg.norm, **kw),
            "xattn": attn.init_cross_attention(g, cfg, device),
            "ln3": norm_init(d, cfg.norm, **kw),
            "mlp": mlp_init(g, d, cfg.d_ff, cfg.act, **kw),
        }
    mixer = ({"rglru": ssm.init_rglru(g, cfg, device)} if kind == "rglru"
             else {"attn": attn.init_self_attention(g, cfg, device)})
    ffn = ({"moe": moe_mod.init_moe(g, cfg, device)} if kind in MOE_KINDS
           else {"mlp": mlp_init(g, d, cfg.d_ff, cfg.act, **kw)})
    return {
        "ln1": norm_init(d, cfg.norm, **kw),
        **mixer,
        "ln2": norm_init(d, cfg.norm, **kw),
        **ffn,
    }


def _memory_kv(cfg: ModelConfig, batch: int, mem_len: int, device) -> dict:
    shape = (batch, mem_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def make_block_cache(kind: str, cfg: ModelConfig, batch: int,
                     cache_len: int, window: Optional[int], mem_len: int = 0,
                     device="cuda"):
    """Empty decode cache for one block.  A ``dense`` block's KV cache is
    sized by `window` (prefill's argument), not by the config's window,
    as the reference's (ROADMAP.md §3 R7); a ``local`` block's is a ring
    of ``window or cfg.window`` slots; cross-attention's holds the
    memory's K and V, `mem_len` positions."""
    _check_kind(kind)
    if kind == "rglru":
        return ssm.make_rglru_state(cfg, batch, device)
    if kind == "mlstm":
        return ssm.make_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return ssm.make_slstm_state(cfg, batch, device)
    if kind == "xattn":
        return _memory_kv(cfg, batch, mem_len, device)
    if kind == "dec":
        return {"self": attn.make_kv_cache(cfg, batch, cache_len, window,
                                           device),
                "cross": _memory_kv(cfg, batch, mem_len, device)}
    if kind == "local":
        window = window or cfg.window
    return attn.make_kv_cache(cfg, batch, cache_len, window, device)


def _cross_kv(p: dict, cache: Optional[dict], memory, cfg: ModelConfig):
    """(K/V the block attends, its new cross cache).  Without memory the
    cache's K/V are read (decode); with it they are projected from the
    memory and, given a cache, written into it in place (prefill)."""
    if cache is not None and memory is None:
        return cache, cache
    mem_kv = attn.precompute_cross_kv(p, memory, cfg)
    if cache is None:
        return mem_kv, None
    cache["k"].copy_(mem_kv["k"])
    cache["v"].copy_(mem_kv["v"])
    return cache, cache


def apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache=None, memory: Optional[torch.Tensor] = None,
                window: Optional[int] = None):
    """Returns (x, new_cache, aux): aux is the MoE blocks' load-balance
    loss (a float32 scalar) and 0.0 for the other kinds.  `memory` (B,
    M, d) feeds ``xattn`` and ``dec``; in decode it is None and their
    caches hold its K/V."""
    _check_kind(kind)
    if kind in ("mlstm", "slstm"):
        apply = ssm.apply_mlstm if kind == "mlstm" else ssm.apply_slstm
        h, new_c = apply(p["core"], norm_apply(p["ln"], x, cfg.norm), cfg,
                         state=cache)
        return x + h, new_c, 0.0
    if kind == "xattn":
        mem_kv, new_c = _cross_kv(p["xattn"], cache, memory, cfg)
        h = attn.apply_cross_attention(
            p["xattn"], norm_apply(p["ln1"], x, cfg.norm), cfg, mem_kv=mem_kv)
        x = x + torch.tanh(p["gate_attn"]) * h
        y = mlp_apply(p["mlp"], norm_apply(p["ln2"], x, cfg.norm), cfg.act)
        return x + torch.tanh(p["gate_mlp"]) * y, new_c, 0.0
    if kind == "dec":
        h, new_self = attn.apply_self_attention(
            p["attn"], norm_apply(p["ln1"], x, cfg.norm), cfg, window=window,
            cache=cache["self"] if cache is not None else None)
        x = x + h
        mem_kv, new_cross = _cross_kv(
            p["xattn"], cache["cross"] if cache is not None else None,
            memory, cfg)
        x = x + attn.apply_cross_attention(
            p["xattn"], norm_apply(p["ln2"], x, cfg.norm), cfg, mem_kv=mem_kv)
        y = mlp_apply(p["mlp"], norm_apply(p["ln3"], x, cfg.norm), cfg.act)
        new_c = (None if cache is None
                 else {"self": new_self, "cross": new_cross})
        return x + y, new_c, 0.0
    if kind == "rglru":
        h, new_c = ssm.apply_rglru(
            p["rglru"], norm_apply(p["ln1"], x, cfg.norm), cfg, state=cache)
    elif kind == "enc":     # the reference's: causal (ROADMAP.md §3 R8)
        h, new_c = attn.apply_self_attention(
            p["attn"], norm_apply(p["ln1"], x, cfg.norm), cfg, window=None)
    else:
        win = window or cfg.window   # explicit override > config window
        h, new_c = attn.apply_self_attention(
            p["attn"], norm_apply(p["ln1"], x, cfg.norm), cfg, window=win,
            cache=cache)
    x = x + h
    h2 = norm_apply(p["ln2"], x, cfg.norm)
    if kind in MOE_KINDS:
        y, aux = moe_mod.apply_moe(p["moe"], h2, cfg)
        return x + y, new_c, aux
    return x + mlp_apply(p["mlp"], h2, cfg.act), new_c, 0.0


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def init_decoder_stack(g: torch.Generator, cfg: ModelConfig,
                       device="cuda") -> list[dict]:
    return [init_block(g, kind, cfg, device) for kind in layer_kinds(cfg)]


def make_decoder_cache(cfg: ModelConfig, batch: int, cache_len: int,
                       window: Optional[int], mem_len: int = 0,
                       device="cuda") -> list:
    return [make_block_cache(kind, cfg, batch, cache_len, window, mem_len,
                             device)
            for kind in layer_kinds(cfg)]


def apply_decoder_stack(layers: list[dict], x: torch.Tensor,
                        cfg: ModelConfig, *, cache: Optional[list] = None,
                        memory: Optional[torch.Tensor] = None,
                        window: Optional[int] = None, remat: bool = False):
    """Returns (x, new_cache, aux_total); new_cache is None without a
    cache, aux_total the blocks' aux losses summed (0.0 when no block
    has one).  ``remat`` (train only) checkpoints each block: the same
    values, x and aux, with its activations recomputed in the backward
    pass."""
    new_cache = [] if cache is not None else None
    aux_total = 0.0
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), layers,
                                      strict=True)):
        if remat and cache is None:
            x, aux = checkpoint(
                lambda x, memory, kind=kind, p=p: apply_block(
                    kind, p, x, cfg, memory=memory, window=window)[::2],
                x, memory, use_reentrant=False)
        else:
            c = cache[i] if cache is not None else None
            x, nc, aux = apply_block(kind, p, x, cfg, cache=c, memory=memory,
                                     window=window)
            if cache is not None:
                new_cache.append(nc)
        aux_total = aux_total + aux
    return x, new_cache, aux_total


# ---------------------------------------------------------------------------
# full language model
# ---------------------------------------------------------------------------

def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder's stack: `encoder_layers` ``enc`` blocks."""
    return cfg.with_overrides(num_layers=cfg.encoder_layers,
                              scan_pattern=("enc",), prefix_kinds=(),
                              moe=None, mla=None)


def _check_lm(cfg: ModelConfig) -> None:
    for kind in layer_kinds(cfg):
        _check_kind(kind)


def init_lm(g: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Random LM parameters with the reference's scales (dense
    1/sqrt(d_in), embedding 0.02, norm scales one; RG-LRU's ``lam``
    float32, uniform on [3, 8); the MoE router float32 at 0.02;
    cross-attention gates 0), drawn from `g`,
    which must live on `device`.  An encoder-decoder config also gets
    ``encoder`` (its layers) and ``enc_norm``."""
    _check_lm(cfg)
    kw = {"dtype": cfg.dtype, "device": device}
    p = {
        "embed": embed_init(g, cfg.padded_vocab, cfg.d_model, **kw),
        "decoder": init_decoder_stack(g, cfg, device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(g, cfg.d_model, cfg.padded_vocab, **kw)
    if cfg.encoder_layers > 0:
        p["encoder"] = init_decoder_stack(g, encoder_config(cfg), device)
        p["enc_norm"] = norm_init(cfg.d_model, cfg.norm, **kw)
    return p


def lm_params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's `init_lm` tree, given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``, bf16 leaves as they
    come or as ``view(np.uint16)``), as the port's parameters.

    The leading group axis of ``decoder.scan`` (and ``encoder.scan``) is
    unstacked into one dict per layer, so a stacked 0-d gate of shape
    (G,) becomes one 0-d tensor a layer; float leaves are cast to
    ``cfg.dtype`` (bf16 bits stay exact: a uint16 view is reinterpreted,
    not converted), except those the reference keeps in float32 whatever
    the model's dtype (FLOAT32_LEAVES: RG-LRU's ``lam``, the MoE
    router's ``router.w``), which stay float32.  A stacked (G, E, d, ff)
    expert leaf unstacks to one (E, d, ff) tensor a layer."""
    _check_lm(cfg)
    out = {"embed": tree["embed"],
           "decoder": _unstack(tree["decoder"], cfg),
           "final_norm": tree["final_norm"]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    if cfg.encoder_layers > 0:
        out["encoder"] = _unstack(tree["encoder"], encoder_config(cfg))
        out["enc_norm"] = tree["enc_norm"]
    return _cast_floats(params_from_jax(out, device, bf16_bits=True),
                        cfg.dtype)


def _unstack(stack: dict, cfg: ModelConfig) -> list:
    """A reference stack tree {"prefix", "scan", "suffix"} as the list of
    its layers' trees, the scanned groups' leading axis indexed."""
    def index(x, gi):
        if isinstance(x, dict):
            return {k: index(v, gi) for k, v in x.items()}
        return x[gi]

    prefix, pattern, suffix = cfg.decoder_layer_kinds()
    if (len(stack["prefix"]) != len(prefix)
            or len(stack["suffix"]) != len(suffix)):
        raise ValueError("the tree's prefix/suffix do not match the config")
    layers = list(stack["prefix"])
    for gi in range(cfg.n_scan_groups()):
        layers += [index(stack["scan"][f"b{j}"], gi)
                   for j in range(len(pattern))]
    return layers + list(stack["suffix"])


def _cast_floats(tree, dtype, path: tuple = ()):
    """`tree` with its float leaves cast to `dtype`, and those whose key
    path ends in one of FLOAT32_LEAVES to float32."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype, path) for v in tree)
    if not tree.is_floating_point():
        return tree
    keep = any(path[-len(tail):] == tail for tail in FLOAT32_LEAVES)
    return tree.to(torch.float32 if keep else dtype)


def _lm_logits(params: dict, h: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].T
    return dense_apply(params["lm_head"], h)


def run_encoder(params: dict, memory_emb: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """The encoder over (stub-)frontend embeddings (B, M, d), then
    ``enc_norm``.  Causal, as the reference's (ROADMAP.md §3 R8)."""
    x, _, _ = apply_decoder_stack(params["encoder"], memory_emb,
                                  encoder_config(cfg))
    return norm_apply(params["enc_norm"], x, cfg.norm)


def _memory_states(params: dict, batch: dict, cfg: ModelConfig):
    """What cross-attention reads, from ``batch["memory"]``: the
    encoder's states for an encoder-decoder config, a VLM's projected
    embeddings as they are; None without memory."""
    mem = batch.get("memory")
    if mem is None:
        return None
    if cfg.encoder_layers > 0:
        return run_encoder(params, mem, cfg)
    return mem


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                   memory=None, window=None, remat: bool = False):
    """tokens (B, S) -> (final-normed hidden states (B, S, d), aux loss:
    a float32 scalar, the MoE layers' load-balance losses summed, 0
    without MoE).  `memory` is what cross-attention reads
    (`_memory_states`: encoder states, not frame embeddings)."""
    x = embed_apply(params["embed"], tokens)
    x, _, aux = apply_decoder_stack(params["decoder"], x, cfg, memory=memory,
                                    window=window, remat=remat)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return norm_apply(params["final_norm"], x, cfg.norm), aux


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, *,
            window: Optional[int] = None, remat: bool = True):
    """Causal LM loss -> (loss + aux, {"xent", "aux"}).  batch holds
    "tokens" and "labels" (B, S), and for a config with a frontend
    "memory" (B, M, d); labels < 0 are ignored.  The LM head runs on
    LOSS_CHUNK positions at a time, so (B, S, V) logits never exist at
    once, and the vocabulary's padding columns are masked."""
    memory = _memory_states(params, batch, cfg)
    h, aux = forward_hidden(params, batch["tokens"], cfg, memory=memory,
                            window=window, remat=remat)
    labels = batch["labels"]
    chunk = min(LOSS_CHUNK, h.shape[1])
    vmask = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
    sums, counts = [], []
    for c0 in range(0, h.shape[1], chunk):
        logits = _lm_logits(params, h[:, c0:c0 + chunk], cfg).float()
        logits = torch.where(vmask, logits, attn.MASK_VALUE)
        logp = torch.log_softmax(logits, dim=-1)
        lc = labels[:, c0:c0 + chunk]
        valid = lc >= 0
        nll = -torch.gather(logp, -1, lc.clamp(min=0)[..., None].long()
                            )[..., 0]
        sums.append(torch.sum(nll * valid))
        counts.append(torch.sum(valid))
    loss = torch.stack(sums).sum() / torch.stack(counts).sum().clamp(min=1)
    return loss + aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache_len: int, window: Optional[int] = None, memory=None):
    """Run the prompt, fill caches, return (last_logits (B,1,V), cache).
    `memory` is the frontend's embeddings: an encoder-decoder config runs
    its encoder over them, a VLM uses them as they are; cross-attention
    caches their K/V for the decode steps."""
    B = tokens.shape[0]
    device = params["embed"]["table"].device
    mem_states = None
    if memory is not None:
        mem_states = (run_encoder(params, memory, cfg)
                      if cfg.encoder_layers > 0 else memory)
    mem_len = 0 if mem_states is None else mem_states.shape[1]
    cache = make_decoder_cache(cfg, B, cache_len, window, mem_len, device)
    x = embed_apply(params["embed"], tokens)
    x, cache, _ = apply_decoder_stack(params["decoder"], x, cfg, cache=cache,
                                      memory=mem_states, window=window)
    h = norm_apply(params["final_norm"], x[:, -1:], cfg.norm)
    return _lm_logits(params, h, cfg), cache


def decode_step(params: dict, token: torch.Tensor, cache: list,
                cfg: ModelConfig, *, window: Optional[int] = None):
    """One-token decode: token (B, 1) int -> (logits (B,1,V), cache).
    The cache's tensors are updated in place."""
    x = embed_apply(params["embed"], token)
    x, cache, _ = apply_decoder_stack(params["decoder"], x, cfg, cache=cache,
                                      window=window)
    h = norm_apply(params["final_norm"], x, cfg.norm)
    return _lm_logits(params, h, cfg), cache
