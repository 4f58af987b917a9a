"""Step builders: prefill_step and serve_step (single-token greedy
decode).

The port of the serving half of `repro.launch.steps`.  The training
steps (FedNC gradient aggregation across the client axis) are not
ported yet; see ROADMAP.md §1 item 13.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

MASK_VALUE = -1e30


def make_prefill_step(cfg: ModelConfig, *, cache_len: int,
                      window: Optional[int] = None) -> Callable:
    """(params, batch) -> (last logits (B, 1, V), cache); batch holds
    "tokens" (B, S)."""
    def prefill_step(params, batch):
        return tf.prefill(params, batch["tokens"], cfg, cache_len=cache_len,
                          window=window)
    return prefill_step


def make_serve_step(cfg: ModelConfig, *,
                    window: Optional[int] = None) -> Callable:
    """Single-token greedy decode step: (params, cache, token (B, 1)) ->
    (next_token (B, 1) int32, its log-prob (B, 1) float32, cache).  The
    vocabulary's padding columns are masked before the argmax."""
    def serve_step(params, cache, token):
        logits, cache = tf.decode_step(params, token, cache, cfg,
                                       window=window)
        logits = logits.float()
        vmask = torch.arange(cfg.padded_vocab,
                             device=logits.device) < cfg.vocab_size
        logits = torch.where(vmask[None, None], logits, MASK_VALUE)
        nxt = torch.argmax(logits, dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        lp = torch.gather(logp, -1, nxt[..., None])[..., 0]
        return nxt.to(torch.int32), lp, cache
    return serve_step
