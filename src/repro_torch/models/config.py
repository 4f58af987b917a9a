"""Unified model configuration covering all assigned architectures.

The port of `repro.models.config`, field for field, so a config file
copies over verbatim; `dtype` is a torch dtype.

A model is described by a stack of typed blocks:
  prefix_kinds  — unrolled leading layers (e.g. deepseek's dense layer 0)
  scan_pattern  — the repeating group (the reference scans it; the
                  port runs its layers one by one)
  suffix        — num_layers - prefix - scanned remainder, unrolled,
                  taken as pattern[:r] (e.g. recurrentgemma's trailing
                  2 recurrent blocks).

Block kinds:
  dense        self-attn (GQA/RoPE/...) + dense MLP
  local        sliding-window self-attn + dense MLP
  moe          self-attn + routed MoE (+ optional shared experts)
  moe_residual self-attn + routed MoE with parallel dense residual MLP
  xattn        cross-attn (to frontend memory) + dense MLP
  rglru        RG-LRU recurrent block + dense MLP
  mlstm        mLSTM block (internal up-proj, no separate MLP)
  slstm        sLSTM block (internal up/down proj)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention.

    absorbed=True scores in latent space (q absorbed through W_uk,
    output combined through W_uv) — K/V are never expanded to
    (B, T, H, head_dim).  More score FLOPs (latent rank vs head_dim),
    far less memory traffic: the §Perf memory-bound variant."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128
    absorbed: bool = False


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0            # per-expert hidden dim
    num_shared_experts: int = 0     # deepseek: always-on shared experts
    dense_residual: bool = False    # arctic: parallel dense MLP
    d_ff_residual: int = 0          # hidden of the residual/shared MLP
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    scan_pattern: tuple = ("dense",)
    prefix_kinds: tuple = ()

    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None        # sliding window (None = full)
    long_context_window: int = 4096     # window for the long_500k variant
    mla: Optional[MLAConfig] = None

    # mlp / norm
    act: str = "swiglu"                 # swiglu|gelu|geglu
    norm: str = "rmsnorm"               # rmsnorm|layernorm

    moe: Optional[MoEConfig] = None

    # enc-dec & stub frontends (DESIGN.md carve-out)
    encoder_layers: int = 0
    frontend: Optional[str] = None      # 'vision' | 'audio'
    num_frontend_tokens: int = 0

    # recurrent widths
    lru_width: int = 0                  # 0 -> d_model
    conv_width: int = 4

    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    vocab_pad_multiple: int = 256

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    def decoder_layer_kinds(self) -> tuple[tuple, tuple, tuple]:
        """(prefix, scanned_groups × pattern, suffix) kind layout."""
        p = len(self.prefix_kinds)
        g = len(self.scan_pattern)
        body = self.num_layers - p
        n_groups = body // g
        r = body - n_groups * g
        return (tuple(self.prefix_kinds),
                tuple(self.scan_pattern) * 0 + tuple(self.scan_pattern),
                tuple(self.scan_pattern[:r]))

    def n_scan_groups(self) -> int:
        p = len(self.prefix_kinds)
        g = len(self.scan_pattern)
        return (self.num_layers - p) // g

    def with_overrides(self, **kw) -> "ModelConfig":
        from dataclasses import replace
        return replace(self, **kw)

    def validate(self) -> None:
        assert self.num_layers >= len(self.prefix_kinds)
        assert self.n_scan_groups() >= 0
        if self.moe is not None:
            assert any(k.startswith("moe") for k in
                       self.scan_pattern + self.prefix_kinds)
        if self.mla is None and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")
