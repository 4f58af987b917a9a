"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder; the speech
frontend (mel + conformer conv) is a STUB (assignment carve-out) —
callers pass frame embeddings (B, frames, d_model); the 12-layer
encoder and the 12-layer decoder (self + cross + MLP) are real.  The
encoder's self-attention is causal, as the reference's `enc` block
computes it, not the published bidirectional one (ROADMAP.md §3 R8).
Vocab 256206 pads to 256256 (a multiple of 256)."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        arch_type="audio",
        num_layers=12,           # decoder layers
        encoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        scan_pattern=("dec",),
        act="gelu",
        norm="layernorm",
        frontend="audio",
        num_frontend_tokens=1024,   # default frames; shapes may override
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke",
        arch_type="audio",
        num_layers=2,
        encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=500,
        scan_pattern=("dec",),
        act="gelu",
        norm="layernorm",
        frontend="audio",
        num_frontend_tokens=16,
        vocab_pad_multiple=16,
    )
