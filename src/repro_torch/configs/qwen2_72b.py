"""Qwen2-72B [arXiv:2407.10671]: dense GQA with QKV bias, SwiGLU."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        arch_type="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        scan_pattern=("dense",),
        qkv_bias=True,
        act="swiglu",
        norm="rmsnorm",
        rope_theta=1e6,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        scan_pattern=("dense",),
        qkv_bias=True,
        act="swiglu",
        norm="rmsnorm",
        vocab_pad_multiple=16,
    )
