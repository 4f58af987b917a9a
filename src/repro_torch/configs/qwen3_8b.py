"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense GQA, QK-RMSNorm, head_dim 128."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        arch_type="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        scan_pattern=("dense",),
        qk_norm=True,
        act="swiglu",
        norm="rmsnorm",
        rope_theta=1e6,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        scan_pattern=("dense",),
        qk_norm=True,
        act="swiglu",
        norm="rmsnorm",
        vocab_pad_multiple=16,
    )
