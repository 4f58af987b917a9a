"""StarCoder2-15B [arXiv:2402.19173]: dense GQA decoder, GeLU MLP,
QKV bias, LayerNorm, sliding-window 4096 (the release trains with SWA
— so the long_500k variant is *faithful* here)."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        arch_type="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        scan_pattern=("dense",),
        qkv_bias=True,
        act="gelu",
        norm="layernorm",
        window=4096,
        rope_theta=1e5,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        scan_pattern=("dense",),
        qkv_bias=True,
        act="gelu",
        norm="layernorm",
        window=64,
        vocab_pad_multiple=16,
    )
