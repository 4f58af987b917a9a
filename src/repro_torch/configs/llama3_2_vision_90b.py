"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision, scaled
per assignment]: 100 decoder layers, every 5th a gated cross-attention
layer over vision-tower patch embeddings.  The ViT tower + projector
is a STUB (assignment carve-out): input_specs provides projected patch
embeddings (B, num_frontend_tokens, d_model)."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        arch_type="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        scan_pattern=("dense", "dense", "dense", "dense", "xattn"),
        act="swiglu",
        norm="rmsnorm",
        rope_theta=5e5,
        frontend="vision",
        num_frontend_tokens=4096,    # 4 tiles x ~1024 projected patches
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        arch_type="vlm",
        num_layers=5,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        scan_pattern=("dense", "dense", "dense", "dense", "xattn"),
        act="swiglu",
        norm="rmsnorm",
        frontend="vision",
        num_frontend_tokens=16,
        vocab_pad_multiple=16,
    )
