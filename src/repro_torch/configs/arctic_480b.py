"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base]:
dense-MoE hybrid — every layer routes 128 experts top-2 (d_ff 4864)
with a parallel dense residual MLP.  56 heads do not divide the
16-way model axis: attention is head-replicated, MoE expert-parallel
(DESIGN.md §6 — attention is <2% of step FLOPs here)."""
from repro_torch.models.config import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        arch_type="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        scan_pattern=("moe_residual",),
        act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            d_ff_expert=4864,
            dense_residual=True,
            d_ff_residual=4864,
        ),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        scan_pattern=("moe_residual",),
        act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=4,
            top_k=2,
            d_ff_expert=256,
            dense_residual=True,
            d_ff_residual=256,
        ),
        vocab_pad_multiple=16,
    )
