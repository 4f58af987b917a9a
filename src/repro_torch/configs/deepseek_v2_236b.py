"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA attention (kv_lora 512,
q_lora 1536, decoupled RoPE head 64) + MoE with 2 shared and 160
routed experts, top-6 (d_ff_expert 1536); layer 0 is dense
(d_ff 12288) — modeled as the unrolled prefix."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=12288,                 # dense prefix layer MLP
        vocab_size=102400,
        prefix_kinds=("dense",),
        scan_pattern=("moe",),
        act="swiglu",
        norm="rmsnorm",
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            nope_head_dim=128,
            rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=160,
            top_k=6,
            d_ff_expert=1536,
            num_shared_experts=2,
            d_ff_residual=1536,
        ),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        arch_type="moe",
        num_layers=3,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        prefix_kinds=("dense",),
        scan_pattern=("moe",),
        act="swiglu",
        norm="rmsnorm",
        mla=MLAConfig(
            kv_lora_rank=64,
            q_lora_rank=96,
            nope_head_dim=32,
            rope_head_dim=16,
            v_head_dim=32,
        ),
        moe=MoEConfig(
            num_experts=4,
            top_k=2,
            d_ff_expert=128,
            num_shared_experts=1,
            d_ff_residual=128,
        ),
        vocab_pad_multiple=16,
    )
