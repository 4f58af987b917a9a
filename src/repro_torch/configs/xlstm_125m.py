"""xLSTM-125M [arXiv:2405.04517]: alternating mLSTM (matrix memory,
parallel-trainable) and sLSTM (scalar memory, sequential) blocks,
5:1 ratio; d_ff=0 — projections live inside the blocks.  Attention-
free -> long_500k native."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        arch_type="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        scan_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm",
                      "slstm"),
        act="gelu",
        norm="layernorm",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke",
        arch_type="ssm",
        num_layers=2,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        scan_pattern=("mlstm", "slstm"),
        act="gelu",
        norm="layernorm",
        vocab_pad_multiple=16,
    )
