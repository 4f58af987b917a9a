"""RecurrentGemma-9B [arXiv:2402.19427] (Griffin): RG-LRU recurrent
blocks + local sliding-window attention in a 2:1 pattern
(rglru, rglru, local-attn); 38 layers = 12 scanned groups + 2 trailing
recurrent blocks.  Natively sub-quadratic -> long_500k runs as-is."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        scan_pattern=("rglru", "rglru", "local"),
        act="geglu",
        norm="rmsnorm",
        window=2048,
        lru_width=4096,
        conv_width=4,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        arch_type="hybrid",
        num_layers=5,          # one scanned group + (rglru, rglru) tail
        d_model=256,
        num_heads=4,
        num_kv_heads=1,
        d_ff=512,
        vocab_size=512,
        scan_pattern=("rglru", "rglru", "local"),
        act="geglu",
        norm="rmsnorm",
        window=32,
        lru_width=256,
        conv_width=4,
        vocab_pad_multiple=16,
    )
