"""granite-moe-1b-a400m [moe] — 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig, moe_pattern

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                      # per-expert FFN width
    vocab_size=49155,
    block_pattern=moe_pattern(24),
    num_experts=32,
    experts_per_token=8,
    mlp_act="swiglu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=256, block_pattern=moe_pattern(2),
        num_experts=4, experts_per_token=2,
    )
