"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8
(paper-table entry).  [arXiv:2501.kimi2]
"""
from repro_torch.configs.base import ModelConfig, moe_pattern

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                     # per-expert FFN width
    vocab_size=163840,
    block_pattern=moe_pattern(61),
    num_experts=384,
    experts_per_token=8,
    mlp_act="swiglu",
    param_dtype="bfloat16",
    source="arXiv:2501.kimi2",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=256, block_pattern=moe_pattern(2),
        num_experts=4, experts_per_token=2,
        param_dtype="float32",
    )
