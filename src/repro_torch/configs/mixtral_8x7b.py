"""EXTRA (beyond the assigned 10): mixtral-8x7b [moe] — 8 experts top-2.
[arXiv:2401.04088]  Exercises the low-expert-count regime (8 experts
cannot shard over model=16 -> divisibility fallback replicates experts
while ff still shards within each expert).
"""
from repro_torch.configs.base import ModelConfig, moe_pattern

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=moe_pattern(32),
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,            # mixtral uses SWA
    mlp_act="swiglu",
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mixtral-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=256, block_pattern=moe_pattern(2),
        num_experts=4, experts_per_token=2, sliding_window=None,
    )
