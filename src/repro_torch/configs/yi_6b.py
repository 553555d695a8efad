"""yi-6b [dense] — llama-arch GQA.  [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=dense_pattern(32),
    rope_theta=5_000_000.0,
    mlp_act="swiglu",
    source="arXiv:2403.04652",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="yi-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256, block_pattern=dense_pattern(2),
    )
