"""reflect-demo-100m — the paper's own end-to-end driver model.

~100M-param dense LM used by examples/train_100m.py (train a few hundred
steps on the synthetic reflection-task corpus) and by the reflection
serving examples.  Byte-level tokenizer (vocab 512).
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="reflect-demo-100m",
    arch_type="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=512,
    block_pattern=dense_pattern(12),
    mlp_act="swiglu",
    source="this work",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="reflect-demo-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, block_pattern=dense_pattern(2),
    )
