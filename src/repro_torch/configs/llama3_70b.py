"""EXTRA (beyond the assigned 10): llama3-70b [dense] — GQA, large-vocab.
[arXiv:2407.21783]
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="llama3-70b",
    arch_type="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=dense_pattern(80),
    rope_theta=500_000.0,
    mlp_act="swiglu",
    param_dtype="bfloat16",
    source="arXiv:2407.21783",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="llama3-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256, block_pattern=dense_pattern(2),
        param_dtype="float32",
    )
