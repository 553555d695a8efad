"""qwen3-0.6b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,                  # Qwen3 decouples head_dim from d_model/H
    d_ff=3072,
    vocab_size=151936,
    block_pattern=dense_pattern(28),
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256, block_pattern=dense_pattern(2),
    )
