"""internvl2-76b [vlm] — InternViT + InternLM2 backbone.  [arXiv:2404.16821]

The vision tower + projector are stubbed per the assignment carve-out:
``input_specs()`` feeds projected patch embeddings [B, 256, d_model];
we implement the InternLM2-style language decoder that consumes them.
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=dense_pattern(80),
    num_patches=256,
    mlp_act="swiglu",
    param_dtype="bfloat16",
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-smoke",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256, block_pattern=dense_pattern(2),
        num_patches=8,
        param_dtype="float32",
    )
