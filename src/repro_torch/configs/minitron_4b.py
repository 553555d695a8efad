"""minitron-4b [dense] — width/depth-pruned Nemotron.  [arXiv:2407.14679]

24 heads is NOT divisible by the 16-way model axis: the sharding layer's
divisibility fallback replicates the head dim while still sharding
ff/vocab/embed — this arch is the stress test for that fallback.
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=dense_pattern(32),
    mlp_act="relu2",
    source="arXiv:2407.14679",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="minitron-smoke",
        num_layers=2, d_model=96, num_heads=3, num_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=256, block_pattern=dense_pattern(2),
    )
