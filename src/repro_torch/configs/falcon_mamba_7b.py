"""falcon-mamba-7b [ssm] — Mamba-1 architecture, attention-free.
[arXiv:2410.05355]

Decode state is O(1) per layer (conv tail + [d_inner, 16] SSM state), no
KV cache at all.
"""
from repro_torch.configs.base import ModelConfig, mamba_pattern

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,                   # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,                        # no MLP sub-block in mamba-1
    vocab_size=65024,
    block_pattern=mamba_pattern(64),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    source="arXiv:2410.05355",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="falcon-mamba-smoke",
        num_layers=2, d_model=128, vocab_size=256,
        block_pattern=mamba_pattern(2),
        ssm_state=8,
    )
