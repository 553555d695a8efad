"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1
local-attn interleave.  [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, recurrentgemma_pattern

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,                # MQA in the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=recurrentgemma_pattern(38),
    local_window=2048,
    rnn_width=4096,
    mlp_act="swiglu",
    param_dtype="bfloat16",
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-smoke",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=256,
        block_pattern=recurrentgemma_pattern(3),
        local_window=32, rnn_width=128,
        param_dtype="float32",
    )
