"""whisper-tiny [audio] — enc-dec backbone; conv/mel frontend is a stub.
[arXiv:2212.04356]

long_500k is SKIPPED for this arch (see DESIGN.md §Arch-applicability):
an enc-dec with a 1500-frame encoder and a short decoder has no 524k-token
decode regime.
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,                  # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,                # whisper is MHA (kv == heads)
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=dense_pattern(4),
    encoder_seq=1500,
    mlp_act="gelu",
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-smoke",
        num_layers=2, encoder_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
        block_pattern=dense_pattern(2), encoder_seq=16,
    )
