"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP.  [arXiv:2402.16819]

The full config's head_dim of 192 is one of the serving kernels' and the
flash forward's head dims (``kernels/cuda_lib.HEAD_DIMS``), so it serves
and runs ``prefill`` / ``forward`` on the card (``chip_smoke.py`` runs 4
of its 96 layers at full width on one H100); the flash backward is not
built at hd 192 (``cuda_lib.BWD_HEAD_DIMS``), so a card call that needs
a gradient raises.  The smoke config (hd 32) runs everywhere.
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    block_pattern=dense_pattern(96),
    mlp_act="relu2",               # squared ReLU
    param_dtype="bfloat16",
    source="arXiv:2402.16819",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="nemotron-smoke",
        num_layers=2, d_model=192, num_heads=6, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=256, block_pattern=dense_pattern(2),
        param_dtype="float32",
    )
