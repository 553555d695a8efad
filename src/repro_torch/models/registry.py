"""Model + config registry: ``--arch <id>`` resolution (port of
``repro/models/registry.py`` for the architectures the port serves: every
one of the reference's but whisper and the VLM)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "granite_moe_1b_a400m",
    "qwen3_0_6b",
    "recurrentgemma_9b",
    "nemotron_4_340b",
    "minitron_4b",
    "kimi_k2_1t_a32b",
    "yi_6b",
    "falcon_mamba_7b",
    "reflect_demo_100m",
)

# Extra pool architectures beyond the assigned ones (selectable by id,
# not part of the reference's default --arch all sweep).
EXTRA_ARCH_IDS = (
    "mixtral_8x7b",
    "llama3_70b",
)


def _module(arch: str):
    """The config module of ``arch``: an id, or a public-pool alias with
    dashes and dots (``qwen3-0.6b``)."""
    key = arch.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS + EXTRA_ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported; the port has "
            f"{ARCH_IDS + EXTRA_ARCH_IDS}; still to port: whisper_tiny, "
            "internvl2_76b")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def build_model(cfg: ModelConfig):
    """An uninitialised ``TransformerLM``: fill it with ``model.init(gen)``
    or ``model.load_state_dict(bridge.params_from_jax(...))``."""
    from repro_torch.models.transformer import TransformerLM
    return TransformerLM(cfg)
