"""Model + config registry: ``--arch <id>`` resolution (port of
``repro/models/registry.py`` for the architectures the port serves)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "reflect_demo_100m",
    "qwen3_0_6b",
    "falcon_mamba_7b",
    "recurrentgemma_9b",
)

ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES["qwen3-0.6b"] = "qwen3_0_6b"


def _module(arch: str):
    key = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported; the port has {ARCH_IDS}; "
            "still to port: the MoE archs, whisper and vlm")
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
