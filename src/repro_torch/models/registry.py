"""Model + config registry: ``--arch <id>`` resolution (port of
``repro/models/registry.py``: all of the reference's architectures)."""
from __future__ import annotations

import importlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "granite_moe_1b_a400m",
    "qwen3_0_6b",
    "recurrentgemma_9b",
    "nemotron_4_340b",
    "minitron_4b",
    "kimi_k2_1t_a32b",
    "yi_6b",
    "internvl2_76b",
    "falcon_mamba_7b",
    "whisper_tiny",
    "reflect_demo_100m",
)

# Extra pool architectures beyond the assigned ones (selectable by id,
# not part of the reference's default --arch all sweep).
EXTRA_ARCH_IDS = (
    "mixtral_8x7b",
    "llama3_70b",
)

# public-pool ids (with dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-0.6b": "qwen3_0_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "nemotron-4-340b": "nemotron_4_340b",
    "minitron-4b": "minitron_4b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "yi-6b": "yi_6b",
    "internvl2-76b": "internvl2_76b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-tiny": "whisper_tiny",
})


def _module(arch: str):
    """The config module of ``arch``: an id or an alias."""
    key = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS + EXTRA_ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; the registry has "
                         f"{ARCH_IDS + EXTRA_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def build_model(cfg: ModelConfig):
    """An uninitialised model of ``cfg.arch_type``: ``WhisperModel``
    (audio), ``VLMModel`` (vlm) or ``TransformerLM``.  Fill it with
    ``model.init(gen)`` or ``model.load_state_dict(bridge.params_from_jax(
    ...))``."""
    if cfg.arch_type == "audio":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(cfg)
    if cfg.arch_type == "vlm":
        from repro_torch.models.vlm import VLMModel
        return VLMModel(cfg)
    from repro_torch.models.transformer import TransformerLM
    return TransformerLM(cfg)


def side_input(cfg: ModelConfig) -> Optional[Tuple[str, int]]:
    """The input the VLM and whisper take beside the tokens, as (batch
    key, rows): the VLM's ``patch_embeds`` (``num_patches`` rows) and
    whisper's ``frames`` (``encoder_seq``), each [batch, rows, d_model] in
    ``cfg.dtype``; None for the other families."""
    if cfg.arch_type == "vlm":
        return "patch_embeds", cfg.num_patches
    if cfg.arch_type == "audio":
        return "frames", cfg.encoder_seq
    return None


def model_inputs(cfg: ModelConfig, batch: int, seq: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, Any]:
    """A concrete input batch for a forward or train step, drawn from
    ``generator`` (seed 0 on the CPU when None) on its device: ``tokens``
    and ``labels`` [batch, seq], and ``side_input``'s normals."""
    g = generator or torch.Generator().manual_seed(0)
    dev = g.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=g, device=dev),
           "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=g, device=dev)}
    side = side_input(cfg)
    if side:
        key, n = side
        out[key] = torch.randn(batch, n, cfg.d_model, generator=g,
                               device=dev).to(getattr(torch, cfg.dtype))
    return out
