"""Decoder-only LM over a paged KV pool and dense recurrent state (port of
the paged serving subset of ``repro/models/transformer.py``).

``TransformerLM`` is an ``nn.Module`` with one block per layer of
``cfg.block_pattern``: ``attn`` and ``rg_attn`` (attention blocks; the
latter with RecurrentGemma's ``local_window``), ``mamba`` and ``rglru``.
The reference's ``lax.scan`` over a stacked repeating unit becomes a loop
over ``self.blocks``.  Its serving entry points are ``prefill_extend``
(chunked prefill, mixed steps and speculative verify) and
``decode_step``; both take the cache — a list with one dict per layer:
the shared page pools of an attention layer, the dense per-slot
``{"conv", "h"}`` state of a recurrent one — and the ``[B, NP]`` int32
page table, update the cache in place and return ``(logits, cache)``.
Not ported yet: MoE blocks, ring caches with full-sequence
``forward``/``prefill``, and the whisper and vlm models.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rglru as RG

Cache = List[Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_KINDS = ("attn", "rg_attn")
STATE_KINDS = ("mamba", "rglru")
UNPORTED = ("MoE blocks, ring caches (paged_kv=False), whisper and vlm "
            "models")


def _block(cfg: ModelConfig, kind: str, dtype: torch.dtype) -> nn.Module:
    if kind in ATTN_KINDS:
        return A.AttnBlock(cfg, dtype)
    if kind == "mamba":
        return M.MambaBlock(cfg, dtype)
    if kind == "rglru":
        return RG.RGLRUBlock(cfg, dtype)
    raise NotImplementedError(
        f"block kind {kind!r} is not ported yet; the port serves "
        f"{ATTN_KINDS + STATE_KINDS}; still to port: {UNPORTED}")


class TransformerLM(nn.Module):
    # prefill_extend accepts all_logits=True (speculative verify step)
    supports_verify = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]
        pd = self.param_dtype
        self.embed = L.param((cfg.vocab_size, cfg.d_model), pd)
        self.blocks = nn.ModuleList(_block(cfg, kind, pd)
                                    for kind in cfg.block_pattern)
        self.ln_f = L.RMSNorm(cfg.d_model, pd)
        if not cfg.tie_embeddings:
            self.unembed = L.param((cfg.d_model, cfg.vocab_size), pd)

    # ---------------- parameters / caches -----------------------------------

    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights from ``generator`` (layers.init_params)."""
        return L.init_params(self, generator)

    def cache_defs_paged(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None, batch: int = 1
                         ) -> List[Dict]:
        """Per-layer cache shapes and dtypes: attention layers get a shared
        page pool (attention.paged_kv_cache_def; ``kv_dtype`` "int8" adds
        the scale sidecar pools), recurrent layers their dense ``batch``-row
        state — paging only pays off where the cache grows with the
        sequence."""
        defs = []
        for kind in self.cfg.block_pattern:
            if kind in ATTN_KINDS:
                defs.append(A.paged_kv_cache_def(self.cfg, num_pages,
                                                 page_size, self.dtype,
                                                 kv_dtype))
            elif kind == "mamba":
                defs.append(M.mamba_cache_def(self.cfg, batch, self.dtype))
            else:
                defs.append(RG.rglru_cache_def(self.cfg, batch, self.dtype))
        return defs

    def init_cache_paged(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None,
                         device: Optional[torch.device] = None,
                         batch: int = 1) -> Cache:
        """Zeroed page pools and recurrent state, one dict per layer."""
        device = device or self.embed.device
        return [{name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in defs.items()}
                for defs in self.cache_defs_paged(num_pages, page_size,
                                                  kv_dtype, batch)]

    # ---------------- embedding ---------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(self.embed, tokens, self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return L.unembed(w, x)

    # ---------------- serving steps ------------------------------------------

    @torch.no_grad()
    def prefill_extend(self, cache: Cache, tokens: torch.Tensor,
                       pos0: torch.Tensor,
                       n_valid: Optional[torch.Tensor] = None,
                       page_table: Optional[torch.Tensor] = None,
                       all_logits: bool = False
                       ) -> Tuple[torch.Tensor, Cache]:
        """Prefill a token suffix on top of the cached prefix.

        tokens: [B, Sx] continue at absolute position pos0 [B] (int32).
        ``n_valid`` ([B]) makes this the engine's mixed chunked-prefill /
        decode step: row b processes only its first n_valid[b] lanes
        (0 = no-op for its pages) and logits come from its last valid
        lane.  ``all_logits`` returns logits at every lane ([B, Sx, V]),
        the speculative verify step; lanes >= n_valid are meaningless.
        """
        _need_pages(page_table)
        x = self.embed_tokens(tokens)
        valid = None
        if n_valid is not None:
            lanes = torch.arange(tokens.shape[1], device=tokens.device)
            valid = lanes[None, :] < n_valid[:, None]
        for kind, blk, c in zip(self.cfg.block_pattern, self.blocks, cache):
            if kind in ATTN_KINDS:
                x, _ = A.attn_block_extend(self.cfg, blk, x, c, pos0, kind,
                                           valid, page_table)
            elif kind == "mamba":
                x, _ = M.mamba_block_extend(self.cfg, blk, x, c, valid)
            else:
                x, _ = RG.rglru_block_extend(self.cfg, blk, x, c, valid)
        x = L.rmsnorm(self.ln_f.scale, x, self.cfg.norm_eps)
        if all_logits:
            return self.logits(x), cache                        # [B, Sx, V]
        if n_valid is None:
            return self.logits(x[:, -1]), cache
        last = torch.clamp_min(n_valid.long() - 1, 0)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
        return self.logits(x_last), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    pos: torch.Tensor,
                    page_table: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, 1]; pos: [B] int32 absolute position of this token.
        Returns ([B, V] logits, cache)."""
        _need_pages(page_table)
        x = self.embed_tokens(tokens)
        for kind, blk, c in zip(self.cfg.block_pattern, self.blocks, cache):
            if kind in ATTN_KINDS:
                x, _ = A.attn_block_decode(self.cfg, blk, x, c, pos, kind,
                                           page_table)
            elif kind == "mamba":
                x, _ = M.mamba_block_decode(self.cfg, blk, x, c)
            else:
                x, _ = RG.rglru_block_decode(self.cfg, blk, x, c)
        x = L.rmsnorm(self.ln_f.scale, x, self.cfg.norm_eps)
        return self.logits(x)[:, 0], cache


def _need_pages(page_table: Optional[torch.Tensor]) -> None:
    if page_table is None:
        raise NotImplementedError(
            "the port serves from a paged KV pool only: pass page_table "
            f"(still to port: {UNPORTED})")
