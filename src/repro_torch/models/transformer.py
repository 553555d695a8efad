"""Decoder-only dense transformer over a paged KV pool (port of the dense,
paged subset of ``repro/models/transformer.py``).

``TransformerLM`` is an ``nn.Module`` with one ``AttnBlock`` per layer;
the reference's ``lax.scan`` over stacked layer parameters becomes a loop
over ``self.blocks``.  Its serving entry points are ``prefill_extend``
(chunked prefill, mixed steps and speculative verify) and ``decode_step``;
both take the paged cache — a list with one pool dict per layer — and the
``[B, NP]`` int32 page table, update the pools in place and return
``(logits, cache)``.  Ring caches and full-sequence ``forward``/``prefill``
are not part of this port yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Cache = List[Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TransformerLM(nn.Module):
    # prefill_extend accepts all_logits=True (speculative verify step)
    supports_verify = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        unsupported = set(cfg.block_pattern) - {"attn"}
        if unsupported:
            raise NotImplementedError(
                f"block kinds {sorted(unsupported)} are not ported yet; "
                "the port serves dense attention models")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]
        pd = self.param_dtype
        self.embed = L.param((cfg.vocab_size, cfg.d_model), pd)
        self.blocks = nn.ModuleList(A.AttnBlock(cfg, pd)
                                    for _ in cfg.block_pattern)
        self.ln_f = L.RMSNorm(cfg.d_model, pd)
        if not cfg.tie_embeddings:
            self.unembed = L.param((cfg.d_model, cfg.vocab_size), pd)

    # ---------------- parameters / caches -----------------------------------

    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights from ``generator`` (layers.init_params)."""
        return L.init_params(self, generator)

    def cache_defs_paged(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None) -> List[Dict]:
        """Per-layer pool shapes and dtypes (attention.paged_kv_cache_def);
        ``kv_dtype`` "int8" adds the scale sidecar pools."""
        return [A.paged_kv_cache_def(self.cfg, num_pages, page_size,
                                     self.dtype, kv_dtype)
                for _ in self.blocks]

    def init_cache_paged(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None,
                         device: Optional[torch.device] = None) -> Cache:
        """Zeroed page pools, one dict per layer."""
        device = device or self.embed.device
        return [{name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in defs.items()}
                for defs in self.cache_defs_paged(num_pages, page_size,
                                                  kv_dtype)]

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
        if page_table is None:
            raise NotImplementedError("the port serves from a paged KV "
                                      "pool only; pass page_table")
        x = self.embed_tokens(tokens)
        valid = None
        if n_valid is not None:
            lanes = torch.arange(tokens.shape[1], device=tokens.device)
            valid = lanes[None, :] < n_valid[:, None]
        for blk, pool in zip(self.blocks, cache):
            x, _ = A.attn_block_extend(self.cfg, blk, x, pool, pos0, "attn",
                                       valid, page_table)
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
        if page_table is None:
            raise NotImplementedError("the port serves from a paged KV "
                                      "pool only; pass page_table")
        x = self.embed_tokens(tokens)
        for blk, pool in zip(self.blocks, cache):
            x, _ = A.attn_block_decode(self.cfg, blk, x, pool, pos, "attn",
                                       page_table)
        x = L.rmsnorm(self.ln_f.scale, x, self.cfg.norm_eps)
        return self.logits(x)[:, 0], cache
