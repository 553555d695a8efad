"""Decoder-only LM over ring or paged KV caches and dense recurrent state
(port of ``repro/models/transformer.py``).

``TransformerLM`` is an ``nn.Module`` with one block per layer of
``cfg.block_pattern``: ``attn`` and ``rg_attn`` (attention blocks; the
latter with RecurrentGemma's ``local_window``), ``moe`` (attention and a
mixture-of-experts FFN, models/moe.py), ``mamba`` and ``rglru``.
The reference's ``lax.scan`` over a stacked repeating unit becomes a loop
over ``self.blocks``.  Entry points:

* ``forward`` (teacher forcing: logits at every position, or the final
  hidden states for the chunked loss, and the MoE load-balancing aux
  loss; ``prefix_embeds`` put before the tokens as a bidirectional
  prefix, the VLM's image patches, models/vlm.py), the one entry point
  autograd can differentiate (the trainer,
  ``train/loop.py``, turns the parameters' ``requires_grad`` on), and
  ``prefill`` (logits at each sequence's last valid token and the primed
  decode cache; ``prefix_embeds`` as in ``forward``), whose attention
  layers run ``ops.flash_attention``;
* ``prefill_extend`` (chunked prefill, mixed steps and speculative
  verify) and ``decode_step``, which take the cache — a list with one
  dict per layer: the ring cache or shared page pools of an attention
  layer, the dense per-slot ``{"conv", "h"}`` state of a recurrent one —
  and, for paged caches, the ``[B, NP]`` int32 page table; they update
  the cache in place and return ``(logits, cache)``.  ``prefill``,
  ``prefill_extend`` and ``decode_step`` run without gradients.

The encoder-decoder whisper model is ``models/whisper.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG

Cache = List[Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_KINDS = ("attn", "rg_attn")
# the kinds whose layers hold K/V (a ring or a page pool)
KV_KINDS = ATTN_KINDS + ("moe",)
STATE_KINDS = ("mamba", "rglru")


def _block(cfg: ModelConfig, kind: str, dtype: torch.dtype) -> nn.Module:
    if kind in ATTN_KINDS:
        return A.AttnBlock(cfg, dtype)
    if kind == "moe":
        return MOE.MoEBlock(cfg, dtype)
    if kind == "mamba":
        return M.MambaBlock(cfg, dtype)
    if kind == "rglru":
        return RG.RGLRUBlock(cfg, dtype)
    raise ValueError(f"unknown block kind {kind!r}; the blocks are "
                     f"{KV_KINDS + STATE_KINDS}")


class TransformerLM(nn.Module):
    # prefill_extend accepts all_logits=True (speculative verify step)
    supports_verify = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]
        pd = self.param_dtype
        self.embed = L.param((cfg.vocab_size, cfg.d_model), pd,
                             axes=("vocab", "embed"))
        self.blocks = nn.ModuleList(_block(cfg, kind, pd)
                                    for kind in cfg.block_pattern)
        self.ln_f = L.RMSNorm(cfg.d_model, pd)
        if not cfg.tie_embeddings:
            self.unembed = L.param((cfg.d_model, cfg.vocab_size), pd,
                                   axes=("embed", "vocab"))

    # ---------------- parameters / caches -----------------------------------

    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights from ``generator`` (layers.init_params)."""
        return L.init_params(self, generator)

    def attn_capacity(self, max_seq: int) -> int:
        w = self.cfg.sliding_window
        return min(max_seq, w) if w else max_seq

    def cache_defs(self, batch: int, max_seq: int,
                   kv_dtype: Optional[str] = None,
                   seq_shard: bool = True) -> List[Dict]:
        """Per-layer ring-cache shapes, dtypes and axes: attention and MoE
        layers get a [batch, capacity] ring (``rg_attn`` layers capped at
        ``local_window``; ``seq_shard`` as in ``attention.kv_cache_def``),
        recurrent layers their dense state."""
        cap = self.attn_capacity(max_seq)
        defs = []
        for kind in self.cfg.block_pattern:
            if kind in KV_KINDS:
                c = min(cap, self.cfg.local_window) if kind == "rg_attn" \
                    else cap
                defs.append(A.kv_cache_def(self.cfg, batch, c, self.dtype,
                                           kv_dtype, seq_shard))
            elif kind == "mamba":
                defs.append(M.mamba_cache_def(self.cfg, batch, self.dtype))
            else:
                defs.append(RG.rglru_cache_def(self.cfg, batch, self.dtype))
        return defs

    def init_cache(self, batch: int, max_seq: int,
                   kv_dtype: Optional[str] = None,
                   device: Optional[torch.device] = None) -> Cache:
        """Empty ring caches (tok = -1) and zeroed state, one dict per
        layer."""
        device = device or self.embed.device
        return [A.empty_cache(defs, device)
                for defs in self.cache_defs(batch, max_seq, kv_dtype)]

    def cache_defs_paged(self, num_pages: int, page_size: int,
                         kv_dtype: Optional[str] = None, batch: int = 1
                         ) -> List[Dict]:
        """Per-layer cache shapes and dtypes: attention and MoE layers get
        a shared page pool (attention.paged_kv_cache_def; ``kv_dtype``
        "int8" adds the scale sidecar pools), recurrent layers their dense
        ``batch``-row state — paging only pays off where the cache grows
        with the sequence."""
        defs = []
        for kind in self.cfg.block_pattern:
            if kind in KV_KINDS:
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
        return [A.empty_cache(defs, device)
                for defs in self.cache_defs_paged(num_pages, page_size,
                                                  kv_dtype, batch)]

    # ---------------- embedding ---------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(self.embed, tokens, self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ L.cast(self.embed, x.dtype).T
        return L.unembed(self.unembed, x)

    # ---------------- full sequences -----------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor], remat: bool = False,
                return_hidden: bool = False,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher forcing: ``batch["tokens"]`` [B, S] (and optional
        ``batch["lengths"]`` [B]) -> (logits [B, S, V], aux loss), or the
        final hidden states [B, S, d] after ``ln_f`` instead of the logits
        with ``return_hidden`` (the chunked loss).  ``prefix_embeds`` [B,
        P, d] go before the token embeddings as a bidirectional prefix:
        positions run over both, ``lengths`` count both (as in the
        reference, which does not shift them here), and the prefix's rows
        are dropped after ``ln_f``.  The aux loss is MoE
        load balancing summed over the MoE layers and divided by
        ``cfg.num_layers``, as in the reference: 0 without MoE blocks.
        Differentiable: on the card attention's backward is the
        hand-written flash backward kernel and the mamba and RG-LRU
        scans' are the hand-written scan backward kernels.  ``remat``
        recomputes each block in the backward pass
        (``torch.utils.checkpoint``), as the reference's
        ``jax.checkpoint`` of its scanned unit."""
        tokens = batch["tokens"]
        lengths = batch.get("lengths")
        x = self.embed_tokens(tokens)
        prefix_len = 0
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(self.dtype), x], dim=1)
            prefix_len = prefix_embeds.shape[1]
        positions = torch.arange(x.shape[1], device=tokens.device,
                                 dtype=torch.int32)[None, :]
        aux = torch.zeros((), device=x.device)
        for kind, blk in zip(self.cfg.block_pattern, self.blocks):
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(self._block_forward, kind, blk, x,
                                  positions, lengths, prefix_len,
                                  use_reentrant=False)
            else:
                x, a = self._block_forward(kind, blk, x, positions, lengths,
                                           prefix_len)
            if a is not None:
                aux = aux + a
        x = L.rmsnorm(self.ln_f.scale, x, self.cfg.norm_eps)
        if prefix_len:
            x = x[:, prefix_len:]
        aux = aux / max(self.cfg.num_layers, 1)
        if return_hidden:
            return x, aux
        return self.logits(x), aux

    def _block_forward(self, kind: str, blk: nn.Module, x: torch.Tensor,
                       positions: torch.Tensor,
                       lengths: Optional[torch.Tensor], prefix_len: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One block of ``forward``: (x, its aux loss; None but for
        MoE)."""
        if kind == "moe":
            return MOE.moe_block_forward(self.cfg, blk, x, positions,
                                         lengths, prefix_len)
        if kind in ATTN_KINDS:
            return A.attn_block_forward(self.cfg, blk, x, positions, kind,
                                        lengths, prefix_len), None
        if kind == "mamba":
            return M.mamba_block_forward(self.cfg, blk, x), None
        return RG.rglru_block_forward(self.cfg, blk, x), None

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, S], valid up to ``lengths`` [B] (all S when None).
        Returns (logits at each row's last valid token [B, V], the primed
        ring cache for ``decode_step``); attention rings hold
        ``attn_capacity(max_seq or S)`` slots, so when S exceeds that only
        each row's last tokens survive.  Recurrent state summarizes all S
        tokens, as in the reference.  ``prefix_embeds`` [B, P, d] go
        before the tokens as a bidirectional prefix and ``lengths`` shift
        by P, so decoding continues at position P + lengths[b]."""
        B, S = tokens.shape
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32,
                                 device=tokens.device)
        x = self.embed_tokens(tokens)
        prefix_len = 0
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(self.dtype), x], dim=1)
            prefix_len = prefix_embeds.shape[1]
            lengths = lengths + prefix_len
        S_tot = x.shape[1]
        capacity = self.attn_capacity(max_seq or S_tot)
        positions = torch.arange(S_tot, device=tokens.device,
                                 dtype=torch.int32)[None, :]
        cache: Cache = []
        for kind, blk in zip(self.cfg.block_pattern, self.blocks):
            if kind in ATTN_KINDS:
                cap = (min(capacity, self.cfg.local_window)
                       if kind == "rg_attn" else capacity)
                x, c = A.attn_block_prefill(self.cfg, blk, x, positions,
                                            lengths, cap, kind, prefix_len)
            elif kind == "moe":
                x, c, _ = MOE.moe_block_prefill(self.cfg, blk, x, positions,
                                                lengths, capacity,
                                                prefix_len)
            elif kind == "mamba":
                x, c = M.mamba_block_prefill(self.cfg, blk, x)
            else:
                x, c = RG.rglru_block_prefill(self.cfg, blk, x)
            cache.append(c)
        x = L.rmsnorm(self.ln_f.scale, x, self.cfg.norm_eps)
        last = (lengths.long() - 1).clamp_min(0)
        return self.logits(x[torch.arange(B, device=x.device), last]), cache

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
        ``page_table`` ([B, NP] int32) is required by paged caches and
        ignored by ring caches.
        """
        x = self.embed_tokens(tokens)
        valid = None
        if n_valid is not None:
            lanes = torch.arange(tokens.shape[1], device=tokens.device)
            valid = lanes[None, :] < n_valid[:, None]
        for kind, blk, c in zip(self.cfg.block_pattern, self.blocks, cache):
            if kind in ATTN_KINDS:
                x, _ = A.attn_block_extend(self.cfg, blk, x, c, pos0, kind,
                                           valid, page_table)
            elif kind == "moe":
                x, _ = MOE.moe_block_extend(self.cfg, blk, x, c, pos0, valid,
                                            page_table)
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
        """tokens: [B, 1]; pos: [B] int32 absolute position of this token;
        ``page_table`` as in ``prefill_extend``.  Returns ([B, V] logits,
        cache)."""
        x = self.embed_tokens(tokens)
        for kind, blk, c in zip(self.cfg.block_pattern, self.blocks, cache):
            if kind in ATTN_KINDS:
                x, _ = A.attn_block_decode(self.cfg, blk, x, c, pos, kind,
                                           page_table)
            elif kind == "moe":
                x, _ = MOE.moe_block_decode(self.cfg, blk, x, c, pos,
                                            page_table)
            elif kind == "mamba":
                x, _ = M.mamba_block_decode(self.cfg, blk, x, c)
            else:
                x, _ = RG.rglru_block_decode(self.cfg, blk, x, c)
        x = L.rmsnorm(self.ln_f.scale, x, self.cfg.norm_eps)
        return self.logits(x)[:, 0], cache

