"""Whisper-tiny transformer backbone (encoder-decoder, arXiv:2212.04356;
port of ``repro/models/whisper.py``).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the caller supplies precomputed frame embeddings [B, F,
d_model].  The encoder is a stack of attention blocks run with a
bidirectional prefix of all F frames (the flash kernels' prefix mode,
``prefix_len = F``); the decoder blocks are causal self-attention,
cross-attention over the encoder's output and an MLP (RMSNorm and RoPE
rather than Whisper's LayerNorm and learned positions, as in the
reference).

Cross-attention (``cross_kv``, ``cross_attention``) is plain PyTorch
matmuls and a float32 softmax in the reference's dtypes: the reference
computes it with XLA einsums, not a Pallas kernel.

The decode cache is a list with one dict per decoder layer: the layer's
ring leaves (``attention.kv_cache_def``) and its cross K/V ``xk``/``xv``
[B, F, K, hd], computed once by ``prefill`` and reused by every later
step; ``init_cache`` makes them zeros, as the reference's cache does, so an
engine's slot resets, prefix snapshots and adoptions carry them like the
other per-slot leaves.  There is no paged layout and no verify step
(``prefill_extend`` returns the last lane's logits only), so an engine
serves whisper from rings without speculation, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Cache = List[Dict[str, torch.Tensor]]


class CrossAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = L.param((d, H, hd), dtype, axes=("embed", "heads", None))
        self.wk = L.param((d, K, hd), dtype,
                          axes=("embed", "kv_heads", None))
        self.wv = L.param((d, K, hd), dtype,
                          axes=("embed", "kv_heads", None))
        self.wo = L.param((H, hd, d), dtype, axes=("heads", None, "embed"))


class DecBlock(nn.Module):
    """Pre-norm decoder block: self-attention, cross-attention, MLP."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, dtype)
        self.attn = A.Attention(cfg, dtype)
        self.lnx = L.RMSNorm(cfg.d_model, dtype)
        self.xattn = CrossAttention(cfg, dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, dtype)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)


def cross_attention(cfg: ModelConfig, p: CrossAttention, x: torch.Tensor,
                    xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d]; xk/xv: [B, F, K, hd], the encoder's K/V.  Every query
    attends every frame."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = A._proj(x, p.wq).reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, xk.to(dt)) * hd ** -0.5
    prob = torch.softmax(scores.float(), dim=-1).to(dt)
    out = torch.einsum("bkgst,btkd->bskgd", prob, xv.to(dt))
    return A._out_proj(p, out.reshape(B, S, H, hd))


def cross_kv(p: CrossAttention, enc: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output [B, F, d] projected to cross K and V [B, F, K,
    hd], in its dtype."""
    return A._proj(enc, p.wk), A._proj(enc, p.wv)


class WhisperModel(nn.Module):
    """Encoder-decoder backbone consuming precomputed frame embeddings."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.param_dtype = pd = getattr(torch, cfg.param_dtype)
        self.embed = L.param((cfg.vocab_size, cfg.d_model), pd,
                             axes=("vocab", "embed"))
        self.enc = nn.ModuleList(A.AttnBlock(cfg, pd) for _ in
                                 range(cfg.encoder_layers or cfg.num_layers))
        self.enc_ln = L.RMSNorm(cfg.d_model, pd)
        self.dec = nn.ModuleList(DecBlock(cfg, pd)
                                 for _ in range(cfg.num_layers))
        self.ln_f = L.RMSNorm(cfg.d_model, pd)
        self.unembed = L.param((cfg.d_model, cfg.vocab_size), pd,
                               axes=("embed", "vocab"))

    # ---------------- parameters / caches -----------------------------------

    def init(self, generator: torch.Generator) -> "WhisperModel":
        """Random weights from ``generator`` (layers.init_params)."""
        return L.init_params(self, generator)

    def attn_capacity(self, max_seq: int) -> int:
        return max_seq

    def cache_defs(self, batch: int, max_seq: int,
                   kv_dtype: Optional[str] = None,
                   seq_shard: bool = True) -> List[Dict]:
        """Per decoder layer: its ring (``attention.kv_cache_def``) and the
        cross K/V ``xk``/``xv`` [batch, encoder_seq, K, hd]."""
        cfg = self.cfg
        xkv = L.LeafDef((batch, cfg.encoder_seq, cfg.num_kv_heads,
                          cfg.head_dim), self.dtype,
                         ("batch", None, "kv_heads", None))
        return [{**A.kv_cache_def(cfg, batch, max_seq, self.dtype, kv_dtype,
                                  seq_shard),
                 "xk": xkv, "xv": xkv} for _ in range(cfg.num_layers)]

    def init_cache(self, batch: int, max_seq: int,
                   kv_dtype: Optional[str] = None,
                   device: Optional[torch.device] = None) -> Cache:
        """Empty rings (tok = -1) and zero cross K/V, one dict per decoder
        layer."""
        device = device or self.embed.device
        return [A.empty_cache(defs, device)
                for defs in self.cache_defs(batch, max_seq, kv_dtype)]

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(self.embed, tokens, self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.unembed(self.unembed, x)

    # ---------------- encoder -----------------------------------------------

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, F, d] precomputed embeddings (the conv frontend's
        stub) -> the encoder's output [B, F, d]; ``prefix_len = F`` makes
        its attention fully bidirectional."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        F = x.shape[1]
        positions = torch.arange(F, device=x.device,
                                 dtype=torch.int32)[None, :]
        for blk in self.enc:
            x = A.attn_block_forward(cfg, blk, x, positions, "attn", None,
                                     prefix_len=F)
        return L.rmsnorm(self.enc_ln.scale, x, cfg.norm_eps)

    # ---------------- decoder -----------------------------------------------

    def _dec_block(self, p: DecBlock, x: torch.Tensor,
                   positions: torch.Tensor, lengths: Optional[torch.Tensor],
                   enc: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
        x = x + A.attention_full(cfg, p.attn, h, positions, None, lengths)
        return self._dec_tail(p, x, *cross_kv(p.xattn, enc))

    def _dec_tail(self, p: DecBlock, x: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor) -> torch.Tensor:
        """Cross-attention and MLP of a decoder block, after its
        self-attention."""
        cfg = self.cfg
        h = L.rmsnorm(p.lnx.scale, x, cfg.norm_eps)
        x = x + cross_attention(cfg, p.xattn, h, xk, xv)
        h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
        return x + L.mlp(p.mlp, h, cfg.mlp_act)

    def forward(self, batch: Dict[str, torch.Tensor], remat: bool = False,
                return_hidden: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher forcing: ``batch["frames"]`` [B, F, d] and
        ``batch["tokens"]`` [B, S] (``batch["lengths"]`` optional) ->
        (logits [B, S, V], a zero aux loss), or the final hidden states
        with ``return_hidden``.  Differentiable (on the card the encoder's
        and decoder's attention go through the flash kernels and their
        backward); ``remat`` recomputes each decoder block in the backward
        pass, as the reference's ``jax.checkpoint``."""
        cfg = self.cfg
        enc = self.encode(batch["frames"])
        tokens = batch["tokens"]
        x = self.embed_tokens(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device,
                                 dtype=torch.int32)[None, :]
        lengths = batch.get("lengths")
        for blk in self.dec:
            if remat and torch.is_grad_enabled():
                x = checkpoint(self._dec_block, blk, x, positions, lengths,
                               enc, use_reentrant=False)
            else:
                x = self._dec_block(blk, x, positions, lengths, enc)
        x = L.rmsnorm(self.ln_f.scale, x, cfg.norm_eps)
        aux = torch.zeros((), device=x.device)
        if return_hidden:
            return x, aux
        return self.logits(x), aux

    # ---------------- prefill / serving steps -------------------------------

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None,
                frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, S] valid up to ``lengths`` [B]; frames: [B, F, d].
        Returns (logits at each row's last valid token [B, V], the primed
        cache: rings of ``max_seq or S`` slots and each layer's cross
        K/V)."""
        cfg = self.cfg
        B, S = tokens.shape
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32,
                                 device=tokens.device)
        enc = self.encode(frames)
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=tokens.device,
                                 dtype=torch.int32)[None, :]
        capacity = max_seq or S
        cache: Cache = []
        for blk in self.dec:
            h = L.rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
            q, k, v = A._qkv(cfg, blk.attn, h, positions)
            c = A.init_kv_cache(cfg, B, capacity, self.dtype,
                                device=x.device)
            A.prefill_into_cache(c, k, v, lengths)
            x = x + A.attention_full_qkv(cfg, blk.attn, q, k, v, None,
                                         lengths)
            c["xk"], c["xv"] = cross_kv(blk.xattn, enc)
            x = self._dec_tail(blk, x, c["xk"], c["xv"])
            cache.append(c)
        x = L.rmsnorm(self.ln_f.scale, x, cfg.norm_eps)
        last = (lengths.long() - 1).clamp_min(0)
        return self.logits(x[torch.arange(B, device=x.device), last]), cache

    @torch.no_grad()
    def prefill_extend(self, cache: Cache, tokens: torch.Tensor,
                       pos0: torch.Tensor,
                       n_valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Cache]:
        """Extend the decoder with a token suffix [B, Sx] at positions
        pos0 [B]; the cross K/V is reused as it is.  ``n_valid`` [B] makes
        it the engine's mixed step (row b processes its first n_valid[b]
        lanes, logits at its last valid lane), as ``TransformerLM``'s."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        valid = None
        if n_valid is not None:
            lanes = torch.arange(tokens.shape[1], device=tokens.device)
            valid = lanes[None, :] < n_valid[:, None]
        for blk, c in zip(self.dec, cache):
            h = L.rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
            y, _ = A.attention_extend(cfg, blk.attn, h, c, pos0, None, valid)
            x = self._dec_tail(blk, x + y, c["xk"], c["xv"])
        x = L.rmsnorm(self.ln_f.scale, x, cfg.norm_eps)
        if n_valid is None:
            return self.logits(x[:, -1]), cache
        last = torch.clamp_min(n_valid.long() - 1, 0)
        return self.logits(x[torch.arange(x.shape[0], device=x.device),
                             last]), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, 1] at positions pos [B] -> ([B, V] logits, cache);
        self-attention reads the ring through the ring decode kernel."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        for blk, c in zip(self.dec, cache):
            h = L.rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
            y, _ = A.attention_decode(cfg, blk.attn, h, c, pos, None)
            x = self._dec_tail(blk, x + y, c["xk"], c["xv"])
        x = L.rmsnorm(self.ln_f.scale, x, cfg.norm_eps)
        return self.logits(x)[:, 0], cache
