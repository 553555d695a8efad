"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``).

Dispatch follows the reference step by step: tokens are routed in groups
(one group per batch row when rows hold 256 tokens or more, else one
group over every lane of the call), each expert takes at most
``_capacity`` lanes of a group, lanes past it are dropped, and pad lanes
(``valid`` false) go to a past-the-end expert id that no expert counts.
The (tokens, experts, capacity) one-hot tensor is never built.

Every step runs on the device with static shapes and reads nothing back
to the host, so a serving step that holds MoE blocks can be captured as a
CUDA graph.  Where the reference adds with a scatter, the port writes or
gathers instead, so that the result does not depend on the order of
atomic adds on the card:

* per-expert counts are a ``scatter_add_`` of integer ones (exact in any
  order) into ``[B, E + 1]``, whose last column is the past-the-end id;
* the dispatch writes each kept lane to its own slot of the expert
  buffer; only the scratch slot behind the buffer, which is discarded,
  receives several writes;
* the combine gathers each token's k lanes back from the expert outputs,
  in the order of the token's top-k, and sums them in that fixed order
  (the reference scatter-adds them in the sorted order: the sums differ
  by rounding only).

``jax.lax.top_k`` puts the lower expert index first on equal
probabilities; ``torch.topk`` promises no order, so the top k come from a
stable descending sort.  The expert products are batched matrix products
(XLA einsums in the reference, outside any Pallas kernel).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.launch.rules import is_placed, run_local
from repro_torch.models import layers as L

# rows of at least this many tokens are routed one group per row
GROUP_ROW_TOKENS = 256


class MoE(nn.Module):
    """Router ``[d, E]`` (init scale 0.1) and expert weights ``wi``/``wg``
    ``[E, d, ff]`` (``wg`` for swiglu only) and ``wo [E, ff, d]``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = L.param((d, E), dtype, scale=0.1,
                              axes=("embed", "experts"))
        self.wi = L.param((E, d, ff), dtype, axes=("experts", "embed", "ff"))
        self.wo = L.param((E, ff, d), dtype, axes=("experts", "ff", "embed"))
        self.wg: Optional[nn.Parameter] = (
            L.param((E, d, ff), dtype, axes=("experts", "embed", "ff"))
            if cfg.mlp_act == "swiglu" else None)


class MoEBlock(nn.Module):
    """Pre-norm residual block: attention mixer + MoE FFN."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, dtype)
        self.attn = A.Attention(cfg, dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, dtype)
        self.moe = MoE(cfg, dtype)


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(num_tokens * cfg.experts_per_token * cfg.capacity_factor
            / max(cfg.num_experts, 1))
    return max(8, -(-c // 8) * 8)


def route(cfg: ModelConfig, p: MoE, x3: torch.Tensor,
          valid3: Optional[torch.Tensor] = None):
    """The router and the dispatch plan of groups ``x3`` [B, S, d]:
    (expert ids [B, S, k], renormalised gates [B, S, k] fp32, aux loss,
    buffer slot of each lane [B, S * k] in token-major order, E * C for a
    dropped or pad lane, and the capacity C)."""
    B, S, _ = x3.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, S)
    logits = (x3 @ L.cast(p.router, x3.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                      # [B, S, E]
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_ids = top[..., :k], ids[..., :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)

    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    Tk = S * k
    flat_e = expert_ids.reshape(B, Tk)
    if valid3 is not None:
        lane_valid = valid3.repeat_interleave(k, dim=1)        # [B, S*k]
        flat_e = torch.where(lane_valid, flat_e, E)
    s_expert, order = torch.sort(flat_e, dim=1, stable=True)
    counts = torch.zeros(B, E + 1, dtype=torch.long, device=x3.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    counts = counts[:, :E]
    starts = torch.cumsum(counts, dim=1) - counts               # [B, E]
    lane = torch.arange(Tk, device=x3.device)[None, :]
    pos_in_e = lane - torch.gather(starts, 1, s_expert.clamp_max(E - 1))
    keep = (pos_in_e < C) & (s_expert < E)
    s_slot = torch.where(keep, s_expert * C + pos_in_e, E * C)
    # back to token-major lane order (order is a permutation of each row)
    slot = torch.empty_like(s_slot).scatter_(1, order, s_slot)
    return expert_ids, gate, aux, slot, C


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor,
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] (or [T, d]).  Returns (y, aux loss fp32).

    ``valid`` ([B, S] bool) excludes pad lanes from dispatch: they
    neither take expert capacity nor change a valid token's output.  A
    layer placed on a mesh runs the dispatch on plain tensors, its
    weights replicated (``rules.run_local``)."""
    if not is_placed(p.wi):
        return _moe_ffn(cfg, p, x, valid)

    def local(x, valid, router, wi, wg, wo):
        w = SimpleNamespace(router=router, wi=wi, wg=wg, wo=wo)
        return _moe_ffn(cfg, w, x, valid)

    return run_local(local, x, valid, p.router, p.wi, p.wg, p.wo, n_out=2)


def _moe_ffn(cfg: ModelConfig, p, x: torch.Tensor,
             valid: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = x.dtype
    orig_shape = x.shape
    d = orig_shape[-1]
    if x.dim() == 3 and x.shape[1] >= GROUP_ROW_TOKENS:
        x3, valid3 = x, valid
    else:
        x3 = x.reshape(1, -1, d)
        valid3 = None if valid is None else valid.reshape(1, -1)
    B, S, _ = x3.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    expert_ids, gate, aux, slot, C = route(cfg, p, x3, valid3)

    # dispatch: lane t * k + j carries token t to its slot (kept slots are
    # distinct; the scratch slot E * C behind the buffer is discarded)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros(B, E * C + 1, d, dtype=dt, device=x.device)
    buf[rows, slot] = x3.repeat_interleave(k, dim=1)
    xe = buf[:, :-1].reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)

    h = torch.bmm(xe, L.cast(p.wi, dt))
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.bmm(xe, L.cast(p.wg, dt))) * h
    elif cfg.mlp_act == "relu2":
        h = F.relu(h).square()
    elif cfg.mlp_act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown act {cfg.mlp_act}")
    out = torch.bmm(h, L.cast(p.wo, dt))                       # [E, B*C, d]
    out = out.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)

    # combine: gather each lane's output, zero the dropped ones, weight by
    # the gate (in the activation dtype, as the reference) and sum each
    # token's k lanes in top-k order
    keep = slot < E * C
    lanes = out[rows, slot.clamp_max(E * C - 1)]               # [B, S*k, d]
    lanes = torch.where(keep[..., None], lanes, 0.0)
    lanes = lanes * gate.reshape(B, S * k, 1).to(dt)
    y = lanes.reshape(B, S, k, d).sum(dim=2)
    return y.reshape(orig_shape), aux


def moe_block_forward(cfg: ModelConfig, p: MoEBlock, x: torch.Tensor,
                      positions: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None,
                      prefix_len: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    x = x + A.attention_full(cfg, p.attn, h, positions, cfg.sliding_window,
                             lengths, prefix_len)
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    y, aux = moe_ffn(cfg, p.moe, h)
    return x + y, aux


def moe_block_prefill(cfg: ModelConfig, p: MoEBlock, x: torch.Tensor,
                      positions: torch.Tensor, lengths: torch.Tensor,
                      capacity: int, prefix_len: int = 0):
    """Full-sequence forward that also returns the primed ring cache and
    the aux loss."""
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    q, k, v = A._qkv(cfg, p.attn, h, positions)
    cache = A.init_kv_cache(cfg, x.shape[0], capacity, x.dtype,
                            device=x.device)
    A.prefill_into_cache(cache, k, v, lengths)
    x = x + A.attention_full_qkv(cfg, p.attn, q, k, v, cfg.sliding_window,
                                 lengths, prefix_len)
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    y, aux = moe_ffn(cfg, p.moe, h)
    return x + y, cache, aux


def moe_block_extend(cfg: ModelConfig, p: MoEBlock, x: torch.Tensor,
                     cache, pos0: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     page_table: Optional[torch.Tensor] = None):
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    if "kp" in cache:                                   # paged pool layer
        y, cache = A.attention_extend_paged(cfg, p.attn, h, cache, pos0,
                                            cfg.sliding_window, page_table,
                                            valid)
    else:
        y, cache = A.attention_extend(cfg, p.attn, h, cache, pos0,
                                      cfg.sliding_window, valid)
    x = x + y
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    y, _ = moe_ffn(cfg, p.moe, h, valid=valid)
    return x + y, cache


def moe_block_decode(cfg: ModelConfig, p: MoEBlock, x: torch.Tensor,
                     cache, pos: torch.Tensor,
                     page_table: Optional[torch.Tensor] = None):
    """One token a row.  Every row is routed, idle batch slots included
    (the reference passes no ``valid`` here), so an idle slot's token can
    take expert capacity from a live one, as in the reference."""
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    if "kp" in cache:                                   # paged pool layer
        y, cache = A.attention_decode_paged(cfg, p.attn, h, cache, pos,
                                            page_table, cfg.sliding_window)
    else:
        y, cache = A.attention_decode(cfg, p.attn, h, cache, pos,
                                      cfg.sliding_window)
    x = x + y
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    y, _ = moe_ffn(cfg, p.moe, h)
    return x + y, cache
