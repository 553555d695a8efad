"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427);
port of ``repro/models/rglru.py`` for the serving path.

Block = [RMSNorm -> dual linear branches -> causal conv (x-branch) ->
RG-LRU recurrence -> gated merge -> out-proj] + MLP sub-block.  The 2:1
recurrent : local-attention interleave is the block pattern; ``rg_attn``
blocks are attention blocks with ``local_window`` (models/attention.py).

Each layer's serving state is a dense per-slot dict ``{"conv": [B, 3, w],
"h": [B, w]}`` updated IN PLACE; full-sequence forward and prefill start
from a zero state.  The gates run in PyTorch in float32 with
float32 weight casts, as in the reference; the recurrence ``h_t = a_t *
h_{t-1} + b_t`` goes through ``kernels/ops.rglru_scan`` (the CUDA kernel
on a card, its plain version on the CPU; under grad mode its autograd
function with the backward kernel, which keeps its own copy of ``h0``:
the mixers overwrite ``state["h"]`` right after the call).  Pad lanes
are masked to a = 1,
b = 0 before the scan, so the state summarizes exactly the valid prefix.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.rules import run_local
from repro_torch.models import layers as L

RG_C = 8.0
CONV_K = 4

State = Dict[str, torch.Tensor]


class RGLRUBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        # Lambda init so that a = exp(-c*softplus(L)) lands in (0.9, 0.999).
        lam_init = math.log(math.expm1(-math.log(0.97) / RG_C))
        self.ln = L.RMSNorm(d, dtype)
        self.in_x = L.param((d, w), dtype, axes=("embed", "ff"))
        self.in_y = L.param((d, w), dtype, axes=("embed", "ff"))
        self.conv_w = L.param((CONV_K, w), dtype, scale=0.5,
                              axes=(None, "ff"))
        self.conv_b = L.param((w,), dtype, init="zeros", axes=("ff",))
        self.w_input_gate = L.param((w, w), dtype, scale=0.5,
                                    axes=("ff", None))
        self.w_rec_gate = L.param((w, w), dtype, scale=0.5,
                                  axes=("ff", None))
        self.lam = L.param((w,), torch.float32, init="const", scale=lam_init,
                           axes=("ff",))
        self.out = L.param((w, d), dtype, axes=("ff", "embed"))
        self.ln2 = L.RMSNorm(d, dtype)
        self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp_act, dtype)


def rglru_cache_def(cfg: ModelConfig, batch: int, dtype: torch.dtype
                    ) -> Dict[str, L.LeafDef]:
    w = cfg.lru_width
    return {"conv": L.LeafDef((batch, CONV_K - 1, w), dtype,
                               ("batch", None, "ff")),
            "h": L.LeafDef((batch, w), torch.float32, ("batch", "ff"))}


def _conv(p: RGLRUBlock, x: torch.Tensor,
          init_state: torch.Tensor) -> torch.Tensor:
    S = x.shape[1]
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    w = L.cast(p.conv_w, x.dtype)
    return (sum(xp[:, j:j + S] * w[j] for j in range(CONV_K))
            + L.cast(p.conv_b, x.dtype))


def _rg_gates(p: RGLRUBlock, xc: torch.Tensor):
    """Decay a_t and gated input b_t of the recurrence, float32."""
    xf = xc.float()
    i_gate = torch.sigmoid(xf @ L.cast(p.w_input_gate, torch.float32))
    r_gate = torch.sigmoid(xf @ L.cast(p.w_rec_gate, torch.float32))
    lam = L.cast(p.lam, torch.float32)
    log_a = -RG_C * F.softplus(lam) * r_gate               # [B,S,w]
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via log
    b_scale = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                         1e-12))
    return a, b_scale * i_gate * xf


def rglru_mixer(cfg: ModelConfig, p: RGLRUBlock, x: torch.Tensor,
                state: State, valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """x: [B, S, d] continuing ``state`` -> [B, S, d]; ``state`` is
    advanced in place over the valid lanes ([B, S] ``valid``; all lanes
    when None)."""
    dt_ = x.dtype
    xb = x @ L.cast(p.in_x, dt_)
    yb = x @ L.cast(p.in_y, dt_)
    conv0 = state["conv"]
    a, b = _rg_gates(p, _conv(p, xb, conv0))
    if valid is not None:
        m = valid[:, :, None]
        a = torch.where(m, a, 1.0)
        b = torch.where(m, b, 0.0)
    hs, h_last = run_local(ops.rglru_scan, a.contiguous(), b.contiguous(),
                           state["h"], n_out=2)
    y = hs.to(dt_) * F.gelu(yb, approximate="tanh")
    out = y @ L.cast(p.out, dt_)
    hist = torch.cat([conv0.to(dt_), xb], dim=1)
    if valid is not None:
        conv0.copy_(L.conv_tail_at(hist, valid.sum(dim=1), CONV_K))
    else:
        conv0.copy_(hist[:, hist.shape[1] - (CONV_K - 1):])
    state["h"].copy_(h_last)
    return out


def rglru_mixer_decode(cfg: ModelConfig, p: RGLRUBlock, x: torch.Tensor,
                       state: State) -> torch.Tensor:
    """One-token step.  x: [B, 1, d]; ``state`` advanced in place."""
    dt_ = x.dtype
    xb = x @ L.cast(p.in_x, dt_)                                # [B,1,w]
    yb = x @ L.cast(p.in_y, dt_)
    conv_in = torch.cat([state["conv"].to(dt_), xb], dim=1)
    w = L.cast(p.conv_w, dt_)
    xc = (sum(conv_in[:, j] * w[j] for j in range(CONV_K))
          + L.cast(p.conv_b, dt_))                              # [B,w]
    a, b = _rg_gates(p, xc[:, None])
    hs, h = run_local(ops.rglru_scan, a, b, state["h"], n_out=2)
    y = hs.to(dt_) * F.gelu(yb, approximate="tanh")
    out = y @ L.cast(p.out, dt_)
    state["conv"].copy_(conv_in[:, 1:])
    state["h"].copy_(h)
    return out


def _mlp_sub_block(cfg: ModelConfig, p: RGLRUBlock,
                   x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    return x + L.mlp(p.mlp, h, cfg.mlp_act)


def rglru_block_prefill(cfg: ModelConfig, p: RGLRUBlock, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, State]:
    """Full-sequence forward from a zero state (a zero conv history, h0 =
    0); also returns the state after the last token."""
    state = {name: torch.zeros(shape, dtype=dt, device=x.device)
             for name, (shape, dt) in
             rglru_cache_def(cfg, x.shape[0], x.dtype).items()}
    return rglru_block_extend(cfg, p, x, state)


def rglru_block_forward(cfg: ModelConfig, p: RGLRUBlock,
                        x: torch.Tensor) -> torch.Tensor:
    return rglru_block_prefill(cfg, p, x)[0]


def rglru_block_extend(cfg: ModelConfig, p: RGLRUBlock, x: torch.Tensor,
                       state: State, valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, State]:
    x = x + rglru_mixer(cfg, p, L.rmsnorm(p.ln.scale, x, cfg.norm_eps),
                        state, valid)
    return _mlp_sub_block(cfg, p, x), state


def rglru_block_decode(cfg: ModelConfig, p: RGLRUBlock, x: torch.Tensor,
                       state: State) -> Tuple[torch.Tensor, State]:
    x = x + rglru_mixer_decode(cfg, p, L.rmsnorm(p.ln.scale, x,
                                                  cfg.norm_eps), state)
    return _mlp_sub_block(cfg, p, x), state
