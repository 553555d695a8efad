"""Mamba-1 selective-state-space block (falcon-mamba-7b family); port of
``repro/models/mamba.py`` for the serving path.

Attention-free: the mixer is a depthwise causal conv + selective scan.
Each layer's serving state is a dense per-slot dict ``{"conv": [B, ck-1,
d_inner], "h": [B, d_inner, state]}`` that the extend and decode steps
update IN PLACE; full-sequence forward and prefill start from a zero
state.  The recurrence itself — the reference's chunked
associative scan over time, and its one-step decode update — goes through
``kernels/ops.mamba_scan``: the hand-written CUDA kernel on a card, its
sequential float32 plain version on the CPU; under grad mode its
autograd function, whose backward is the hand-written backward kernel.
That function keeps its own copy of ``h0``, since the mixers write the
new state into ``state["h"]`` right after the scan.  The scan's output
already includes the ``D * x`` skip term.

Pad lanes of a masked extend (``valid`` false) get ``dt = 0``, which makes
the recurrence the identity on them (exp(0) = 1, 0 * x * B = 0), so the
state after the step summarizes exactly the valid prefix — the reference
masks a = 1, b = 0 to the same effect.
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

State = Dict[str, torch.Tensor]


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        d, di, st, dtr, ck = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                              cfg.dt_rank, cfg.ssm_conv)
        self.ln = L.RMSNorm(d, dtype)
        self.in_proj = L.param((d, 2 * di), dtype, axes=("embed", "ff"))
        self.conv_w = L.param((ck, di), dtype, scale=0.5, axes=(None, "ff"))
        self.conv_b = L.param((di,), dtype, init="zeros", axes=("ff",))
        self.x_proj = L.param((di, dtr + 2 * st), dtype, axes=("ff", None))
        self.dt_proj = L.param((dtr, di), dtype, axes=(None, "ff"))
        self.dt_bias = L.param((di,), dtype, init="const",
                               scale=math.log(math.expm1(0.01)),
                               axes=("ff",))
        # A = -exp(A_log) and the skip D stay float32 for any param dtype
        self.A_log = L.param((di, st), torch.float32, init="const",
                             scale=0.0, axes=("ff", None))
        self.D = L.param((di,), torch.float32, init="ones", axes=("ff",))
        self.out_proj = L.param((di, d), dtype, axes=("ff", "embed"))


def mamba_cache_def(cfg: ModelConfig, batch: int, dtype: torch.dtype
                    ) -> Dict[str, L.LeafDef]:
    di, st, ck = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": L.LeafDef((batch, ck - 1, di), dtype,
                               ("batch", None, "ff")),
            "h": L.LeafDef((batch, di, st), torch.float32,
                            ("batch", "ff", None))}


def _causal_conv(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor,
                 init_state: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d continuing ``init_state``.  x: [B, S, di]."""
    ck, S = cfg.ssm_conv, x.shape[1]
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)     # [B, S+ck-1, di]
    w = L.cast(p.conv_w, x.dtype)                          # [ck, di]
    y = sum(xp[:, j:j + S] * w[j] for j in range(ck))
    return F.silu(y + L.cast(p.conv_b, x.dtype))


def _ssm_params(cfg: ModelConfig, p: MambaBlock, xc: torch.Tensor):
    """Input-dependent dt (float32, post-softplus) and B, C rows (in the
    activation dtype).  xc: [B, S, di] (post-conv)."""
    dtr, st = cfg.dt_rank, cfg.ssm_state
    proj = xc @ L.cast(p.x_proj, xc.dtype)
    dt_raw, Bmat, Cmat = torch.split(proj, [dtr, st, st], dim=-1)
    dt = dt_raw @ L.cast(p.dt_proj, xc.dtype)
    dt = F.softplus(dt.float() + L.cast(p.dt_bias, torch.float32))
    return dt, Bmat, Cmat


def _scan(cfg: ModelConfig, p: MambaBlock, xc: torch.Tensor,
          h0: torch.Tensor, valid: Optional[torch.Tensor]):
    """y [B, S, di] f32 (with the D skip) and the final state."""
    dt, Bmat, Cmat = _ssm_params(cfg, p, xc)
    if valid is not None:
        dt = torch.where(valid[:, :, None], dt, 0.0)
    A = -torch.exp(L.cast(p.A_log, torch.float32))         # [di, st]
    return run_local(ops.mamba_scan, dt.contiguous(),
                     Bmat.float().contiguous(), Cmat.float().contiguous(),
                     xc.contiguous(), A, L.cast(p.D, torch.float32), h0,
                     n_out=2)


def _conv_tail(cfg: ModelConfig, hist: torch.Tensor,
               valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The ck-1 conv inputs ending at each row's last processed token.
    hist: [B, (ck-1)+S, di]."""
    ck = cfg.ssm_conv
    if valid is not None:
        return L.conv_tail_at(hist, valid.sum(dim=1), ck)
    return hist[:, hist.shape[1] - (ck - 1):]


def mamba_mixer(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor,
                state: State, valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """x: [B, S, d] continuing ``state`` -> y [B, S, d]; ``state`` is
    advanced in place over the valid lanes ([B, S] ``valid``; all lanes
    when None)."""
    dt_ = x.dtype
    xb, z = (x @ L.cast(p.in_proj, dt_)).chunk(2, dim=-1)       # [B,S,di] each
    conv0 = state["conv"]
    xc = _causal_conv(cfg, p, xb, conv0)
    y, h_last = _scan(cfg, p, xc, state["h"], valid)
    y = y.to(dt_) * F.silu(z)
    out = y @ L.cast(p.out_proj, dt_)
    if cfg.ssm_conv > 1:
        hist = torch.cat([conv0.to(dt_), xb], dim=1)
        conv0.copy_(_conv_tail(cfg, hist, valid))
    state["h"].copy_(h_last)
    return out


def mamba_mixer_decode(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor,
                       state: State) -> torch.Tensor:
    """One-token step.  x: [B, 1, d]; ``state`` advanced in place."""
    dt_ = x.dtype
    xb, z = (x @ L.cast(p.in_proj, dt_)).chunk(2, dim=-1)       # [B,1,di]
    ck = cfg.ssm_conv
    conv_in = torch.cat([state["conv"].to(dt_), xb], dim=1)  # [B,ck,di]
    w = L.cast(p.conv_w, dt_)
    yc = sum(conv_in[:, j] * w[j] for j in range(ck))      # [B,di]
    xc = F.silu(yc + L.cast(p.conv_b, dt_))[:, None]       # [B,1,di]
    y, h = _scan(cfg, p, xc, state["h"], None)
    y = y.to(dt_) * F.silu(z)
    out = y @ L.cast(p.out_proj, dt_)
    state["conv"].copy_(conv_in[:, 1:])
    state["h"].copy_(h)
    return out


def mamba_block_prefill(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, State]:
    """Full-sequence forward from a zero state (a zero conv history, h0 =
    0); also returns the state after the last token."""
    state = {name: torch.zeros(shape, dtype=dt, device=x.device)
             for name, (shape, dt) in
             mamba_cache_def(cfg, x.shape[0], x.dtype).items()}
    return mamba_block_extend(cfg, p, x, state)


def mamba_block_forward(cfg: ModelConfig, p: MambaBlock,
                        x: torch.Tensor) -> torch.Tensor:
    return mamba_block_prefill(cfg, p, x)[0]


def mamba_block_extend(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor,
                       state: State, valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, State]:
    """Continue the recurrence from the cached state over a token suffix."""
    y = mamba_mixer(cfg, p, L.rmsnorm(p.ln.scale, x, cfg.norm_eps), state,
                    valid)
    return x + y, state


def mamba_block_decode(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor,
                       state: State) -> Tuple[torch.Tensor, State]:
    y = mamba_mixer_decode(cfg, p, L.rmsnorm(p.ln.scale, x, cfg.norm_eps),
                           state)
    return x + y, state
