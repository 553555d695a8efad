"""Shared neural layers and parameter initialisation (port of
``repro/models/layers.py``).

Parameters keep the reference's layouts and dtypes (``wq [d, H, hd]``,
``wi [d, ff]``, ...; stored in ``ModelConfig.param_dtype``) and are read in
the dtype each use site asks for, as in the JAX package; :func:`cast`
makes that copy once per parameter and dtype instead of at every use, so
no serving step re-casts a weight and a captured step allocates none.  Every
parameter carries its initialisation recipe (``normal`` scaled by
``fan_in ** -0.5``, ``zeros``, ``ones`` or ``const``), which
:func:`init_params` applies from an explicit ``torch.Generator``, and the
reference's logical axes (``axes``: ``embed``, ``heads``, ``ff``, ...;
one per dim), from which ``launch/sharding.py`` places it on a mesh.
Cache leaves are described by :class:`LeafDef`, which carries the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def param(shape, dtype=torch.float32, init: str = "normal",
          scale: float = 1.0,
          axes: Optional[Tuple[Optional[str], ...]] = None) -> nn.Parameter:
    """An uninitialised parameter tagged with its init recipe and its
    logical axes (None: no axis names, every dim replicated)."""
    axes = tuple(axes) if axes is not None else (None,) * len(shape)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {tuple(shape)}")
    p = nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)
    p.init = init
    p.init_scale = scale
    p.axes = axes
    return p


class LeafDef(tuple):
    """A tensor's ``(shape, dtype)`` pair with its logical axes as ``axes``
    (one per dim), as the reference's ``ParamDef`` describes a cache or
    optimizer-state leaf: it unpacks as the pair."""

    def __new__(cls, shape, dtype: torch.dtype,
                axes: Tuple[Optional[str], ...]):
        shape, axes = tuple(shape), tuple(axes)
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not match shape {shape}")
        self = super().__new__(cls, (shape, dtype))
        self.axes = axes
        return self

    @property
    def shape(self) -> Tuple[int, ...]:
        return self[0]

    @property
    def dtype(self) -> torch.dtype:
        return self[1]


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` from its recipe, in registration
    order.  The draws come from ``generator`` (float32 normals, then cast
    to the parameter's dtype), so one seed gives one model on any device."""
    for p in module.parameters():
        kind = getattr(p, "init", "normal")
        scale = getattr(p, "init_scale", 1.0)
        if kind == "zeros":
            p.zero_()
        elif kind == "ones":
            p.fill_(1.0)
        elif kind == "const":
            p.fill_(scale)
        else:
            fan_in = p.shape[-2] if p.dim() >= 2 else max(p.shape[-1], 1)
            x = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
            # scaled in place and freed before the next draw: one float32
            # temporary of one parameter's size at a time (17.6 GiB for
            # nemotron-4-340b's embedding, then its unembedding)
            p.copy_(x.mul_(scale / fan_in ** 0.5))
            del x
    return module


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``: ``w`` itself when it already is; for a parameter,
    a copy kept on it, one per dtype, made again when the parameter was
    written (its version counter moved: ``copy_``, ``load_state_dict``) or
    moved (its storage changed: ``Module.to``).  The copy holds the values
    ``w.to(dtype)`` gives; other tensors, and a parameter that autograd
    is tracking (grad mode on and ``requires_grad``: a kept copy would be
    detached from it, or hold a graph past its backward), are cast
    afresh."""
    if w.dtype == dtype:
        return w
    if not isinstance(w, nn.Parameter) or (w.requires_grad
                                           and torch.is_grad_enabled()):
        return w.to(dtype)
    casts = w.__dict__.setdefault("_casts", {})
    # a parameter placed on a mesh (a DTensor) is keyed by its local shard
    local = getattr(w, "_local_tensor", w)
    key = (local._version, local.data_ptr())
    hit = casts.get(dtype)
    if hit is None or hit[0] != key:
        hit = casts[dtype] = (key, w.to(dtype))
    return hit[1]


def conv_tail_at(hist: torch.Tensor, n_valid: torch.Tensor,
                 ck: int) -> torch.Tensor:
    """Gather the ck-1 causal-conv history entries ending at each row's
    last valid token (masked recurrent extends).  hist: [B, (ck-1)+S, W];
    returns [B, ck-1, W].  Shared by the mamba and RG-LRU mixers."""
    idx = n_valid.long()[:, None] + torch.arange(ck - 1,
                                                 device=hist.device)[None]
    return torch.gather(hist, 1, idx[:, :, None].expand(-1, -1,
                                                        hist.shape[2]))


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.scale = param((dim,), dtype, init="ones", axes=(None,))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise the last axis in float32; returns x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * cast(scale, torch.float32)).to(x.dtype)


def rmsnorm_heads(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS normalize over the head dim. scale: (head_dim,)."""
    return rmsnorm(scale, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply RoPE.  x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq                  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                         # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / squared-ReLU / GeLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str,
                 dtype=torch.float32):
        super().__init__()
        self.wi = param((d_model, d_ff), dtype, axes=("embed", "ff"))
        self.wo = param((d_ff, d_model), dtype, axes=("ff", "embed"))
        self.wg: Optional[nn.Parameter] = (
            param((d_model, d_ff), dtype, axes=("embed", "ff"))
            if act == "swiglu" else None)


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    h = x @ cast(p.wi, dt)
    if act == "swiglu":
        h = F.silu(x @ cast(p.wg, dt)) * h
    elif act == "relu2":
        h = F.relu(h).square()
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown act {act}")
    return h @ cast(p.wo, dt)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Rows of the [vocab, d] table for ``tokens``, in ``dtype``."""
    return table[tokens.long()].to(dtype)


def unembed(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ w`` for a [d, vocab] unembedding, in x's dtype."""
    return x @ cast(w, x.dtype)
