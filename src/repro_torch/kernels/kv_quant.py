"""int8 KV-cache quantization math (port of ``repro/kernels/kv_quant.py``).

Granularity is per cache slot per kv head (reduction over the head dim):

  * K — asymmetric: q = round((k - min) / scale) - 128,
        scale = (max - min) / 255, zero = min;
  * V — symmetric:  q = round(v / scale), scale = amax / 127.

Scales and zeros are float32 sidecars shaped like the cache minus the head
dim.  ``torch.round`` rounds half to even like ``jnp.round``, and every
step is the same float32 operation in the same order as the reference, so
on identical float32 input the int8 payload and the scales are
bit-identical to the JAX package's: replaying tokens after a preemption or
through another chunking reproduces the same pages.  The CUDA kernels
dequantize in registers with exactly :func:`dequantize_k` and
:func:`dequantize_v`.
"""
from __future__ import annotations

from typing import Tuple

import torch

# Guard for degenerate (constant / all-zero) slot-head rows: keeps the
# scale strictly positive so dequant maps q -> exactly the constant.
EPS = 1e-6


def quantize_k(k: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k: [..., hd] float -> (q int8 [..., hd], scale f32 [...], zero f32 [...])."""
    kf = k.float()
    kmin = kf.amin(dim=-1)
    kmax = kf.amax(dim=-1)
    scale = torch.clamp_min(kmax - kmin, EPS) / 255.0
    q = torch.round((kf - kmin[..., None]) / scale[..., None]) - 128.0
    q = torch.clamp(q, -128, 127).to(torch.int8)
    return q, scale, kmin


def dequantize_k(q: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_k`; returns float32."""
    return (q.float() + 128.0) * scale[..., None] + zero[..., None]


def quantize_v(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: [..., hd] float -> (q int8 [..., hd], scale f32 [...])."""
    vf = v.float()
    scale = torch.clamp_min(vf.abs().amax(dim=-1), EPS) / 127.0
    q = torch.clamp(torch.round(vf / scale[..., None]), -128, 127)
    return q.to(torch.int8), scale


def dequantize_v(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_v`; returns float32."""
    return q.float() * scale[..., None]
