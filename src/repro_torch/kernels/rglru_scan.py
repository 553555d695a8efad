"""RG-LRU linear recurrence: ``h_t = a_t * h_{t-1} + b_t``.

  a, b: [B, S, W] f32 (decay / gated input, computed by the block; a = 1,
        b = 0 on pad lanes)
  h0:   [B, W]    f32
  out:  hs [B, S, W] f32, h_last [B, W] f32

Port of ``repro/kernels/rglru_scan.py``, the recurrence of every RG-LRU
layer's prefill chunk, mixed step and decode step.  On a CUDA tensor the
call launches the hand-written Hopper kernel ``csrc/rglru_scan.cu`` (one
thread per (request, channel), 32-step register tiles loaded one ahead
of the chain; see the note at the top of the source) or raises; on a CPU
tensor it runs the plain PyTorch version, ``ref.rglru_scan_ref``, with
which it agrees bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import rglru_scan_ref as plain


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Returns (hs [B, S, W] f32, h_last [B, W] f32)."""
    if a.device.type == "cpu":
        return plain(a, b, h0)
    cuda_lib.refuse_grad("rglru_scan", "A16c", a, b, h0)
    B, S, W = a.shape
    for name, t, shape in (("a", a, (B, S, W)), ("b", b, (B, S, W)),
                           ("h0", h0, (B, W))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_cuda or t.device != a.device:
            raise ValueError("rglru_scan takes CUDA tensors on one device")
        if not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be contiguous float32")
    hs = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    h = torch.empty(B, W, dtype=torch.float32, device=a.device)
    cuda_lib.launch(
        "rglru_scan", a.data_ptr(), b.data_ptr(), h0.data_ptr(),
        hs.data_ptr(), h.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    return hs, h
