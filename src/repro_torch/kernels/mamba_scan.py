"""Mamba-1 selective scan.

  dt:   [B, S, D]  f32   (post-softplus step sizes; 0 on pad lanes)
  Bm:   [B, S, N]  f32   (input matrix rows)
  Cm:   [B, S, N]  f32   (output matrix rows)
  x:    [B, S, D]  f32 or bf16 (post-conv activations)
  A:    [D, N]     f32   (negative state matrix)
  Dsk:  [D]        f32   (skip connection)
  h0:   [B, D, N]  f32   (state before token 0: prefix-cache extension)
  out:  y [B, S, D] f32 (including ``Dsk * x``), h_last [B, D, N] f32

Port of ``repro/kernels/mamba_scan.py``, the recurrence of every mamba
layer's prefill chunk, mixed step and decode step.  On a CUDA tensor the
call launches the hand-written Hopper kernel ``csrc/mamba_scan.cu`` (a
channel's N states spread over two lanes in registers, one at N 4, its
steps staged in shared memory by ``cp.async`` in groups that the chain
runs as they land; see the note at the top of the source) or raises; on
a CPU tensor it runs the plain PyTorch version, ``ref.mamba_scan_ref``.
Every operand but ``Dsk`` must be 16-byte aligned, as a fresh tensor is.
A lane with ``dt = 0`` leaves the state unchanged exactly, which is how
callers mask pad lanes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import mamba_scan_ref as plain

STATE_SIZES = (4, 8, 16)
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mamba_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               x: torch.Tensor, A: torch.Tensor, Dsk: torch.Tensor,
               h0: torch.Tensor):
    """Returns (y [B, S, D] f32, h_last [B, D, N] f32)."""
    if dt.device.type == "cpu":
        return plain(dt, Bm, Cm, x, A, Dsk, h0)
    cuda_lib.refuse_grad("mamba_scan", "A16c", dt, Bm, Cm, x, A, Dsk, h0)
    B, S, D = dt.shape
    N = A.shape[-1]
    shapes = {"dt": (dt, (B, S, D)), "Bm": (Bm, (B, S, N)),
              "Cm": (Cm, (B, S, N)), "x": (x, (B, S, D)), "A": (A, (D, N)),
              "Dsk": (Dsk, (D,)), "h0": (h0, (B, D, N))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_cuda or t.device != dt.device:
            raise ValueError("mamba_scan takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "Dsk" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name != "x" and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if x.dtype not in X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not in {STATE_SIZES}")
    y = torch.empty(B, S, D, dtype=torch.float32, device=dt.device)
    h = torch.empty(B, D, N, dtype=torch.float32, device=dt.device)
    cuda_lib.launch(
        "mamba_scan", X_DTYPES[x.dtype], dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), x.data_ptr(), A.data_ptr(), Dsk.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, D, N,
        torch.cuda.current_stream(dt.device).cuda_stream)
    return y, h
