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

Gradients: when grad mode is on and an input requires a gradient, the
call goes through ``_MambaScan``, an autograd function.  On CUDA tensors
its forward is the same kernel launch and its backward launches the
hand-written ``csrc/mamba_scan_bwd.cu`` (``mamba_scan_bwd``: the forward
recomputed from ``h0`` with its states kept at tile boundaries, then g
walked back through each tile; no atomics); on CPU tensors the plain
forward and the written-out ``ref.mamba_scan_bwd_ref``.  The function
keeps its own copy of ``h0``: the mixers write the new state into the
tensor they passed as ``h0`` right after the call.  Any other call is the
bare forward, so serving steps and their CUDA-graph captures are
unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import mamba_scan_bwd_ref
from repro_torch.kernels.ref import mamba_scan_ref as plain

STATE_SIZES = (4, 8, 16)
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_TILE = 16    # steps a backward block recomputes and keeps at once
BWD_CHANNELS = 64  # channels of a backward block (``kChannels``)


def _check(dt, Bm, Cm, x, A, Dsk, h0, extra=()) -> None:
    """Validate a forward or (with ``extra``: dy, dh_last) backward
    launch."""
    B, S, D = dt.shape
    N = A.shape[-1]
    shapes = {"dt": (dt, (B, S, D)), "Bm": (Bm, (B, S, N)),
              "Cm": (Cm, (B, S, N)), "x": (x, (B, S, D)), "A": (A, (D, N)),
              "Dsk": (Dsk, (D,)), "h0": (h0, (B, D, N))}
    if extra:
        shapes.update(dy=(extra[0], (B, S, D)), dh_last=(extra[1], (B, D, N)))
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


def _launch(dt, Bm, Cm, x, A, Dsk, h0):
    """The forward kernel: (y, h_last)."""
    _check(dt, Bm, Cm, x, A, Dsk, h0)
    B, S, D = dt.shape
    N = A.shape[-1]
    y = torch.empty(B, S, D, dtype=torch.float32, device=dt.device)
    h = torch.empty(B, D, N, dtype=torch.float32, device=dt.device)
    cuda_lib.launch(
        "mamba_scan", X_DTYPES[x.dtype], dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), x.data_ptr(), A.data_ptr(), Dsk.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, D, N,
        torch.cuda.current_stream(dt.device).cuda_stream)
    return y, h


def mamba_scan_bwd(dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last):
    """(d_dt, dBm, dCm, dx, dA, dDsk, dh0) of ``mamba_scan`` at output
    gradients ``dy`` [B, S, D] and ``dh_last`` [B, D, N] (float32): the
    kernel on CUDA tensors, ``ref.mamba_scan_bwd_ref`` on CPU tensors.  dx
    takes x's dtype, the rest float32.  The kernel's scratch: the state at
    every ``BWD_TILE``-step boundary, and float32 partial sums of dBm and
    dCm a block of ``BWD_CHANNELS`` channels and of dA and dDsk a
    sequence, which a second pass adds in a fixed order."""
    if dt.device.type == "cpu":
        return mamba_scan_bwd_ref(dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last)
    _check(dt, Bm, Cm, x, A, Dsk, h0, extra=(dy, dh_last))
    B, S, D = dt.shape
    N = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    d_dt, dx = torch.empty_like(dt), torch.empty_like(x)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dA, dDsk, dh0 = (torch.empty_like(A), torch.empty_like(Dsk),
                     torch.empty_like(h0))
    tiles = -(-S // BWD_TILE)
    blocks = -(-D // BWD_CHANNELS)
    states = torch.empty(B, tiles, D, N, **f32)
    part = torch.empty(B, S, blocks, 2, N, **f32)
    part_a, part_d = torch.empty(B, D, N, **f32), torch.empty(B, D, **f32)
    cuda_lib.launch(
        "mamba_scan_bwd", X_DTYPES[x.dtype], dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), x.data_ptr(), A.data_ptr(), Dsk.data_ptr(),
        h0.data_ptr(), dy.data_ptr(), dh_last.data_ptr(), d_dt.data_ptr(),
        dBm.data_ptr(), dCm.data_ptr(), dx.data_ptr(), dA.data_ptr(),
        dDsk.data_ptr(), dh0.data_ptr(), states.data_ptr(), part.data_ptr(),
        part_a.data_ptr(), part_d.data_ptr(), B, S, D, N,
        torch.cuda.current_stream(dt.device).cuda_stream)
    return d_dt, dBm, dCm, dx, dA, dDsk, dh0


class _MambaScan(torch.autograd.Function):
    """The forward kernel (or plain version), differentiated by the
    backward kernel (or written-out plain backward)."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A, Dsk, h0):
        cpu = dt.device.type == "cpu"
        y, h = (plain if cpu else _launch)(dt, Bm, Cm, x, A, Dsk, h0)
        # a copy: the caller writes the new state into h0 after the call
        ctx.save_for_backward(dt, Bm, Cm, x, A, Dsk, h0.clone())
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        return mamba_scan_bwd(*ctx.saved_tensors, dy.contiguous(),
                              dh_last.contiguous())


def mamba_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               x: torch.Tensor, A: torch.Tensor, Dsk: torch.Tensor,
               h0: torch.Tensor):
    """Returns (y [B, S, D] f32, h_last [B, D, N] f32)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, Bm, Cm, x, A, Dsk, h0)):
        return _MambaScan.apply(dt, Bm, Cm, x, A, Dsk, h0)
    if dt.device.type == "cpu":
        return plain(dt, Bm, Cm, x, A, Dsk, h0)
    return _launch(dt, Bm, Cm, x, A, Dsk, h0)
