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
its forward is the same kernel launch, which then also stores the state
before every ``BWD_TILE``-step tile (``_launch(..., keep_states=True)``:
[B, ceil(S / BWD_TILE), D, N] float32, 67 MB at falcon-mamba-7b's
training shape; entry 0 is ``h0``), and its backward launches the
hand-written ``csrc/mamba_scan_bwd.cu`` (``mamba_scan_bwd``) on those
states: each tile's states recomputed from its boundary in registers, g
walked back through them, the sums over channels by warp shuffles and a
fixed-order pass over the blocks' partials; no atomics.  On CPU tensors
the plain forward and the written-out ``ref.mamba_scan_bwd_ref``, with
the function's own copy of ``h0`` (the mixers write the new state into
the tensor they passed as ``h0`` right after the call).  Any other call
is the bare forward, which stores no states, so serving steps and their
CUDA-graph captures are unchanged.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import mamba_scan_bwd_ref
from repro_torch.kernels.ref import mamba_scan_ref as plain

STATE_SIZES = (4, 8, 16)
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# steps between the states the forward keeps for the backward
# (``csrc/mamba_tile.cuh``'s ``kStateTile``, checked when cuda_lib loads)
BWD_TILE = cuda_lib.MAMBA_STATE_TILE
BWD_CHANNELS = 128   # channels of a backward block (``kChannels``)


def _check(dt, Bm, Cm, x, A, Dsk, **more) -> None:
    """Validate a launch: the forward's operands, and ``more`` of ``h0``,
    ``states``, ``dy`` and ``dh_last``."""
    B, S, D = dt.shape
    N = A.shape[-1]
    shapes = {"dt": (B, S, D), "Bm": (B, S, N), "Cm": (B, S, N),
              "x": (B, S, D), "A": (D, N), "Dsk": (D,), "h0": (B, D, N),
              "states": (B, -(-S // BWD_TILE), D, N), "dy": (B, S, D),
              "dh_last": (B, D, N)}
    tensors = dict(dt=dt, Bm=Bm, Cm=Cm, x=x, A=A, Dsk=Dsk, **more)
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
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


def _launch(dt, Bm, Cm, x, A, Dsk, h0, keep_states=False):
    """The forward kernel: (y, h_last), and with ``keep_states`` also the
    state before every ``BWD_TILE``-step tile, [B, ceil(S / BWD_TILE), D,
    N] float32 (``ref.mamba_scan_states_ref``), which the backward kernel
    starts its tiles from.  Without it the kernel stores no states."""
    _check(dt, Bm, Cm, x, A, Dsk, h0=h0)
    B, S, D = dt.shape
    N = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    y, h = torch.empty(B, S, D, **f32), torch.empty(B, D, N, **f32)
    states = (torch.empty(B, -(-S // BWD_TILE), D, N, **f32) if keep_states
              else None)
    cuda_lib.launch(
        "mamba_scan", X_DTYPES[x.dtype], dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), x.data_ptr(), A.data_ptr(), Dsk.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), cuda_lib.pointer(states),
        B, S, D, N, torch.cuda.current_stream(dt.device).cuda_stream)
    return (y, h) if states is None else (y, h, states)


def _pieces(device, *shapes):
    """Float32 tensors of the given shapes, consecutive views of one
    allocation."""
    sizes = [math.prod(shape) for shape in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return [piece.view(shape) for piece, shape in
            zip(buf.split(sizes), shapes)]


def mamba_scan_bwd(dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last, states=None):
    """(d_dt, dBm, dCm, dx, dA, dDsk, dh0) of ``mamba_scan`` at output
    gradients ``dy`` [B, S, D] and ``dh_last`` [B, D, N] (float32).  dx
    takes x's dtype, the rest float32.  On CPU tensors
    ``ref.mamba_scan_bwd_ref`` from ``h0``; on CUDA tensors the kernel,
    which starts its tiles from ``states``, the forward's
    (``_launch(..., keep_states=True)``; entry 0 is ``h0``, which it does
    not read).  The kernel's scratch: float32 partial sums of dBm and dCm a
    block of ``BWD_CHANNELS`` channels and of dA and dDsk a sequence, which
    a second pass adds in a fixed order.  The small gradients share one
    allocation, and so does the scratch (the host's time to enqueue the
    call is mostly allocations), each piece at a multiple of 16 bytes for
    the kernels' float4 stores."""
    if dt.device.type == "cpu":
        return mamba_scan_bwd_ref(dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last)
    if states is None:
        raise ValueError("mamba_scan_bwd on CUDA tensors takes the "
                         "forward's tile states")
    _check(dt, Bm, Cm, x, A, Dsk, states=states, dy=dy, dh_last=dh_last)
    B, S, D = dt.shape
    N = A.shape[-1]
    d_dt, dx = torch.empty_like(dt), torch.empty_like(x)
    dBm, dCm, dA, dh0, dDsk = _pieces(dt.device, (B, S, N), (B, S, N),
                                      (D, N), (B, D, N), (D,))
    part, part_a, part_d = _pieces(
        dt.device, (B, S, -(-D // BWD_CHANNELS), 2, N), (B, D, N), (B, D))
    cuda_lib.launch(
        "mamba_scan_bwd", X_DTYPES[x.dtype], dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), x.data_ptr(), A.data_ptr(), Dsk.data_ptr(),
        states.data_ptr(), dy.data_ptr(), dh_last.data_ptr(),
        d_dt.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), dx.data_ptr(),
        dA.data_ptr(), dDsk.data_ptr(), dh0.data_ptr(), part.data_ptr(),
        part_a.data_ptr(), part_d.data_ptr(), B, S, D, N,
        torch.cuda.current_stream(dt.device).cuda_stream)
    return d_dt, dBm, dCm, dx, dA, dDsk, dh0


class _MambaScan(torch.autograd.Function):
    """The forward kernel keeping its tile states (or the plain version),
    differentiated by the backward kernel on those states (or the
    written-out plain backward)."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A, Dsk, h0):
        if dt.device.type == "cpu":
            y, h = plain(dt, Bm, Cm, x, A, Dsk, h0)
            # a copy: the caller writes the new state into h0 after the call
            start = h0.clone()
        else:
            y, h, start = _launch(dt, Bm, Cm, x, A, Dsk, h0, keep_states=True)
        ctx.save_for_backward(dt, Bm, Cm, x, A, Dsk, start)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        # start: h0's copy on the CPU, the tile states on the card
        *args, start = ctx.saved_tensors
        dy, dh_last = dy.contiguous(), dh_last.contiguous()
        if dy.device.type == "cpu":
            return mamba_scan_bwd(*args, start, dy, dh_last)
        return mamba_scan_bwd(*args, start[:, 0], dy, dh_last, states=start)


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
