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

Gradients: when grad mode is on and an input requires a gradient, the
call goes through ``_RGLRUScan``, an autograd function.  On CUDA tensors
its forward is the same kernel launch and its backward launches the
hand-written ``csrc/rglru_scan_bwd.cu`` (``rglru_scan_bwd``: one thread
per (request, channel) in reverse time, reading the forward's own ``hs``,
bit for bit with its plain version); on CPU tensors the plain forward and
the written-out ``ref.rglru_scan_bwd_ref``.  The function keeps its own
copy of ``h0``, which the mixers overwrite with the new state right after
the call.  Any other call is the bare forward, so serving steps and their
CUDA-graph captures are unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import rglru_scan_bwd_ref
from repro_torch.kernels.ref import rglru_scan_ref as plain


def _check(a, shapes) -> None:
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_cuda or t.device != a.device:
            raise ValueError("rglru_scan takes CUDA tensors on one device")
        if not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be contiguous float32")


def _launch(a, b, h0):
    """The forward kernel: (hs, h_last)."""
    B, S, W = a.shape
    _check(a, (("a", a, (B, S, W)), ("b", b, (B, S, W)),
               ("h0", h0, (B, W))))
    hs = torch.empty(B, S, W, dtype=torch.float32, device=a.device)
    h = torch.empty(B, W, dtype=torch.float32, device=a.device)
    cuda_lib.launch(
        "rglru_scan", a.data_ptr(), b.data_ptr(), h0.data_ptr(),
        hs.data_ptr(), h.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    return hs, h


def rglru_scan_bwd(a, hs, h0, dhs, dh_last):
    """(da, db, dh0) of ``rglru_scan`` at its output ``hs`` and output
    gradients ``dhs`` [B, S, W] and ``dh_last`` [B, W]: the kernel on CUDA
    tensors, ``ref.rglru_scan_bwd_ref`` on CPU tensors, bit for bit."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, hs, h0, dhs, dh_last)
    B, S, W = a.shape
    _check(a, (("a", a, (B, S, W)), ("hs", hs, (B, S, W)),
               ("h0", h0, (B, W)), ("dhs", dhs, (B, S, W)),
               ("dh_last", dh_last, (B, W))))
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), \
        torch.empty_like(h0)
    cuda_lib.launch(
        "rglru_scan_bwd", a.data_ptr(), hs.data_ptr(), h0.data_ptr(),
        dhs.data_ptr(), dh_last.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    return da, db, dh0


class _RGLRUScan(torch.autograd.Function):
    """The forward kernel (or plain version), differentiated by the
    backward kernel (or written-out plain backward)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        hs, h = (plain if a.device.type == "cpu" else _launch)(a, b, h0)
        # a copy: the caller writes the new state into h0 after the call
        ctx.save_for_backward(a, hs, h0.clone())
        return hs, h

    @staticmethod
    def backward(ctx, dhs, dh_last):
        return rglru_scan_bwd(*ctx.saved_tensors, dhs.contiguous(),
                              dh_last.contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Returns (hs [B, S, W] f32, h_last [B, W] f32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        return _RGLRUScan.apply(a, b, h0)
    if a.device.type == "cpu":
        return plain(a, b, h0)
    return _launch(a, b, h0)
