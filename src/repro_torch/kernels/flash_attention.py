"""Flash attention: causal grouped-query attention over full sequences.

  q:       [B, H, S, hd]     (H = K * G query heads)
  k, v:    [B, K, S, hd]
  lengths: [B] int32         (optional: only tokens t < lengths[b] attend)
  out:     [B, H, S, hd]

Port of ``repro/kernels/flash_attention.py``, the attention of every layer
of ``TransformerLM.forward`` and ``.prefill``.  On a CUDA tensor the call
launches the hand-written Hopper kernel ``csrc/flash_attention.cu`` or
raises; on a CPU tensor it runs the plain PyTorch version,
``ref.flash_attention_ref``.  The kernel's body is chosen by dtype, not
as a fallback, and both run on the tensor cores: bfloat16
(``csrc/flash_tc.cuh``: wgmma for Q K^T and P V, two warpgroups per 128
query tokens of one head) and float32 (``csrc/flash_tf32.cuh``: the same
walk with each product as three TF32 wgmma products of the inputs split
into tf32 hi and lo, lo hi + hi lo + hi hi, which keeps about 2^-21 of
fp32 at an effective 165 TFLOP/s against 67 of FMA; V is split and
transposed on its way into shared memory, since TF32 operands must be
K-major); both walk only the keys between a tile's window start and its
diagonal.  See the notes at the top of the sources.
Token i attends j <= i (and j > i - window with a window, and j <
lengths[b] with lengths); with ``prefix_len`` P > 0 the first P tokens
also attend each other both ways (j <= i or both below P, still cut by
the window and the lengths): the bidirectional prefix of the VLM's image
patches and of whisper's encoder (P = S).  The output takes q's dtype.  A
row with no attendable token is zeros.

Gradients: on a CPU tensor autograd differentiates the plain version.  On
a CUDA tensor that needs a gradient (grad mode on and q, k or v requiring
one) the call goes through ``_FlashAttention``, an autograd function whose
forward is the same kernel launch and whose backward launches the
hand-written ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``;
plain version ``ref.flash_attention_bwd_ref``).  The forward launch then
also stores each row's log-sum-exp (``lse``, float32 [B, H, S], natural
log; plain version ``ref.flash_attention_ref(..., return_lse=True)``),
which the backward takes P from in both dtypes (on the tensor cores: a
dk/dv kernel a key tile and head group, a dq kernel a query tile; float32
as 3xTF32 products).  Without a gradient the call is the bare launch with
no lse, so serving steps and their CUDA-graph captures are unchanged.
The forward takes head dims 32, 64, 128, 192 and 256, the backward all
but 192 (``cuda_lib.BWD_HEAD_DIMS``): a CUDA call at hd 192 that needs a
gradient raises ValueError before it launches anything.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import flash_attention_bwd_ref
from repro_torch.kernels.ref import flash_attention_ref as plain


def _check(q, k, v, lengths, window, prefix_len=0, extra=()) -> int:
    """Validate a forward or backward launch; returns the dtype code."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, H, S, hd] and k [B, K, S, hd], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, S, hd = q.shape
    K = k.shape[1]
    tensors = [q, k, v, *extra] + ([] if lengths is None else [lengths])
    cuda_lib.check_operands("flash", tensors, q)
    code = cuda_lib.DTYPE_CODES.get((q.dtype, k.dtype))
    if code not in (0, 1) or v.dtype != k.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k "
                         f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in cuda_lib.HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {cuda_lib.HEAD_DIMS}")
    if H % K or k.shape != (B, K, S, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if any(t.shape != q.shape or t.dtype != q.dtype for t in extra):
        raise ValueError("o and its gradient must match q's shape and dtype")
    if lengths is not None and (lengths.dtype != torch.int32
                                or lengths.shape != (B,)):
        raise ValueError("lengths must be int32 [B]")
    # the kernels read q, k, v (and the backward o and its gradient) in
    # 16-byte chunks
    if any(t.data_ptr() % 16 for t in (q, k, v, *extra)):
        raise ValueError("q, k, v, o and its gradient must be 16-byte "
                         "aligned")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    _check_prefix(prefix_len, S)
    return code


def _check_bwd_head_dim(hd: int) -> None:
    """ValueError for a head dim the backward kernel is not built for, so
    that a call that needs a gradient is refused at its forward."""
    if hd not in cuda_lib.BWD_HEAD_DIMS:
        raise ValueError(
            f"the flash backward kernel takes head_dim in "
            f"{cuda_lib.BWD_HEAD_DIMS}, not {hd} (ROADMAP B3: 3b at hd "
            "192); call flash_attention under torch.no_grad(), or train on "
            "the CPU, where autograd differentiates its plain version")


def _check_prefix(prefix_len: int, S: int) -> None:
    if not 0 <= prefix_len <= S:
        raise ValueError(f"prefix_len must lie in [0, S = {S}], got "
                         f"{prefix_len}")


def _launch(q, k, v, window, lengths, with_lse=False, prefix_len=0):
    """The forward kernel: (out, lse), lse float32 [B, H, S] when
    ``with_lse``, else None."""
    code = _check(q, k, v, lengths, window, prefix_len)
    B, H, S, hd = q.shape
    K = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    cuda_lib.launch(
        "flash_attention", code, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), cuda_lib.pointer(lengths), out.data_ptr(),
        cuda_lib.pointer(lse), B, K, H // K, hd, S, window or 0, prefix_len,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        lse: Optional[torch.Tensor] = None,
                        window: Optional[int] = None,
                        lengths: Optional[torch.Tensor] = None,
                        prefix_len: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` at output ``o`` and
    output gradient ``do``, in the inputs' dtype: the kernel on a CUDA
    tensor, ``ref.flash_attention_bwd_ref`` on a CPU tensor (which
    recomputes every row's lse).  On the card it takes the forward's
    ``lse`` (float32 [B, H, S], ``_launch(..., with_lse=True)``) in both
    dtypes and raises without it."""
    if q.device.type == "cpu":
        _check_prefix(prefix_len, q.shape[2])
        return flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                       lengths=lengths, prefix_len=prefix_len)
    code = _check(q, k, v, lengths, window, prefix_len, extra=(o, do))
    B, H, S, hd = q.shape
    _check_bwd_head_dim(hd)
    K = k.shape[1]
    if lse is None:
        raise ValueError("the flash backward takes the forward's lse "
                         "(_launch(..., with_lse=True))")
    cuda_lib.check_operands("flash", [lse], q)
    if lse.dtype != torch.float32 or lse.shape != (B, H, S):
        raise ValueError(f"lse must be float32 {[B, H, S]}")
    # the fp32 body sums dk / dv on the tensor cores at hd 256: two heads
    # a group at most (cuda_lib.bwd_splits)
    splits = cuda_lib.bwd_splits(
        B, K, S, H // K,
        max_group=2 if q.dtype == torch.float32 and hd == 256 else None)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    part = (torch.empty(splits, 2, B, K, S, hd, dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    cuda_lib.launch(
        "flash_attention_bwd", code, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), do.data_ptr(), cuda_lib.pointer(lengths),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), cuda_lib.pointer(part), B, K, H // K, hd, S,
        window or 0, prefix_len, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (storing lse), differentiated by the backward
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, window, lengths, prefix_len=0):
        out, lse = _launch(q, k, v, window, lengths, with_lse=True,
                           prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.window, ctx.prefix_len = window, prefix_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(),
                                         lse=lse, window=ctx.window,
                                         lengths=lengths,
                                         prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    lengths: Optional[torch.Tensor] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    if q.device.type == "cpu":
        _check_prefix(prefix_len, q.shape[2])
        return plain(q, k, v, window=window, lengths=lengths,
                     prefix_len=prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _check_bwd_head_dim(q.shape[-1])
        return _FlashAttention.apply(q, k, v, window, lengths, prefix_len)
    return _launch(q, k, v, window, lengths, prefix_len=prefix_len)[0]
