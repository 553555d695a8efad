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
as a fallback: bfloat16 runs on the tensor cores (``csrc/flash_tc.cuh``:
wgmma for Q K^T and P V, two warpgroups per 128 query tokens of one
head), float32 on the CUDA cores (the staged walk of
``csrc/paged_common.cuh``: a block per (sequence, kv head, tile of query
rows of the G heads of that kv head)); both walk only the keys between a
tile's window start and its diagonal.  See the notes at the top of the
sources.
Token i attends j <= i (and j > i - window with a window, and j <
lengths[b] with lengths); the output takes q's dtype.  A row with no
attendable token is zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import flash_attention_ref as plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain(q, k, v, window=window, lengths=lengths)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, H, S, hd] and k [B, K, S, hd], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, S, hd = q.shape
    K = k.shape[1]
    tensors = [q, k, v] + ([] if lengths is None else [lengths])
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
    if lengths is not None and (lengths.dtype != torch.int32
                                or lengths.shape != (B,)):
        raise ValueError("lengths must be int32 [B]")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    out = torch.empty_like(q)
    cuda_lib.launch(
        "flash_attention", code, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), cuda_lib.pointer(lengths), out.data_ptr(), B, K,
        H // K, hd, S, window or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
