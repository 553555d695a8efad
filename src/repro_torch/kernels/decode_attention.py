"""Ring-cache decode attention: one query token per request over a dense
ring of C slots.

  q:   [B, K, G, hd]        (single position, grouped-query layout)
  k,v: [B, C, K, hd]        (ring cache, C slots)
  tok: [B, C] int32         (absolute token held by each slot, -1 = empty)
  pos: [B] int32            (current position)
  out: [B, K, G, hd]

Port of ``repro/kernels/decode_attention.py``, the read of every attention
layer's decode step on a ring cache (``ServeConfig.paged_kv=False``, and
``TransformerLM.decode_step`` after ``prefill``).  On a CUDA tensor the
call launches the hand-written Hopper kernel ``csrc/decode_attention.cu``
(the ring of each (request, kv head) split into :func:`split_plan`'s
count of segments (``tuning``'s table for this card and shape, else
``cuda_lib.ring_splits``), a block each, that list the slots the query
may attend and stream only those, then a combine of the splits in split
order; see the note at the top of the source) or raises; on a CPU tensor
it runs the plain PyTorch version, ``ref.decode_attention_ref``.  Slot c
is valid iff ``tok >= 0`` and ``tok <= pos`` (and ``tok > pos - window``
with a window).  With
``k_scale``/``k_zero``/``v_scale`` ([B, C, K] float32 sidecars) the ring
is int8 and is dequantized inside the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib, tuning
from repro_torch.kernels.ref import decode_attention_ref as plain


def split_plan(device, B: int, K: int, C: int, hd: int):
    """``(splits, source)`` of a launch at these shapes on ``device``:
    ``tuning.splits("decode", ...)`` over a ring of ``C`` slots."""
    return tuning.splits("decode", device, b=B, k=K, slots=C, hd=hd)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     tok: torch.Tensor, pos: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     k_zero: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain(q, k, v, tok, pos, k_scale=k_scale, k_zero=k_zero,
                     v_scale=v_scale, window=window)
    cuda_lib.refuse_grad("decode_attention", "A16d", q, k, v, k_scale, k_zero,
                         v_scale)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, K, G, hd], got {tuple(q.shape)}")
    B, K, G, hd = q.shape
    if G > cuda_lib.MAX_DECODE_G:
        raise ValueError(f"ring decode takes G <= {cuda_lib.MAX_DECODE_G} "
                         "heads per group")
    C = k.shape[1] if k.dim() == 4 else -1
    code = cuda_lib.check_kv_inputs("ring", q, k, v, tok, pos, k_scale,
                                    k_zero, v_scale, (B, C))
    cuda_lib.check_smem(
        cuda_lib.smem_bytes(hd, cuda_lib.decode_rows(G), C), C)
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    splits, _ = split_plan(q.device, B, K, C, hd)
    out = torch.empty_like(q)
    part = torch.empty(cuda_lib.partials_shape(B, K, G, hd, splits),
                       dtype=torch.float32, device=q.device)
    cuda_lib.launch(
        "decode_attention", code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cuda_lib.pointer(k_scale), cuda_lib.pointer(k_zero),
        cuda_lib.pointer(v_scale), tok.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, K, G, hd, C, window or 0,
        splits, torch.cuda.current_stream(q.device).cuda_stream)
    return out
