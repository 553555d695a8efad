"""Paged decode attention: one query token per request over a paged KV pool.

  q:          [B, K, G, hd]        (single position, grouped-query layout)
  k_pool:     [P, ps, K, hd]       (shared page pool, P physical pages)
  v_pool:     [P, ps, K, hd]
  page_table: [B, NP] int32        (logical page -> physical page, -1 = unmapped)
  pos:        [B] int32            (current absolute position)
  out:        [B, K, G, hd]

Port of ``repro/kernels/paged_attention.py``.  On a CUDA tensor the call
launches the hand-written Hopper kernel ``csrc/paged_decode.cu`` (the
attendable range of each (request, kv head) split into
``cuda_lib.paged_splits`` segments of whole stages, a block each walking
its segment of the page table, then a combine of the splits in split
order; see the note at the top of the source) or raises; on a CPU tensor
it runs the plain PyTorch version, ``ref.paged_decode_attention_ref``.  With
``k_scale``/``k_zero``/``v_scale`` ([P, ps, K] float32 sidecar pools) the
pools are int8 and are dequantized inside the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import paged_decode_attention_ref as plain


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           k_zero: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, page_table, pos, k_scale=k_scale,
                     k_zero=k_zero, v_scale=v_scale, window=window)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, K, G, hd], got {tuple(q.shape)}")
    B, K, G, hd = q.shape
    if G > cuda_lib.MAX_DECODE_G:
        raise ValueError(f"paged decode takes G <= {cuda_lib.MAX_DECODE_G} "
                         "heads per group")
    code = cuda_lib.check_kv_inputs(
        "paged", q, k_pool, v_pool, page_table, pos, k_scale, k_zero,
        v_scale, k_pool.shape[:2])
    ps, NP = k_pool.shape[1], page_table.shape[1]
    cuda_lib.check_smem(
        cuda_lib.smem_bytes(hd, cuda_lib.decode_rows(G), NP), NP)
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    splits = cuda_lib.paged_splits(B, K, 1, NP * ps, hd)
    out = torch.empty_like(q)
    part = torch.empty(cuda_lib.partials_shape(B, K, G, hd, splits),
                       dtype=torch.float32, device=q.device)
    cuda_lib.launch(
        "paged_decode", code, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), cuda_lib.pointer(k_scale),
        cuda_lib.pointer(k_zero), cuda_lib.pointer(v_scale),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, K, G, hd, ps, NP, window or 0, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
