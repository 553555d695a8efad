"""Paged extend/verify attention: Sx query lanes over a paged KV pool.

  q:          [B, Sx, K, G, hd]    (lane l sits at absolute pos0[b] + l)
  k_pool:     [P, ps, K, hd]       (shared page pool, P physical pages)
  v_pool:     [P, ps, K, hd]
  page_table: [B, NP] int32        (logical page -> physical page, -1 = unmapped)
  pos0:       [B] int32            (absolute position of lane 0)
  out:        [B, Sx, K, G, hd]

Port of ``repro/kernels/paged_extend.py``, the kernel behind every
chunked-prefill chunk, mixed step and speculative verify step.  On a CUDA
tensor the call launches the hand-written Hopper kernel
``csrc/paged_extend.cu`` or raises: bf16 q runs on the tensor cores
(wgmma on tiles of 64 or 128 of the Sx*G rows, key tiles gathered from
the page table), float32 q on the fp32 staged walk; either way each
tile's attendable range is split into :func:`split_plan`'s count of
segments (``tuning``'s table for this card and shape, else
``cuda_lib.paged_splits``), a block each, combined in split order (see
the note at the top of the source).  On a CPU tensor it runs the plain
PyTorch version, ``ref.paged_extend_attention_ref``.  Lane l attends
slot t iff its page is mapped and ``t <= pos0 + l`` (and
``t > pos0 + l - window`` with a window).  Scale sidecar pools
([P, ps, K] float32) select the int8 variant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib, tuning
from repro_torch.kernels.ref import paged_extend_attention_ref as plain


def split_plan(device, B: int, Sx: int, K: int, G: int, hd: int,
               n_slots: int, code: int):
    """``(splits, source)`` of a launch at these shapes on ``device``,
    with kernel dtype ``code`` (``cuda_lib.DTYPE_CODES``), which sets the
    row tile (``cuda_lib.extend_rows``): ``tuning.splits("paged_extend",
    ...)`` over the Sx * G rows' tiles and a table of ``n_slots`` slots."""
    tiles = -(-Sx * G // cuda_lib.extend_rows(hd, Sx * G, code))
    return tuning.splits("paged_extend", device, b=B, k=K, tiles=tiles,
                         slots=n_slots, hd=hd)


def paged_extend_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           pos0: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           k_zero: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, page_table, pos0, k_scale=k_scale,
                     k_zero=k_zero, v_scale=v_scale, window=window)
    cuda_lib.refuse_grad("paged_extend", "A16d", q, k_pool, v_pool, k_scale, k_zero,
                         v_scale)
    if q.dim() != 5:
        raise ValueError(f"q must be [B, Sx, K, G, hd], got {tuple(q.shape)}")
    B, Sx, K, G, hd = q.shape
    code = cuda_lib.check_kv_inputs(
        "paged", q, k_pool, v_pool, page_table, pos0, k_scale, k_zero,
        v_scale, k_pool.shape[:2])
    ps, NP = k_pool.shape[1], page_table.shape[1]
    rows = cuda_lib.extend_rows(hd, Sx * G, code)
    smem = (cuda_lib.tc_smem_bytes if code in cuda_lib.TC_CODES
            else cuda_lib.smem_bytes)(hd, rows, NP)
    cuda_lib.check_smem(smem, NP)
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    splits, _ = split_plan(q.device, B, Sx, K, G, hd, NP * ps, code)
    out = torch.empty_like(q)
    part = torch.empty(cuda_lib.partials_shape(B, K, Sx * G, hd, splits),
                       dtype=torch.float32, device=q.device)
    cuda_lib.launch(
        "paged_extend", code, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), cuda_lib.pointer(k_scale),
        cuda_lib.pointer(k_zero), cuda_lib.pointer(v_scale),
        page_table.data_ptr(), pos0.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, Sx, K, G, hd, ps, NP, window or 0, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
