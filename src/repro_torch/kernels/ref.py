"""Plain PyTorch versions of the port's kernels.

Ports of ``repro/kernels/ref.py``: ``paged_decode_attention_ref`` and
``paged_extend_attention_ref`` gather each request's pages into a dense
logical ``[B, NP*ps, K, hd]`` view, mask by absolute position and
softmax in float32; ``mamba_scan_ref`` and ``rglru_scan_ref`` run the two
recurrences as sequential float32 loops over time.  They are the CPU
path of the port (``kernels/ops.py``) and the oracles ``chip_smoke.py``
holds the CUDA kernels against.

One rule differs from the JAX oracle, on purpose: a query row with NO
valid slot (an empty batch slot, a pad lane) comes out as zeros.  The JAX
oracle softmaxes an all ``-1e30`` row into a uniform average of whatever
pages the row maps; the CUDA kernels skip unmapped pages and pages wholly
past ``pos``, so they cannot reproduce that average, and a zero row is
finite where an empty softmax would be NaN.  Rows with at least one valid
slot are unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import kv_quant

NEG_INF = -1e30


def _gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[P, ps, ...] pool + [B, NP] table -> dense logical [B, NP*ps, ...];
    unmapped entries (-1) gather page 0 and are masked by the caller."""
    B, NP = page_table.shape
    g = pool[page_table.clamp_min(0).long()]               # [B,NP,ps,...]
    return g.reshape(B, NP * pool.shape[1], *pool.shape[2:])


def _paged_attend(q, k_pool, v_pool, page_table, pos_lane, k_scale, k_zero,
                  v_scale, window):
    """q: [B,Sx,K,G,hd]; pos_lane: [B,Sx] absolute position of each lane."""
    B, Sx, K, G, hd = q.shape
    ps, NP = k_pool.shape[1], page_table.shape[1]
    kg, vg = _gather(k_pool, page_table), _gather(v_pool, page_table)
    if k_scale is not None:
        kg = kv_quant.dequantize_k(kg, _gather(k_scale, page_table),
                                   _gather(k_zero, page_table))
        vg = kv_quant.dequantize_v(vg, _gather(v_scale, page_table))
    s = torch.einsum("bskgd,btkd->bskgt", q.float(), kg.float()) * hd ** -0.5
    t = torch.arange(NP * ps, device=q.device)[None, None, :]
    mapped = torch.repeat_interleave(page_table >= 0, ps, dim=1)[:, None, :]
    pl = pos_lane.long()[..., None]                          # [B,Sx,1]
    valid = mapped & (t <= pl)
    if window is not None:
        valid = valid & (t > pl - window)
    valid = valid[:, :, None, None, :]                       # [B,Sx,1,1,T]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bskgt,btkd->bskgd", p / l.clamp_min(1e-30), vg.float())
    return o.to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, pos, *,
                               k_scale=None, k_zero=None, v_scale=None,
                               window: Optional[int] = None) -> torch.Tensor:
    """q: [B,K,G,hd]; k/v_pool: [P,ps,K,hd]; page_table: [B,NP]; pos: [B].
    Slot ``t`` is valid iff its page is mapped, ``t <= pos`` and (with a
    window) ``t > pos - window``.  Scale sidecar pools ([P,ps,K] f32) mark
    an int8 pool, dequantized here."""
    return _paged_attend(q[:, None], k_pool, v_pool, page_table, pos[:, None],
                         k_scale, k_zero, v_scale, window)[:, 0]


def paged_extend_attention_ref(q, k_pool, v_pool, page_table, pos0, *,
                               k_scale=None, k_zero=None, v_scale=None,
                               window: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sx,K,G,hd]; pos0: [B], the absolute position of lane 0.  Lane
    ``l`` attends every mapped slot ``t <= pos0 + l`` (minus the window):
    the per-lane staircase mask of ``attention_extend_paged``."""
    Sx = q.shape[1]
    pos_lane = pos0.long()[:, None] + torch.arange(Sx, device=q.device)
    return _paged_attend(q, k_pool, v_pool, page_table, pos_lane,
                         k_scale, k_zero, v_scale, window)


def mamba_scan_ref(dt, Bm, Cm, x, A, Dsk, h0):
    """Sequential Mamba-1 selective scan, float32.

    dt, x: [B, S, D]; Bm, Cm: [B, S, N]; A: [D, N]; Dsk: [D]; h0:
    [B, D, N].  ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t`` and
    ``y_t = h_t . C_t + Dsk * x_t``.  Returns (y [B, S, D], h_last
    [B, D, N]), both float32."""
    h = h0.float()
    A, Dsk = A.float(), Dsk.float()
    ys = []
    for t in range(dt.shape[1]):
        dtt, xt = dt[:, t].float(), x[:, t].float()
        a = torch.exp(dtt[..., None] * A[None])                  # [B,D,N]
        h = a * h + (dtt * xt)[..., None] * Bm[:, t, None, :].float()
        y = torch.einsum("bdn,bn->bd", h, Cm[:, t].float())
        ys.append(y + Dsk[None] * xt)
    return torch.stack(ys, dim=1), h


def rglru_scan_ref(a, b, h0):
    """Sequential linear recurrence ``h_t = a_t * h_{t-1} + b_t``.
    a, b: [B, S, W] float32; h0: [B, W].  Returns (hs [B, S, W], h_last
    [B, W])."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
