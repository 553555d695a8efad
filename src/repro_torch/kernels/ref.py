"""Plain PyTorch versions of the port's kernels.

Ports of ``repro/kernels/ref.py``: ``flash_attention_ref`` (causal
full-sequence attention) and its gradient ``flash_attention_bwd_ref``
(which the reference leaves to JAX's autodiff and the port writes out),
``decode_attention_ref`` (one query over a dense ring cache),
``paged_decode_attention_ref`` and
``paged_extend_attention_ref`` (which gather each request's pages into a
dense logical ``[B, NP*ps, K, hd]`` view) all mask by absolute position
and softmax in float32 through :func:`masked_attention`;
``mamba_scan_ref`` and ``rglru_scan_ref`` run the two recurrences as
sequential float32 loops over time (``mamba_scan_states_ref`` returns the
mamba loop's state at tile boundaries, which the forward kernel keeps
for the backward), and ``mamba_scan_bwd_ref`` and ``rglru_scan_bwd_ref``
write out their gradients as reverse-time loops (the reference
differentiates XLA scans).  They are the CPU path of the port
(``kernels/ops.py``) and the oracles ``chip_smoke.py`` holds the CUDA
kernels against.

A query row with NO valid slot (an idle batch slot, a pad lane) follows
the JAX oracle in the paged versions: it softmaxes an all ``-1e30`` row
into the uniform average of the V rows it gathered, page 0's for each
unmapped table entry, which is what the TPU kernels give it and what an
MoE decode step routes for an idle slot.  The ring and full-sequence
versions give such a row zeros instead, on purpose: their CUDA kernels
never read slots no row may attend, and no caller reads those rows.
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


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, empty_mean: bool = False
                     ) -> torch.Tensor:
    """Softmax attention in float32 with an explicit mask.  q:
    [B,Sx,K,G,hd]; k/v: [B,T,K,hd] (float); valid: [B,Sx,T], may lane s
    attend slot t.  Returns [B,Sx,K,G,hd] in q's dtype; a lane with no
    valid slot is zeros, or (``empty_mean``) the mean of all T rows of v,
    as the JAX oracle's softmax of an all ``-1e30`` row gives it."""
    hd = q.shape[-1]
    s = torch.einsum("bskgd,btkd->bskgt", q.float(), k.float()) * hd ** -0.5
    valid = valid[:, :, None, None, :]                       # [B,Sx,1,1,T]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if not empty_mean:          # else masked slots of a live row give 0
        p = p * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bskgt,btkd->bskgd", p / l.clamp_min(1e-30), v.float())
    return o.to(q.dtype)


def _dequant(k, v, k_scale, k_zero, v_scale):
    """Float K/V of an fp or int8 cache (scales mark int8)."""
    if k_scale is None:
        return k, v
    return (kv_quant.dequantize_k(k, k_scale, k_zero),
            kv_quant.dequantize_v(v, v_scale))


def _in_window(t, pos, window):
    """Slot position(s) t attendable from query position(s) pos."""
    ok = t <= pos
    return ok if window is None else ok & (t > pos - window)


def _flash_valid(S, window, lengths, device, prefix_len=0) -> torch.Tensor:
    """[B or 1, S, S] bool: may query i attend key j.  The reference's
    mask: ``((j <= i) | (i < P & j < P)) & (j > i - window) & (j <
    lengths[b])`` with P = ``prefix_len``."""
    i = torch.arange(S, device=device)
    qi, kj = i[:, None], i[None, :]
    valid = kj <= qi
    if prefix_len:
        valid = valid | ((qi < prefix_len) & (kj < prefix_len))
    if window is not None:
        valid = valid & (kj > qi - window)
    valid = valid[None]                                      # [1,S,S]
    if lengths is not None:
        valid = valid & (i[None, None, :] < lengths.long()[:, None, None])
    return valid


def flash_attention_ref(q, k, v, *, window: Optional[int] = None,
                        lengths: Optional[torch.Tensor] = None,
                        return_lse: bool = False, prefix_len: int = 0):
    """q: [B,H,S,hd]; k/v: [B,K,S,hd] -> [B,H,S,hd].  Causal: token i
    attends j <= i (and j > i - window); with ``lengths`` ([B]) also only
    j < lengths[b]; with ``prefix_len`` P the first P tokens also attend
    each other both ways (j <= i or both below P, still cut by the window
    and the lengths) — the mask of the JAX ``attention_full_qkv``.  With
    ``return_lse``, returns (out, lse): lse float32 [B,H,S] is each row's
    log-sum-exp of its scaled scores q.k / sqrt(hd) over its valid keys,
    in natural-log units (``torch.logsumexp``'s), ``+inf`` for a row with
    none — the plain version of the bf16 kernel's lse output, which the
    backward kernel takes P from."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    valid = _flash_valid(S, window, lengths, q.device, prefix_len)
    q5 = q.reshape(B, K, H // K, S, hd).permute(0, 3, 1, 2, 4)
    o = masked_attention(q5, k.transpose(1, 2), v.transpose(1, 2),
                         valid.expand(B, S, S))
    o = o.permute(0, 2, 3, 1, 4).reshape(B, H, S, hd)
    if not return_lse:
        return o
    s = torch.einsum("bkgid,bkjd->bkgij",
                     q.float().reshape(B, K, H // K, S, hd),
                     k.float()) * hd ** -0.5
    valid = valid[:, None, None]                             # [B|1,1,1,S,S]
    lse = torch.logsumexp(s.masked_fill(~valid, -torch.inf), dim=-1)
    lse = lse.masked_fill(~valid.any(-1), torch.inf)
    return o, lse.reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, o, do, *, window: Optional[int] = None,
                            lengths: Optional[torch.Tensor] = None,
                            prefix_len: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` at output ``o``
    and output gradient ``do`` (both [B,H,S,hd]), written out in float32
    rather than taken by autograd: the scores are recomputed, ``lse`` is
    each row's log-sum-exp over its valid keys, ``D = rowsum(do * o)``,
    ``dS = P * (dP - D)``, and dK and dV are summed over the G query heads
    of each KV head.  Same mask as the forward; a query row with no valid
    key (``lengths`` 0) gets zero gradients, as the forward gives it
    zeros.  Returns the input dtypes."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    scale = hd ** -0.5
    valid = _flash_valid(S, window, lengths, q.device,
                         prefix_len)[:, None, None]
    qf = q.float().reshape(B, K, H // K, S, hd)
    dof = do.float().reshape(B, K, H // K, S, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgid,bkjd->bkgij", qf, kf) * scale
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    delta = (dof * o.float().reshape(B, K, H // K, S, hd)).sum(-1)
    dp = torch.einsum("bkgid,bkjd->bkgij", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgij,bkjd->bkgid", ds, kf) * scale
    dk = torch.einsum("bkgij,bkgid->bkjd", ds, qf) * scale
    dv = torch.einsum("bkgij,bkgid->bkjd", p, dof)
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q, k, v, tok, pos, *, k_scale=None, k_zero=None,
                         v_scale=None, window: Optional[int] = None
                         ) -> torch.Tensor:
    """q: [B,K,G,hd]; k/v: [B,C,K,hd] ring; tok: [B,C] absolute token of
    each slot (-1 = empty); pos: [B].  Slot c is valid iff tok >= 0 and
    tok <= pos (and tok > pos - window).  Scale sidecars ([B,C,K] f32)
    mark an int8 ring, dequantized here."""
    kf, vf = _dequant(k, v, k_scale, k_zero, v_scale)
    tok = tok.long()
    valid = (tok >= 0) & _in_window(tok, pos.long()[:, None], window)
    return masked_attention(q[:, None], kf, vf, valid[:, None])[:, 0]


def _paged_attend(q, k_pool, v_pool, page_table, pos_lane, k_scale, k_zero,
                  v_scale, window):
    """q: [B,Sx,K,G,hd]; pos_lane: [B,Sx] absolute position of each lane."""
    ps, NP = k_pool.shape[1], page_table.shape[1]
    kg, vg = _dequant(
        _gather(k_pool, page_table), _gather(v_pool, page_table),
        *(None if s is None else _gather(s, page_table)
          for s in (k_scale, k_zero, v_scale)))
    t = torch.arange(NP * ps, device=q.device)[None, None, :]
    mapped = torch.repeat_interleave(page_table >= 0, ps, dim=1)[:, None, :]
    valid = mapped & _in_window(t, pos_lane.long()[..., None], window)
    return masked_attention(q, kg, vg, valid, empty_mean=True)


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, pos, *,
                               k_scale=None, k_zero=None, v_scale=None,
                               window: Optional[int] = None) -> torch.Tensor:
    """q: [B,K,G,hd]; k/v_pool: [P,ps,K,hd]; page_table: [B,NP]; pos: [B].
    Slot ``t`` is valid iff its page is mapped, ``t <= pos`` and (with a
    window) ``t > pos - window``; a row with none gets the mean of its
    gathered V (an idle slot: page 0's).  Scale sidecar pools ([P,ps,K]
    f32) mark an int8 pool, dequantized here."""
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
    [B, D, N]), both float32.  h0 is copied, not aliased: callers write
    the returned state into it while autograd may still need it."""
    h = h0.float().clone()
    A, Dsk = A.float(), Dsk.float()
    ys = []
    for t in range(dt.shape[1]):
        dtt, xt = dt[:, t].float(), x[:, t].float()
        a = torch.exp(dtt[..., None] * A[None])                  # [B,D,N]
        h = a * h + (dtt * xt)[..., None] * Bm[:, t, None, :].float()
        y = torch.einsum("bdn,bn->bd", h, Cm[:, t].float())
        ys.append(y + Dsk[None] * xt)
    return torch.stack(ys, dim=1), h


def mamba_scan_states_ref(dt, Bm, x, A, h0, tile: int):
    """The state before every ``tile``-step tile of ``mamba_scan_ref``'s
    loop, [B, ceil(S / tile), D, N] float32: entry k is the state after
    the first k * tile tokens (entry 0 is h0), computed as that loop
    computes it.  The forward kernel stores these under training
    (``mamba_scan._launch(..., keep_states=True)``) and the backward kernel
    recomputes each tile from its entry."""
    h = h0.float().clone()
    A = A.float()
    states = []
    for t in range(dt.shape[1]):
        if t % tile == 0:
            states.append(h)
        dtt, xt = dt[:, t].float(), x[:, t].float()
        a = torch.exp(dtt[..., None] * A[None])                  # [B,D,N]
        h = a * h + (dtt * xt)[..., None] * Bm[:, t, None, :].float()
    return torch.stack(states, dim=1)


def mamba_scan_bwd_ref(dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last):
    """Gradients (d_dt, dBm, dCm, dx, dA, dDsk, dh0) of ``mamba_scan_ref``
    at output gradients ``dy`` [B, S, D] and ``dh_last`` [B, D, N],
    written out as a reverse-time loop in float32 rather than taken by
    autograd.  With ``a_t = exp(dt_t A)`` and ``g_t = dL/dh_t = dy_t C_t +
    a_{t+1} g_{t+1}`` (``g_{S-1} = dy_{S-1} C_{S-1} + dh_last``):
    ``dC_t = sum_d dy_t h_t``, ``dB_t = sum_d g_t dt_t x_t``, ``dx_t =
    dt_t sum_n g_t B_t + Dsk dy_t``, ``d_dt_t = sum_n g_t (A a_t h_{t-1} +
    x_t B_t)``, ``dA = sum_{b,t} g_t dt_t a_t h_{t-1}``, ``dDsk =
    sum_{b,t} dy_t x_t`` and ``dh0 = a_0 g_0``.  The states are recomputed
    from ``h0``.  dx takes x's dtype; the rest are float32."""
    S = dt.shape[1]
    A, Dsk = A.float(), Dsk.float()
    xf, dy = x.float(), dy.float()
    hs = [h0.float()]
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A[None])               # [B,D,N]
        hs.append(a * hs[-1] + (dt[:, t] * xf[:, t])[..., None]
                  * Bm[:, t, None, :])
    d_dt, dx = torch.empty_like(dt), torch.empty_like(xf)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    carry = dh_last.float()                               # a_{t+1} g_{t+1}
    for t in reversed(range(S)):
        dtt, xt, dyt = dt[:, t], xf[:, t], dy[:, t]
        a = torch.exp(dtt[..., None] * A[None])
        g = dyt[..., None] * Cm[:, t, None, :] + carry
        dCm[:, t] = torch.einsum("bd,bdn->bn", dyt, hs[t + 1])
        dBm[:, t] = torch.einsum("bdn,bd->bn", g, dtt * xt)
        dx[:, t] = dtt * torch.einsum("bdn,bn->bd", g, Bm[:, t]) \
            + Dsk[None] * dyt
        ah = a * hs[t]                                    # a_t h_{t-1}
        d_dt[:, t] = (g * (A[None] * ah + xt[..., None]
                           * Bm[:, t, None, :])).sum(-1)
        dA += (g * dtt[..., None] * ah).sum(0)
        carry = a * g
    dDsk = (dy * xf).sum((0, 1))
    return d_dt, dBm, dCm, dx.to(x.dtype), dA, dDsk, carry


def rglru_scan_ref(a, b, h0):
    """Sequential linear recurrence ``h_t = a_t * h_{t-1} + b_t``.
    a, b: [B, S, W] float32; h0: [B, W].  Returns (hs [B, S, W], h_last
    [B, W]); h0 is copied, as in ``mamba_scan_ref``."""
    h = h0.clone()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_bwd_ref(a, hs, h0, dhs, dh_last):
    """Gradients (da, db, dh0) of ``rglru_scan_ref`` at its output ``hs``
    and output gradients ``dhs`` [B, S, W] and ``dh_last`` [B, W], written
    out as a reverse-time loop: ``g_t = dhs_t + a_{t+1} g_{t+1}`` (``g_{S-1}
    = dhs_{S-1} + dh_last``), ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``),
    ``db_t = g_t`` and ``dh0 = a_0 g_0``.  Each product and each sum is
    rounded on its own, in this order, so that the CUDA kernel can give
    the same bits."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = dh_last                                       # a_{t+1} g_{t+1}
    for t in reversed(range(a.shape[1])):
        g = dhs[:, t] + carry
        da[:, t] = g * (hs[:, t - 1] if t else h0)
        db[:, t] = g
        carry = a[:, t] * g
    return da, db, carry
