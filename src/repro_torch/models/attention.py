"""GQA attention blocks: full-sequence (forward / prefill), and decode and
extend steps over a ring KV cache or a paged KV pool (port of
``repro/models/attention.py``).

Full-sequence attention (``attention_full_qkv``) goes through
``ops.flash_attention`` whatever the sequence length: the reference's
split at ``ATTN_CHUNK`` chooses between two XLA forms of one function.

Ring layout per attention layer: ``{"k": [B, C, K, hd], "v": [B, C, K,
hd], "tok": [B, C] int32}`` where C is the capacity (a ring when a window
is active) and ``tok`` holds the absolute token in each slot (-1 =
empty), so windowed and ring masking is exact; with ``kv_dtype="int8"``
K/V are int8 with float32 sidecars ``ks``/``kz``/``vs`` ([B, C, K]).
Decode reads the ring through ``ops.decode_attention``; the multi-lane
extend read has no kernel in the JAX package either (it is XLA there) and
stays plain PyTorch here.

Paged layout per attention layer: a dict ``{"kp": [P, ps, K, hd], "vp":
[P, ps, K, hd]}`` — a pool of P physical pages of ps tokens each, shared
by every request — plus, with ``kv_dtype="int8"``, int8 pools and float32
scale sidecar pools ``ksp``/``kzp``/``vsp`` ([P, ps, K]; asymmetric K,
symmetric V — kernels/kv_quant.py).  Each request owns a page table row
mapping logical page (position // ps) to a physical page (-1 = unmapped),
so masking is position arithmetic.

Rings and pools are updated IN PLACE (``index_put_``), where the JAX
package rebuilt them functionally and donated the old buffers.  The order
inside a step is unchanged: each layer writes its new K/V rows first and
then reads the post-write cache, which is what lets a speculative verify
step write drafted tokens before knowing whether they are accepted —
every read masks by absolute position and every step rewrites positions
from the committed frontier before attending.  Lanes whose page is
unmapped, pad lanes, and ring lanes that a later lane of the same block
overwrites go to a scratch slot that the storage of every K/V leaf holds
behind the leaf (``empty_cache``), where the reference routed them to a
scratch slot or past the pool and relied on ``mode="drop"``.  So no write
reads a tensor on the host, and a serving step can be captured as a CUDA
graph.

The reads go through ``kernels/ops.py``: the hand-written CUDA kernels on
a CUDA device, their plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import kv_quant as Q
from repro_torch.kernels import ops
from repro_torch.kernels.ref import masked_attention
from repro_torch.launch.rules import (is_placed, is_replicated, run_local,
                                      shard_box)
from repro_torch.models import layers as L

Pool = Dict[str, torch.Tensor]
Ring = Dict[str, torch.Tensor]


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = L.param((d, H, hd), dtype, axes=("embed", "heads", None))
        self.wk = L.param((d, K, hd), dtype,
                          axes=("embed", "kv_heads", None))
        self.wv = L.param((d, K, hd), dtype,
                          axes=("embed", "kv_heads", None))
        self.wo = L.param((H, hd, d), dtype, axes=("heads", None, "embed"))
        if cfg.qk_norm:
            self.q_norm = L.param((hd,), dtype, init="ones", axes=(None,))
            self.k_norm = L.param((hd,), dtype, init="ones", axes=(None,))


class AttnBlock(nn.Module):
    """Pre-norm residual block: attention mixer + MLP."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, dtype)
        self.attn = Attention(cfg, dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, dtype)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,d] @ w [d,N,hd] -> [B,S,N,hd] (einsum 'bsd,dhk->bshk')."""
    B, S, d = x.shape
    return (x @ L.cast(w, x.dtype).reshape(d, -1)).view(B, S, *w.shape[1:])


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
         positions: torch.Tensor):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = L.rmsnorm_heads(p.q_norm, q, cfg.norm_eps)
        k = L.rmsnorm_heads(p.k_norm, k, cfg.norm_eps)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """out [B,S,H,hd] @ wo [H,hd,d] -> [B,S,d] (einsum 'bshk,hkd->bsd')."""
    B, S, H, hd = out.shape
    return (out.reshape(B, S, H * hd)
            @ L.cast(p.wo, out.dtype).reshape(H * hd, -1))


# ---------------------------------------------------------------------------
# Full-sequence attention (forward / prefill)
# ---------------------------------------------------------------------------

def attention_full_qkv(cfg: ModelConfig, p: Attention, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       window: Optional[int],
                       lengths: Optional[torch.Tensor] = None,
                       prefix_len: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention of projected q [B, S,
    H, hd] and k/v [B, S, K, hd] at positions 0..S-1, the positions
    ``forward`` and ``prefill`` give; ``lengths`` ([B] int32) masks key
    tokens at or past each sequence's length; ``prefix_len`` marks a
    bidirectional prefix (the VLM's image patches attend among themselves;
    whisper's encoder passes S), after which tokens stay causal.  Returns
    [B, S, d] in q's dtype."""
    B, S, H, hd = q.shape
    out = run_local(
        ops.flash_attention,
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), window=window,
        lengths=None if lengths is None else lengths.to(torch.int32),
        prefix_len=prefix_len)
    return _out_proj(p, out.transpose(1, 2))


def attention_full(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int],
                   lengths: Optional[torch.Tensor] = None,
                   prefix_len: int = 0) -> torch.Tensor:
    q, k, v = _qkv(cfg, p, x, positions)
    return attention_full_qkv(cfg, p, q, k, v, window, lengths, prefix_len)


# ---------------------------------------------------------------------------
# KV storage shared by ring caches and page pools
# ---------------------------------------------------------------------------

def resolve_kv_dtype(cfg: ModelConfig, kv_dtype: Optional[str]) -> str:
    kvd = kv_dtype or cfg.kv_dtype
    if kvd not in ("model", "int8"):
        raise ValueError(f"unknown kv_dtype {kvd!r}")
    return kvd


def _slots(leaf: torch.Tensor) -> torch.Tensor:
    """A K/V leaf [N0, N1, *row] (pool [P, ps], ring [B, C]) as its N0 * N1
    slots followed by the scratch slot behind them: [N0 * N1 + 1, *row]."""
    n, row = leaf.shape[0] * leaf.shape[1], leaf.shape[2:]
    need = (leaf.storage_offset() + (n + 1) * math.prod(row)) \
        * leaf.element_size()
    if not leaf.is_contiguous() or leaf.untyped_storage().nbytes() < need:
        raise ValueError("K/V leaves are written through the scratch slot "
                         "behind them: make caches with empty_cache")
    return leaf.as_strided((n + 1, *row), (leaf.stride(1),
                                           *leaf.stride()[2:]))


def _write(leaf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """``_slots(leaf)[idx] = val`` in place.  A leaf placed on a mesh (a
    DTensor) writes into its local shard the lanes that fall in it, each
    cut to the shard's box; the other lanes go to the local scratch
    slot."""
    if not is_placed(leaf):
        _slots(leaf).index_put_((idx,), val)
        return
    local = leaf.to_local()
    val = val.full_tensor() if is_placed(val) else val
    if not is_replicated(leaf):
        (o0, o1, *orow), (n0, n1, *nrow) = shard_box(leaf)
        r, c = idx // leaf.shape[1], idx % leaf.shape[1]
        mine = (r >= o0) & (r < o0 + n0) & (c >= o1) & (c < o1 + n1)
        idx = torch.where(mine, (r - o0) * n1 + (c - o1), n0 * n1)
        val = val[(slice(None),) + tuple(slice(o, o + n)
                                         for o, n in zip(orow, nrow))]
    _slots(local).index_put_((idx,), val)


def _put_kv(cache: Dict[str, torch.Tensor], names: Tuple[str, ...],
            idx: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write K/V rows [n, K, hd] at slots ``idx`` [n] (``_slots``; the
    last one is the scratch slot) in place into the leaves ``names`` (K, V
    and the K scale, K zero and V scale sidecars).  An int8 cache
    quantizes here, at write time: the scales land at the same slot as
    their int8 rows."""
    kn, vn, ksn, kzn, vsn = names
    if ksn in cache:
        kq, ks, kz = Q.quantize_k(k)
        vq, vs = Q.quantize_v(v)
        vals = ((kn, kq), (vn, vq), (ksn, ks), (kzn, kz), (vsn, vs))
    else:
        vals = ((kn, k.to(cache[kn].dtype)), (vn, v.to(cache[vn].dtype)))
    for name, val in vals:
        _write(cache[name], idx, val)


def _scales(cache: Dict[str, torch.Tensor], names: Tuple[str, ...]
            ) -> Dict[str, Optional[torch.Tensor]]:
    """The int8 sidecars of a cache as kernel keyword arguments (None for
    an fp cache)."""
    return {"k_scale": cache.get(names[2]), "k_zero": cache.get(names[3]),
            "v_scale": cache.get(names[4])}


POOL_LEAVES = ("kp", "vp", "ksp", "kzp", "vsp")
RING_LEAVES = ("k", "v", "ks", "kz", "vs")


# ---------------------------------------------------------------------------
# Ring KV cache
# ---------------------------------------------------------------------------

def kv_cache_def(cfg: ModelConfig, batch: int, capacity: int,
                 dtype: torch.dtype, kv_dtype: Optional[str] = None,
                 seq_shard: bool = True) -> Dict[str, L.LeafDef]:
    """Shapes, dtypes and logical axes of one attention layer's ring
    cache; "int8" adds the scale sidecars ``ks``/``kz``/``vs`` ([batch,
    capacity, K]).  The capacity dim carries the reference's ``kv_seq``
    axis when ``seq_shard`` (the dry run's decode layout), no axis
    otherwise (the serving engine's)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    quant = resolve_kv_dtype(cfg, kv_dtype) == "int8"
    kv = torch.int8 if quant else dtype
    seq_ax = "kv_seq" if seq_shard else None
    kv_axes = ("batch", seq_ax, "kv_heads", None)
    d = {"k": L.LeafDef((batch, capacity, K, hd), kv, kv_axes),
         "v": L.LeafDef((batch, capacity, K, hd), kv, kv_axes),
         "tok": L.LeafDef((batch, capacity), torch.int32,
                           ("batch", seq_ax))}
    if quant:
        for leaf in ("ks", "kz", "vs"):
            d[leaf] = L.LeafDef((batch, capacity, K), torch.float32,
                                 kv_axes[:3])
    return d


KV_LEAVES = POOL_LEAVES + RING_LEAVES + ("tok",)


def empty_cache(defs: Dict[str, L.LeafDef],
                device: Optional[torch.device] = None
                ) -> Dict[str, torch.Tensor]:
    """A cache dict in its EMPTY state: zeros, except ``tok`` leaves, which
    hold -1 (no token cached).  The storage of a K/V leaf holds one slot
    more than the leaf: the scratch slot of the writes (``_slots``)."""
    out = {}
    for name, (shape, dt) in defs.items():
        fill = -1 if name == "tok" else 0
        if name in KV_LEAVES:
            n = shape[0] * shape[1]
            full = torch.full((n + 1, *shape[2:]), fill, dtype=dt,
                              device=device)
            out[name] = full[:n].view(shape)
        else:
            out[name] = torch.full(shape, fill, dtype=dt, device=device)
    return out


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  dtype: torch.dtype, kv_dtype: Optional[str] = None,
                  device: Optional[torch.device] = None) -> Ring:
    return empty_cache(kv_cache_def(cfg, batch, capacity, dtype, kv_dtype),
                       device)


def _ring_write(cache: Ring, k: torch.Tensor, v: torch.Tensor,
                idx: torch.Tensor, positions: torch.Tensor) -> Ring:
    """Write K/V rows [n, K, hd] of tokens ``positions`` [n] in place at
    ring slots ``idx`` [n] (row * C + slot, or B * C, the scratch slot);
    no two rows share a slot but the scratch slot."""
    _put_kv(cache, RING_LEAVES, idx, k, v)
    _write(cache["tok"], idx, positions.to(torch.int32))
    return cache


def _ring_slots(positions: torch.Tensor, keep: Optional[torch.Tensor],
                C: int) -> torch.Tensor:
    """Ring slot of each lane of a [B, S] block, flattened: row * C +
    position % C where ``keep`` (everywhere when None), else the scratch
    slot B * C."""
    B = positions.shape[0]
    rows = torch.arange(B, device=positions.device)[:, None] * C
    idx = rows + positions.long() % C
    if keep is not None:
        idx = torch.where(keep, idx, B * C)
    return idx.flatten()


def prefill_into_cache(cache: Ring, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor) -> Ring:
    """Write a full prefill's K/V [B, S, K, hd] into an empty ring.
    Tokens at or past a sequence's length stay unwritten (tok = -1); when
    S exceeds the capacity C only each sequence's last C tokens survive —
    exactly the sliding-window semantics."""
    B, S = k.shape[:2]
    C = cache["k"].shape[1]
    t = torch.arange(S, device=k.device)[None, :].expand(B, S)
    n = lengths.long()[:, None]
    keep = (t < n) & (t >= n - C)
    return _ring_write(cache, k.flatten(0, 1), v.flatten(0, 1),
                       _ring_slots(t, keep, C), t.flatten())


def _masked_ring_write(cache: Ring, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor,
                       valid: Optional[torch.Tensor]) -> Ring:
    """Write the valid lanes of a [B, Sx] block into the ring, in place.
    When Sx exceeds the capacity two lanes can alias one slot; the later
    lane wins (the earlier token has already left the window).  The engine
    never runs a block wider than its rings, so only direct calls take
    that branch.

    Speculative verify writes follow the write-then-mask rollback contract
    of the paged pool: rejected lanes leave ``tok`` entries past the
    committed frontier, which every read masks (``tok <= pos``) and the
    next step overwrites.  But a ring write at position p evicts position
    p - C; when C is window-clamped the evicted token may still be
    attendable after a rejection, so the engine speculates only on rings
    whose capacity is max_seq."""
    B, Sx = positions.shape
    C = cache["k"].shape[1]
    keep = valid
    if Sx > C:
        if keep is None:
            keep = torch.ones_like(positions, dtype=torch.bool)
        slot = positions % C
        lane = torch.arange(Sx, device=positions.device)
        same = slot[:, :, None] == slot[:, None, :]             # [B,Sx,Sx]
        later = lane[None, None, :] > lane[None, :, None]
        keep = keep & ~(same & later & keep[:, None, :]).any(dim=-1)
    return _ring_write(cache, k.flatten(0, 1), v.flatten(0, 1),
                       _ring_slots(positions, keep, C), positions.flatten())


def attention_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                     cache: Ring, pos: torch.Tensor, window: Optional[int]
                     ) -> Tuple[torch.Tensor, Ring]:
    """One-token decode over the ring.  x: [B, 1, d]; pos: [B] int32.
    Writes this token at slot pos % C, then reads the post-write ring
    through the ring decode kernel."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C = cache["k"].shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    _ring_write(cache, k[:, 0], v[:, 0], _ring_slots(pos[:, None], None, C),
                pos)
    out = run_local(
        ops.decode_attention,
        q.reshape(B, K, H // K, hd).contiguous(), cache["k"], cache["v"],
        cache["tok"], pos, window=window, **_scales(cache, RING_LEAVES))
    return _out_proj(p, out.reshape(B, 1, H, hd).to(x.dtype)), cache


def attention_extend(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                     cache: Ring, pos0: torch.Tensor, window: Optional[int],
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Ring]:
    """Multi-token extension over the ring: x: [B, Sx, d] continues at
    position pos0 [B] int32.  Writes the suffix's valid lanes ([B, Sx]
    ``valid``; all lanes when None), then attends over the whole ring with
    exact token masking: lane l attends slots holding tokens <= pos0 + l
    (and > pos0 + l - window).  The JAX package reads the ring here with
    XLA, having no kernel for it, so this read is plain PyTorch."""
    B, Sx, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = pos0[:, None] + torch.arange(Sx, device=x.device,
                                             dtype=pos0.dtype)[None, :]
    q, k, v = _qkv(cfg, p, x, positions)
    _masked_ring_write(cache, k, v, positions, valid)
    out = run_local(_ring_extend_read, q.reshape(B, Sx, K, H // K, hd),
                    cache["k"], cache["v"], cache["tok"], positions, window,
                    **_scales(cache, RING_LEAVES))
    return _out_proj(p, out.reshape(B, Sx, H, hd).to(x.dtype)), cache


def _ring_extend_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      tok: torch.Tensor, positions: torch.Tensor,
                      window: Optional[int], k_scale=None, k_zero=None,
                      v_scale=None) -> torch.Tensor:
    """Lane l of q [B, Sx, K, G, hd] at ``positions`` [B, Sx] attends the
    ring slots holding tokens <= its position (and > position - window)."""
    if k_scale is not None:
        k = Q.dequantize_k(k, k_scale, k_zero)
        v = Q.dequantize_v(v, v_scale)
    tok = tok[:, None, :].long()                                # [B,1,C]
    pl = positions[:, :, None].long()                           # [B,Sx,1]
    attendable = (tok >= 0) & (tok <= pl)
    if window is not None:
        attendable = attendable & (tok > pl - window)
    return masked_attention(q, k, v, attendable)


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

def paged_kv_cache_def(cfg: ModelConfig, num_pages: int, page_size: int,
                       dtype: torch.dtype, kv_dtype: Optional[str] = None
                       ) -> Dict[str, L.LeafDef]:
    """Shapes, dtypes and logical axes of one attention layer's page
    pools.  Every leaf leads with the ``pages`` axis, so COW copies,
    snapshot pins, per-page byte accounting and mesh placement (pages
    along ``model``: launch/rules.py) treat payload and sidecars alike."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    quant = resolve_kv_dtype(cfg, kv_dtype) == "int8"
    pool_dtype = torch.int8 if quant else dtype
    axes = ("pages", None, "kv_heads", None)
    d = {"kp": L.LeafDef((num_pages, page_size, K, hd), pool_dtype, axes),
         "vp": L.LeafDef((num_pages, page_size, K, hd), pool_dtype, axes)}
    if quant:
        for leaf in ("ksp", "kzp", "vsp"):
            d[leaf] = L.LeafDef((num_pages, page_size, K), torch.float32,
                                 axes[:3])
    return d


def _paged_write(pool: Pool, k: torch.Tensor, v: torch.Tensor,
                 phys: torch.Tensor, off: torch.Tensor) -> Pool:
    """Write K/V rows into pool pages in place.  k/v: [B, (Sx,) K, hd];
    phys/off: [B] or [B, Sx] (phys < 0 sends the lane to the scratch slot:
    pad lanes and unmapped positions)."""
    P, ps = pool["kp"].shape[:2]
    idx = torch.where(phys >= 0, phys.long() * ps + off.long(), P * ps)
    K, hd = k.shape[-2:]
    _put_kv(pool, POOL_LEAVES, idx.flatten(), k.reshape(-1, K, hd),
            v.reshape(-1, K, hd))
    return pool


def _write_phys(page_table: torch.Tensor, positions: torch.Tensor,
                ps: int) -> torch.Tensor:
    """Physical page holding each position [B, S] (-1 = unmapped).  The
    logical page is clamped to the table, as on the reference's write
    side; the reads mask by position and need no clamp."""
    NP = page_table.shape[1]
    lpage = torch.clamp(positions // ps, 0, NP - 1).long()
    return torch.gather(page_table, 1, lpage)


def attention_decode_paged(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                           pool: Pool, pos: torch.Tensor,
                           page_table: torch.Tensor, window: Optional[int]
                           ) -> Tuple[torch.Tensor, Pool]:
    """One-token decode over the page pool.  x: [B,1,d]; pos: [B] int32;
    page_table: [B, NP] int32.  Writes this token's K/V, then reads the
    post-write pool through the paged decode kernel, which gives a row
    whose table maps no page (an idle slot) the reference's value, the
    mean of physical page 0's V."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = pool["kp"].shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    phys = _write_phys(page_table, pos[:, None], ps)[:, 0]
    _paged_write(pool, k[:, 0], v[:, 0], phys, pos % ps)
    out = run_local(
        ops.paged_decode_attention,
        q.reshape(B, K, H // K, hd).contiguous(), pool["kp"], pool["vp"],
        page_table, pos, window=window, **_scales(pool, POOL_LEAVES))
    return _out_proj(p, out.reshape(B, 1, H, hd).to(x.dtype)), pool


def attention_extend_paged(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                           pool: Pool, pos0: torch.Tensor,
                           window: Optional[int], page_table: torch.Tensor,
                           valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Pool]:
    """Multi-token extension over the page pool: x: [B, Sx, d] continues
    at position pos0 [B] int32; the engine has already mapped (and
    COW-resolved) every logical page the valid lanes touch.  Lane l writes
    page table[(pos0+l)//ps] offset (pos0+l)%ps; invalid lanes ([B, Sx]
    ``valid`` false) never reach the pool.  The post-write pool is read by
    the paged extend kernel, each page once for all lanes of a tile."""
    B, Sx, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = pool["kp"].shape[1]
    positions = pos0[:, None] + torch.arange(Sx, device=x.device,
                                             dtype=pos0.dtype)[None, :]
    q, k, v = _qkv(cfg, p, x, positions)
    phys = _write_phys(page_table, positions, ps)
    if valid is not None:
        phys = torch.where(valid, phys, -1)
    _paged_write(pool, k, v, phys, positions % ps)
    out = run_local(
        ops.paged_extend_attention,
        q.reshape(B, Sx, K, H // K, hd).contiguous(), pool["kp"],
        pool["vp"], page_table, pos0, window=window,
        **_scales(pool, POOL_LEAVES))
    return _out_proj(p, out.reshape(B, Sx, H, hd).to(x.dtype)), pool


# ---------------------------------------------------------------------------
# Residual blocks (attn mixer + MLP)
# ---------------------------------------------------------------------------

def block_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == "rg_attn":
        return cfg.local_window
    return cfg.sliding_window


def _mlp_residual(cfg: ModelConfig, p: AttnBlock,
                  x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    return x + L.mlp(p.mlp, h, cfg.mlp_act)


def attn_block_forward(cfg: ModelConfig, p: AttnBlock, x: torch.Tensor,
                       positions: torch.Tensor, kind: str = "attn",
                       lengths: Optional[torch.Tensor] = None,
                       prefix_len: int = 0) -> torch.Tensor:
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    x = x + attention_full(cfg, p.attn, h, positions,
                           block_window(cfg, kind), lengths, prefix_len)
    return _mlp_residual(cfg, p, x)


def attn_block_prefill(cfg: ModelConfig, p: AttnBlock, x: torch.Tensor,
                       positions: torch.Tensor, lengths: torch.Tensor,
                       capacity: int, kind: str = "attn",
                       prefix_len: int = 0) -> Tuple[torch.Tensor, Ring]:
    """Full-sequence forward that also returns the primed ring cache (in
    ``cfg.kv_dtype``)."""
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    q, k, v = _qkv(cfg, p.attn, h, positions)
    cache = init_kv_cache(cfg, x.shape[0], capacity, x.dtype,
                          device=x.device)
    prefill_into_cache(cache, k, v, lengths)
    x = x + attention_full_qkv(cfg, p.attn, q, k, v, block_window(cfg, kind),
                               lengths, prefix_len)
    return _mlp_residual(cfg, p, x), cache


def attn_block_decode(cfg: ModelConfig, p: AttnBlock, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                      kind: str = "attn",
                      page_table: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    if "kp" in cache:                                   # paged pool layer
        y, cache = attention_decode_paged(cfg, p.attn, h, cache, pos,
                                          page_table,
                                          block_window(cfg, kind))
    else:
        y, cache = attention_decode(cfg, p.attn, h, cache, pos,
                                    block_window(cfg, kind))
    return _mlp_residual(cfg, p, x + y), cache


def attn_block_extend(cfg: ModelConfig, p: AttnBlock, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], pos0: torch.Tensor,
                      kind: str = "attn",
                      valid: Optional[torch.Tensor] = None,
                      page_table: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    if "kp" in cache:                                   # paged pool layer
        y, cache = attention_extend_paged(cfg, p.attn, h, cache, pos0,
                                          block_window(cfg, kind),
                                          page_table, valid)
    else:
        y, cache = attention_extend(cfg, p.attn, h, cache, pos0,
                                    block_window(cfg, kind), valid)
    return _mlp_residual(cfg, p, x + y), cache
