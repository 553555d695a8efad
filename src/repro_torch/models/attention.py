"""GQA attention over a paged KV pool (port of the paged subset of
``repro/models/attention.py``).

Layout per attention layer: a dict ``{"kp": [P, ps, K, hd], "vp": [P, ps,
K, hd]}`` — a pool of P physical pages of ps tokens each, shared by every
request — plus, with ``kv_dtype="int8"``, int8 pools and float32 scale
sidecar pools ``ksp``/``kzp``/``vsp`` ([P, ps, K]; asymmetric K, symmetric
V — kernels/kv_quant.py).  Each request owns a page table row mapping
logical page (position // ps) to a physical page (-1 = unmapped), so
masking is position arithmetic.

The pools are updated IN PLACE (``index_put_``), where the JAX package
rebuilt them functionally and donated the old buffers.  The order inside
a step is unchanged: each layer writes its new K/V rows first and then
reads the post-write pool, which is what lets a speculative verify step
write drafted tokens before knowing whether they are accepted — every
read masks by absolute position and every step rewrites positions from
the committed frontier before attending.  Lanes whose page is unmapped,
and pad lanes, are filtered out of the write (the reference routed them
to ``phys >= P`` and relied on ``mode="drop"``, which torch lacks).

The reads go through ``kernels/ops.py``: the hand-written CUDA kernels on
a CUDA device, their plain PyTorch versions on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import kv_quant as Q
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Pool = Dict[str, torch.Tensor]


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = L.param((d, H, hd), dtype)
        self.wk = L.param((d, K, hd), dtype)
        self.wv = L.param((d, K, hd), dtype)
        self.wo = L.param((H, hd, d), dtype)
        if cfg.qk_norm:
            self.q_norm = L.param((hd,), dtype, init="ones")
            self.k_norm = L.param((hd,), dtype, init="ones")


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
    return (x @ w.reshape(d, -1).to(x.dtype)).view(B, S, *w.shape[1:])


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
    return out.reshape(B, S, H * hd) @ p.wo.reshape(H * hd, -1).to(out.dtype)


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

def resolve_kv_dtype(cfg: ModelConfig, kv_dtype: Optional[str]) -> str:
    kvd = kv_dtype or cfg.kv_dtype
    if kvd not in ("model", "int8"):
        raise ValueError(f"unknown kv_dtype {kvd!r}")
    return kvd


def paged_kv_cache_def(cfg: ModelConfig, num_pages: int, page_size: int,
                       dtype: torch.dtype, kv_dtype: Optional[str] = None
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes and dtypes of one attention layer's page pools.  Every leaf
    leads with the ``pages`` axis, so COW copies, snapshot pins and
    per-page byte accounting treat payload and sidecars alike."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    quant = resolve_kv_dtype(cfg, kv_dtype) == "int8"
    pool_dtype = torch.int8 if quant else dtype
    d = {"kp": ((num_pages, page_size, K, hd), pool_dtype),
         "vp": ((num_pages, page_size, K, hd), pool_dtype)}
    if quant:
        for leaf in ("ksp", "kzp", "vsp"):
            d[leaf] = ((num_pages, page_size, K), torch.float32)
    return d


def _paged_write(pool: Pool, k: torch.Tensor, v: torch.Tensor,
                 phys: torch.Tensor, off: torch.Tensor) -> Pool:
    """Write K/V rows into pool pages in place.  k/v: [B, (Sx,) K, hd];
    phys/off: [B] or [B, Sx] (phys < 0 drops the lane: pad lanes and
    unmapped positions).  Quantized pools quantize here, at write time:
    the scales land at the same (page, offset) as their int8 rows."""
    keep = torch.nonzero(phys >= 0, as_tuple=True)   # one host sync
    phys, off = phys[keep].long(), off[keep].long()
    k, v = k[keep], v[keep]
    if "ksp" in pool:
        kq, ks, kz = Q.quantize_k(k)
        vq, vs = Q.quantize_v(v)
        for name, val in (("kp", kq), ("vp", vq), ("ksp", ks), ("kzp", kz),
                          ("vsp", vs)):
            pool[name].index_put_((phys, off), val)
    else:
        pool["kp"].index_put_((phys, off), k.to(pool["kp"].dtype))
        pool["vp"].index_put_((phys, off), v.to(pool["vp"].dtype))
    return pool


def _pool_scales(pool: Pool) -> Dict[str, Optional[torch.Tensor]]:
    return {"k_scale": pool.get("ksp"), "k_zero": pool.get("kzp"),
            "v_scale": pool.get("vsp")}


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
    post-write pool through the paged decode kernel."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = pool["kp"].shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None])
    phys = _write_phys(page_table, pos[:, None], ps)[:, 0]
    _paged_write(pool, k[:, 0], v[:, 0], phys, pos % ps)
    out = ops.paged_decode_attention(
        q.reshape(B, K, H // K, hd).contiguous(), pool["kp"], pool["vp"],
        page_table, pos, window=window, **_pool_scales(pool))
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
    out = ops.paged_extend_attention(
        q.reshape(B, Sx, K, H // K, hd).contiguous(), pool["kp"],
        pool["vp"], page_table, pos0, window=window, **_pool_scales(pool))
    return _out_proj(p, out.reshape(B, Sx, H, hd).to(x.dtype)), pool


# ---------------------------------------------------------------------------
# Residual blocks (attn mixer + MLP)
# ---------------------------------------------------------------------------

def block_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == "rg_attn":
        return cfg.local_window
    return cfg.sliding_window


def attn_block_decode(cfg: ModelConfig, p: AttnBlock, x: torch.Tensor,
                      pool: Pool, pos: torch.Tensor, kind: str = "attn",
                      page_table: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Pool]:
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    y, pool = attention_decode_paged(cfg, p.attn, h, pool, pos, page_table,
                                     block_window(cfg, kind))
    x = x + y
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    return x + L.mlp(p.mlp, h, cfg.mlp_act), pool


def attn_block_extend(cfg: ModelConfig, p: AttnBlock, x: torch.Tensor,
                      pool: Pool, pos0: torch.Tensor, kind: str = "attn",
                      valid: Optional[torch.Tensor] = None,
                      page_table: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Pool]:
    h = L.rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    y, pool = attention_extend_paged(cfg, p.attn, h, pool, pos0,
                                     block_window(cfg, kind), page_table,
                                     valid)
    x = x + y
    h = L.rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    return x + L.mlp(p.mlp, h, cfg.mlp_act), pool
