"""The gradient of the port's full-sequence attention against the JAX
package's.

``ref.flash_attention_bwd_ref`` (the plain version of the card's flash
backward kernel, ``csrc/flash_attention_bwd.cu``) is held to autograd
through ``ref.flash_attention_ref`` and to ``jax.grad`` of the
reference's ``attention_full_qkv`` on both of its paths (the dense scores
at S <= ATTN_CHUNK, the chunked flash scan above it), with GQA, a window,
ragged lengths with an empty row, and S not a multiple of a tile.  A
plain mirror of the kernel's tile walk (which key tiles a query tile
visits, which query tiles a key tile visits) must give the same
gradients, so every valid (query, key) pair is visited exactly once; and
the autograd function the card uses is checked on the CPU with its two
launches replaced by their plain versions.

Tolerances: float32 against float32 on the same inputs, 1e-5 absolute
plus 1e-4 relative (sums in another order); the gradients are O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import attention as JA
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.models import attention as A

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run long loops of small tensor
    operations, which wait on every thread of the pool, and the suite's
    parallel workers would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (B, H, K, S, hd, window, lengths)
CASES = {
    "gqa": (2, 6, 2, 19, 16, None, None),
    "window": (2, 4, 2, 21, 16, 5, None),
    "ragged_empty_row": (3, 4, 1, 13, 8, None, [13, 0, 6]),
    "window_ragged": (2, 6, 3, 27, 16, 7, [27, 11]),
}


def _inputs(B, H, K, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, H, S, hd), f(B, K, S, hd), f(B, K, S, hd), f(B, H, S, hd)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=ATOL,
                               rtol=RTOL)


def _lengths(lengths):
    return None if lengths is None else torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_autograd(case):
    B, H, K, S, hd, window, lengths = CASES[case]
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, K, S, hd))
    ln = _lengths(lengths)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = ref.flash_attention_ref(q, k, v, window=window, lengths=ln)
    o.backward(do)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      o.detach(), do, window=window,
                                      lengths=ln)
    for g, t in zip(got, (q, k, v)):
        assert torch.isfinite(g).all()
        _close(g, t.grad)
    if lengths is not None and 0 in lengths:
        b = lengths.index(0)
        assert not got[0][b].any() and not got[1][b].any() \
            and not got[2][b].any()


def _jax_cfg(H, K, hd):
    return JConfig(name="t", arch_type="dense", num_layers=1, d_model=8,
                   num_heads=H, num_kv_heads=K, head_dim=hd, d_ff=8,
                   vocab_size=16, block_pattern=("attn",), dtype="float32")


def _live_rows(S, window, lengths, B):
    """[B, S] bool: does the row attend any key."""
    valid = ref._in_window(torch.arange(S)[None, :],
                           torch.arange(S)[:, None], window)[None]
    if lengths is not None:
        valid = valid & (torch.arange(S)[None, None, :]
                         < torch.tensor(lengths)[:, None, None])
    return valid.any(-1).expand(B, S).numpy()


@pytest.mark.parametrize("path", ["dense", "flash"])
@pytest.mark.parametrize("case", ["window_ragged", "ragged_empty_row"])
def test_bwd_ref_matches_jax_attention(case, path, monkeypatch):
    """jax.grad of the reference's attention_full_qkv (q/k/v [B,S,N,hd],
    output projected by wo) against the port: the plain forward, then
    ``flash_attention_bwd_ref`` at the output gradient wo gives.  The two
    cases hold G 2 and 4, a window, ragged lengths with an empty row, and
    S not a multiple of a tile between them."""
    B, H, K, S, hd, window, lengths = CASES[case]
    if path == "flash":           # the chunked flash scan, as above 1024
        monkeypatch.setattr(JA, "ATTN_CHUNK", 8)
    q, k, v, _ = _inputs(B, H, K, S, hd)
    rng = np.random.default_rng(1)
    wo = rng.standard_normal((H, hd, 8)).astype(np.float32) * 0.3
    gout = rng.standard_normal((B, S, 8)).astype(np.float32)
    # a row with no valid key (past its length by more than the window,
    # or of a length-0 sequence) is zeros in the port and the mean of V in
    # the reference (ROADMAP C3); no caller reads it, so no gradient
    # flows into it here
    gout[~_live_rows(S, window, lengths, B)] = 0.0
    cfg = _jax_cfg(H, K, hd)
    pos = jnp.arange(S, dtype=jnp.int32)[None]
    ln = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    qs, ks, vs = (np.swapaxes(a, 1, 2) for a in (q, k, v))   # [B,S,N,hd]

    def loss(q_, k_, v_):
        out = JA.attention_full_qkv(cfg, {"wo": jnp.asarray(wo)}, q_, k_,
                                    v_, pos, window, ln)
        return jnp.sum(out * gout)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(qs), jnp.asarray(ks),
                                           jnp.asarray(vs))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    tl = _lengths(lengths)
    o = ref.flash_attention_ref(tq, tk, tv, window=window, lengths=tl)
    # d loss / d o[b, h, s, :] = gout[b, s, :] @ wo[h].T
    do = torch.einsum("bse,hde->bhsd", torch.tensor(gout), torch.tensor(wo))
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, do, window=window,
                                      lengths=tl)
    for g, want in zip(got, jg):
        _close(g, np.swapaxes(np.asarray(want), 1, 2))

    # and autograd through the port's own attention_full_qkv
    pcfg = ModelConfig(**{f: getattr(cfg, f) for f in
                          ("name", "arch_type", "num_layers", "d_model",
                           "num_heads", "num_kv_heads", "head_dim", "d_ff",
                           "vocab_size", "block_pattern", "dtype")})
    p = A.Attention(pcfg)
    with torch.no_grad():
        p.wo.copy_(torch.tensor(wo))
    ts = [torch.tensor(a, requires_grad=True) for a in (qs, ks, vs)]
    out = A.attention_full_qkv(pcfg, p, *ts, window, tl)
    (out * torch.tensor(gout)).sum().backward()
    for t, want in zip(ts, jg):
        _close(t.grad, want)


def _mirror_bwd(q, k, v, o, do, window, lengths, TL):
    """The kernel's walk in float64: dq by query tile over key tiles from
    the window's start to the diagonal, dk/dv by key tile over the query
    tiles of every head of its group from the diagonal to the window's
    end, each pair masked as the kernel masks it."""
    q, k, v, o, do = (np.asarray(a, np.float64) for a in (q, k, v, o, do))
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = hd ** -0.5
    w = window or 0
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    visits = np.zeros((B, H, S, S), np.int64)

    def attends(i, j, ln):
        return i < S and j <= i and j < ln and (w <= 0 or j > i - w)

    for b in range(B):
        ln = S if lengths is None else min(max(lengths[b], 0), S)
        lse = np.full((H, S), np.inf)          # pre-pass

        for h in range(H):
            kv = h // G
            for i in range(S):
                s = [q[b, h, i] @ k[b, kv, j] * scale for j in range(S)
                     if attends(i, j, ln)]
                if s:
                    lse[h, i] = np.log(np.sum(np.exp(np.array(s) - max(s)))) \
                        + max(s)
        delta = (do[b] * o[b]).sum(-1)
        tiles = range(0, S, TL)

        def pair(h, i, j):
            kv = h // G
            p = np.exp(q[b, h, i] @ k[b, kv, j] * scale - lse[h, i])
            return p, p * (do[b, h, i] @ v[b, kv, j] - delta[h, i])

        for h in range(H):                          # dq kernel
            for i0 in tiles:
                j_lo = max(0, i0 - w + 1) if w > 0 else 0
                j_hi = min(min(i0 + TL, S), ln)
                for j0 in range(j_lo // TL * TL, j_hi, TL):
                    for i in range(i0, i0 + TL):
                        for j in range(j0, j0 + TL):
                            if attends(i, j, ln):
                                _, ds = pair(h, i, j)
                                dq[b, h, i] += ds * k[b, h // G, j] * scale
                                visits[b, h, i, j] += 1
        for kv in range(K):                         # dk/dv kernel
            for j0 in tiles:
                if j0 >= ln:
                    continue
                i_end = min(S, j0 + TL - 1 + w) if w > 0 else S
                for g in range(G):
                    h = kv * G + g
                    for i0 in range(j0, i_end, TL):
                        for i in range(i0, i0 + TL):
                            for j in range(j0, j0 + TL):
                                if attends(i, j, ln):
                                    p, ds = pair(h, i, j)
                                    dv[b, kv, j] += p * do[b, h, i]
                                    dk[b, kv, j] += ds * q[b, h, i] * scale
                                    visits[b, h, i, j] += 10
    return (dq, dk, dv), visits


@pytest.mark.parametrize("TL", [4, 8])
@pytest.mark.parametrize("case", ["window", "window_ragged",
                                  "ragged_empty_row"])
def test_kernel_tile_walk_visits_every_pair_once(case, TL):
    B, H, K, S, hd, window, lengths = CASES[case]
    B, H, K = min(B, 2), min(H, 4), min(K, 2)
    lengths = None if lengths is None else lengths[:B]
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, K, S, hd))
    tl = _lengths(lengths)
    o = ref.flash_attention_ref(q, k, v, window=window, lengths=tl)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                       lengths=tl)
    got, visits = _mirror_bwd(q, k, v, o, do, window, lengths, TL)
    valid = ref._in_window(torch.arange(S)[None, :],
                           torch.arange(S)[:, None], window)[None]
    if tl is not None:
        valid = valid & (torch.arange(S)[None, None, :]
                         < tl.long()[:, None, None])
    expect = np.broadcast_to(valid[:, None].numpy(), visits.shape) * 11
    np.testing.assert_array_equal(visits, expect)
    for g, w in zip(got, want):
        _close(g, w)


def test_autograd_function_plumbing(monkeypatch):
    """The card's ``_FlashAttention`` (forward launch saved for the
    backward launch) with both launches replaced by their plain versions
    gives autograd's gradients of the plain forward; in both dtypes the
    forward launch is asked for lse, and the backward gets that lse."""
    B, H, K, S, hd, window, lengths = CASES["window_ragged"]
    calls, lses = [], []

    def launch(q, k, v, w, ln, with_lse=False, prefix_len=0):
        assert prefix_len == 0
        out, lse = ref.flash_attention_ref(q, k, v, window=w, lengths=ln,
                                           return_lse=True)
        calls.append(("fwd", with_lse))
        lses.append(lse if with_lse else None)
        return out, lses[-1]

    def bwd(q, k, v, o, do, *, lse=None, window=None, lengths=None,
            prefix_len=0):
        assert prefix_len == 0
        calls.append(("bwd", lse is lses[-1]))
        return ref.flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                           lengths=lengths)

    monkeypatch.setattr(FA, "_launch", launch)
    monkeypatch.setattr(FA, "flash_attention_bwd", bwd)
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, K, S, hd))
    tl = _lengths(lengths)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FA._FlashAttention.apply(*a, window, tl).backward(do)
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.flash_attention_ref(*b, window=window, lengths=tl).backward(do)
    assert calls == [("fwd", True), ("bwd", True)]
    assert lses[-1].dtype == torch.float32 and lses[-1].shape == (B, H, S)
    for x, y in zip(a, b):
        _close(x.grad, y.grad)

    # bfloat16: lse from the forward reaches the backward
    calls.clear()
    a16 = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
    out = FA._FlashAttention.apply(*a16, window, tl)
    out.backward(do.to(torch.bfloat16))
    assert calls == [("fwd", True), ("bwd", True)]
    assert lses[-1].dtype == torch.float32 and lses[-1].shape == (B, H, S)
    want = ref.flash_attention_bwd_ref(*(t.detach() for t in a16),
                                       out.detach(), do.to(torch.bfloat16),
                                       window=window, lengths=tl)
    for x, w in zip(a16, want):
        assert torch.equal(x.grad, w)
