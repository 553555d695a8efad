"""The split ring-decode walk of ``csrc/decode_attention.cu``, on the CPU.

The CUDA kernel splits each (request, kv head) ring into
``cuda_lib.ring_splits`` segments of consecutive slots; each block writes
its rows' unnormalized (acc, m, l) and a second kernel combines them in
split order:

    out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,  M = max m_s,

skipping splits with no valid slot (l = 0); a row with none is zeros.
``split_combine`` below is a plain PyTorch mirror of that arithmetic.  It
is held, on numpy-seeded inputs, against the port's plain version
(``repro_torch.kernels.ref.decode_attention_ref``) and the JAX oracle
(``repro.kernels.ref.decode_attention_ref``) to 1e-5 in float32 (sums in
another order): float32 and int8 rings, wrapped rings, empty splits, a
window, every valid slot in one split, and C not a multiple of the split
count.  The JAX oracle softmaxes a row with no valid slot into a uniform
average, so such rows are compared with the port's zeros only.  The split
count and the scratch shape are checked at reflect_demo_100m's and
recurrentgemma-9b's decode shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as JQ
from repro.kernels import ref as jref
from repro_torch.kernels import cuda_lib, ref

TOL = 1e-5


def split_combine(q, k, v, tok, pos, splits, *, window=None, k_scale=None,
                  k_zero=None, v_scale=None):
    """Ring decode as the split kernel computes it: q [B, K, G, hd], ring
    k/v [B, C, K, hd] (int8 with [B, C, K] scales), tok [B, C], pos [B]."""
    kf, vf = ref._dequant(k, v, k_scale, k_zero, v_scale)
    kf, vf = kf.float(), vf.float()
    hd, C = q.shape[-1], k.shape[1]
    scores = torch.einsum("bkgd,bckd->bkgc", q.float(), kf) * hd ** -0.5
    tok = tok.long()
    valid = (tok >= 0) & ref._in_window(tok, pos.long()[:, None], window)
    parts = []
    for s in range(splits):
        lo, hi = s * C // splits, (s + 1) * C // splits
        ok = valid[:, None, None, lo:hi]
        sc = scores[..., lo:hi].masked_fill(~ok, float("-inf"))
        m = sc.amax(dim=-1)                       # -inf: no valid slot
        p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
        acc = torch.einsum("bkgc,bckd->bkgd", p, vf[:, lo:hi])
        parts.append((acc, m, p.sum(dim=-1)))
    M = torch.stack([torch.where(l > 0, m, float("-inf"))
                     for _, m, l in parts]).amax(dim=0)
    o = torch.zeros_like(parts[0][0])
    L = torch.zeros_like(M)
    for acc, m, l in parts:                       # split order
        e = torch.where(l > 0, torch.exp(m - M), 0.0)
        L = L + e * l
        o = o + e[..., None] * acc
    return torch.where(L[..., None] > 0, o / L[..., None].clamp_min(1e-30),
                       0.0).to(q.dtype)


def _inputs(seed, B, K, G, hd, C, quant, one_segment=None):
    """Rings wrapped past C with 10% empty slots and three slots ahead of
    pos (a rejected draft's writes); the last row is empty.  With
    ``one_segment`` = (lo, hi) every valid slot lies in [lo, hi)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    pos = rng.integers(C // 2, 3 * C, size=B)
    c = np.arange(C)[None, :]
    tok = pos[:, None] - (pos[:, None] - c) % C   # latest t with t == c mod C
    tok[(tok < 0) | (rng.random((B, C)) < 0.1)] = -1
    ahead = (c - pos[:, None] % C) % C
    tok = np.where((ahead >= 1) & (ahead <= 3), pos[:, None] + ahead, tok)
    if one_segment is not None:
        lo, hi = one_segment
        tok[:, :lo] = -1
        tok[:, hi:] = -1
    tok[B - 1] = -1
    jargs = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)]
    sc = {}
    if quant:
        kq, ks, kz = JQ.quantize_k(jargs[1])
        vq, vs = JQ.quantize_v(jargs[2])
        jargs[1:] = [kq, vq]
        sc = {"k_scale": ks, "k_zero": kz, "v_scale": vs}
    jargs += [jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32)]
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    return jargs, sc, targs, {n: torch.from_numpy(np.array(a))
                              for n, a in sc.items()}


def _check(jargs, jsc, targs, tsc, splits, window):
    got = split_combine(*targs, splits, window=window, **tsc)
    want = ref.decode_attention_ref(*targs, window=window, **tsc)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    jwant = torch.from_numpy(np.array(jref.decode_attention_ref(
        *jargs, window=window, **jsc)))
    tok, pos = targs[3].long(), targs[4].long()
    valid = (tok >= 0) & ref._in_window(tok, pos[:, None], window)
    seen = valid.any(dim=1)                        # rows with a valid slot
    assert seen.any()
    torch.testing.assert_close(got[seen], jwant[seen], atol=TOL, rtol=TOL)
    assert not got[~seen].any()                    # the port's zeros
    return got


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("B,K,G,hd,C,splits", [
    (3, 2, 3, 64, 512, 8),        # demo-like: 8 segments of 64
    (2, 1, 16, 32, 256, 16),      # MQA, G 16, many splits
    (3, 2, 5, 32, 300, 7),        # C not a multiple of the split count
    (2, 2, 3, 64, 256, 1),        # one split: the unsplit walk
])
def test_split_combine_matches_references(B, K, G, hd, C, splits, window,
                                          quant):
    """Window 48 on a ring wrapped past C leaves most splits empty."""
    jargs, jsc, targs, tsc = _inputs(C + splits + G, B, K, G, hd, C, quant)
    _check(jargs, jsc, targs, tsc, splits, window)


@pytest.mark.parametrize("quant", [False, True])
def test_split_combine_with_every_slot_in_one_split(quant):
    """Segment 2 of 8 holds every valid slot; the other seven are empty."""
    C, splits = 256, 8
    jargs, jsc, targs, tsc = _inputs(3, 3, 2, 4, 64, C, quant,
                                     one_segment=(64, 96))
    got = _check(jargs, jsc, targs, tsc, splits, None)
    # the same as one split over the whole ring, to rounding
    torch.testing.assert_close(got, split_combine(*targs, 1, **tsc),
                               atol=TOL, rtol=TOL)


def test_split_combine_all_empty_row_is_zeros():
    jargs, jsc, targs, tsc = _inputs(5, 2, 2, 3, 32, 128, False)
    targs[3][:] = -1                               # every slot empty
    got = split_combine(*targs, 4)
    assert got.shape == (2, 2, 3, 32) and not got.any()


@pytest.mark.parametrize("B,K,C,hd,splits", [
    (8, 4, 2048, 64, 9),          # reflect_demo_100m: 9 x 228 slots
    (8, 1, 2048, 256, 33),        # recurrentgemma-9b: 33 x 62 slots
    (1, 1, 2048, 64, 32),         # capped at one 64-slot stage a split
    (2, 2, 40, 64, 1),            # C smaller than one stage
    (8, 4, 16, 256, 1),
    (66, 4, 2048, 128, 1),        # enough rows already
])
def test_ring_splits(B, K, C, hd, splits):
    got = cuda_lib.ring_splits(B, K, C, hd)
    assert got == splits
    assert got == 1 or C // got >= cuda_lib.stage_slots(hd)
    assert B * K * got <= 2 * cuda_lib.SMS + B * K
    G = 3
    assert cuda_lib.partials_shape(B, K, G, hd, got) == (B, K, got, G,
                                                         hd + 2)
