"""The forward's log-sum-exp and the tensor-core walk of the bf16 flash
backward, on the CPU.

``ref.flash_attention_ref(..., return_lse=True)`` (the plain version of the
lse the bf16 forward kernel stores for the backward,
``csrc/flash_tc.cuh``) is held to a float64 numpy log-sum-exp over the
masked scores, with ``+inf`` for a row that attends no key.  A plain
mirror of the bf16 backward's walk (``csrc/flash_attention_bwd.cu``): dk/dv
blocks of KT keys over query steps of BM rows of the heads of one of NS
head groups, from the diagonal to the window's end, the groups' partials
added in group order; dq blocks of WG warpgroups of QR rows over key steps
of BN, each warpgroup skipping the steps none of its rows can attend; a
step's pairs masked only when the kernel's test says the step straddles
an edge, and P taken from the forward's lse.  Every valid (query, key)
pair must be visited exactly once by each kernel and no other pair, and
the gradients must match ``ref.flash_attention_bwd_ref``.

Tolerances: float32 inputs; the lse to 1e-5 absolute plus 1e-6 relative
of the float64 value, the gradients to 1e-5 absolute plus 1e-4 relative
(sums in another order, P from a float32 lse); the gradients are O(1).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_lib, ref

ATOL, RTOL = 1e-5, 1e-4

# (B, H, K, S, hd, window, lengths)
CASES = {
    "gqa": (2, 6, 2, 19, 16, None, None),
    "window": (2, 4, 2, 21, 16, 5, None),
    "ragged_empty_row": (3, 4, 1, 13, 8, None, [13, 0, 6]),
    "window_ragged": (2, 6, 3, 27, 16, 7, [27, 11]),
    "g4_window": (1, 8, 2, 23, 8, 9, [12]),   # rows 20-22 see no key
}


def _inputs(B, H, K, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, H, S, hd), f(B, K, S, hd), f(B, K, S, hd), f(B, H, S, hd)


def _valid(B, S, window, lengths):
    """[B, S, S] bool numpy: may query i attend key j."""
    i = np.arange(S)
    v = (i[None, :] <= i[:, None])
    if window is not None:
        v &= i[None, :] > i[:, None] - window
    v = np.broadcast_to(v, (B, S, S)).copy()
    if lengths is not None:
        v &= i[None, None, :] < np.asarray(lengths)[:, None, None]
    return v


def _lengths(lengths):
    return (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("case", CASES)
def test_plain_lse_matches_float64(case):
    B, H, K, S, hd, window, lengths = CASES[case]
    q, k, v, _ = _inputs(B, H, K, S, hd)
    out, lse = ref.flash_attention_ref(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), window=window,
        lengths=_lengths(lengths), return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    assert torch.equal(out, ref.flash_attention_ref(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), window=window,
        lengths=_lengths(lengths)))
    G = H // K
    s = np.einsum("bhid,bhjd->bhij", q.astype(np.float64),
                  np.repeat(k.astype(np.float64), G, axis=1)) / np.sqrt(hd)
    valid = _valid(B, S, window, lengths)[:, None]
    s = np.where(valid, s, -np.inf)
    m = s.max(-1, keepdims=True)
    empty = ~valid.any(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = np.log(np.exp(s - np.where(np.isfinite(m), m, 0)).sum(-1)) \
            + np.where(np.isfinite(m), m, 0)[..., 0]
    want = np.where(np.broadcast_to(empty, want.shape), np.inf, want)
    got = lse.numpy().astype(np.float64)
    assert (np.isinf(got) == np.isinf(want)).all()
    assert empty.any() == (case in ("ragged_empty_row", "window_ragged",
                                    "g4_window"))
    assert (got[np.isinf(want)] > 0).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=1e-6)


def _mirror_tc_bwd(q, k, v, o, do, lse, window, lengths, KT, BM, QR, WG,
                   BN, NS):
    """The bf16 backward's walk in float64 with P = exp(s - lse) from the
    forward's lse: dk/dv blocks (b, kv head, KT keys, head group of NS),
    dq blocks (b, head, WG x QR queries).  A step's pairs are masked only
    when the kernel's test says it straddles an edge, and otherwise all
    added.  Returns the gradients and a visit count a pair: 10 a dk/dv
    visit, 1 a dq visit."""
    q, k, v, o, do, lse = (np.asarray(a, np.float64)
                           for a in (q, k, v, o, do, lse))
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = hd ** -0.5
    w = window or 0
    kk, vv = np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)
    with np.errstate(invalid="ignore"):
        p = np.exp(np.einsum("bhid,bhjd->bhij", q, kk) * scale
                   - lse[..., None])
    delta = (do * o).sum(-1)
    ds = p * (np.einsum("bhid,bhjd->bhij", do, vv) - delta[..., None])
    dq = np.zeros_like(q)
    part = np.zeros((NS, 2) + k.shape)
    visits = np.zeros((B, H, S, S), np.int64)

    def attends(i, j, ln):
        return i < S and j <= i and j < ln and (w <= 0 or j > i - w)

    for b in range(B):
        ln = S if lengths is None else min(max(lengths[b], 0), S)
        for kv in range(K):                         # dk/dv kernel
            for j0 in range(0, S, KT):
                for grp in range(NS):
                    g0, g1 = G * grp // NS, G * (grp + 1) // NS
                    i_end = (j0 if j0 >= ln else
                             min(S, j0 + KT - 1 + w) if w > 0 else S)
                    nt = -(-(i_end - j0) // BM)
                    for h in range(kv * G + g0, kv * G + g1):
                        for i0 in range(j0, j0 + nt * BM, BM):
                            full = (i0 >= j0 + KT - 1 and j0 + KT <= ln
                                    and i0 + BM <= S and
                                    (w <= 0 or j0 > i0 + BM - 1 - w))
                            for i in range(i0, min(i0 + BM, S)):
                                for j in range(j0, min(j0 + KT, S)):
                                    if full or attends(i, j, ln):
                                        part[grp, 0, b, kv, j] += \
                                            ds[b, h, i, j] * q[b, h, i]
                                        part[grp, 1, b, kv, j] += \
                                            p[b, h, i, j] * do[b, h, i]
                                        visits[b, h, i, j] += 10
        for h in range(H):                          # dq kernel
            for q0 in range(0, S, QR * WG):
                t_hi = min(q0 + QR * WG - 1, ln - 1)
                t_lo = max(0, q0 - w + 1) if w > 0 else 0
                n0 = t_lo // BN
                n1 = t_hi // BN if t_hi >= t_lo else n0 - 1
                for wg in range(WG):
                    qw = q0 + QR * wg
                    w_hi = min(qw + QR - 1, ln - 1)
                    w_lo = max(0, qw - w + 1) if w > 0 else 0
                    for n in range(n0, n1 + 1):
                        k0 = n * BN
                        if qw >= S or k0 > w_hi or k0 + BN - 1 < w_lo:
                            continue
                        full = (k0 + BN - 1 <= qw and k0 + BN <= ln and
                                (w <= 0 or k0 > qw + QR - 1 - w))
                        # rows past S have lse +inf (P 0) and are not
                        # stored
                        for i in range(qw, min(qw + QR, S)):
                            for j in range(k0, min(k0 + BN, S)):
                                if full or attends(i, j, ln):
                                    dq[b, h, i] += ds[b, h, i, j] * \
                                        k[b, h // G, j]
                                    visits[b, h, i, j] += 1
    dk, dv = part[0, 0].copy(), part[0, 1].copy()
    for grp in range(1, NS):                        # the fixed-order sum
        dk += part[grp, 0]
        dv += part[grp, 1]
    return (dq * scale, dk * scale, dv), visits


# (KT, BM, QR, WG, BN, NS): the kernel's shape cut down, BM != KT, BN !=
# QR, one and two dq warpgroups, head groups of one to all heads
WALKS = {
    "square": (8, 8, 8, 2, 8, 1),
    "bm_half": (8, 4, 4, 2, 8, 2),
    "bm_double": (4, 8, 8, 1, 4, 3),
    "bn_half": (8, 8, 8, 2, 4, 4),
}


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("case", ["window", "window_ragged",
                                  "ragged_empty_row", "g4_window"])
def test_tensor_core_walk_visits_every_pair_once(case, walk):
    B, H, K, S, hd, window, lengths = CASES[case]
    KT, BM, QR, WG, BN, NS = WALKS[walk]
    NS = min(NS, H // K)
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, K, S, hd))
    tl = _lengths(lengths)
    o, lse = ref.flash_attention_ref(q, k, v, window=window, lengths=tl,
                                     return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                       lengths=tl)
    got, visits = _mirror_tc_bwd(q, k, v, o, do, lse, window, lengths, KT,
                                 BM, QR, WG, BN, NS)
    valid = _valid(B, S, window, lengths)[:, None]
    np.testing.assert_array_equal(
        visits, np.broadcast_to(valid, visits.shape) * 11)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32), w.numpy(),
                                   atol=ATOL, rtol=RTOL)
    if lengths is not None and 0 in lengths:
        b = lengths.index(0)
        assert not any(np.asarray(g)[b].any() for g in got)


@pytest.mark.parametrize("B,K,S,G,want", [
    (8, 4, 256, 3, 1),      # the demo's training shape: 128 blocks
    (1, 1, 4096, 16, 8),    # recurrentgemma-9b's local attention
    (8, 4, 1000, 3, 1),     # ragged S 1000: 512 blocks
    (1, 1, 4096, 12, 12),   # no divisor of G between 6 and G
    (1, 8, 300, 8, 8),      # G
    (2, 1, 2048, 16, 8),    # 64 blocks: 8 groups give three a SM
    (1, 2, 2048, 4, 4),     # 64 blocks: no divisor of 4 gives three
])
def test_bwd_splits(B, K, S, G, want):
    assert cuda_lib.bwd_splits(B, K, S, G) == want


@pytest.mark.parametrize("B,K,S,G,want", [
    (1, 1, 4096, 16, 8),    # recurrentgemma-9b: 8 already
    (2, 1, 4096, 16, 8),    # 128 blocks would take one group of 16
    (8, 1, 256, 16, 16),    # its training shape: 32 blocks, G groups
    (1, 8, 300, 3, 3),      # odd G: groups of one
    (4, 1, 2048, 1, 1),     # one head
])
def test_bwd_splits_max_group(B, K, S, G, want):
    """fp32 at hd 256 (``max_group=2``): groups of at most two heads."""
    assert cuda_lib.bwd_splits(B, K, S, G, max_group=2) == want
