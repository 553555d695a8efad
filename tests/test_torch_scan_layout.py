"""The arithmetic of ``csrc/mamba_scan.cu`` and ``csrc/rglru_scan.cu``,
mirrored on the CPU.

The mamba scan spreads a channel's N states over ``LANES[N]`` lanes (the
kernel's ``Geometry::kLanes``): lane j holds the float4 groups j,
j + lanes, ... of 4 states, adds ``h . C`` over its own states in that
order, and the lanes of a channel add their partial sums with
``__shfl_xor_sync`` (lane masks 1, 2, ...), which leaves every lane with
the same sum.  Each step's exponential is ``2^(dt * (A log2 e))``.
``mamba_lane_split`` below is a plain PyTorch mirror of that arithmetic,
held on numpy-seeded inputs against the port's plain version
(``repro_torch.kernels.ref.mamba_scan_ref``) and the JAX oracle
(``repro.kernels.ref.mamba_scan_ref``) at the card check's tolerance, 1e-4
abs + 1e-4 rel: every N, D just past a block's 64 channels, S past one
32-step tile, pad lanes (dt = 0) in every row but the first, float32 and
bf16 x.

The RG-LRU scan runs one thread a channel and walks time in register
tiles of ``TILE`` steps (the kernel's ``kTile``), loading the next tile
while it runs the current one; the decode step (S = 1) takes one
multiply-add without tiles.  ``rglru_tiles`` mirrors that schedule; it is
bit-identical to the port's sequential oracle and within 1e-5 of JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

ATOL = RTOL = 1e-4
LOG2E = 1.4426950408889634
LANES = {4: 1, 8: 2, 16: 2}    # lanes a channel, by state size N
TILE = 32                       # steps of an RG-LRU register tile


def mamba_lane_split(dt, Bm, Cm, x, A, Dsk, h0):
    """The mamba scan as ``mamba_scan.cu`` computes it: per-lane partial
    sums of ``h . C`` in each lane's state order, added in the shuffle
    order; exponentials as powers of 2.  Returns (y, h) like the oracles."""
    N = A.shape[-1]
    lanes = LANES[N]
    states = [[4 * g + i for g in range(j, N // 4, lanes) for i in range(4)]
              for j in range(lanes)]
    a2 = A.float() * LOG2E                               # once per lane
    h = h0.float().clone()
    ys = []
    for t in range(dt.shape[1]):
        dtt, xt = dt[:, t].float(), x[:, t].float()
        h = torch.exp2(dtt[..., None] * a2[None]) * h \
            + (dtt * xt)[..., None] * Bm[:, t, None, :].float()
        part = []
        for lane in states:
            p = torch.zeros_like(dtt)
            for n in lane:
                p = p + h[..., n] * Cm[:, t, None, n].float()
            part.append(p)
        mask = 1
        while mask < lanes:                    # __shfl_xor_sync butterfly
            part = [part[j] + part[j ^ mask] for j in range(lanes)]
            mask *= 2
        assert all(torch.equal(p, part[0]) for p in part)
        ys.append(part[0] + Dsk.float()[None] * xt)
    return torch.stack(ys, dim=1), h


def rglru_tiles(a, b, h0):
    """The RG-LRU scan in ``rglru_scan.cu``'s schedule: two register tiles
    in turn, the next tile loaded before the current one runs (S = 1
    takes one multiply-add and no tile).  Returns (hs, h)."""
    S = a.shape[1]
    h, hs = h0.clone(), torch.empty_like(a)
    if S == 1:                          # the decode step: no tiles
        h = a[:, 0] * h + b[:, 0]
        hs[:, 0] = h
        return hs, h

    def load(t0):
        return a[:, t0:t0 + TILE], b[:, t0:t0 + TILE]

    def run(tile, t0, h):
        for i in range(tile[0].shape[1]):
            h = tile[0][:, i] * h + tile[1][:, i]
            hs[:, t0 + i] = h
        return h

    tiles = [load(0), None]
    for t0 in range(0, S, 2 * TILE):
        if t0 + TILE < S:
            tiles[1] = load(t0 + TILE)
        h = run(tiles[0], t0, h)
        if t0 + TILE >= S:
            break
        if t0 + 2 * TILE < S:
            tiles[0] = load(t0 + 2 * TILE)
        h = run(tiles[1], t0 + TILE, h)
    return hs, h


def _mamba_inputs(seed, B, S, D, N, x_dtype):
    """The card tests' operands: softplus step sizes, per-(d, n) A,
    per-d skip, nonzero h0, and dt = 0 on the last lanes of every row but
    the first."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, D)) - 2.0))
    n_valid = [S] + [max(1, S - 3 * b) for b in range(1, B)]
    for b, nv in enumerate(n_valid):
        dt[b, nv:] = 0.0
    args = [a.astype(np.float32) for a in (
        dt, rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N)),
        rng.normal(size=(B, S, D)), -np.exp(0.5 * rng.normal(size=(D, N))),
        rng.normal(size=(D,)), rng.normal(size=(B, D, N)))]
    targs = [torch.from_numpy(a) for a in args]
    if x_dtype == "bfloat16":                  # both sides see the rounding
        targs[3] = targs[3].bfloat16()
        args[3] = targs[3].float().numpy()
    return args, targs, n_valid


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,N", [
    (3, 33, 65, 16),      # one step past a tile, one channel past a block
    (2, 70, 129, 8),      # three tiles, two channels past two blocks
    (2, 100, 67, 4),      # one lane a channel
    (8, 1, 64, 16),       # the decode step, a whole block
    (4, 32, 300, 16),     # the serve's chunk, a ragged last block
])
def test_mamba_lane_split_matches_references(x_dtype, B, S, D, N):
    args, targs, n_valid = _mamba_inputs(S + D + N, B, S, D, N, x_dtype)
    y, h = mamba_lane_split(*targs)
    want_y, want_h = ref.mamba_scan_ref(*targs)
    torch.testing.assert_close(y, want_y, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(h, want_h, atol=ATOL, rtol=RTOL)
    jy, jh = jref.mamba_scan_ref(*map(jnp.asarray, args))
    torch.testing.assert_close(y, torch.from_numpy(np.array(jy)),
                               atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(h, torch.from_numpy(np.array(jh)),
                               atol=ATOL, rtol=RTOL)
    for b, nv in enumerate(n_valid):            # pads leave h untouched
        _, hb = mamba_lane_split(*(t[b:b + 1, :nv] for t in targs[:4]),
                                 targs[4], targs[5], targs[6][b:b + 1])
        torch.testing.assert_close(h[b:b + 1], hb, atol=ATOL, rtol=RTOL)


def test_mamba_pad_lane_is_exactly_the_identity():
    """dt = 0 gives 2^0 = 1 and 0 * x * B = 0 in the lane split too."""
    _, targs, _ = _mamba_inputs(5, 2, 6, 64, 16, "float32")
    dt = torch.zeros_like(targs[0])
    y, h = mamba_lane_split(dt, *targs[1:])
    assert torch.equal(h, targs[6])
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 65, 100, 129])
def test_rglru_tiles_bit_identical(S):
    rng = np.random.default_rng(S)
    B, W = 3, 40
    a = 1 / (1 + np.exp(-rng.normal(size=(B, S, W))))
    b = rng.normal(size=(B, S, W))
    a[1:, S // 2:], b[1:, S // 2:] = 1.0, 0.0         # pad lanes
    a, b, h0 = (x.astype(np.float32) for x in (a, b,
                                                rng.normal(size=(B, W))))
    ta, tb, th0 = map(torch.from_numpy, (a, b, h0))
    hs, h = rglru_tiles(ta, tb, th0)
    want_hs, want_h = ref.rglru_scan_ref(ta, tb, th0)
    assert torch.equal(hs, want_hs) and torch.equal(h, want_h)
    jhs, jh = jref.rglru_scan_ref(*map(jnp.asarray, (a, b, h0)))
    torch.testing.assert_close(hs, torch.from_numpy(np.array(jhs)),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, torch.from_numpy(np.array(jh)),
                               atol=1e-5, rtol=1e-5)
