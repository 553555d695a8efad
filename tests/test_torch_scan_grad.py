"""The gradients of the port's two scans against the JAX package's.

``ref.mamba_scan_bwd_ref`` and ``ref.rglru_scan_bwd_ref`` (the plain
versions of the card's ``csrc/mamba_scan_bwd.cu`` and
``csrc/rglru_scan_bwd.cu``, written out as reverse-time loops) are held to
``jax.vjp`` of the JAX package's oracles ``repro.kernels.ref.mamba_scan_ref``
and ``rglru_scan_ref``, and to torch autograd of the port's plain
forwards, with random cotangents on both outputs (``y`` / ``hs`` and the
last state): a nonzero ``h0``, pad lanes (``dt = 0``; ``a = 1, b = 0``),
every state size the kernel takes, bf16 ``x``, and S not a multiple of
the backward kernel's tile (``mamba_scan.BWD_TILE``) nor of the
reference's ``SCAN_CHUNK``.  A plain mirror of the mamba kernel's walk
(the states kept at tile boundaries, each tile recomputed, channel sums
a block of ``BWD_CHANNELS`` added in block order) must give the same
gradients.  The autograd functions the wrappers use under grad mode give
the written-out gradients on CPU tensors and keep their own copy of
``h0``, which the mixers overwrite right after the call.

Tolerance: 1e-5 of each gradient's largest magnitude (float32 on both
sides, sums in another order; exp rounds differently in the two
frameworks); a bf16 ``dx`` also within one bf16 rounding of the float32
reference's.  The RG-LRU's mirror of its kernel is bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.mamba import SCAN_CHUNK
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as RS

TOL = 1e-5
MAMBA_NAMES = ("dt", "Bm", "Cm", "x", "A", "Dsk", "h0")


def _mamba_inputs(seed, B, S, D, N):
    """Inputs and cotangents (float32 numpy); the last rows of every
    sequence but the first are pad lanes (dt = 0)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, D)))) * 0.3
    for b in range(1, B):
        dt[b, S - 1 - (S * b) // (2 * B):] = 0.0
    args = [dt, rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N)),
            rng.normal(size=(B, S, D)), -np.exp(0.3 * rng.normal(size=(D, N))),
            rng.normal(size=(D,)), rng.normal(size=(B, D, N))]
    cts = [rng.normal(size=(B, S, D)), rng.normal(size=(B, D, N))]
    return ([a.astype(np.float32) for a in args],
            [c.astype(np.float32) for c in cts])


def _rglru_inputs(seed, B, S, W):
    """a, b, h0 and cotangents; the second half of every sequence but the
    first is pad lanes (a = 1, b = 0)."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.normal(size=(B, S, W))))
    b = rng.normal(size=(B, S, W))
    a[1:, S // 2:], b[1:, S // 2:] = 1.0, 0.0
    arrays = [a, b, rng.normal(size=(B, W)), rng.normal(size=(B, S, W)),
              rng.normal(size=(B, W))]
    return [x.astype(np.float32) for x in arrays]


def _close(got, want, name, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (name, err)


def _t(a):
    return torch.from_numpy(np.array(a))


# (B, S, D, N, x dtype): S 37 and 130 are multiples of neither the tile
# (16) nor the reference's chunk (128)
MAMBA_CASES = [(2, 37, 24, 4, torch.float32), (2, 37, 24, 8, torch.float32),
               (3, 37, 24, 16, torch.float32),
               (3, 20, 16, 16, torch.bfloat16),
               (2, SCAN_CHUNK + 2, 8, 8, torch.float32)]


def _written_out(args, cts, x_dtype):
    t = [_t(a) for a in args]
    t[3] = t[3].to(x_dtype)
    return ref.mamba_scan_bwd_ref(*t, *map(_t, cts))


@pytest.mark.parametrize("B,S,D,N,x_dtype", MAMBA_CASES)
def test_mamba_bwd_ref_matches_jax_vjp(B, S, D, N, x_dtype):
    args, cts = _mamba_inputs(N + S, B, S, D, N)
    if x_dtype == torch.bfloat16:     # both sides see the same rounded x
        args[3] = _t(args[3]).bfloat16().float().numpy()
    _, vjp = jax.vjp(jref.mamba_scan_ref, *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, cts)))
    got = _written_out(args, cts, x_dtype)
    assert got[3].dtype == x_dtype
    for name, g, w in zip(MAMBA_NAMES, got, want):
        if name == "x" and x_dtype == torch.bfloat16:   # rounded once
            w = np.asarray(w)
            err = np.abs(g.float().numpy() - w)
            assert (err <= 2.0 ** -8 * np.abs(w) + TOL * np.abs(w).max()).all()
        else:
            _close(g, w, name)


@pytest.mark.parametrize("B,S,D,N,x_dtype", MAMBA_CASES)
def test_mamba_bwd_ref_matches_autograd(B, S, D, N, x_dtype):
    args, cts = _mamba_inputs(N + S, B, S, D, N)
    t = [_t(a).requires_grad_(True) for a in args]
    xin = t[3].to(x_dtype)
    y, h = ref.mamba_scan_ref(*t[:3], xin, *t[4:])
    want = torch.autograd.grad((y * _t(cts[0])).sum()
                               + (h * _t(cts[1])).sum(), t)
    got = _written_out(args, cts, x_dtype)
    for name, g, w in zip(MAMBA_NAMES, got, want):
        if name == "x" and x_dtype == torch.bfloat16:
            err = (g.float() - w).abs()
            assert bool((err <= 2.0 ** -8 * w.abs() + TOL * w.abs().max())
                        .all())
        else:
            _close(g.detach(), w, name)


def _mamba_bwd_tiled(dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last):
    """A plain mirror of csrc/mamba_scan_bwd.cu's walk: the forward from h0
    keeps the state before each tile of ``BWD_TILE`` steps; the tiles are
    walked in reverse, each recomputed from its boundary; dC and dB are
    summed over each block of ``BWD_CHANNELS`` channels and the blocks'
    partials added in block order, dA and dDsk summed a sequence and the
    sequences added in order."""
    T, C = MS.BWD_TILE, MS.BWD_CHANNELS
    B, S, D = dt.shape
    xf = x.float()
    a_all = torch.exp(dt[..., None] * A)                    # [B,S,D,N]
    bounds, h = [], h0.clone()
    for t in range(S):
        if t % T == 0:
            bounds.append(h)
        h = a_all[:, t] * h + (dt[:, t] * xf[:, t])[..., None] * Bm[:, t, None]
    d_dt, dx = torch.empty_like(dt), torch.empty_like(xf)
    blocks = -(-D // C)
    part = torch.zeros(B, S, blocks, 2, Bm.shape[-1])
    part_a = torch.zeros(B, *A.shape)
    carry = dh_last.clone()
    for tile in reversed(range(len(bounds))):
        t0, nt = tile * T, min(T, S - tile * T)
        hs = [bounds[tile]]
        for t in range(t0, t0 + nt):
            hs.append(a_all[:, t] * hs[-1] + (dt[:, t] * xf[:, t])[..., None]
                      * Bm[:, t, None])
        for blk in range(blocks):
            sl = slice(blk * C, (blk + 1) * C)
            for tt in range(nt):
                part[:, t0 + tt, blk, 1] = torch.einsum(
                    "bd,bdn->bn", dy[:, t0 + tt, sl], hs[tt + 1][:, sl])
        w = [None] * nt
        for tt in reversed(range(nt)):
            t = t0 + tt
            g = dy[:, t, :, None] * Cm[:, t, None] + carry
            ah = a_all[:, t] * hs[tt]
            d_dt[:, t] = (g * (A * ah + xf[:, t, :, None] * Bm[:, t, None])) \
                .sum(-1)
            dx[:, t] = dt[:, t] * (g * Bm[:, t, None]).sum(-1) \
                + Dsk * dy[:, t]
            part_a += g * dt[:, t, :, None] * ah
            carry = a_all[:, t] * g
            w[tt] = g * (dt[:, t] * xf[:, t])[..., None]
        for blk in range(blocks):
            sl = slice(blk * C, (blk + 1) * C)
            for tt in range(nt):
                part[:, t0 + tt, blk, 0] = w[tt][:, sl].sum(1)
    dBm, dCm = part[:, :, 0, 0].clone(), part[:, :, 0, 1].clone()
    for blk in range(1, blocks):
        dBm += part[:, :, blk, 0]
        dCm += part[:, :, blk, 1]
    dA, dDsk = part_a[0].clone(), (dy[0] * xf[0]).sum(0)
    for b in range(1, B):
        dA += part_a[b]
        dDsk += (dy[b] * xf[b]).sum(0)
    return d_dt, dBm, dCm, dx.to(x.dtype), dA, dDsk, carry


@pytest.mark.parametrize("B,S,D,N", [(2, 37, 150, 8), (3, 16, 64, 16),
                                     (1, 5, 65, 4)])
def test_mamba_kernel_walk_mirror_matches_ref(B, S, D, N):
    """Tiles past, at and below one tile; D past one block, at one block
    and one channel past it."""
    args, cts = _mamba_inputs(D, B, S, D, N)
    got = _mamba_bwd_tiled(*map(_t, args), *map(_t, cts))
    want = _written_out(args, cts, torch.float32)
    for name, g, w in zip(MAMBA_NAMES, got, want):
        _close(g, w, name)


def _rglru_ref_args(a, b, h0, dhs, dh_last):
    hs, _ = ref.rglru_scan_ref(_t(a), _t(b), _t(h0))
    return _t(a), hs, _t(h0), _t(dhs), _t(dh_last)


RGLRU_CASES = [(2, 37, 24), (3, SCAN_CHUNK + 2, 16), (2, 1, 8)]


@pytest.mark.parametrize("B,S,W", RGLRU_CASES)
def test_rglru_bwd_ref_matches_jax_vjp(B, S, W):
    a, b, h0, dhs, dh_last = _rglru_inputs(S + W, B, S, W)
    _, vjp = jax.vjp(jref.rglru_scan_ref, *map(jnp.asarray, (a, b, h0)))
    want = vjp((jnp.asarray(dhs), jnp.asarray(dh_last)))
    got = ref.rglru_scan_bwd_ref(*_rglru_ref_args(a, b, h0, dhs, dh_last))
    for name, g, w in zip(("a", "b", "h0"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("B,S,W", RGLRU_CASES)
def test_rglru_bwd_ref_matches_autograd(B, S, W):
    a, b, h0, dhs, dh_last = _rglru_inputs(S + W, B, S, W)
    t = [_t(v).requires_grad_(True) for v in (a, b, h0)]
    hs, h = ref.rglru_scan_ref(*t)
    want = torch.autograd.grad((hs * _t(dhs)).sum() + (h * _t(dh_last)).sum(),
                               t)
    got = ref.rglru_scan_bwd_ref(*_rglru_ref_args(a, b, h0, dhs, dh_last))
    for name, g, w in zip(("a", "b", "h0"), got, want):
        _close(g, w, name)


def test_rglru_kernel_walk_mirror_matches_ref_bit_for_bit():
    """A plain mirror of csrc/rglru_scan_bwd.cu's walk: register tiles of
    16 steps from the end (the first one partial), g = dhs + carry, da = g
    h_{t-1}, carry = a g, each op rounded on its own."""
    a, hs, h0, dhs, dh_last = _rglru_ref_args(*_rglru_inputs(5, 2, 37, 12))
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = dh_last.clone()
    for t1 in range(a.shape[1], 0, -16):
        for t in range(t1 - 1, max(t1 - 16, 0) - 1, -1):
            g = torch.add(dhs[:, t], carry)
            da[:, t] = torch.mul(g, hs[:, t - 1] if t else h0)
            db[:, t] = g
            carry = torch.mul(a[:, t], g)
    want = ref.rglru_scan_bwd_ref(a, hs, h0, dhs, dh_last)
    for g, w in zip((da, db, carry), want):
        assert torch.equal(g, w)


# ------------------------------------------------- the autograd functions

def test_mamba_function_on_cpu_gives_written_out_gradients(monkeypatch):
    """Under grad mode the wrapper goes through ``_MambaScan``, whose
    backward is the written-out plain version (the same bits), within 1e-5
    of autograd of the plain path; the state tensor passed as h0 (which
    needs no gradient, as the mixers' state) is overwritten after the
    call, as ``mamba_mixer`` does, without changing the gradients."""
    args, cts = _mamba_inputs(3, 2, 37, 24, 8)
    calls = []
    fn = MS._MambaScan

    class Spy:
        @staticmethod
        def apply(*a):
            calls.append(len(a))
            return fn.apply(*a)

    monkeypatch.setattr(MS, "_MambaScan", Spy)
    t = [_t(a).requires_grad_(i < 6) for i, a in enumerate(args)]
    y, h = ops.mamba_scan(*t)
    t[6].copy_(h)                      # the mixer's state write
    got = torch.autograd.grad((y * _t(cts[0])).sum()
                              + (h * _t(cts[1])).sum(), t[:6])
    assert calls == [7]
    want = _written_out(args, cts, torch.float32)
    for name, g, w in zip(MAMBA_NAMES, got, want):
        assert torch.equal(g, w), name
    p = [_t(a).requires_grad_(i < 6) for i, a in enumerate(args)]
    y, h = ref.mamba_scan_ref(*p)
    plain = torch.autograd.grad((y * _t(cts[0])).sum()
                                + (h * _t(cts[1])).sum(), p[:6])
    for name, g, w in zip(MAMBA_NAMES, got, plain):
        _close(g, w, name)
    with torch.no_grad():              # no gradient: the bare plain call
        y2, _ = ops.mamba_scan(*t)
    assert calls == [7] and y2.grad_fn is None


def test_rglru_function_on_cpu_gives_written_out_gradients(monkeypatch):
    """As for mamba: ``_RGLRUScan`` on CPU tensors, its backward the
    written-out plain version, h0 overwritten after the call."""
    a, b, h0, dhs, dh_last = _rglru_inputs(4, 3, 37, 16)
    calls = []
    fn = RS._RGLRUScan

    class Spy:
        @staticmethod
        def apply(*x):
            calls.append(len(x))
            return fn.apply(*x)

    monkeypatch.setattr(RS, "_RGLRUScan", Spy)
    t = [_t(v).requires_grad_(True) for v in (a, b)] + [_t(h0)]
    hs, h = ops.rglru_scan(*t)
    t[2].copy_(h)                      # the mixer's state write
    got = torch.autograd.grad((hs * _t(dhs)).sum() + (h * _t(dh_last)).sum(),
                              t[:2])
    assert calls == [3]
    want = ref.rglru_scan_bwd_ref(*_rglru_ref_args(a, b, h0, dhs, dh_last))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hs2, _ = ops.rglru_scan(*(v.detach() for v in t))   # nothing needs grad
    assert calls == [3] and hs2.grad_fn is None
