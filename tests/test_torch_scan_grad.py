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
(each tile recomputed from the state the forward kept before it, g walked
back, the sums over a channel's states in its lanes' orders and over the
channels as a butterfly tree in each warp, then in warp and block order)
must give the same gradients, and the kept states
(``ref.mamba_scan_states_ref``) are the JAX oracle's last state on each
prefix of whole tiles.  The autograd functions the wrappers use under grad mode give
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


def _tree(v, dim):
    """Sum over ``dim`` (a power of two long) as a pairwise tree of
    neighbours, (v0 + v1) + (v2 + v3) ..., as a butterfly of shuffles adds
    it."""
    v = v.movedim(dim, -1)
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _in_order(v, dim):
    """Sum over ``dim`` from its first entry to its last."""
    s = v.select(dim, 0)
    for k in range(1, v.shape[dim]):
        s = s + v.select(dim, k)
    return s


def _channel_sums(w):
    """[B, D, N] -> [B, N] summed over d as the kernel adds dB_t and dC_t:
    a pairwise tree over each warp's channels (32 / (N / 4) of them:
    channel c with c ^ 1, then ^ 2, ...), the warps of a
    ``BWD_CHANNELS``-channel block in warp order, the blocks in block
    order (channels past D are zeros)."""
    B, D, N = w.shape
    C, per_warp = MS.BWD_CHANNELS, 32 // (N // 4)
    blocks = -(-D // C)
    w = torch.nn.functional.pad(w, (0, 0, 0, blocks * C - D))
    w = _tree(w.reshape(B, blocks, C // per_warp, per_warp, N), 3)
    return _in_order(_in_order(w, 2), 1)


def _mamba_bwd_tiled(dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last):
    """A plain mirror of csrc/mamba_scan_bwd.cu's walk: the tiles of
    ``BWD_TILE`` steps in reverse, each recomputed from the state the
    forward kept before it (``ref.mamba_scan_states_ref``); g walked back
    with a_t h_{t-1} taken as h_t - dt_t x_t B_t; d_dt and dx summed over
    each lane's 4 states in the lane's order (its two pairs swapped when
    its channel's bit 0 is set), A scaled by log2 e and the sum by ln 2,
    and over a channel's N / 4 lanes as a tree; dB and dC over channels as
    ``_channel_sums`` (the kernel fuses one product of each first add);
    dA and dDsk summed over the sequence from its end, and the sequences
    added in order."""
    T = MS.BWD_TILE
    B, S, D = dt.shape
    N = A.shape[-1]
    xf = x.float()
    bounds = ref.mamba_scan_states_ref(dt, Bm, xf, A, h0, T)
    d_dt, dx = torch.empty_like(dt), torch.empty_like(xf)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dacc, dd = torch.zeros(B, D, N), torch.zeros(B, D)
    carry = dh_last.clone()
    a2 = A * torch.tensor(1.4426950408889634, dtype=torch.float32)
    ln2 = torch.tensor(0.6931471805599453, dtype=torch.float32)
    swap = (torch.arange(D) % (32 // (N // 4)) % 2 == 1)[None, :, None, None]

    def by_lane(w):      # [B, D, N] -> [B, D, N / 4]: a lane's 4 in order
        w = w.reshape(B, D, N // 4, 4)
        return _in_order(torch.where(swap, w[..., [2, 3, 0, 1]], w), 3)

    for tile in reversed(range(bounds.shape[1])):
        t0, nt = tile * T, min(T, S - tile * T)
        hs, h = [], bounds[:, tile]
        for t in range(t0, t0 + nt):
            a = torch.exp(dt[:, t, :, None] * A)
            h = a * h + (dt[:, t] * xf[:, t])[..., None] * Bm[:, t, None]
            hs.append(h)
        for tt in reversed(range(nt)):
            t = t0 + tt
            dtx = (dt[:, t] * xf[:, t])[..., None]
            g = dy[:, t, :, None] * Cm[:, t, None] + carry
            u = g * (hs[tt] - dtx * Bm[:, t, None])      # g a_t h_{t-1}
            sa, sb = by_lane(a2 * u), by_lane(g * Bm[:, t, None])
            d_dt[:, t] = _tree(xf[:, t, :, None] * sb + sa * ln2, 2)
            dx[:, t] = dt[:, t] * _tree(sb, 2) + Dsk * dy[:, t]
            dacc = dacc + dt[:, t, :, None] * u
            carry = torch.exp(dt[:, t, :, None] * A) * g
            dBm[:, t] = _channel_sums(g * dtx)
            dCm[:, t] = _channel_sums(dy[:, t, :, None] * hs[tt])
            dd = dd + dy[:, t] * xf[:, t]
    return (d_dt, dBm, dCm, dx.to(x.dtype), _in_order(dacc, 0),
            _in_order(dd, 0), carry)


@pytest.mark.parametrize("B,S,D,N", [(2, 37, 150, 8), (3, 16, 64, 16),
                                     (1, 5, 65, 4), (2, 37, 300, 16)])
def test_mamba_kernel_walk_mirror_matches_ref(B, S, D, N):
    """Tiles past, at and below one tile; D past one block (two and three
    blocks), within one block, and one channel past a warp's."""
    args, cts = _mamba_inputs(D, B, S, D, N)
    got = _mamba_bwd_tiled(*map(_t, args), *map(_t, cts))
    want = _written_out(args, cts, torch.float32)
    for name, g, w in zip(MAMBA_NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("B,S,D,N,x_dtype", MAMBA_CASES[:4])
def test_mamba_states_ref_matches_jax_prefixes(B, S, D, N, x_dtype):
    """``ref.mamba_scan_states_ref``'s entry k is the JAX oracle's last
    state after the first k * ``BWD_TILE`` tokens (entry 0: h0 itself)."""
    args, _ = _mamba_inputs(N + S, B, S, D, N)
    args[3] = _t(args[3]).to(x_dtype).float().numpy()
    dt, Bm, Cm, x, A, Dsk, h0 = args
    T = MS.BWD_TILE
    got = ref.mamba_scan_states_ref(_t(dt), _t(Bm), _t(x).to(x_dtype),
                                    _t(A), _t(h0), T)
    assert got.shape == (B, -(-S // T), D, N) and got.dtype == torch.float32
    assert torch.equal(got[:, 0], _t(h0))     # the oracle takes no empty scan
    for k in range(1, got.shape[1]):
        pre = [jnp.asarray(v[:, :k * T]) for v in (dt, Bm, Cm, x)]
        _, want = jref.mamba_scan_ref(*pre, *map(jnp.asarray, (A, Dsk, h0)))
        _close(got[:, k], want, f"state before tile {k}")


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
