"""The port's paged-attention kernels against the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; it is held
against ``repro.kernels.ref`` and the Pallas kernels in interpret mode on
the same numpy inputs, in fp and int8 modes, with and without a window,
rows with no valid slot included (the mean of the V rows their table
gathers, page 0's for unmapped entries, as the TPU kernels give them).
The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

TOL = 1e-5


def _inputs(B=3, Sx=6, K=2, G=4, hd=64, ps=16, NP=8, P=40, seed=0):
    """The geometry of tests/test_paged_extend.py: scattered physical
    pages and per-request unmapped tails past the lane frontier."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sx, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    pt = rng.permutation(P)[: B * NP].reshape(B, NP).astype(np.int32)
    pos0 = np.asarray([37, 90, NP * ps - Sx], np.int32)[:B]
    for b in range(B):
        used = (int(pos0[b]) + Sx + ps - 1) // ps
        pt[b, used:] = -1
    return q, kp, vp, pt, pos0


def _pools(kp, vp, quant):
    """fp pools, or int8 pools + sidecars quantized by the JAX package."""
    if not quant:
        return kp, vp, {}
    kq, ks, kz = JQ.quantize_k(jnp.asarray(kp))
    vq, vs = JQ.quantize_v(jnp.asarray(vp))
    return (np.asarray(kq), np.asarray(vq),
            {"k_scale": np.asarray(ks), "k_zero": np.asarray(kz),
             "v_scale": np.asarray(vs)})


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("window", [None, 48])
def test_extend_plain_matches_jax(quant, window):
    q, kp, vp, pt, pos0 = _inputs(seed=int(quant))
    kp, vp, sc = _pools(kp, vp, quant)
    got = ops.paged_extend_attention(
        _t(q), _t(kp), _t(vp), _t(pt), _t(pos0), window=window,
        **{k: _t(v) for k, v in sc.items()}).numpy()
    jsc = {k: _j(v) for k, v in sc.items()}
    want_ref = jref.paged_extend_attention_ref(
        _j(q), _j(kp), _j(vp), _j(pt), _j(pos0), window=window, **jsc)
    want_pallas = jops.paged_extend_attention(
        _j(q), _j(kp), _j(vp), _j(pt), _j(pos0), window=window,
        interpret=True, **jsc)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("window", [None, 48])
def test_decode_plain_matches_jax(quant, window):
    q, kp, vp, pt, pos0 = _inputs(Sx=1, seed=2 + int(quant))
    q = q[:, 0]
    kp, vp, sc = _pools(kp, vp, quant)
    got = ops.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(pt), _t(pos0), window=window,
        **{k: _t(v) for k, v in sc.items()}).numpy()
    jsc = {k: _j(v) for k, v in sc.items()}
    want_ref = jref.paged_decode_attention_ref(
        _j(q), _j(kp), _j(vp), _j(pt), _j(pos0), window=window, **jsc)
    want_pallas = jops.paged_decode_attention(
        _j(q), _j(kp), _j(vp), _j(pt), _j(pos0), window=window,
        interpret=True, **jsc)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_extend_single_lane_equals_decode(quant):
    """An Sx=1 extend is a decode step on the same pool state."""
    q, kp, vp, pt, pos0 = _inputs(Sx=1, seed=4)
    kp, vp, sc = _pools(kp, vp, quant)
    sc = {k: _t(v) for k, v in sc.items()}
    ext = ops.paged_extend_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                     _t(pos0), **sc)
    dec = ops.paged_decode_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(pt),
                                     _t(pos0), **sc)
    np.testing.assert_allclose(ext[:, 0].numpy(), dec.numpy(), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_rows_without_valid_slot_are_zero(window):
    """An unmapped row (an idle batch slot) reads the mean of physical page
    0's V, and lanes whose window holds no mapped slot the mean of every
    V row their table gathers, as the JAX oracle and the Pallas kernels
    give them (no longer the port's former zeros); every row matches."""
    q, kp, vp, pt, pos0 = _inputs(B=3, Sx=6)
    pt[1, :] = -1                                   # an empty batch slot
    if window is not None:
        # row 0's lanes 0..2 (positions 45..47) see only page 2, unmapped
        # here; lanes 3..5 reach into page 3, mapped to a free page
        pos0[0] = 45
        pt[0, 2] = -1
        pt[0, 3] = min(set(range(kp.shape[0])) - set(pt.ravel().tolist()))
    for quant in (False, True):
        kq, vq, sc = _pools(kp, vp, quant)
        got = ops.paged_extend_attention(
            _t(q), _t(kq), _t(vq), _t(pt), _t(pos0), window=window,
            **{k: _t(v) for k, v in sc.items()}).numpy()
        dec = ops.paged_decode_attention(
            _t(q[:, 0]), _t(kq), _t(vq), _t(pt), _t(pos0), window=window,
            **{k: _t(v) for k, v in sc.items()}).numpy()
        assert np.isfinite(got).all()
        jsc = {k: _j(v) for k, v in sc.items()}
        for want in (jref.paged_extend_attention_ref(
                         _j(q), _j(kq), _j(vq), _j(pt), _j(pos0),
                         window=window, **jsc),
                     jops.paged_extend_attention(
                         _j(q), _j(kq), _j(vq), _j(pt), _j(pos0),
                         window=window, interpret=True, **jsc)):
            np.testing.assert_allclose(got, np.asarray(want), atol=TOL,
                                       rtol=TOL)
        jdec = jops.paged_decode_attention(
            _j(q[:, 0]), _j(kq), _j(vq), _j(pt), _j(pos0), window=window,
            interpret=True, **jsc)
        np.testing.assert_allclose(dec, np.asarray(jdec), atol=TOL,
                                   rtol=TOL)
        v0 = vq[0] if not quant else vq[0] * sc["v_scale"][0][..., None]
        np.testing.assert_allclose(                 # page 0's mean V
            dec[1], np.broadcast_to(v0.mean(0)[:, None], dec[1].shape),
            atol=TOL, rtol=TOL)


def test_cpu_dispatch_launches_no_kernel():
    """CPU tensors take the plain version; the launch counters count
    kernel launches only."""
    q, kp, vp, pt, pos0 = _inputs(Sx=2)
    ops.reset_launches()
    ops.paged_extend_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(pos0))
    ops.paged_decode_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(pt),
                               _t(pos0))
    a, bc = torch.rand(2, 3, 8), torch.rand(2, 3, 4)
    ops.rglru_scan(a, a, a[:, 0])
    ops.mamba_scan(a, bc, bc, a, -torch.ones(8, 4), torch.ones(8),
                   torch.zeros(2, 8, 4))
    assert ops.LAUNCHES == {"paged_decode": 0, "paged_extend": 0,
                            "decode_attention": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "mamba_scan": 0,
                            "mamba_scan_bwd": 0, "rglru_scan": 0,
                            "rglru_scan_bwd": 0}
    assert ops.resolve_attn_impl(torch.device("cpu")) == "plain"
