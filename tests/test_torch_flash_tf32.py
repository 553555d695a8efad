"""The arithmetic of the float32 flash kernels on the tensor cores, on the
CPU: 3xTF32 products.

The float32 bodies of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` (``csrc/flash_tf32.cuh``) compute each
product of fp32 matrices as three TF32 products: every input x is split
into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, both rounded to nearest
with ties away from zero (``cvt.rna.tf32.f32``), and ``a b = lo_a hi_b +
hi_a lo_b + hi_a hi_b`` is added into fp32 accumulators in that order,
eight terms of the reduction (one wgmma k-step) at a time.  This file
emulates those products in plain PyTorch (a test helper: nothing on the
port's path calls it), runs the algorithm of ``ref.flash_attention_ref``
and ``ref.flash_attention_bwd_ref`` (masked scores, P from each row's
log-sum-exp, D = rowsum(dO o), dS = P (dP - D)) through it, and holds the
result to the JAX package's reference (``repro.kernels.ref``, the Pallas
kernel in interpret mode, ``attention_full_qkv`` where lengths or a
prefix are given, and ``jax.vjp`` of them for the gradients) within the
card check's bounds: the output to 1e-4 absolute and relative, each
gradient to 1e-4 of max(its largest magnitude, 1).  One TF32 product
alone misses those bounds (the test that says why three are needed); a
row with no attendable key gives zeros and zero gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models.registry import get_smoke_config as jsmoke
from repro_torch.kernels import ref

TOL = 1e-4
LOG2E = 1.4426950408889634

# (B, H, K, S, hd, window, lengths, prefix): the demo's GQA at a small S,
# windowed, ragged with an empty row, whisper's encoder (P = S), a prefix
# below S with a window and lengths, and head dims 32, 128, 256
CASES = {
    "demo": (2, 6, 2, 128, 64, None, None, 0),
    "window": (2, 4, 1, 130, 64, 40, None, 0),
    "ragged": (3, 4, 4, 77, 64, None, [77, 0, 30], 0),
    "prefix_all": (2, 6, 6, 150, 64, None, None, 150),
    "prefix_part": (2, 4, 2, 200, 64, 20, [200, 100], 150),
    "hd32": (2, 4, 2, 77, 32, 16, [77, 40], 0),
    "hd128": (2, 8, 2, 100, 128, None, None, 0),
    "hd256": (1, 4, 1, 65, 256, 48, None, 0),
}


# ---------------------------------------------------------- the emulation

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the bits: ``cvt.rna.tf32.f32``."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, n] @ b [..., n, N] as the kernels' 3xTF32 wgmma: per
    eight terms of n, lo_a hi_b, then hi_a lo_b, then hi_a hi_b, into one
    fp32 accumulator."""
    (ah, al), (bh, bl) = split(a.float()), split(b.float())
    acc = torch.zeros(*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]),
                      a.shape[-2], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        acc = acc + al[..., s] @ bh[..., s, :]
        acc = acc + ah[..., s] @ bl[..., s, :]
        acc = acc + ah[..., s] @ bh[..., s, :]
    return acc


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product of the inputs rounded to TF32."""
    return tf32(a.float()) @ tf32(b.float())


def emulated_flash(q, k, v, do, window, lengths, prefix, mm=mm3):
    """(o, lse, dq, dk, dv) by the plain versions' algorithm with every
    product through ``mm``, as the kernels run it: the scores' log2-domain
    exponentials, P from each row's lse, an empty row's lse +inf (zeros
    out and zero gradients)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = hd ** -0.5
    valid = ref._flash_valid(S, window, lengths, q.device,
                             prefix)[:, None, None]       # [B|1,1,1,S,S]
    q5 = q.reshape(B, K, G, S, hd)
    do5 = do.reshape(B, K, G, S, hd)
    kt, vt = k[:, :, None], v[:, :, None]                 # [B,K,1,S,hd]
    s = mm(q5, kt.transpose(-1, -2))
    s = s.masked_fill(~valid, -torch.inf)
    m = s.amax(-1, keepdim=True) * scale * LOG2E
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp2(s * scale * LOG2E - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, vt) / torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, (m + torch.log2(l)) / LOG2E,
                      torch.full_like(l, torch.inf))
    p = torch.exp2(s * scale * LOG2E - lse * LOG2E)       # from lse
    delta = (do5 * o).sum(-1, keepdim=True)
    ds = p * (mm(do5, vt.transpose(-1, -2)) - delta)
    dq = mm(ds, kt) * scale
    dk = (mm(ds.transpose(-1, -2), q5) * scale).sum(2)
    dv = mm(p.transpose(-1, -2), do5).sum(2)
    return (o.reshape(B, H, S, hd), lse.reshape(B, H, S),
            dq.reshape(B, H, S, hd), dk, dv)


# ------------------------------------------------------ the JAX reference

def _inputs(B, H, K, S, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, H, S, hd), f(B, K, S, hd), f(B, K, S, hd), f(B, H, S, hd)


def jax_flash(q, k, v, do, window, lengths, prefix):
    """(o, dq, dk, dv) of the JAX package: ``repro.kernels.ref`` (causal,
    a window) or ``attention_full_qkv`` with an identity output
    projection (lengths, a prefix), and ``jax.vjp`` of it."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    if lengths is None and not prefix:
        fn = lambda a, b, c: jref.flash_attention_ref(a, b, c, window=window)
    else:
        cfg = jsmoke("qwen3_0_6b").replace(
            num_heads=H, num_kv_heads=K, head_dim=hd, dtype="float32")
        eye = {"wo": jnp.eye(H * hd, dtype=jnp.float32).reshape(H, hd,
                                                                H * hd)}
        pos = jnp.arange(S, dtype=jnp.int32)[None, :]
        lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)

        def fn(a, b, c):
            out = JA.attention_full_qkv(
                cfg, eye, a.transpose(0, 2, 1, 3), b.transpose(0, 2, 1, 3),
                c.transpose(0, 2, 1, 3), pos, window, lens, prefix_len=prefix)
            return out.reshape(B, S, H, hd).transpose(0, 2, 1, 3)
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(o), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


def _rows(B, S, window, lengths, prefix):
    """[B, 1, S, 1] rows that attend a key.  The JAX softmax of a row with
    none is its mean of V, the port's zeros (``test_empty_rows_give_zeros``),
    so the JAX comparisons leave those rows out and give them no output
    gradient."""
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    valid = ref._flash_valid(S, window, tl, torch.device("cpu"), prefix)
    return np.broadcast_to(valid.any(-1).numpy(), (B, S))[:, None, :, None]


def _worst(got, want):
    """Largest error of each gradient over max(its largest magnitude, 1)."""
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1.0)
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_tf32_products_match_jax(case):
    """The 3xTF32 emulation of both kernels against the JAX reference:
    the output to 1e-4 (rows that attend a key), the gradients to 1e-4 of
    max(largest, 1), and the lse to 1e-4 of the port's plain lse."""
    B, H, K, S, hd, window, lengths, P = CASES[case]
    q, k, v, do = _inputs(B, H, K, S, hd, seed=S + hd + H)
    do = do * _rows(B, S, window, lengths, P)
    t = [torch.tensor(x) for x in (q, k, v, do)]
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    o, lse, *grads = emulated_flash(*t, window, tl, P)
    want_o, *want = jax_flash(q, k, v, do, window, lengths, P)
    rows = np.broadcast_to(_rows(B, S, window, lengths, P), o.shape)
    np.testing.assert_allclose(o.numpy()[rows], want_o[rows], atol=TOL,
                               rtol=TOL)
    _, plain_lse = ref.flash_attention_ref(*t[:3], window=window, lengths=tl,
                                           prefix_len=P, return_lse=True)
    assert torch.equal(torch.isinf(lse), torch.isinf(plain_lse))
    fin = torch.isfinite(plain_lse)
    assert float((lse[fin] - plain_lse[fin]).abs().max()) <= TOL
    assert _worst([g.numpy() for g in grads], want) <= TOL


def test_three_tf32_products_match_the_pallas_kernel():
    """The emulated forward against the Pallas flash kernel in interpret
    mode (the TPU kernel the fp32 body replaces) at the demo's GQA."""
    B, H, K, S, hd, window, _, _ = CASES["demo"]
    q, k, v, do = _inputs(B, H, K, S, hd, seed=1)
    o = emulated_flash(*(torch.tensor(x) for x in (q, k, v, do)), window,
                       None, 0)[0]
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), window=window, bq=64, bk=64,
        interpret=True))
    np.testing.assert_allclose(o.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", ["demo", "prefix_all", "hd128"])
def test_one_tf32_product_misses_the_bound(case):
    """One TF32 product (inputs rounded to 10 mantissa bits) misses the
    1e-4 the card holds float32 attention to, where three products meet
    it: the reason the fp32 bodies issue three."""
    B, H, K, S, hd, window, lengths, P = CASES[case]
    q, k, v, do = _inputs(B, H, K, S, hd, seed=S + hd + H)
    t = [torch.tensor(x) for x in (q, k, v, do)]
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    want_o, *want = jax_flash(q, k, v, do, window, lengths, P)
    errs = {}
    for name, mm in (("one", mm1), ("three", mm3)):
        o, _, *grads = emulated_flash(*t, window, tl, P, mm=mm)
        errs[name] = max(float(np.abs(o.numpy() - want_o).max()),
                         _worst([g.numpy() for g in grads], want))
    assert errs["three"] <= TOL < errs["one"], errs


def test_empty_rows_give_zeros():
    """A row with no attendable key (lengths 0, and rows past a window's
    reach of a short length) gives a zero output, lse +inf and zero
    gradients through the 3xTF32 walk, as the plain versions give."""
    B, H, K, S, hd = 3, 4, 2, 40, 32
    q, k, v, do = (torch.tensor(x) for x in _inputs(B, H, K, S, hd, seed=5))
    lengths = torch.tensor([0, 40, 3], dtype=torch.int32)
    o, lse, dq, dk, dv = emulated_flash(q, k, v, do, 8, lengths, 0)
    empty = ~ref._flash_valid(S, 8, lengths, q.device, 0).any(-1)  # [B, S]
    assert bool(empty[0].all()) and bool(empty[2, 11:].all())
    rows = empty[:, None].expand(B, H, S)
    assert not o[rows].any() and not dq[rows].any()
    assert bool(torch.isinf(lse[rows]).all() and (lse[rows] > 0).all())
    assert not dk[0].any() and not dv[0].any()
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, window=8,
                                       lengths=lengths)
    for g, w in zip((dq, dk, dv), want):
        assert float((g - w).abs().max()) <= TOL * max(float(w.abs().max()),
                                                       1.0)
    plain = ref.flash_attention_ref(q, k, v, window=8, lengths=lengths)
    assert float((o - plain).abs().max()) <= TOL
