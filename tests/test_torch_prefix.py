"""The bidirectional prefix of full-sequence attention (``prefix_len`` P:
tokens below P attend each other both ways; the VLM's image patches, and
whisper's encoder with P = S) against the JAX package, on the CPU.

* ``attention_full_qkv`` with P in {0, 1, S // 3, S}, with and without a
  window and ragged lengths, against the JAX ``attention_full_qkv`` on the
  same (bridged) ``wo``: its dense form at S 40 and, at S 1100 (above
  ``ATTN_CHUNK``), both of its chunked forms (the causal-skip walk for P
  up to a chunk, the banded flash walk beyond).  1e-4 absolute + 1e-4
  relative, as the other attention-layer checks; rows at or past a
  sequence's length feed nothing and are not compared.
* The written-out backward (``flash_attention_bwd_ref``) against torch
  autograd of the plain forward, to 1e-5 of each gradient's largest
  magnitude; the plain lse over the same keys as a float64 log-sum-exp.
* The wrappers refuse a prefix outside [0, S] on the CPU as on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.registry import get_smoke_config as jsmoke
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.models import attention as A
from repro_torch.models.registry import get_smoke_config

LAYER_TOL = 1e-4


def _attn(arch="qwen3_0_6b", seed=1):
    jcfg = jsmoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    jp = jax.tree_util.tree_map(np.asarray, JL.init_params(
        JA.attn_def(jcfg, jnp.float32), jax.random.PRNGKey(seed)))
    p = A.Attention(cfg)
    p.load_state_dict({k: torch.tensor(v) for k, v in jp.items()})
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in jp.items()}, p


def _check_full_qkv(S, P, window, ragged, B=2):
    jcfg, cfg, jp, p = _attn()
    rng = np.random.default_rng(S + P)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    lengths = np.asarray([S, max(S // 3, 1)], np.int32) if ragged else None
    positions = jnp.arange(S, dtype=jnp.int32)[None, :]
    want = JA.attention_full_qkv(
        jcfg, jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), positions,
        window, None if lengths is None else jnp.asarray(lengths),
        prefix_len=P)
    got = A.attention_full_qkv(
        cfg, p, torch.tensor(q), torch.tensor(k), torch.tensor(v), window,
        None if lengths is None else torch.tensor(lengths), prefix_len=P)
    rows = (np.ones((B, S), bool) if lengths is None
            else np.arange(S)[None, :] < lengths[:, None])
    np.testing.assert_allclose(got.numpy()[rows],
                               np.asarray(want, np.float32)[rows],
                               atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("P", [0, 1, 13, 40])
def test_prefix_mask_matches_jax_dense(P, window, ragged):
    """S 40: the JAX function's dense form; P = S // 3 (13) and S."""
    _check_full_qkv(40, P, window, ragged)


@pytest.mark.parametrize("P,window,ragged", [
    (300, None, False),      # the causal-skip walk (P <= its 550 chunk)
    (1100, None, True),      # the banded flash walk, whisper's P = S
    (367, 64, True),         # P = S // 3 with a window: the flash walk
])
def test_prefix_mask_matches_jax_chunked(P, window, ragged):
    """S 1100, above ``ATTN_CHUNK``: the JAX chunked forms."""
    _check_full_qkv(1100, P, window, ragged)


def _inputs(B, H, K, S, hd, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64).float()
            for shape in ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd),
                          (B, H, S, hd))]


@pytest.mark.parametrize("P,window,lengths", [
    (1, None, None),
    (7, None, [21, 5]),
    (21, None, None),
    (12, 4, [21, 0]),        # a window inside the prefix, an empty row
    (21, 9, [17, 21]),
])
def test_prefix_backward_matches_autograd(P, window, lengths):
    """``flash_attention_bwd_ref`` (written out: recomputed scores, D,
    dS = P (dP - D)) against autograd of ``flash_attention_ref`` with the
    same prefix, to 1e-5 of each gradient's largest magnitude; and the
    plain lse against a float64 log-sum-exp over the same keys."""
    B, H, K, S, hd = 2, 4, 2, 21, 16
    q, k, v, do = _inputs(B, H, K, S, hd, seed=P + S)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    kw = dict(window=window, lengths=lens, prefix_len=P)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, **kw)
    out.backward(do)
    got = ref.flash_attention_bwd_ref(q, k, v, out.detach(), do, **kw)
    for g, leaf in zip(got, leaves):
        want = leaf.grad
        assert float((g - want).abs().max()) <= \
            1e-5 * max(float(want.abs().max()), 1e-30)
    # the CPU wrapper is the same function
    wrapped = flash_attention_bwd(q, k, v, out.detach(), do, **kw)
    for x, y in zip(wrapped, got):
        assert torch.equal(x, y)
    _, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    i = torch.arange(S)
    valid = (i[None, :] <= i[:, None]) | ((i[:, None] < P)
                                          & (i[None, :] < P))
    if window is not None:
        valid &= i[None, :] > i[:, None] - window
    valid = valid[None].expand(B, S, S).clone()
    if lens is not None:
        valid &= i[None, None, :] < lens[:, None, None]
    s = torch.einsum("bkgid,bkjd->bkgij",
                     q.double().reshape(B, K, H // K, S, hd),
                     k.double()) * hd ** -0.5
    want = torch.logsumexp(s.masked_fill(~valid[:, None, None], -torch.inf),
                           dim=-1).reshape(B, H, S)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(lse))
    assert float((lse[fin].double() - want[fin]).abs().max()) <= 1e-5


def test_wrappers_refuse_a_prefix_outside_the_sequence():
    B, H, K, S, hd = 1, 2, 1, 8, 16
    q, k, v, do = _inputs(B, H, K, S, hd, seed=0)
    for bad in (-1, S + 1):
        with pytest.raises(ValueError, match="prefix_len"):
            ops.flash_attention(q, k, v, prefix_len=bad)
        with pytest.raises(ValueError, match="prefix_len"):
            flash_attention_bwd(q, k, v, q, do, prefix_len=bad)
    # P = S is whisper's encoder: every token attends every token
    full = ops.flash_attention(q, k, v, prefix_len=S)
    ones = torch.ones(B, S, S, dtype=torch.bool)
    want = ref.masked_attention(q.reshape(B, K, H // K, S, hd)
                                .permute(0, 3, 1, 2, 4), k.transpose(1, 2),
                                v.transpose(1, 2), ones)
    torch.testing.assert_close(full, want.permute(0, 2, 3, 1, 4)
                               .reshape(B, H, S, hd), atol=1e-6, rtol=0)
