"""The port's ring-cache and full-sequence paths against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU, where every kernel wrapper runs its plain PyTorch
version:

* the two plain versions (``flash_attention_ref``, ``decode_attention_ref``)
  against ``repro.kernels.ref`` and the Pallas kernels in interpret mode,
  at the shapes of the JAX package's kernel tests;
* the ring layer (``prefill_into_cache``, ``_masked_ring_write``,
  ``attention_decode``, ``attention_extend``) and ``attention_full_qkv``;
* ``TransformerLM.forward``, ``prefill`` + ring ``decode_step`` and ring
  ``prefill_extend`` logits of five smoke models on bridged weights
  (granite-moe also with forward's MoE aux loss).

Tolerances: the kernels' plain versions 1e-5 in float32 (sums in another
order) and 2e-2 on bfloat16 inputs (the output is rounded to bfloat16,
2^-9 relative, on values up to ~4); the attention layers (projections
included) and model logits 1e-4 absolute + 1e-4 relative, as in
tests/test_torch_model.py.  Random-init attention is near one-hot, which
turns last-bit differences of float32 sums into O(1) logit changes
through a few layers, so the model-level checks scale the q and k
projections by 1/4 in both packages (the same weights on each side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models.registry import build_model, get_smoke_config

TOL = 1e-5
BF16_TOL = 2e-2
LAYER_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _normal(rng, shape, dtype):
    """Seeded normal inputs for both packages: float32 arrays, or bfloat16
    values handed over as their exact float32 copies."""
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x = _np(jnp.asarray(x, jnp.bfloat16))
    return x


def _cast(x, dtype):
    """(JAX array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = _t(x)
    return j, (t.bfloat16() if dtype == "bfloat16" else t)


# ------------------------------------------------------- plain versions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd,window", [
    (1, 4, 2, 256, 64, None),
    (2, 4, 4, 128, 32, None),       # MHA
    (2, 8, 2, 256, 64, 64),         # GQA + sliding window
    (1, 2, 1, 512, 128, 128),       # MQA
])
def test_flash_plain_matches_jax(B, H, K, S, hd, window, dtype):
    rng = np.random.default_rng(S + hd)
    (jq, q), (jk, k), (jv, v) = (
        _cast(_normal(rng, shape, dtype), dtype)
        for shape in ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd)))
    got = _np(ops.flash_attention(q, k, v, window=window).float())
    want_ref = _np(jref.flash_attention_ref(jq, jk, jv, window=window))
    want_pallas = _np(jops.flash_attention(jq, jk, jv, window=window, bq=64,
                                           bk=64, interpret=True))
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)


def _ring_tok(B, C, pos):
    """Ring occupancy of tests/test_kernels.py: tokens 0..pos written at
    slot t % C, later slots empty."""
    c = np.arange(C)[None, :]
    return np.where(c <= pos[:, None], c, -1).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,C,hd,window", [
    (2, 2, 2, 256, 64, None),
    (1, 4, 1, 128, 32, None),
    (2, 1, 8, 256, 64, 64),         # MQA ring with window
])
def test_decode_plain_matches_jax(B, K, G, C, hd, window, dtype):
    rng = np.random.default_rng(C + hd + G)
    (jq, q), (jk, k), (jv, v) = (
        _cast(_normal(rng, shape, dtype), dtype)
        for shape in ((B, K, G, hd), (B, C, K, hd), (B, C, K, hd)))
    pos = np.full((B,), C // 2 + 3, np.int32)
    tok = _ring_tok(B, C, pos)
    got = _np(ops.decode_attention(q, k, v, _t(tok), _t(pos),
                                   window=window).float())
    want_ref = _np(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(tok),
                                             jnp.asarray(pos), window=window))
    want_pallas = _np(jops.decode_attention(
        jq, jk, jv, jnp.asarray(tok), jnp.asarray(pos), window=window,
        bk=64, interpret=True))
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)


def test_decode_plain_ignores_empty_slots():
    """Slots with tok = -1 contribute nothing (tests/test_kernels.py), and
    a row whose every slot is empty is zeros."""
    rng = np.random.default_rng(2)
    B, K, G, C, hd = 2, 2, 2, 128, 32
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    pos = np.asarray([20, 20], np.int32)
    tok = _ring_tok(B, C, pos)
    tok[1] = -1
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(tok),
                               _t(pos)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, 21:], v2[:, 21:] = 100.0, -100.0          # garbage in empty slots
    got2 = ops.decode_attention(_t(q), _t(k2), _t(v2), _t(tok),
                                _t(pos)).numpy()
    np.testing.assert_allclose(got, got2, atol=TOL, rtol=TOL)
    want = _np(jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, tok,
                                                            pos))))
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got[1], 0.0)


def test_quant_decode_plain_matches_jax():
    """int8 ring with [B, C, K] sidecars (tests/test_quant_kv.py)."""
    rng = np.random.default_rng(2)
    B, K, G, hd, C = 2, 2, 2, 32, 64
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    tok = np.broadcast_to(np.arange(C)[None], (B, C)).astype(np.int32)
    pos = np.asarray([40, 63], np.int32)
    kq, ks, kz = JQ.quantize_k(jnp.asarray(k))
    vq, vs = JQ.quantize_v(jnp.asarray(v))
    got = ops.decode_attention(
        _t(q), _t(kq), _t(vq), _t(tok), _t(pos), k_scale=_t(ks),
        k_zero=_t(kz), v_scale=_t(vs)).numpy()
    args = (jnp.asarray(q), kq, vq, jnp.asarray(tok), jnp.asarray(pos))
    want_ref = _np(jref.decode_attention_ref(*args, k_scale=ks, k_zero=kz,
                                             v_scale=vs))
    want_pallas = _np(jops.decode_attention(*args, k_scale=ks, k_zero=kz,
                                            v_scale=vs, bk=16,
                                            interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want_pallas, atol=TOL, rtol=TOL)


def test_cpu_dispatch_of_new_kernels_launches_nothing():
    q = torch.rand(1, 2, 8, 32)
    kv = torch.rand(1, 2, 8, 32)
    ops.reset_launches()
    ops.flash_attention(q, kv, kv, lengths=torch.tensor([5],
                                                        dtype=torch.int32))
    ops.decode_attention(q[:, :, :2].transpose(1, 2).contiguous(),
                         kv.transpose(1, 2).contiguous(),
                         kv.transpose(1, 2).contiguous(),
                         torch.arange(8, dtype=torch.int32)[None],
                         torch.tensor([4], dtype=torch.int32))
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.LAUNCHES["decode_attention"] == 0


# ------------------------------------------------------------ ring layer

def _ring(rng, B, C, K, hd, quant, fill):
    """A ring holding tokens 0..fill[b]-1 (wrapped past C) and its port
    copy; int8 rings quantized by the JAX package."""
    k = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    c = np.arange(C)[None, :]
    last = fill[:, None] - 1
    tok = np.where(c <= last, last - (last - c) % C, -1).astype(np.int32)
    ring = {"k": k, "v": v, "tok": tok}
    if quant:
        kq, ks, kz = JQ.quantize_k(jnp.asarray(k))
        vq, vs = JQ.quantize_v(jnp.asarray(v))
        ring.update(k=np.asarray(kq), v=np.asarray(vq), ks=np.asarray(ks),
                    kz=np.asarray(kz), vs=np.asarray(vs))
    return ({n: jnp.asarray(a) for n, a in ring.items()}, _cache(ring))


def _cache(arrays):
    """The port's cache holding ``arrays``, made by ``empty_cache`` (whose
    K/V leaves keep the writes' scratch slot behind them)."""
    cache = A.empty_cache({n: (a.shape, _t(a).dtype)
                           for n, a in arrays.items()})
    for n, a in arrays.items():
        cache[n].copy_(_t(a))
    return cache


def _assert_ring_equal(got, want):
    """Same leaves, same slots; projected K/V rows to float32 rounding."""
    assert set(got) == set(want)
    for name, a in want.items():
        np.testing.assert_allclose(got[name].float().numpy(), _np(a),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("S,C", [(12, 16), (40, 16)])
def test_prefill_into_cache_matches_jax(quant, S, C):
    """Ragged lengths; with S > C only each row's last C tokens survive."""
    cfg = get_smoke_config("reflect_demo_100m")
    jcfg = jsmoke("reflect_demo_100m")
    rng = np.random.default_rng(S)
    B, K, hd = 3, cfg.num_kv_heads, cfg.head_dim
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    lengths = np.asarray([S, S - 5, 3], np.int32)
    kvd = "int8" if quant else None
    want = JA.prefill_into_cache(
        JA.init_kv_cache(jcfg, B, C, jnp.float32, kv_dtype=kvd),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    if quant:                      # the JAX function passes sidecars on too
        assert set(want) == {"k", "v", "tok", "ks", "kz", "vs"}
    got = A.prefill_into_cache(
        A.init_kv_cache(cfg, B, C, torch.float32, kv_dtype=kvd), _t(k),
        _t(v), _t(lengths))
    _assert_ring_equal(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_masked_ring_write_matches_jax(quant):
    """Pad lanes are not written; with Sx > C two lanes alias a slot and
    the later lane wins."""
    cfg = get_smoke_config("qwen3_0_6b")
    rng = np.random.default_rng(4)
    B, Sx, C, K, hd = 3, 12, 8, cfg.num_kv_heads, cfg.head_dim
    jring, ring = _ring(rng, B, C, K, hd, quant, np.asarray([3, 8, 0]))
    k = rng.normal(size=(B, Sx, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sx, K, hd)).astype(np.float32)
    pos0 = np.asarray([3, 8, 0], np.int32)
    positions = pos0[:, None] + np.arange(Sx)[None, :]
    valid = np.arange(Sx)[None, :] < np.asarray([12, 4, 10])[:, None]
    want = JA._masked_ring_write(jring, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(positions), jnp.asarray(valid))
    got = A._masked_ring_write(ring, _t(k), _t(v), _t(positions),
                               _t(valid))
    _assert_ring_equal(got, want)


def _attn_params(arch, seed):
    jcfg = jsmoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    jp = jax.tree_util.tree_map(np.asarray, JL.init_params(
        JA.attn_def(jcfg, jnp.float32), jax.random.PRNGKey(seed)))
    p = A.Attention(cfg)
    p.load_state_dict({k: torch.tensor(v) for k, v in jp.items()})
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in jp.items()}, p


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("window", [None, 12])
def test_attention_decode_and_extend_on_one_ring_match_jax(quant, window):
    """A mixed extend (uneven valid lanes, a row with none) and then a
    decode step, on one wrapped ring."""
    jcfg, cfg, jp, p = _attn_params("reflect_demo_100m", 0)
    rng = np.random.default_rng(5)
    B, C = 3, 16
    fill = np.asarray([5, 21, 40], np.int32)
    jring, ring = _ring(rng, B, C, cfg.num_kv_heads, cfg.head_dim, quant,
                        fill)
    Sx = 6
    x = rng.normal(size=(B, Sx, cfg.d_model)).astype(np.float32)
    valid = np.arange(Sx)[None, :] < np.asarray([6, 2, 0])[:, None]
    want, jring = JA.attention_extend(jcfg, jp, jnp.asarray(x), jring,
                                      jnp.asarray(fill), window,
                                      jnp.asarray(valid))
    got, ring = A.attention_extend(cfg, p, _t(x), ring, _t(fill), window,
                                   _t(valid))
    # pad lanes are computed but read by nobody: compare the valid lanes
    np.testing.assert_allclose(got.numpy()[valid], _np(want)[valid],
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    _assert_ring_equal(ring, jring)
    pos = fill + valid.sum(1).astype(np.int32)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    want, jring = JA.attention_decode(jcfg, jp, jnp.asarray(x1), jring,
                                      jnp.asarray(pos), window)
    got, ring = A.attention_decode(cfg, p, _t(x1), ring, _t(pos), window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    _assert_ring_equal(ring, jring)


@pytest.mark.parametrize("S", [300, 1100], ids=["dense", "flash"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("ragged", [False, True])
def test_attention_full_qkv_matches_jax(S, window, ragged):
    """Both of the JAX function's forms (dense up to ATTN_CHUNK, XLA flash
    above) against the port's one flash path, with window and lengths;
    rows at or past a sequence's length feed nothing and are not
    compared."""
    jcfg, cfg, jp, p = _attn_params("qwen3_0_6b", 1)
    rng = np.random.default_rng(S)
    B, H, K, hd = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    lengths = np.asarray([S, S // 3], np.int32) if ragged else None
    positions = jnp.arange(S, dtype=jnp.int32)[None, :]
    want = JA.attention_full_qkv(
        jcfg, jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), positions,
        window, None if lengths is None else jnp.asarray(lengths))
    got = A.attention_full_qkv(cfg, p, _t(q), _t(k), _t(v), window,
                               None if lengths is None else _t(lengths))
    rows = (np.ones((B, S), bool) if lengths is None
            else np.arange(S)[None, :] < lengths[:, None])
    np.testing.assert_allclose(got.numpy()[rows], _np(want)[rows],
                               atol=LAYER_TOL, rtol=LAYER_TOL)


def test_prefix_len_is_not_ported():
    """The bidirectional prefix, once refused here, now runs: a prefix of
    2 of 4 tokens gives the JAX function's output (tests/test_torch_prefix.py
    holds it to the JAX package over windows, lengths and S past
    ATTN_CHUNK)."""
    jcfg, cfg, jp, p = _attn_params("qwen3_0_6b", 1)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 4, cfg.num_heads, cfg.head_dim))
    kv = rng.normal(size=(1, 4, cfg.num_kv_heads, cfg.head_dim))
    q, kv = q.astype(np.float32), kv.astype(np.float32)
    want = JA.attention_full_qkv(jcfg, jp, jnp.asarray(q), jnp.asarray(kv),
                                 jnp.asarray(kv),
                                 jnp.arange(4, dtype=jnp.int32)[None, :],
                                 None, prefix_len=2)
    got = A.attention_full_qkv(cfg, p, _t(q), _t(kv), _t(kv), None,
                               prefix_len=2)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)


# ------------------------------------------------------------ the model

ARCHS = ("reflect_demo_100m", "qwen3_0_6b", "falcon_mamba_7b",
         "recurrentgemma_9b", "granite_moe_1b_a400m")


def _pair(arch):
    """(JAX model, params, port model) on the same weights, q/k softened."""
    jm = jbuild(jsmoke(arch).replace(dtype="float32"))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.25 if path[-1].key in ("wq", "wk") else x,
        jm.init(jax.random.PRNGKey(0)))
    m = build_model(get_smoke_config(arch).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


def _close(got, want, rows=None):
    got, want = got.numpy(), _np(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_and_verify_match_jax(arch):
    """forward; prefill of ragged rows (S = 40 runs past recurrentgemma's
    32-token local window, so its rings wrap) then ring decode steps; then
    an all-lane verify extend on the same ring."""
    jm, params, m = _pair(arch)
    B, S = 2, 40
    rng = np.random.default_rng(7)
    tokens = rng.integers(3, m.cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 27], np.int32)
    want, jaux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    got, aux = m.forward({"tokens": _t(tokens)})
    _close(got, want)
    # MoE load balancing (granite); exactly 0 without MoE blocks
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert (float(aux) > 0) == ("moe" in m.cfg.block_pattern)
    want, jcache = jm.prefill(params, jnp.asarray(tokens),
                              jnp.asarray(lengths), max_seq=64)
    got, cache = m.prefill(_t(tokens), _t(lengths), max_seq=64)
    _close(got, want)
    nxt = np.argmax(_np(want), -1)[:, None].astype(np.int32)
    pos = lengths.copy()
    for _ in range(3):
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt),
                                      jnp.asarray(pos))
        got, cache = m.decode_step(cache, _t(nxt), _t(pos))
        _close(got, want)
        nxt = np.argmax(_np(want), -1)[:, None].astype(np.int32)
        pos = pos + 1
    blk = np.concatenate([nxt, nxt + 1, nxt + 2], axis=1).astype(np.int32)
    nv = np.asarray([3, 2], np.int32)
    want, _ = jm.prefill_extend(params, jcache, jnp.asarray(blk),
                                jnp.asarray(pos), jnp.asarray(nv),
                                all_logits=True)
    got, _ = m.prefill_extend(cache, _t(blk), _t(pos), _t(nv),
                              all_logits=True)
    _close(got, want, np.arange(3)[None, :] < nv[:, None])


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_chunked_prefill_extend_matches_jax(arch):
    """Chunked prefill into empty rings (rows advance at 5 and 3 tokens a
    step, n_valid masking), then decode steps: the engine's ring walk."""
    jm, params, m = _pair(arch)
    B, S, max_seq = 2, 45, 64
    tokens = np.random.default_rng(3).integers(3, m.cfg.vocab_size, (B, S))
    jcache = JL.init_empty_cache(jm.cache_defs(B, max_seq, seq_shard=False))
    jext = jax.jit(jm.prefill_extend, static_argnames=("all_logits",))
    cache = m.init_cache(B, max_seq, device=torch.device("cpu"))
    sizes, prog = [5, 3], [0, 0]
    while min(prog) < S:
        blk = np.zeros((B, 5), np.int32)
        nv = np.zeros(B, np.int32)
        p0 = np.zeros(B, np.int32)
        for b in range(B):
            n = min(sizes[b], S - prog[b])
            blk[b, :n] = tokens[b, prog[b]:prog[b] + n]
            nv[b], p0[b] = n, prog[b]
            prog[b] += n
        want, jcache = jext(params, jcache, jnp.asarray(blk),
                            jnp.asarray(p0), jnp.asarray(nv))
        got, cache = m.prefill_extend(cache, _t(blk), _t(p0), _t(nv))
        _close(got, want, nv > 0)
    nxt = np.argmax(_np(want), -1)[:, None].astype(np.int32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt),
                                      jnp.asarray(pos))
        got, cache = m.decode_step(cache, _t(nxt), _t(pos))
        _close(got, want)
        nxt = np.argmax(_np(want), -1)[:, None].astype(np.int32)
