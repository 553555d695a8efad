"""The port's paged attention layers and TransformerLM against the JAX
package, on the same weights (bridged with ``params_from_jax``), pools,
page tables and inputs.  Paged is compared with paged only: the JAX
package's own paged-vs-ring parity does not hold bit for bit on every
architecture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as JQ
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro_torch.bridge import params_from_jax
from repro_torch.models import attention as A
from repro_torch.models.registry import build_model, get_smoke_config

TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch):
    """(JAX model, JAX params, port model) with identical fp32 weights."""
    jcfg = jsmoke(arch).replace(dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_smoke_config(arch).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(_np_tree(params)))
    return jm, params, m


def _pool(rng, P, ps, K, hd, quant):
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    if not quant:
        return {"kp": kp, "vp": vp}
    kq, ks, kz = JQ.quantize_k(jnp.asarray(kp))
    vq, vs = JQ.quantize_v(jnp.asarray(vp))
    return {k: np.asarray(v) for k, v in
            (("kp", kq), ("vp", vq), ("ksp", ks), ("kzp", kz), ("vsp", vs))}


def _cache(arrays):
    """The port's pool holding ``arrays``, made by ``empty_cache`` (whose
    K/V leaves keep the writes' scratch slot behind them)."""
    cache = A.empty_cache({n: (a.shape, torch.tensor(a).dtype)
                           for n, a in arrays.items()})
    for n, a in arrays.items():
        cache[n].copy_(torch.tensor(a))
    return cache


def _attn_setup(arch, quant, seed):
    jcfg = jsmoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    jp = _np_tree(JL.init_params(JA.attn_def(jcfg, jnp.float32),
                                 jax.random.PRNGKey(seed)))
    p = A.Attention(cfg)
    p.load_state_dict({k: torch.tensor(v) for k, v in jp.items()})
    rng = np.random.default_rng(seed)
    P, ps, NP = 24, 8, 6
    pool = _pool(rng, P, ps, cfg.num_kv_heads, cfg.head_dim, quant)
    pt = rng.permutation(P)[:3 * NP].reshape(3, NP).astype(np.int32)
    return jcfg, cfg, jp, p, rng, pool, pt


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("window", [None, 12])
def test_attention_decode_paged_matches_jax(quant, window):
    jcfg, cfg, jp, p, rng, pool, pt = _attn_setup("reflect_demo_100m",
                                                  quant, 0)
    pos = np.asarray([5, 21, 40], np.int32)
    pt[0, 1:] = -1                          # unmapped tail past the frontier
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    want, jpool = JA.attention_decode_paged(
        jcfg, {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(pos),
        jnp.asarray(pt), window)
    tpool = _cache(pool)
    got, tpool = A.attention_decode_paged(
        cfg, p, torch.tensor(x), tpool, torch.tensor(pos), torch.tensor(pt),
        window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if not quant:
        np.testing.assert_allclose(tpool["kp"].numpy(),
                                   np.asarray(jpool["kp"]), atol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("window", [None, 12])
def test_attention_extend_paged_matches_jax(quant, window):
    jcfg, cfg, jp, p, rng, pool, pt = _attn_setup("qwen3_0_6b", quant, 1)
    Sx = 6
    pos0 = np.asarray([3, 17, 30], np.int32)
    nv = np.asarray([6, 2, 0], np.int32)
    pt[0, 2:] = -1
    x = rng.normal(size=(3, Sx, cfg.d_model)).astype(np.float32)
    valid = np.arange(Sx)[None, :] < nv[:, None]
    want, jpool = JA.attention_extend_paged(
        jcfg, {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(pos0),
        window, jnp.asarray(pt), jnp.asarray(valid))
    tpool = _cache(pool)
    got, tpool = A.attention_extend_paged(
        cfg, p, torch.tensor(x), tpool, torch.tensor(pos0), window,
        torch.tensor(pt), torch.tensor(valid))
    # pad lanes are computed but read by nobody: compare the valid lanes
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=TOL, rtol=TOL)
    if not quant:
        np.testing.assert_allclose(tpool["vp"].numpy(),
                                   np.asarray(jpool["vp"]), atol=1e-5)


def test_bridge_is_a_copy():
    jm, params, m = _pair("reflect_demo_100m")
    np.testing.assert_array_equal(
        m.blocks[1].attn.wq.numpy(), np.asarray(params["scan"][0]["attn"]
                                                ["wq"][1]))
    np.testing.assert_array_equal(m.unembed.numpy(),
                                  np.asarray(params["unembed"]))


@pytest.mark.parametrize("arch", [
    "reflect_demo_100m", "qwen3_0_6b", "granite_moe_1b_a400m",
    "mixtral_8x7b", "kimi_k2_1t_a32b", "llama3_70b", "minitron_4b",
    "yi_6b", "nemotron_4_340b"])
def test_transformer_paged_logits_match_jax(arch):
    """Chunked paged prefill (uneven chunks per row, nv masking) then
    paged decode steps: logits of both packages agree to 1e-4."""
    jm, params, m = _pair(arch)
    cfg = m.cfg
    B, S, ps, NP = 2, 13, 4, 8
    tokens = np.random.default_rng(3).integers(3, cfg.vocab_size, (B, S))
    pt = np.stack([np.arange(NP) + b * NP for b in range(B)]).astype(np.int32)
    jcache = JL.init_empty_cache(jm.cache_defs_paged(B, B * NP, ps))
    jext = jax.jit(jm.prefill_extend, static_argnames=("all_logits",))
    jdec = jax.jit(jm.decode_step)
    tcache = m.init_cache_paged(B * NP, ps, device=torch.device("cpu"))
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
        want, jcache = jext(params, jcache, jnp.asarray(blk), jnp.asarray(p0),
                             jnp.asarray(nv), page_table=jnp.asarray(pt))
        got, tcache = m.prefill_extend(tcache, torch.tensor(blk),
                                       torch.tensor(p0), torch.tensor(nv),
                                       page_table=torch.tensor(pt))
        rows = nv > 0
        np.testing.assert_allclose(got.numpy()[rows],
                                   np.asarray(want)[rows], atol=TOL,
                                   rtol=TOL)
    nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        want, jcache = jdec(params, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                            page_table=jnp.asarray(pt))
        got, tcache = m.decode_step(tcache, torch.tensor(nxt),
                                    torch.tensor(pos),
                                    page_table=torch.tensor(pt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
        nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
    # all-lane verify logits over a drafted block
    blk = np.concatenate([nxt, nxt + 1, nxt + 2], axis=1).astype(np.int32)
    pos0 = np.full((B,), S + 3, np.int32)
    nv = np.asarray([3, 2], np.int32)
    want, _ = jext(params, jcache, jnp.asarray(blk), jnp.asarray(pos0),
                   jnp.asarray(nv), page_table=jnp.asarray(pt),
                   all_logits=True)
    got, _ = m.prefill_extend(tcache, torch.tensor(blk), torch.tensor(pos0),
                              torch.tensor(nv), page_table=torch.tensor(pt),
                              all_logits=True)
    lanes = np.arange(3)[None, :] < nv[:, None]
    np.testing.assert_allclose(got.numpy()[lanes], np.asarray(want)[lanes],
                               atol=TOL, rtol=TOL)
