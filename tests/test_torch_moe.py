"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``moe_ffn``, on the same weights and inputs (seeded numpy,
float32).

Outputs agree within ``ATOL``: the expert products are matrix products in
both packages, and the combine adds a token's k lanes in top-k order
where the reference adds them in sorted order.  The aux loss agrees
within ``AUX_RTOL``: it is a mean of router probabilities, which the two
packages' matrix products and reductions round differently in the last
bit.  The routing itself must be EQUAL: expert ids and the kept mask
(which lanes an expert took within its capacity).  The reference's ids
and kept mask are not returned by its ``moe_ffn``; ``_jax_plan``
recomputes them with the reference's own JAX operations
(``repro/models/moe.py:80-111``), and the test checks that plan's aux
loss against the reference's output first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models.registry import get_smoke_config as jsmoke
from repro_torch.models import moe as MOE
from repro_torch.models.registry import get_smoke_config

ATOL = 1e-5
AUX_RTOL = 1e-6
ARCHS = ("granite_moe_1b_a400m", "mixtral_8x7b")


def _setup(arch, seed, **over):
    jcfg = jsmoke(arch).replace(dtype="float32", **over)
    cfg = get_smoke_config(arch).replace(dtype="float32", **over)
    jp = JL.init_params(JMOE.moe_def(jcfg, jnp.float32),
                        jax.random.PRNGKey(seed))
    p = MOE.MoE(cfg)
    p.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in jp.items()})
    return jcfg, cfg, jp, p


def _jax_plan(cfg, p, x3, valid3):
    """The reference's routing of groups x3 [B, S, d]: (expert ids
    [B, S, k], kept mask [B, S*k] in token-major lane order, aux)."""
    B, S, _ = x3.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = JMOE._capacity(cfg, S)
    logits = jnp.einsum("bsd,de->bse", x3, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    me = jnp.mean(probs, axis=(0, 1))
    ce = jnp.mean(jax.nn.one_hot(expert_ids[..., 0], E, dtype=jnp.float32),
                  axis=(0, 1))
    aux = E * jnp.sum(me * ce)
    flat_e = expert_ids.reshape(B, S * k)
    if valid3 is not None:
        flat_e = jnp.where(jnp.repeat(valid3, k, axis=1), flat_e, E)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    s_expert = jnp.take_along_axis(flat_e, order, axis=1)
    counts = jnp.sum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), axis=1)
    starts = jnp.cumsum(counts, axis=1) - counts
    pos_in_e = jnp.arange(S * k)[None, :] - jnp.take_along_axis(
        starts, jnp.minimum(s_expert, E - 1), axis=1)
    keep = np.asarray((pos_in_e < C) & (s_expert < E))
    kept = np.zeros_like(keep)
    np.put_along_axis(kept, np.asarray(order), keep, axis=1)
    return np.asarray(expert_ids), kept, float(aux)


def _groups(x, valid):
    """The grouping rule of both packages."""
    if x.ndim == 3 and x.shape[1] >= 256:
        return x, valid
    return (x.reshape(1, -1, x.shape[-1]),
            None if valid is None else valid.reshape(1, -1))


def _check(arch, x, valid=None, seed=0, router=None, **over):
    jcfg, cfg, jp, p = _setup(arch, seed, **over)
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
        p.router.data.copy_(torch.tensor(router))
    jv = None if valid is None else jnp.asarray(valid)
    want, jaux = JMOE.moe_ffn(jcfg, jp, jnp.asarray(x), jv)
    tv = None if valid is None else torch.tensor(valid)
    got, aux = MOE.moe_ffn(cfg, p, torch.tensor(x), tv)
    x3, v3 = _groups(x, valid)
    ids, kept, plan_aux = _jax_plan(jcfg, jp, jnp.asarray(x3),
                                    None if v3 is None else jnp.asarray(v3))
    assert plan_aux == float(jaux)              # the plan is the reference's
    t_ids, _, t_aux, slot, C = MOE.route(
        cfg, p, torch.tensor(x3), None if v3 is None else torch.tensor(v3))
    t_kept = (slot < cfg.num_experts * C).numpy()
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_kept, kept)
    assert float(aux) == float(t_aux)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    want = np.asarray(want)
    if valid is not None:                       # pad rows are read by nobody
        want, got = want[valid], got.numpy()[valid]
    else:
        got = got.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return kept, valid


@pytest.mark.parametrize("arch", ARCHS)
def test_one_group_with_pad_lanes(arch):
    """[3, 5] rows of unequal length: one group over 15 lanes, the pad
    lanes routed past the end and dropped."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    valid = np.arange(5)[None, :] < np.asarray([5, 2, 0])[:, None]
    kept, _ = _check(arch, x, valid)
    k = get_smoke_config(arch).experts_per_token
    lane_valid = np.repeat(valid.reshape(1, -1), k, axis=1)
    assert not kept[~lane_valid].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_per_row_groups(arch):
    """[2, 256]: rows of 256 tokens are routed one group per row."""
    x = np.random.default_rng(2).normal(size=(2, 256, 128)).astype(
        np.float32)
    _check(arch, x, seed=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_shape(arch):
    """[12, 1], the decode step's shape: one group of 12 tokens."""
    x = np.random.default_rng(3).normal(size=(12, 1, 128)).astype(
        np.float32)
    _check(arch, x, seed=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops(arch):
    """capacity_factor 0.25: experts overflow and drop lanes, and the
    outputs differ from capacity_factor 8.0, where nothing drops (the
    reference's test_models.py::test_moe_capacity_drops_tokens)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 24, 128)).astype(np.float32)
    kept_lo, _ = _check(arch, x, seed=3, capacity_factor=0.25)
    kept_hi, _ = _check(arch, x, seed=3, capacity_factor=8.0)
    assert not kept_lo.all() and kept_hi.all()
    cfg = get_smoke_config(arch).replace(dtype="float32")
    _, _, _, p = _setup(arch, 3)
    lo, _ = MOE.moe_ffn(cfg.replace(capacity_factor=0.25), p,
                        torch.tensor(x))
    hi, _ = MOE.moe_ffn(cfg.replace(capacity_factor=8.0), p, torch.tensor(x))
    assert float((lo - hi).abs().max()) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_router_ties(arch):
    """A router whose columns repeat gives exactly equal probabilities:
    both packages put the lower expert index first (jax.lax.top_k's
    order), and the stable dispatch sort keeps the same lanes."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(5)
    col = rng.normal(size=(cfg.d_model, 1)).astype(np.float32) * 0.1
    other = rng.normal(size=(cfg.d_model, 1)).astype(np.float32) * 0.1
    router = np.concatenate(
        [col, other] + [col] * (cfg.num_experts - 2), axis=1)
    x = rng.normal(size=(6, 4, 128)).astype(np.float32)
    _check(arch, x, seed=4, router=router, capacity_factor=0.5)
    _, _, _, p = _setup(arch, 4)
    p.router.data.copy_(torch.tensor(router))
    ids, *_ = MOE.route(cfg.replace(dtype="float32"), p,
                        torch.tensor(x.reshape(1, -1, 128)))
    # expert 1 differs; the equal columns 0, 2, 3, ... tie exactly
    assert set(np.unique(ids.numpy())) <= set(range(cfg.num_experts))
    tied = ids.numpy()[..., 0] != 1
    assert tied.any() and (ids.numpy()[..., 0][tied] == 0).all()


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_decode_step_idle_row_matches_jax(kv_dtype):
    """A paged MoE decode step routes every batch slot, so an idle slot
    (no page mapped) must read what the reference reads there — the mean
    of physical page 0's V, not zeros — or its lanes take other experts'
    capacity than in the reference.  Logits of the idle row and of the
    live rows agree."""
    from repro.models.registry import build_model as jbuild
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.registry import build_model

    arch = "granite_moe_1b_a400m"
    jm = jbuild(jsmoke(arch).replace(dtype="float32", kv_dtype=kv_dtype))
    params = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_smoke_config(arch).replace(dtype="float32",
                                                   kv_dtype=kv_dtype))
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params)))
    B, ps, NP = 3, 4, 4
    pt = np.arange(B * NP, dtype=np.int32).reshape(B, NP)
    jcache = JL.init_empty_cache(jm.cache_defs_paged(B, B * NP, ps))
    cache = m.init_cache_paged(B * NP, ps, device=torch.device("cpu"))
    tok = np.random.default_rng(6).integers(3, 256, (B, 6)).astype(np.int32)
    nv, p0 = np.full(B, 6, np.int32), np.zeros(B, np.int32)
    _, jcache = jm.prefill_extend(params, jcache, jnp.asarray(tok),
                                  jnp.asarray(p0), jnp.asarray(nv),
                                  page_table=jnp.asarray(pt))
    m.prefill_extend(cache, torch.tensor(tok), torch.tensor(p0),
                     torch.tensor(nv), page_table=torch.tensor(pt))
    pt[0] = -1                                   # slot 0 is idle
    nxt = np.asarray([[5], [7], [9]], np.int32)
    pos = np.full(B, 6, np.int32)
    want, _ = jm.decode_step(params, jcache, jnp.asarray(nxt),
                             jnp.asarray(pos), page_table=jnp.asarray(pt))
    got, _ = m.decode_step(cache, torch.tensor(nxt), torch.tensor(pos),
                           page_table=torch.tensor(pt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
