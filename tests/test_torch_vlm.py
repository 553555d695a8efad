"""The VLM's port (``repro_torch/models/vlm.py``: internvl2-76b's language
backbone with a bidirectional prefix of patch embeddings) against the JAX
package's ``VLMModel`` on the CPU, at the smoke config on bridged weights
(q/k softened x 0.25 in both packages, as tests/test_torch_ring.py).

* ``forward`` with patches (their rows dropped after ``ln_f``), with and
  without ragged lengths (which count the patches, as in the reference);
  ``prefill`` with patches (lengths shifted by the patch count) + ring
  decode steps at that offset; ``prefill`` + ``prefill_extend`` + decode
  (tests/test_prefix_extend.py's contract): 3e-4 absolute + 3e-3
  relative, as tests/test_models.py.
* One train step with patches against the reference's
  ``make_train_step``: metrics to 1e-5 relative, gradients to 1e-3 of each
  leaf's largest.
* Engine parity: the served VLM is its text decoder on the paged pool (the
  engines pass no patches), on the JAX package's ``quick_fit_ramp``
  weights bridged into the port, speculation on: greedy streams,
  ``TokenUsage``, step counters and pool pages identical; the smallest
  top-1/top-2 gap is printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro.train import optimizer as jopt
from repro.train.loop import make_loss_fn as jloss_fn
from repro.train.loop import make_train_step as jtrain_step
from repro.train.quick_fit import quick_fit_ramp, ramp_prompt
from repro_torch import bridge
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.models.vlm import VLMModel
from repro_torch.serving.request import Request, Status
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import (grads_of, init_opt_state, make_loss_fn,
                                    make_train_step, params_of, to_device,
                                    trainable)

from test_torch_whisper import STEP_KEYS, MarginEngine, _serve

ARCH = "internvl2_76b"
TOL = dict(atol=3e-4, rtol=3e-3)


def _port(params):
    m = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    m.load_state_dict(bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return m


def _pair(seed=0):
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.25 if path[-1].key in ("wq", "wk") else x,
        jm.init(jax.random.PRNGKey(seed)))
    return jm, params, _port(params)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rows=None):
    got, want = got.numpy(), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, **TOL)


def _patches(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(
        np.float32)


def test_forward_prefill_and_decode_at_the_patch_offset():
    jm, params, m = _pair()
    cfg = m.cfg
    assert isinstance(m, VLMModel)
    B, S, P = 2, 12, cfg.num_patches
    rng = np.random.default_rng(1)
    tokens = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = _patches(cfg, B)
    for lengths in (None, np.asarray([P + S, P + 5], np.int32)):
        batch = {"tokens": tokens, "patch_embeds": patches}
        if lengths is not None:
            batch["lengths"] = lengths
        want, _ = jm.forward(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        got, _ = m.forward({k: _t(v) for k, v in batch.items()})
        assert got.shape == (B, S, cfg.vocab_size)
        rows = (None if lengths is None
                else np.arange(S)[None, :] < (lengths - P)[:, None])
        _close(got, want, rows)
    lengths = np.asarray([S, 7], np.int32)
    want, jcache = jm.prefill(params, jnp.asarray(tokens),
                              jnp.asarray(lengths), max_seq=48,
                              patch_embeds=jnp.asarray(patches))
    got, cache = m.prefill(_t(tokens), _t(lengths), max_seq=48,
                           patch_embeds=_t(patches))
    _close(got, want)
    nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
    pos = lengths + P
    for _ in range(3):
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt),
                                      jnp.asarray(pos))
        got, cache = m.decode_step(cache, _t(nxt), _t(pos))
        _close(got, want)
        nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
        pos = pos + 1


def test_prefill_extend_continues_the_prefill():
    jm, params, m = _pair()
    cfg = m.cfg
    B, S, split, P = 2, 14, 9, cfg.num_patches
    tokens = np.random.default_rng(2).integers(
        3, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = _t(_patches(cfg, B, seed=3))
    full, cache_full = m.prefill(_t(tokens), max_seq=P + S + 8,
                                 patch_embeds=patches)
    _, cache = m.prefill(_t(tokens[:, :split]), max_seq=P + S + 8,
                         patch_embeds=patches)
    pos0 = np.full((B,), P + split, np.int32)
    got, cache = m.prefill_extend(cache, _t(tokens[:, split:]), _t(pos0))
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)
    _, jcache = jm.prefill(params, jnp.asarray(tokens[:, :split]),
                           max_seq=P + S + 8,
                           patch_embeds=jnp.asarray(patches.numpy()))
    want, jcache = jm.prefill_extend(params, jcache,
                                     jnp.asarray(tokens[:, split:]),
                                     jnp.asarray(pos0))
    _close(got, want)
    nxt = np.argmax(full.numpy(), -1)[:, None].astype(np.int32)
    pos = np.full((B,), P + S, np.int32)
    d_full, _ = m.decode_step(cache_full, _t(nxt), _t(pos))
    d_ext, _ = m.decode_step(cache, _t(nxt), _t(pos))
    np.testing.assert_allclose(d_ext.numpy(), d_full.numpy(), **TOL)
    want, _ = jm.decode_step(params, jcache, jnp.asarray(nxt),
                             jnp.asarray(pos))
    _close(d_ext, want)


def test_train_step_with_patches_matches_reference():
    jm, params, m = _pair()
    cfg = m.cfg
    tkw = dict(remat=False, z_loss=1e-4, learning_rate=1e-3, warmup_steps=2)
    jt, tcfg = JTrainConfig(**tkw), TrainConfig(**tkw)
    rng = np.random.default_rng(4)
    B, S = 2, 12
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "patch_embeds": _patches(cfg, B, seed=5)}

    def ref(p, b):
        (_, _), g = jax.value_and_grad(jloss_fn(jm, jm.cfg, jt),
                                       has_aux=True)(p, b)
        _, _, met = jtrain_step(jm, jm.cfg, jt)(p, jopt.opt_init(p, jt), b)
        return g, met

    jg, jmetrics = jax.jit(ref)(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    with trainable(m):
        loss, _ = make_loss_fn(m, cfg, tcfg)(to_device(batch, "cpu"))
        grads = grads_of(loss, params_of(m))
    metrics = make_train_step(m, cfg, tcfg)(init_opt_state(m, cfg, tcfg),
                                            batch)
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want),
                                   rtol=1e-4 if k == "grad_norm" else 1e-5,
                                   atol=1e-7, err_msg=k)
    tree = bridge.reference_tree({k: v.detach() for k, v in grads.items()},
                                 cfg)
    got = {p: t.float().numpy() for p, t in ckpt._leaves(tree)}
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(leaf, np.float32) for path, leaf
            in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert list(want) == list(got)
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-3 * float(np.abs(w).max()) + 1e-7, (path, err)


def test_paged_engine_matches_jax():
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)), steps=40,
                            max_steps=40)
    m = _port(params)
    kw = dict(max_batch=3, max_seq=128, page_size=8, prefill_chunk=16,
              prefill_token_budget=24, spec_decode=True, spec_tokens=3)
    prompts = [ramp_prompt(10 + 9 * i, 18 + 5 * i) for i in range(3)]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, 2, 8)
    eng = MarginEngine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, 2, 8)
    print(f"internvl2 paged: smallest top-1/top-2 gap sampled "
          f"{eng.margin:.3e}")
    assert eng.paged and jeng.paged and eng.spec
    assert all(r.status is Status.DONE for r in reqs)
    eng.pool.check()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    st, jst = eng.stats(), jeng.stats()
    keys = STEP_KEYS + ("spec_accepted", "kv_pool_pages_used",
                        "kv_pool_pages")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert eng.prefix_cache.stats["hits"] > 0, "round 2 must hit"
