"""whisper-tiny's port (``repro_torch/models/whisper.py``) against the JAX
package's ``WhisperModel`` on the CPU, at the smoke config on bridged
weights (q/k projections softened x 0.25 in both packages: random-init
attention is near one-hot, see tests/test_torch_ring.py).

* ``forward`` with frames, ``prefill`` + ring ``decode_step``s, and
  ``prefill`` of a prefix + ``prefill_extend`` of the suffix + decode
  (tests/test_prefix_extend.py's contract, and a masked mixed step):
  logits to 3e-4 absolute + 3e-3 relative, as tests/test_models.py.
* One train step with frames against the reference's ``make_train_step``:
  metrics to 1e-5 relative, every gradient leaf to 1e-3 of its largest.
* Checkpoint bytes equal the reference's for the same weights, and
  ``params_to_jax`` inverts ``params_from_jax`` over the enc/dec tree.
* Engine parity: the port's and the JAX ``Engine`` on rings (whisper has
  no paged layout, so ``paged_kv=True`` serves from rings in both, and no
  verify step, so ``spec_decode=True`` serves without speculation in
  both), prefix cache on: greedy streams, ``TokenUsage`` and step counters
  identical.  The unembedding is sharpened x 4 so that top-2 ties are
  not what is compared; the smallest top-1/top-2 gap is printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.loop import make_loss_fn as jloss_fn
from repro.train.loop import make_train_step as jtrain_step
from repro_torch import bridge
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import (grads_of, init_opt_state, make_loss_fn,
                                    make_train_step, params_of, to_device,
                                    trainable)

ARCH = "whisper_tiny"
TOL = dict(atol=3e-4, rtol=3e-3)
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "preemptions", "prefill_chunks",
             "resident_kv_bytes", "allocated_kv_bytes")


def _pair(sharpen=1.0, seed=0):
    """(JAX model, params, port model) on one weight set: q/k (self- and
    cross-attention) x 0.25, the unembedding x ``sharpen``."""
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))

    def scale(path, x):
        key = path[-1].key
        return x * (0.25 if key in ("wq", "wk") else
                    sharpen if key == "unembed" else 1.0)

    params = jax.tree_util.tree_map_with_path(
        scale, jm.init(jax.random.PRNGKey(seed)))
    m = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    m.load_state_dict(bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rows=None):
    got, want = got.numpy(), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, **TOL)


def _frames(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def test_forward_prefill_and_decode_match_jax():
    jm, params, m = _pair()
    cfg = m.cfg
    B, S = 2, 12
    rng = np.random.default_rng(1)
    tokens = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 7], np.int32)
    frames = _frames(cfg, B)
    batch = {"tokens": tokens, "frames": frames, "lengths": lengths}
    want, _ = jm.forward(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    got, aux = m.forward({k: _t(v) for k, v in batch.items()})
    _close(got, want, np.arange(S)[None, :] < lengths[:, None])
    assert float(aux) == 0.0
    want, jcache = jm.prefill(params, jnp.asarray(tokens),
                              jnp.asarray(lengths), max_seq=32,
                              frames=jnp.asarray(frames))
    got, cache = m.prefill(_t(tokens), _t(lengths), max_seq=32,
                           frames=_t(frames))
    _close(got, want)
    for i, c in enumerate(cache):
        for leaf in ("xk", "xv"):
            _close(c[leaf], jcache["cross"][leaf][i])
    nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
    pos = lengths.copy()
    for _ in range(3):
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt),
                                      jnp.asarray(pos))
        got, cache = m.decode_step(cache, _t(nxt), _t(pos))
        _close(got, want)
        nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
        pos = pos + 1


def test_prefill_extend_continues_the_prefill():
    """prefill(prefix) + prefill_extend(suffix) gives prefill(full)'s
    logits and next decode step (tests/test_prefix_extend.py), and the
    JAX model's; then a masked mixed step (rows advancing 3 and 0 lanes)
    against the JAX model's."""
    jm, params, m = _pair()
    cfg = m.cfg
    B, S, split = 2, 14, 9
    tokens = np.random.default_rng(2).integers(
        3, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(cfg, B, seed=3)
    full, cache_full = m.prefill(_t(tokens), max_seq=S + 8,
                                 frames=_t(frames))
    _, cache = m.prefill(_t(tokens[:, :split]), max_seq=S + 8,
                         frames=_t(frames))
    pos0 = np.full((B,), split, np.int32)
    got, cache = m.prefill_extend(cache, _t(tokens[:, split:]), _t(pos0))
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)
    _, jcache = jm.prefill(params, jnp.asarray(tokens[:, :split]),
                           max_seq=S + 8, frames=jnp.asarray(frames))
    want, jcache = jm.prefill_extend(params, jcache,
                                     jnp.asarray(tokens[:, split:]),
                                     jnp.asarray(pos0))
    _close(got, want)
    nxt = np.argmax(full.numpy(), -1)[:, None].astype(np.int32)
    pos = np.full((B,), S, np.int32)
    d_full, _ = m.decode_step(cache_full, _t(nxt), _t(pos))
    d_ext, cache = m.decode_step(cache, _t(nxt), _t(pos))
    np.testing.assert_allclose(d_ext.numpy(), d_full.numpy(), **TOL)
    want, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt),
                                  jnp.asarray(pos))
    _close(d_ext, want)
    blk = np.concatenate([nxt, nxt + 1, nxt + 2], 1).astype(np.int32)
    nv = np.asarray([3, 0], np.int32)
    want, _ = jm.prefill_extend(params, jcache, jnp.asarray(blk),
                                jnp.asarray(pos + 1), jnp.asarray(nv))
    got, _ = m.prefill_extend(cache, _t(blk), _t(pos + 1), _t(nv))
    _close(got, want, nv > 0)


def _ref_leaves(tree):
    return {tuple(k.key for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_step_with_frames_matches_reference():
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
             "frames": _frames(cfg, B, seed=5)}

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
    want = _ref_leaves(jg)
    assert list(want) == list(got)
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-3 * float(np.abs(w).max()) + 1e-7, (path, err)


def test_checkpoint_bytes_and_bridge_round_trip(tmp_path):
    jm, params, m = _pair()
    a, b = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    jckpt.save(a, params, step=4)
    ckpt.save_model(b, m, step=4)
    assert open(a, "rb").read() == open(b, "rb").read()
    other = build_model(m.cfg)
    assert ckpt.restore_model(a, other) == 4
    for k, v in m.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, params))
    got = jax.tree_util.tree_flatten_with_path(
        bridge.params_to_jax(m.state_dict(), m.cfg))
    assert want[1] == got[1]
    for (pw, w), (pg, g) in zip(want[0], got[0]):
        assert pw == pg and w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


class MarginEngine(Engine):
    """The port's engine, recording the smallest top-1/top-2 gap of the
    logits its steps return (decode: live rows; mixed: rows with lanes;
    verify: valid lanes)."""
    margin = float("inf")

    def _run(self, kind, *arrays):
        logits = super()._run(kind, *arrays)
        lg = logits.float()
        if kind == "decode":
            lg = lg[[i for i, r in enumerate(self.slots) if r is not None]]
        else:
            nv = torch.as_tensor(arrays[2])
            lg = lg[nv > 0 if kind == "mixed" else
                    torch.arange(lg.shape[1])[None] < nv[:, None]]
        if lg.numel():
            top = lg.topk(2, dim=-1).values
            self.margin = min(self.margin,
                              float((top[:, 0] - top[:, 1]).min()))
        return logits


def _serve(engine, request_cls, prompts, rounds, max_new):
    convos = [list(p) for p in prompts]
    reqs_all = []
    for _ in range(rounds):
        reqs = [request_cls(prompt=list(c), max_new_tokens=max_new,
                            eos_id=None) for c in convos]
        for r in reqs:
            engine.submit(r)
        engine.run()
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
        reqs_all += reqs
    return reqs_all


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec_asked"])
def test_ring_engine_matches_jax(spec):
    jm, params, m = _pair(sharpen=4.0)
    kw = dict(max_batch=3, max_seq=96, page_size=8, prefill_chunk=8,
              prefill_token_budget=12, spec_decode=spec)
    prompts = [[1] + list(range(10 + 7 * i, 24 + 9 * i)) for i in range(3)]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, 3, 6)
    eng = MarginEngine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, 3, 6)
    print(f"whisper rings (spec {spec}): smallest top-1/top-2 gap sampled "
          f"{eng.margin:.3e}")
    assert not eng.paged and not jeng.paged
    assert not eng.spec and not jeng.spec
    assert all(r.status is Status.DONE for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in STEP_KEYS} == {k: jst[k] for k in STEP_KEYS}
    assert eng.prefix_cache.stats["hits"] > 0, "rounds 2-3 must hit"
    assert (eng.prefix_cache.stats_snapshot()
            == jeng.prefix_cache.stats_snapshot())
