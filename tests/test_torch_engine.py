"""The port's serving engine against the JAX ``Engine``.

Both engines serve two reflection rounds of the same conversations on the
same weights — the JAX package's ``quick_fit_ramp`` fixture, bridged into
the port — in fp and int8 KV, with speculative decoding on and off.  The
greedy token streams, the ``TokenUsage`` bills, the step counters and the
prefix-cache hit counts must be identical.  Temperature sampling cannot
share random bits across ``jax.random`` and ``torch.Generator``, so it is
checked by distribution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving import sampler as jsampler
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro.train.quick_fit import quick_fit_ramp, ramp_prompt
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving import sampler
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status

ARCH = "reflect_demo_100m"
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks")
CACHE_KEYS = ("hits", "partial_hits", "misses", "tokens_saved",
              "boundary_snapshots", "entries")


@pytest.fixture(scope="module")
def fitted():
    """JAX model + quick-fitted params, and the port's model on the same
    weights: fitted logits have real top-2 gaps, so token-for-token
    parity across frameworks is a meaningful statement."""
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)), steps=60,
                            max_steps=60)
    m = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


def _serve(engine, request_cls, prompts, rounds, max_new):
    """Reflection rounds: each round's prompt is the previous prompt plus
    its output plus the reflection suffix [99, 98]."""
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


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_engine_matches_jax(fitted, kv_dtype, spec):
    jm, params, m = fitted
    kw = dict(max_batch=3, max_seq=160, page_size=8, spec_decode=spec,
              spec_tokens=4, kv_dtype=kv_dtype, prefill_chunk=16,
              prefill_token_budget=24)
    prompts = [ramp_prompt(10 + 9 * i, 22 + 5 * i) for i in range(4)]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, rounds=2, max_new=10)
    eng = Engine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, rounds=2, max_new=10)

    assert all(r.status is Status.DONE for r in reqs)
    eng.pool.check()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    assert [r.stop_reason for r in reqs] == [r.stop_reason for r in jreqs]
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in STEP_KEYS} == {k: jst[k] for k in STEP_KEYS}
    pc, jpc = st["prefix_cache"], jst["prefix_cache"]
    assert {k: pc[k] for k in CACHE_KEYS} == {k: jpc[k] for k in CACHE_KEYS}
    assert pc["hits"] > 0, "round 2 must hit the prefix cache"
    if spec:
        assert st["verify_steps"] > 0
    assert st["step_compiles"] == 0


def test_engine_preemption_matches_jax(fitted):
    """A pool too small for every request: preemption, replay and COW run
    the same schedule in both packages."""
    jm, params, m = fitted
    kw = dict(max_batch=3, max_seq=64, page_size=8, num_pages=12,
              prefill_chunk=8)
    prompts = [ramp_prompt(20 + 11 * i, 20) for i in range(3)]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, rounds=1, max_new=16)
    eng = Engine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, rounds=1, max_new=16)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    assert eng.model_steps["preemptions"] == jeng.model_steps["preemptions"]
    assert eng.model_steps["preemptions"] > 0
    eng.pool.check()


@pytest.mark.parametrize("option", [
    {"enforce_deadlines": True}, {"nan_quarantine": True},
    {"stall_limit": 3}, {"slo_price_model": "nova_micro"},
    {"mesh": "1x1"},
    {"paged_kv": False, "nan_quarantine": True}])
def test_unported_options_raise(fitted, option):
    """Every option of the reference's engine is ported (the name is the
    test's history): each constructs and serves the JAX engine's streams
    and bills with the same option, a 1x1 mesh included."""
    jm, params, m = fitted
    kw = dict(max_batch=1, max_seq=64, page_size=8, **option)
    prompts = [ramp_prompt(10, 20)]
    jreqs = _serve(JEngine(jm, params, JServeConfig(**kw)), JRequest,
                   prompts, rounds=1, max_new=8)
    reqs = _serve(Engine(m, ServeConfig(**kw), device="cpu"), Request,
                  prompts, rounds=1, max_new=8)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    assert [r.stop_reason for r in reqs] == ["max_tokens"]


def test_faults_raise(fitted):
    """A fault plan is ported: ``faults=`` takes the port's ``FaultPlan``
    (a rate-0 plan serves as no plan); ``mesh=`` takes a DeviceMesh and
    refuses anything else."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    _, _, m = fitted
    scfg = ServeConfig(max_batch=1, max_seq=64, page_size=8)
    prompts = [ramp_prompt(10, 20)]
    plan = FaultPlan([FaultSpec("engine.logits"), FaultSpec("engine.crash")])
    eng = Engine(m, scfg, device="cpu", faults=plan)
    assert eng.clock is plan.clock
    got = _serve(eng, Request, prompts, rounds=1, max_new=8)
    want = _serve(Engine(m, scfg, device="cpu"), Request, prompts,
                  rounds=1, max_new=8)
    assert [r.output for r in got] == [r.output for r in want]
    assert plan.fired_total == 0
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(m, scfg, device="cpu", faults=plan, mesh=object())


# ---------------------------------------------------------------- sampler

def test_greedy_sampling_bit_exact():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    temps = np.zeros(6, np.float32)
    got = sampler.sample_batch(torch.tensor(logits), torch.tensor(temps),
                               torch.Generator().manual_seed(0))
    want = jsampler.sample_batch(jnp.asarray(logits),
                                 jax.random.PRNGKey(0), jnp.asarray(temps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    W = 4
    lg = rng.normal(size=(6, W, 50)).astype(np.float32)
    toks = rng.integers(0, 50, size=(6, W)).astype(np.int32)
    toks[:, 1] = lg[:, 0].argmax(-1)                # an accepted draft
    nv = np.asarray([4, 4, 3, 2, 1, 3], np.int32)
    nd = np.asarray([3, 2, 2, 1, 0, 0], np.int32)
    got = sampler.verify_batch(torch.tensor(lg), torch.tensor(toks),
                               torch.tensor(nv), torch.tensor(nd),
                               torch.zeros(6), torch.Generator())
    want = jsampler.verify_batch(jnp.asarray(lg), jnp.asarray(toks),
                                 jnp.asarray(nv), jnp.asarray(nd),
                                 jax.random.PRNGKey(0), jnp.zeros(6))
    n_emit = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), n_emit)
    for b in range(6):                   # lanes past n_emit are unread
        np.testing.assert_array_equal(got[1].numpy()[b, :n_emit[b]],
                                      np.asarray(want[1])[b, :n_emit[b]])


def _freq(tokens, V):
    return np.bincount(tokens, minlength=V) / len(tokens)


def test_temperature_sampling_distribution():
    """sample_batch draws from softmax(logits / T)."""
    N, V, T = 40_000, 6, 0.7
    logits = np.asarray([1.0, 0.2, -0.5, 2.0, 0.0, -1.0], np.float32)
    got = sampler.sample_batch(torch.tensor(np.tile(logits, (N, 1))),
                               torch.full((N,), T),
                               torch.Generator().manual_seed(1))
    p = np.exp(logits / T) / np.exp(logits / T).sum()
    np.testing.assert_allclose(_freq(got.numpy(), V), p, atol=0.01)


def test_verify_rejection_sampling_distribution():
    """With one draft d per row, the first committed token is distributed
    as ancestral sampling from p (accept d w.p. p(d), else resample from
    p without d), and a rejection never re-emits d."""
    N, V = 40_000, 5
    lg0 = np.asarray([0.5, 1.5, -0.3, 0.0, 1.0], np.float32)
    logits = np.zeros((N, 2, V), np.float32)
    logits[:, 0] = lg0
    d = 4
    toks = np.tile(np.asarray([[0, d]], np.int32), (N, 1))
    n_emit, emit = sampler.verify_batch(
        torch.tensor(logits), torch.tensor(toks),
        torch.full((N,), 2, dtype=torch.int32),
        torch.ones(N, dtype=torch.int32), torch.ones(N),
        torch.Generator().manual_seed(2))
    p = np.exp(lg0) / np.exp(lg0).sum()
    first = emit.numpy()[:, 0]
    np.testing.assert_allclose(_freq(first, V), p, atol=0.01)
    rejected = n_emit.numpy() == 1
    assert not np.any(first[rejected] == d)
