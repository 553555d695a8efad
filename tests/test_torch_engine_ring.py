"""The port's ring-cache engine (``ServeConfig.paged_kv=False``) against
the JAX ``Engine`` in the same mode.

Both engines serve reflection rounds of the same conversations on the same
weights — the JAX package's ``quick_fit_ramp`` fixture, bridged into the
port — in fp and int8 KV with speculative decoding on.  Greedy token
streams, ``TokenUsage`` bills, step counters, resident KV bytes and
prefix-cache statistics must be identical.  Three more tests mirror the
JAX package's own ring pins: the mixed-step width clamped to the smallest
ring (tests/test_chunked_prefill.py), speculation on a ring of capacity
max_seq (tests/test_spec_decode.py), and no speculation on a
window-clamped ring (tests/test_spec_decode.py).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro.train.quick_fit import quick_fit_ramp, ramp_prompt
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status

STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks", "resident_kv_bytes", "allocated_kv_bytes")
CACHE_KEYS = ("hits", "partial_hits", "misses", "tokens_saved",
              "boundary_snapshots", "entries", "evictions", "pinned_bytes")
REP_PROMPT = [1] + list(range(10, 22)) * 3     # self-repetition: drafts fire


def _fit(arch, steps):
    jm = jbuild(jsmoke(arch).replace(dtype="float32"))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)),
                            steps=steps, max_steps=steps)
    m = build_model(get_smoke_config(arch).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


@pytest.fixture(scope="module")
def fitted():
    """Fitted weights of reflect_demo_100m and of recurrentgemma
    (greedy streams of fitted models have real top-2 gaps, so token-for-
    token parity across frameworks is a meaningful statement)."""
    return {"reflect_demo_100m": _fit("reflect_demo_100m", 60),
            "recurrentgemma_9b": _fit("recurrentgemma_9b", 40)}


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


def _both(fitted, arch, kw, prompts, rounds, max_new):
    jm, params, m = fitted[arch]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, rounds, max_new)
    eng = Engine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, rounds, max_new)
    return jeng, jreqs, eng, reqs


def _assert_same(jeng, jreqs, eng, reqs):
    assert all(r.status is Status.DONE for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    assert [r.stop_reason for r in reqs] == [r.stop_reason for r in jreqs]
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in STEP_KEYS} == {k: jst[k] for k in STEP_KEYS}
    assert "kv_pool_pages" not in st and "kv_pool_pages" not in jst
    if "prefix_cache" in jst:
        pc, jpc = st["prefix_cache"], jst["prefix_cache"]
        assert ({k: pc[k] for k in CACHE_KEYS}
                == {k: jpc[k] for k in CACHE_KEYS})


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_ring_engine_matches_jax(fitted, kv_dtype):
    kw = dict(max_batch=3, max_seq=160, page_size=8, paged_kv=False,
              spec_decode=True, spec_tokens=4, kv_dtype=kv_dtype,
              prefill_chunk=16, prefill_token_budget=24)
    prompts = [ramp_prompt(10 + 9 * i, 22 + 5 * i) for i in range(4)]
    jeng, jreqs, eng, reqs = _both(fitted, "reflect_demo_100m", kw, prompts,
                                   rounds=3, max_new=10)
    _assert_same(jeng, jreqs, eng, reqs)
    assert eng.spec and eng.model_steps["verify_steps"] > 0
    assert eng.prefix_cache.stats["hits"] > 0, "rounds 2-3 must hit"
    assert eng.pool is None and eng.page_tables is None


def test_ring_recurrent_engine_matches_jax(fitted):
    """recurrentgemma on rings: prompts past its 32-token local window
    wrap the rg_attn rings; recurrent state snapshots ride in the dense
    prefix snapshots; no speculation."""
    kw = dict(max_batch=2, max_seq=128, page_size=8, paged_kv=False,
              prefill_chunk=16, prefill_token_budget=24)
    prompts = [ramp_prompt(10 + 7 * i, 30 + 9 * i) for i in range(3)]
    jeng, jreqs, eng, reqs = _both(fitted, "recurrentgemma_9b", kw, prompts,
                                   rounds=2, max_new=8)
    _assert_same(jeng, jreqs, eng, reqs)
    assert not eng.spec and eng.prefix_cache.stats["hits"] > 0


def test_chunk_clamped_to_ring_capacity(fitted):
    """tests/test_chunked_prefill.py: the lane width never exceeds the
    smallest ring (recurrentgemma's 32-token local window), and the
    clamped engine's tokens equal an explicitly small chunk's and the JAX
    ring engine's."""
    outs = {}
    for chunk in (64, 8):
        kw = dict(max_batch=1, max_seq=128, page_size=8, paged_kv=False,
                  prefix_cache=False, prefill_chunk=chunk,
                  prefill_token_budget=chunk)
        prompt = [ramp_prompt(10, 51)]                # 51 tokens > window
        jeng, jreqs, eng, reqs = _both(fitted, "recurrentgemma_9b", kw,
                                       prompt, rounds=1, max_new=4)
        assert eng.chunk == jeng.chunk == min(chunk, 32)
        _assert_same(jeng, jreqs, eng, reqs)
        outs[chunk] = reqs[0].output
    assert outs[64] == outs[8]


def test_spec_parity_ring_mode(fitted):
    """tests/test_spec_decode.py: a ring of capacity max_seq speculates,
    and its tokens equal the non-speculative ring engine's and the JAX
    engine's."""
    outs = {}
    for spec in (False, True):
        kw = dict(max_batch=2, max_seq=128, page_size=8, paged_kv=False,
                  spec_decode=spec)
        jeng, jreqs, eng, reqs = _both(fitted, "reflect_demo_100m", kw,
                                       [REP_PROMPT], rounds=1, max_new=8)
        assert eng.spec == jeng.spec == spec
        _assert_same(jeng, jreqs, eng, reqs)
        if spec:
            assert eng.model_steps["verify_steps"] > 0
        outs[spec] = reqs[0].output
    assert outs[True] == outs[False]


def test_spec_gate_windowed_ring():
    """tests/test_spec_decode.py: a window-clamped ring refuses to
    speculate (a rejected lane's write would evict a live in-window
    token); the paged engine keeps speculating on the same config."""
    cfg = get_smoke_config("qwen3_0_6b").replace(dtype="float32",
                                                 sliding_window=32)
    m = build_model(cfg)
    ring = Engine(m, ServeConfig(max_batch=1, max_seq=128, page_size=8,
                                 paged_kv=False, spec_decode=True),
                  device="cpu")
    assert not ring.spec and ring.chunk == min(ServeConfig().prefill_chunk,
                                               32)
    paged = Engine(m, ServeConfig(max_batch=1, max_seq=128, page_size=8,
                                  spec_decode=True), device="cpu")
    assert paged.spec
