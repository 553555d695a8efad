"""The port's serving engine against the JAX ``Engine`` on the recurrent
families (falcon-mamba-7b and recurrentgemma-9b smoke configs).

Both engines serve two reflection rounds of the same conversations on the
same weights — the JAX package's ``quick_fit_ramp`` fixture, bridged into
the port — with prompts split into chunks.  Greedy token streams,
``TokenUsage`` bills, step counters, prefix-cache hits and the pool's
page counts must be identical; speculative decoding stays off for
recurrent models in both.  recurrentgemma's prompts run past its 32-slot
local window, so both engines free the pages that slide out of it.
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

ARCHS = ("falcon_mamba_7b", "recurrentgemma_9b")
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks", "kv_pool_pages_used", "kv_pool_pages")
CACHE_KEYS = ("hits", "partial_hits", "misses", "tokens_saved",
              "boundary_snapshots", "entries", "evictions", "pinned_bytes")


@pytest.fixture(scope="module")
def fitted():
    """Per arch: JAX model + quick-fitted params, and the port's model on
    the same weights (fitted logits have real top-2 gaps, so token-for-
    token parity across frameworks is a meaningful statement)."""
    out = {}
    for arch in ARCHS:
        jm = jbuild(jsmoke(arch).replace(dtype="float32"))
        params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)),
                                steps=40, max_steps=40)
        m = build_model(get_smoke_config(arch).replace(dtype="float32"))
        m.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        out[arch] = (jm, params, m)
    return out


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
    eng.pool.check()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    assert [r.stop_reason for r in reqs] == [r.stop_reason for r in jreqs]
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in STEP_KEYS} == {k: jst[k] for k in STEP_KEYS}
    pc, jpc = st["prefix_cache"], jst["prefix_cache"]
    assert {k: pc[k] for k in CACHE_KEYS} == {k: jpc[k] for k in CACHE_KEYS}
    return st


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(fitted, arch):
    """Chunked prefill (chunks of 8 under a 12-token budget), two rounds,
    spec_decode asked for: the same streams, bills, counters and hits,
    and no verify step in either engine."""
    kw = dict(max_batch=3, max_seq=160, page_size=8, spec_decode=True,
              prefill_chunk=8, prefill_token_budget=12)
    prompts = [ramp_prompt(10 + 9 * i, 14 + 5 * i) for i in range(4)]
    jeng, jreqs, eng, reqs = _both(fitted, arch, kw, prompts, rounds=2,
                                   max_new=8)
    st = _assert_same(jeng, jreqs, eng, reqs)
    assert not eng.spec and st["verify_steps"] == 0
    assert st["prefix_cache"]["hits"] > 0, "round 2 must hit the cache"
    assert st["prefix_cache"]["partial_hits"] == 0


def test_window_frees_pages_like_jax(fitted):
    """recurrentgemma's rg_attn layers attend within local_window (32 in
    the smoke config), so pages that slide out of it are freed as a
    request advances — in the JAX engine, and in the port since it
    derives its window from local_window.  Prompts of 40-60 tokens run
    well past the window on a pool that holds both requests only if
    slid-out pages go back to it; round-end snapshots (no mid-prefill
    boundary snapshots) then pin only the window's pages."""
    kw = dict(max_batch=2, max_seq=80, page_size=8, num_pages=12,
              prefill_chunk=8, cache_prefill_chunks=False)
    prompts = [ramp_prompt(20, 40), ramp_prompt(70, 50)]
    jeng, jreqs, eng, reqs = _both(fitted, "recurrentgemma_9b", kw, prompts,
                                   rounds=2, max_new=8)
    assert eng._window_free == jeng._window_free == 32
    _assert_same(jeng, jreqs, eng, reqs)
    # snapshots keep the slid-out pages' table entries unmapped
    assert all(-1 in e.cache.pages
               for e in eng.prefix_cache.entries.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_preemption_matches_jax(fitted, arch):
    """A pool too small for every request: preemption, replay from zeroed
    recurrent state and prefix snapshots run the same schedule in both
    packages."""
    kw = dict(max_batch=3, max_seq=64, page_size=8, num_pages=12,
              prefill_chunk=8)
    prompts = [ramp_prompt(20 + 11 * i, 20) for i in range(3)]
    jeng, jreqs, eng, reqs = _both(fitted, arch, kw, prompts, rounds=1,
                                   max_new=16)
    _assert_same(jeng, jreqs, eng, reqs)
    assert eng.model_steps["preemptions"] > 0
