"""The port's serving engine against the JAX ``Engine`` on MoE models
(granite-moe-1b-a400m and mixtral-8x7b smoke configs).

Both engines serve two reflection rounds of the same conversations on the
same weights — the JAX package's ``quick_fit_ramp`` fixture, bridged into
the port.  Greedy token streams, ``TokenUsage`` bills, step counters,
prefix-cache counts and the pool's page counts must be identical: paged
fp KV with speculation off and on, paged int8 KV, ring caches, windowed
mixtral (pages freed as they slide out of the window), and a batch of 12
slots at ``capacity_factor`` 0.5, where a decode step routes 12 tokens
to experts of capacity 8 and drops lanes, so that live rows, and idle
slots carrying their last token, take capacity from each other as in the
reference.  Each test prints the smallest top-1/top-2 logit gap the
port's engine sampled from.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro.train.quick_fit import quick_fit_ramp, ramp_prompt
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.models import moe as MOE
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status

ARCHS = ("granite_moe_1b_a400m", "mixtral_8x7b")
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks", "kv_pool_pages_used", "kv_pool_pages")
CACHE_KEYS = ("hits", "partial_hits", "misses", "tokens_saved",
              "boundary_snapshots", "entries", "evictions", "pinned_bytes")


class MarginEngine(Engine):
    """The port's engine, recording the smallest top-1/top-2 gap over the
    rows (verify: the valid lanes) of the logits each step returns."""
    margin = float("inf")

    def _run(self, kind, *arrays):
        logits = super()._run(kind, *arrays)
        lg = logits.float()
        if kind == "decode":
            lg = lg[[i for i, r in enumerate(self.slots) if r is not None]]
        else:
            nv = torch.as_tensor(arrays[2])
            lanes = (nv > 0 if kind == "mixed" else
                     torch.arange(lg.shape[1])[None] < nv[:, None])
            lg = lg[lanes]
        if lg.numel():
            top = lg.topk(2, dim=-1).values
            self.margin = min(self.margin,
                              float((top[:, 0] - top[:, 1]).min()))
        return logits


@pytest.fixture(scope="module")
def fitted():
    """Per arch: the quick-fitted JAX params (fitted logits have real
    top-2 gaps, so token-for-token parity across frameworks is a
    meaningful statement)."""
    out = {}
    for arch in ARCHS:
        jm = jbuild(jsmoke(arch).replace(dtype="float32"))
        out[arch] = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)),
                                   steps=40, max_steps=40)
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


def _both(fitted, arch, kw, prompts, rounds=2, max_new=8, **model_kw):
    """Both engines on the fitted weights of ``arch`` (its smoke config
    with ``model_kw`` replaced), each serving the same rounds."""
    params = fitted[arch]
    jm = jbuild(jsmoke(arch).replace(dtype="float32", **model_kw))
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, rounds, max_new)
    m = build_model(get_smoke_config(arch).replace(dtype="float32",
                                                   **model_kw))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    eng = MarginEngine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, rounds, max_new)
    return jeng, jreqs, eng, reqs


def _assert_same(jeng, jreqs, eng, reqs, label):
    print(f"{label}: smallest top-1/top-2 gap sampled {eng.margin:.3e}")
    assert all(r.status is Status.DONE for r in reqs)
    if eng.pool is not None:
        eng.pool.check()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    assert [r.stop_reason for r in reqs] == [r.stop_reason for r in jreqs]
    st, jst = eng.stats(), jeng.stats()
    keys = [k for k in STEP_KEYS if k in jst]
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    pc, jpc = st["prefix_cache"], jst["prefix_cache"]
    assert {k: pc[k] for k in CACHE_KEYS} == {k: jpc[k] for k in CACHE_KEYS}
    assert pc["hits"] > 0, "round 2 must hit the prefix cache"
    return st


def _prompts(n):
    return [ramp_prompt(10 + 9 * i, 14 + 5 * i) for i in range(n)]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_paged_engine_matches_jax(fitted, kv_dtype, spec):
    """granite smoke, paged pool, chunked prefill (chunks of 16 under a
    24-token budget): verify steps route their valid lanes only."""
    kw = dict(max_batch=3, max_seq=160, page_size=8, spec_decode=spec,
              spec_tokens=4, kv_dtype=kv_dtype, prefill_chunk=16,
              prefill_token_budget=24)
    jeng, jreqs, eng, reqs = _both(fitted, "granite_moe_1b_a400m", kw,
                                   _prompts(4), max_new=10)
    st = _assert_same(jeng, jreqs, eng, reqs, f"paged {kv_dtype} "
                      f"spec={spec}")
    assert eng.spec == spec and (st["verify_steps"] > 0) == spec
    assert st["step_compiles"] == 0


def test_ring_engine_matches_jax(fitted):
    """granite smoke on ring caches (``paged_kv=False``), speculation on
    (the rings hold max_seq)."""
    kw = dict(max_batch=3, max_seq=160, page_size=8, paged_kv=False,
              spec_decode=True, spec_tokens=4, prefill_chunk=16,
              prefill_token_budget=24)
    jeng, jreqs, eng, reqs = _both(fitted, "granite_moe_1b_a400m", kw,
                                   _prompts(4), max_new=10)
    st = _assert_same(jeng, jreqs, eng, reqs, "ring")
    assert eng.spec and st["verify_steps"] > 0


def test_windowed_moe_frees_pages_like_jax(fitted):
    """mixtral smoke with a 16-token sliding window (the full config's
    SWA, cut to the smoke size): every layer is a windowed MoE layer, so
    both engines free the pages that slide out of the window; prompts of
    40-50 tokens run past it on a pool that holds both requests only if
    slid-out pages go back to it."""
    kw = dict(max_batch=2, max_seq=80, page_size=8, num_pages=12,
              prefill_chunk=8, cache_prefill_chunks=False)
    prompts = [ramp_prompt(20, 40), ramp_prompt(70, 50)]
    jeng, jreqs, eng, reqs = _both(fitted, "mixtral_8x7b", kw, prompts,
                                   sliding_window=16)
    assert eng._window_free == jeng._window_free == 16
    _assert_same(jeng, jreqs, eng, reqs, "mixtral window 16")
    assert all(-1 in e.cache.pages
               for e in eng.prefix_cache.entries.values())


def test_decode_drops_couple_rows_like_jax(fitted, monkeypatch):
    """12 slots, 10 conversations, capacity_factor 0.5: a decode step
    routes all 12 slots as one group of 24 lanes into 4 experts of
    capacity 8, so lanes are dropped and a row's output depends on the
    others'.  Budgets of 4 to 22 new tokens make the low slots finish
    first, so idle slots (their last token and position kept, no page
    mapped) sit before live ones in the dispatch order and take their
    capacity.  The port's engine must still give the JAX engine's
    streams, bills and counters, and decode steps must drop lanes."""
    _decode_drops(fitted, monkeypatch, paged=True)


def test_decode_drops_couple_rows_like_jax_ring(fitted, monkeypatch):
    """The same on ring caches (``paged_kv=False``): an idle slot's ring
    read is the ring decode walk's zero row (the JAX oracle's is a uniform
    average, which no caller reads), and its MoE lanes still take
    capacity from the live rows, so the streams, bills and counters must
    equal the JAX engine's on rings too."""
    _decode_drops(fitted, monkeypatch, paged=False)


def _decode_drops(fitted, monkeypatch, paged):
    drops = []
    route = MOE.route

    def counting_route(cfg, p, x3, valid3=None):
        out = route(cfg, p, x3, valid3)
        slot, C = out[3], out[4]
        if valid3 is None and x3.shape[1] == 12:         # a decode step
            drops.append(int((slot >= cfg.num_experts * C).sum()))
        return out

    monkeypatch.setattr(MOE, "route", counting_route)
    kw = dict(max_batch=12, max_seq=160, page_size=8, spec_decode=False,
              prefill_chunk=16, prefill_token_budget=64, paged_kv=paged)
    prompts = _prompts(10)
    budgets = [4 + 2 * i for i in range(10)]
    arch = "granite_moe_1b_a400m"
    params = fitted[arch]
    runs = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            jm = jbuild(jsmoke(arch).replace(dtype="float32",
                                             capacity_factor=0.5))
            eng, req_cls = JEngine(jm, params, JServeConfig(**kw)), JRequest
        else:
            m = build_model(get_smoke_config(arch).replace(
                dtype="float32", capacity_factor=0.5))
            m.load_state_dict(params_from_jax(
                jax.tree_util.tree_map(np.asarray, params)))
            eng = MarginEngine(m, ServeConfig(**kw), device="cpu")
            req_cls = Request
        convos, reqs = [list(q) for q in prompts], []
        for _ in range(2):
            rnd = [req_cls(prompt=list(c), max_new_tokens=n, eos_id=None)
                   for c, n in zip(convos, budgets)]
            for r in rnd:
                eng.submit(r)
            eng.run()
            for c, r in zip(convos, rnd):
                c += r.output + [99, 98]
            reqs += rnd
        runs.append((eng, reqs))
    (jeng, jreqs), (eng, reqs) = runs
    _assert_same(jeng, jreqs, eng, reqs, "max_batch 12, capacity 0.5, "
                 + ("paged" if paged else "ring"))
    print(f"decode steps {len(drops)}, lanes dropped {sum(drops)}")
    assert drops and sum(drops) > 0
