"""The port's step warmup (``ServeConfig.aot_warmup``, serving/step_graph.py)
on the CPU, where a warmed step runs eagerly through its static buffers.

* A warmed port engine against the JAX ``Engine`` with ``aot_warmup=True``
  on the same weights (the JAX package's ``quick_fit_ramp`` fixture,
  bridged into the port): identical greedy streams, ``TokenUsage`` bills,
  step counters and preemptions, with no step outside the warmed shapes
  (``step_compiles == 0``) — the reflect_demo_100m smoke config paged in
  fp and int8 KV with speculation and on rings, the granite-moe smoke
  config paged with speculation, and the falcon-mamba and recurrentgemma
  smoke configs paged.
* The cache after warm-up equals a fresh cache bit for bit.
* The K/V writes through the scratch slot leave pools, rings and ``tok``
  bit-identical to a write that selects its lanes with ``torch.nonzero``.
* ``layers.cast`` keeps one copy per parameter and dtype, refreshes it
  when the parameter changes, and leaves logits bit-identical to casting
  at every use.
* A mixed width that was not warmed is served eagerly, correctly, and
  counted by the tripwire.
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
from repro_torch.kernels import kv_quant as Q
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status

STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks")
DEMO = dict(max_batch=3, max_seq=160, page_size=8, spec_decode=True,
            spec_tokens=4, prefill_chunk=16, prefill_token_budget=24)
# the recurrent models do not speculate: a second mixed bucket makes a
# third warmed shape
RECURRENT = dict(max_batch=3, max_seq=160, page_size=8, prefill_chunk=8,
                 prefill_token_budget=12, prefill_buckets=(4,))


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
    """Fitted weights (greedy streams of fitted models have real top-2
    gaps, so token-for-token parity across frameworks means something)."""
    return {"reflect_demo_100m": _fit("reflect_demo_100m", 60),
            "granite_moe_1b_a400m": _fit("granite_moe_1b_a400m", 40),
            "falcon_mamba_7b": _fit("falcon_mamba_7b", 40),
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


@pytest.mark.parametrize("arch,kw", [
    ("reflect_demo_100m", dict(DEMO, kv_dtype="model")),
    ("reflect_demo_100m", dict(DEMO, kv_dtype="int8")),
    ("reflect_demo_100m", dict(DEMO, paged_kv=False)),
    ("granite_moe_1b_a400m", DEMO),
    ("falcon_mamba_7b", RECURRENT),
    ("recurrentgemma_9b", RECURRENT)],
    ids=["demo-paged-fp", "demo-paged-int8", "demo-ring", "granite-paged",
         "falcon-paged", "recurrentgemma-paged"])
def test_warmed_engine_matches_jax(fitted, arch, kw):
    jm, params, m = fitted[arch]
    kw = dict(kw, aot_warmup=True)
    prompts = [ramp_prompt(10 + 9 * i, 14 + 5 * i) for i in range(4)]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, rounds=2, max_new=10)
    eng = Engine(m, ServeConfig(**kw), device="cpu")
    st0 = eng.stats()
    assert st0["aot_warmed"] >= 3 and st0["startup_compile_s"] > 0.0
    reqs = _serve(eng, Request, prompts, rounds=2, max_new=10)

    assert all(r.status is Status.DONE for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    assert [r.stop_reason for r in reqs] == [r.stop_reason for r in jreqs]
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in STEP_KEYS} == {k: jst[k] for k in STEP_KEYS}
    assert st["step_compiles"] == 0, st["step_compiles_by_fn"]
    assert jst["step_compiles"] == 0, jst["step_compiles_by_fn"]
    assert st["prefix_cache"]["hits"] > 0
    assert ((st["verify_steps"] > 0) == eng.spec
            == (arch in ("reflect_demo_100m", "granite_moe_1b_a400m")))
    if eng.paged:
        eng.pool.check()


def _leaves(cache):
    return [(i, name, leaf) for i, layer in enumerate(cache)
            for name, leaf in layer.items()]


@pytest.mark.parametrize("arch,kw", [
    ("reflect_demo_100m", dict(spec_decode=True, kv_dtype="int8")),
    ("reflect_demo_100m", dict(spec_decode=True, paged_kv=False)),
    ("falcon_mamba_7b", {}),
    ("recurrentgemma_9b", dict(paged_kv=False))],
    ids=["demo-paged-int8", "demo-ring", "falcon-paged",
         "recurrentgemma-ring"])
def test_cache_after_warmup_is_fresh(arch, kw):
    """The warm-up runs write into the cache (the ring decode step writes
    slot 0 of every row, recurrent state advances); the engine then
    empties it in place, so it equals a fresh engine's cache bit for bit
    and every leaf keeps its address."""
    m = build_model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0))
    scfg = ServeConfig(max_batch=2, max_seq=64, page_size=8, **kw)
    fresh = Engine(m, scfg, device="cpu").cache
    eng = Engine(m, dataclasses.replace(scfg, aot_warmup=True),
                 device="cpu")
    assert eng.stats()["aot_warmed"] >= 2
    for (i, name, got), (_, _, want) in zip(_leaves(eng.cache),
                                            _leaves(fresh)):
        assert torch.equal(got, want), (i, name)
    ptrs = [leaf.data_ptr() for _, _, leaf in _leaves(eng.cache)]
    eng.submit(Request(prompt=list(range(3, 20)), max_new_tokens=4,
                       eos_id=None))
    eng.run()
    assert [leaf.data_ptr() for _, _, leaf in _leaves(eng.cache)] == ptrs


# ------------------------------------------------- writes without a sync

def _nonzero_put(cache, names, idx, k, v):
    """The K/V write as it selected its lanes before: ``idx`` a tuple of
    index tensors into the leaves themselves."""
    kn, vn, ksn, kzn, vsn = names
    if ksn in cache:
        kq, ks, kz = Q.quantize_k(k)
        vq, vs = Q.quantize_v(v)
        for name, val in ((kn, kq), (vn, vq), (ksn, ks), (kzn, kz),
                          (vsn, vs)):
            cache[name].index_put_(idx, val)
    else:
        cache[kn].index_put_(idx, k.to(cache[kn].dtype))
        cache[vn].index_put_(idx, v.to(cache[vn].dtype))


def _nonzero_paged_write(pool, k, v, phys, off):
    keep = torch.nonzero(phys >= 0, as_tuple=True)
    _nonzero_put(pool, A.POOL_LEAVES, (phys[keep].long(), off[keep].long()),
                 k[keep], v[keep])


def _nonzero_ring_write(ring, k, v, positions, valid):
    B, Sx = positions.shape
    C = ring["k"].shape[1]
    slot = positions % C
    lane = torch.arange(Sx)
    same = slot[:, :, None] == slot[:, None, :]
    later = lane[None, None, :] > lane[None, :, None]
    dup = (same & later & valid[:, None, :]).any(dim=-1)
    b, s = torch.nonzero(valid & ~dup, as_tuple=True)
    idx = (b, slot[b, s].long())
    _nonzero_put(ring, A.RING_LEAVES, idx, k[b, s], v[b, s])
    ring["tok"].index_put_(idx, positions[b, s].to(torch.int32))


def _filled(defs, seed):
    """Two copies of one cache made by ``empty_cache`` and filled with
    seeded values (an int8 cache through the quantizers)."""
    g = torch.Generator().manual_seed(seed)
    caches = [A.empty_cache(defs), A.empty_cache(defs)]
    for name, (shape, dt) in defs.items():
        if dt == torch.int8:
            val = torch.randint(-128, 128, shape, generator=g, dtype=dt)
        elif name == "tok":
            val = torch.randint(-1, 50, shape, generator=g, dtype=dt)
        else:
            val = torch.randn(shape, generator=g).to(dt)
        for c in caches:
            c[name].copy_(val)
    return caches


def _assert_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("shape", ["decode", "extend"])
def test_paged_write_matches_nonzero_write(kv_dtype, shape):
    """Pad lanes and lanes on unmapped pages (-1) go to the scratch slot;
    every other lane lands where the nonzero write put it."""
    cfg = get_smoke_config("reflect_demo_100m")
    P, ps, K, hd = 12, 4, cfg.num_kv_heads, cfg.head_dim
    got, want = _filled(A.paged_kv_cache_def(cfg, P, ps, torch.float32,
                                             kv_dtype), 1)
    g = torch.Generator().manual_seed(2)
    B, Sx = 3, (1 if shape == "decode" else 7)
    pt = torch.randperm(P, generator=g)[:B * 4].view(B, 4).to(torch.int32)
    pt[0, 2:] = -1
    pt[2] = -1
    pos0 = torch.tensor([2, 5, 9], dtype=torch.int32)
    positions = pos0[:, None] + torch.arange(Sx, dtype=torch.int32)
    phys = A._write_phys(pt, positions, ps)
    valid = torch.arange(Sx)[None, :] < torch.tensor([7, 3, 5])[:, None]
    phys = torch.where(valid, phys, -1)
    k = torch.randn(B, Sx, K, hd, generator=g)
    v = torch.randn(B, Sx, K, hd, generator=g)
    if shape == "decode":
        phys, positions, k, v = phys[:, 0], positions[:, 0], k[:, 0], v[:, 0]
    assert bool((phys < 0).any()) and bool((phys >= 0).any())
    A._paged_write(got, k, v, phys, positions % ps)
    _nonzero_paged_write(want, k, v, phys, positions % ps)
    _assert_equal(got, want)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("Sx", [5, 13], ids=["Sx<=C", "Sx>C"])
def test_ring_write_matches_nonzero_write(kv_dtype, Sx):
    """Pad lanes go to the scratch slot; with Sx > C (a direct call: the
    engine never runs a block wider than its rings) two lanes alias one
    slot and the later valid lane wins, as before."""
    cfg = get_smoke_config("reflect_demo_100m")
    B, C = 3, 8
    got, want = _filled(A.kv_cache_def(cfg, B, C, torch.float32, kv_dtype),
                        3)
    g = torch.Generator().manual_seed(4)
    positions = (torch.tensor([3, 8, 0])[:, None]
                 + torch.arange(Sx)[None, :]).to(torch.int32)
    valid = torch.arange(Sx)[None, :] < torch.tensor([Sx, 4, Sx - 2])[:, None]
    k = torch.randn(B, Sx, cfg.num_kv_heads, cfg.head_dim, generator=g)
    v = torch.randn(B, Sx, cfg.num_kv_heads, cfg.head_dim, generator=g)
    A._masked_ring_write(got, k, v, positions, valid)
    _nonzero_ring_write(want, k, v, positions, valid)
    _assert_equal(got, want)


@pytest.mark.parametrize("S", [6, 20])
def test_prefill_into_cache_matches_nonzero_write(S):
    """Tokens past a row's length stay unwritten, and with S > C only the
    last C of each row survive."""
    cfg = get_smoke_config("reflect_demo_100m")
    B, C = 3, 8
    defs = A.kv_cache_def(cfg, B, C, torch.float32, "int8")
    got, want = A.empty_cache(defs), A.empty_cache(defs)
    g = torch.Generator().manual_seed(5)
    k = torch.randn(B, S, cfg.num_kv_heads, cfg.head_dim, generator=g)
    v = torch.randn(B, S, cfg.num_kv_heads, cfg.head_dim, generator=g)
    lengths = torch.tensor([S, S // 2, 1], dtype=torch.int32)
    A.prefill_into_cache(got, k, v, lengths)
    t = torch.arange(S)[None, :].expand(B, S)
    n = lengths.long()[:, None]
    _nonzero_ring_write(want, k, v, t, (t < n) & (t >= n - C))
    _assert_equal(got, want)


def test_write_refuses_a_cache_without_its_scratch_slot():
    pool = {name: torch.zeros(shape, dtype=dt) for name, (shape, dt) in
            A.paged_kv_cache_def(get_smoke_config("reflect_demo_100m"), 4, 4,
                                 torch.float32).items()}
    k = torch.zeros(1, pool["kp"].shape[2], pool["kp"].shape[3])
    with pytest.raises(ValueError, match="scratch slot"):
        A._paged_write(pool, k, k, torch.tensor([-1]), torch.tensor([0]))


# ------------------------------------------------------------ cast helper

def test_cast_keeps_one_copy_per_parameter_and_dtype():
    w = L.param((4, 3))
    w.copy_(torch.randn(4, 3))
    assert L.cast(w, torch.float32) is w
    c1 = L.cast(w, torch.bfloat16)
    assert L.cast(w, torch.bfloat16) is c1
    assert torch.equal(c1, w.to(torch.bfloat16))
    w.add_(1.0)                              # a write moves its version
    c2 = L.cast(w, torch.bfloat16)
    assert c2 is not c1 and torch.equal(c2, w.to(torch.bfloat16))
    t = torch.randn(4, 3)                    # not a parameter: no copy kept
    assert L.cast(t, torch.bfloat16) is not L.cast(t, torch.bfloat16)
    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0))
    blk = m.blocks[0].mlp
    before = L.cast(blk.wi, torch.bfloat16)
    m.load_state_dict({k: v * 2 for k, v in m.state_dict().items()})
    after = L.cast(blk.wi, torch.bfloat16)
    assert after is not before
    assert torch.equal(after, blk.wi.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["reflect_demo_100m", "falcon_mamba_7b",
                                  "recurrentgemma_9b", "qwen3_0_6b",
                                  "granite_moe_1b_a400m"])
def test_cast_leaves_logits_bit_identical(arch, monkeypatch):
    """bf16 activations (recurrentgemma: bf16 parameters, its gates read
    in fp32; qwen3: tied embeddings; granite: the router and expert
    weights): chunked paged prefill and a decode step give the same bits
    with the kept copies as with a cast at every use."""
    cfg = get_smoke_config(arch).replace(dtype="bfloat16")
    m = build_model(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.randint(3, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    pt = torch.arange(8, dtype=torch.int32).view(2, 4)

    def run():
        cache = m.init_cache_paged(8, 4, batch=2)
        i32 = dict(dtype=torch.int32)
        a, _ = m.prefill_extend(cache, toks, torch.zeros(2, **i32),
                                torch.tensor([8, 5], **i32), page_table=pt)
        b, _ = m.decode_step(cache, toks[:, :1], torch.tensor([8, 5], **i32),
                             page_table=pt)
        return a, b

    kept = run() + run()                     # the second pass reuses copies
    monkeypatch.setattr(L, "cast", lambda w, dt: w.to(dt))
    every_use = run()
    for got, want in zip(kept, every_use + every_use):
        assert torch.equal(got, want)


# ------------------------------------------------------ the tripwire

def test_unwarmed_width_is_served_and_counted(fitted):
    """A mixed width that was not warmed (the engine's bucket list grown
    after warm-up) runs eagerly and counts in step_compiles_by_fn; the
    streams equal an eager engine's that has that bucket."""
    _, _, m = fitted["reflect_demo_100m"]
    kw = dict(DEMO, spec_decode=False)
    prompts = [ramp_prompt(10 + 9 * i, 14 + 5 * i) for i in range(3)]
    ref = Engine(m, ServeConfig(**kw, prefill_buckets=(4,)), device="cpu")
    want = _serve(ref, Request, prompts, rounds=2, max_new=8)
    eng = Engine(m, ServeConfig(**kw, aot_warmup=True), device="cpu")
    eng._mixed_buckets = sorted(set(eng._mixed_buckets) | {4})
    got = _serve(eng, Request, prompts, rounds=2, max_new=8)
    assert [r.output for r in got] == [r.output for r in want]
    assert ([dataclasses.asdict(r.usage) for r in got]
            == [dataclasses.asdict(r.usage) for r in want])
    st = eng.stats()
    assert st["step_compiles_by_fn"]["mixed"] > 0
    assert st["step_compiles_by_fn"]["decode"] == 0
    assert st["step_compiles"] == st["step_compiles_by_fn"]["mixed"]
