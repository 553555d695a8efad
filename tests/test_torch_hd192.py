"""Head dim 192 (nemotron-4-340b's) on the port, against the JAX package
on the CPU, where every kernel wrapper runs its plain PyTorch version.

The model is nemotron's smoke config widened to hd 192 (12 query heads
over one KV head, d_model 256, 2 layers, vocab 256), on weights bridged
from the JAX model's (``bridge.params_from_jax``):

* chunked paged prefill + paged decode, and ``prefill`` + ring decode
  (then an all-lane verify extend on the ring): logits to 1e-4 absolute +
  1e-4 relative, as tests/test_torch_model.py, with q/k x 0.25 in both
  packages as tests/test_torch_ring.py (random-init attention is near
  one-hot);
* both engines, paged with speculation and on rings, on the JAX
  package's ``quick_fit_ramp`` weights: greedy streams, ``TokenUsage``
  and step counters identical.

It also pins the Python mirrors of the kernels' hd-192 tiles
(``cuda_lib``: stage slots, key tile, paged-extend rows, both shared
memory sizes under the card's limit) and the flash wrapper's refusal of
a gradient at hd 192, whose backward kernel is not built yet (ROADMAP
B3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro.train.quick_fit import quick_fit_ramp, ramp_prompt
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, Status

from test_torch_whisper import _serve

ARCH = "nemotron_4_340b"
WIDE = dict(head_dim=192, num_heads=12, num_kv_heads=1, d_model=256,
            dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks")


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(params):
    m = build_model(get_smoke_config(ARCH).replace(**WIDE))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return m


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, port model) on one weight set, q/k x 0.25."""
    jm = jbuild(jsmoke(ARCH).replace(**WIDE))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.25 if path[-1].key in ("wq", "wk") else x,
        jm.init(jax.random.PRNGKey(0)))
    m = _port(params)
    assert (m.cfg.head_dim, m.cfg.num_heads, m.cfg.num_kv_heads,
            m.cfg.num_layers) == (192, 12, 1, 2)
    return jm, params, m


def _close(got, want, rows=None):
    got, want = got.numpy(), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, **TOL)


def test_chunked_paged_prefill_and_paged_decode_match_jax(pair):
    """Chunked paged prefill (rows at 5 and 3 tokens a step, n_valid
    masking, scattered pages) then paged decode steps."""
    jm, params, m = pair
    B, S, ps, NP = 2, 21, 4, 8
    tokens = np.random.default_rng(3).integers(3, m.cfg.vocab_size, (B, S))
    pt = np.stack([np.arange(NP)[::-1] + b * NP
                   for b in range(B)]).astype(np.int32)
    jcache = JL.init_empty_cache(jm.cache_defs_paged(B, B * NP, ps))
    jext = jax.jit(jm.prefill_extend, static_argnames=("all_logits",))
    jdec = jax.jit(jm.decode_step)
    cache = m.init_cache_paged(B * NP, ps, device=torch.device("cpu"))
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
        got, cache = m.prefill_extend(cache, _t(blk), _t(p0), _t(nv),
                                      page_table=_t(pt))
        _close(got, want, nv > 0)
    nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
    for step in range(4):
        pos = np.full((B,), S + step, np.int32)
        want, jcache = jdec(params, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                            page_table=jnp.asarray(pt))
        got, cache = m.decode_step(cache, _t(nxt), _t(pos), page_table=_t(pt))
        _close(got, want)
        nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)


def test_prefill_and_ring_decode_match_jax(pair):
    """``forward``; ``prefill`` of ragged rows then ring decode steps; then
    an all-lane verify extend on the same ring."""
    jm, params, m = pair
    B, S = 2, 40
    rng = np.random.default_rng(7)
    tokens = rng.integers(3, m.cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 27], np.int32)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    got, _ = m.forward({"tokens": _t(tokens)})
    _close(got, want)
    want, jcache = jm.prefill(params, jnp.asarray(tokens),
                              jnp.asarray(lengths), max_seq=64)
    got, cache = m.prefill(_t(tokens), _t(lengths), max_seq=64)
    _close(got, want)
    nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
    pos = lengths.copy()
    for _ in range(3):
        want, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt),
                                      jnp.asarray(pos))
        got, cache = m.decode_step(cache, _t(nxt), _t(pos))
        _close(got, want)
        nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
        pos = pos + 1
    blk = np.concatenate([nxt, nxt + 1, nxt + 2], axis=1).astype(np.int32)
    nv = np.asarray([3, 2], np.int32)
    want, _ = jm.prefill_extend(params, jcache, jnp.asarray(blk),
                                jnp.asarray(pos), jnp.asarray(nv),
                                all_logits=True)
    got, _ = m.prefill_extend(cache, _t(blk), _t(pos), _t(nv),
                              all_logits=True)
    _close(got, want, np.arange(3)[None, :] < nv[:, None])


@pytest.fixture(scope="module")
def fitted():
    jm = jbuild(jsmoke(ARCH).replace(**WIDE))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)), steps=40,
                            max_steps=40)
    return jm, params, _port(params)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
def test_engine_matches_jax(fitted, paged):
    """Two reflection rounds on both engines, speculation asked: greedy
    streams, bills, step counters and prefix hits identical."""
    jm, params, m = fitted
    kw = dict(max_batch=3, max_seq=128, page_size=8, prefill_chunk=16,
              prefill_token_budget=24, spec_decode=True, spec_tokens=3,
              paged_kv=paged)
    prompts = [ramp_prompt(10 + 9 * i, 18 + 5 * i) for i in range(3)]
    jeng = JEngine(jm, params, JServeConfig(**kw))
    jreqs = _serve(jeng, JRequest, prompts, 2, 8)
    eng = Engine(m, ServeConfig(**kw), device="cpu")
    reqs = _serve(eng, Request, prompts, 2, 8)
    assert eng.paged == jeng.paged == paged
    assert all(r.status is Status.DONE for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert ([dataclasses.asdict(r.usage) for r in reqs]
            == [dataclasses.asdict(r.usage) for r in jreqs])
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in STEP_KEYS} == {k: jst[k] for k in STEP_KEYS}
    print(f"hd 192 {'paged' if paged else 'ring'}: verify steps "
          f"{st['verify_steps']}, drafted {st['spec_drafted']}, accepted "
          f"{st['spec_accepted']}")
    assert (eng.prefix_cache.stats["hits"] == jeng.prefix_cache.stats["hits"]
            > 0), "round 2 must hit"


def test_kernel_tile_mirrors_at_hd192():
    """``cuda_lib``'s mirrors of the kernels' hd-192 tiles, each equal to
    its C++ counterpart's arithmetic, and both shared-memory sizes under
    the card's limit at nemotron's serve (a 2048-slot table of 128
    pages)."""
    assert 192 in cuda_lib.HEAD_DIMS and 192 not in cuda_lib.BWD_HEAD_DIMS
    # paged::stage_slots: 4096 / 192 = 21, raised to one slot a lane
    assert cuda_lib.stage_slots(192) == 32
    # flash_tc::key_tile
    assert cuda_lib.key_tile(192) == 64
    # paged_extend.cu: bf16 q one warpgroup to 64 rows, two above; fp32
    # q kRows<192> = 16 (1024 / 192 = 5 would not split over 4 warps)
    for code in (0, 2):
        assert cuda_lib.extend_rows(192, 60, code) == 16
    for code in cuda_lib.TC_CODES:
        assert cuda_lib.extend_rows(192, 60, code) == 64
        assert cuda_lib.extend_rows(192, 384, code) == 128
    # paged::smem_bytes: q rows, a stage of K (padded) and V, p, rescale
    # and l, the table
    smem = cuda_lib.smem_bytes(192, 16, 128)
    assert smem == 4 * (16 * 192 + 32 * 196 + 32 * 192 + 16 * 32 + 2 * 16) \
        + 4 * 128
    # paged_extend.cu::tc_smem_bytes: bf16 Q, two stages of K and V tiles,
    # a flag byte a slot, the table
    tc = cuda_lib.tc_smem_bytes(192, 128, 128)
    assert tc == 2 * 192 * (128 + 2 * 2 * 64) + 2 * 64 + 4 * 128
    assert max(smem, tc) <= cuda_lib.MAX_SMEM_BYTES
    # paged_common.cuh's P.V pass at hd 192: the column of accumulator k
    # of thread tid, (tid + 128 k) % 48, is one of NCOL = 48 / gcd(128,
    # 48) = 3 columns, those of k % 3
    ch = 192 // 4
    ncol = ch // np.gcd(128, ch)
    assert ncol == 3
    for tid in range(128):
        for k in range(16 * ch // 128):
            assert (tid + 128 * k) % ch == (tid + 128 * (k % ncol)) % ch


def test_flash_refuses_a_gradient_at_hd192():
    """The backward kernel is not built at hd 192: the wrapper's check
    names the ROADMAP item; on the CPU autograd differentiates the plain
    version at any head dim."""
    with pytest.raises(ValueError, match="3b at hd 192"):
        FA._check_bwd_head_dim(192)
    for hd in cuda_lib.BWD_HEAD_DIMS:
        FA._check_bwd_head_dim(hd)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 9, 192, generator=g, requires_grad=True)
               for _ in range(3))
    FA.flash_attention(q, k, v).sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))
