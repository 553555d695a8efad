"""The port's recurrent families against the JAX package on the CPU.

The same numpy inputs (and bridged weights) go through both packages:

* the plain scans (``repro_torch.kernels.ref``, reached through
  ``ops`` on CPU tensors) against the JAX sequential oracles and the
  Pallas kernels in interpret mode, including the split-sequence ``h0``
  continuation — to 1e-5: both sides scan sequentially in float32 and
  differ only in the rounding of ``exp`` and of the output dot product;
* the mamba and RG-LRU blocks (masked extend, unmasked extend, decode,
  conv tails) on the smoke configs — to 1e-4: the JAX blocks scan with a
  chunked associative scan, whose summation order differs from the port's
  sequential scan in the last bits;
* ``TransformerLM`` logits of the falcon-mamba-7b and recurrentgemma-9b
  smoke configs through a chunked paged walk — to 1e-4, for the same
  reason, over a prompt longer than recurrentgemma's 32-slot window;
* the plain paged kernels at recurrentgemma-9b's local-attention shape
  (K 1, G 16, hd 256) with a window — to 1e-5, as
  ``tests/test_torch_kernels.py`` holds the other shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import rglru as JRG
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import mamba as M
from repro_torch.models import rglru as RG
from repro_torch.models.registry import build_model, get_smoke_config

SCAN_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _mamba_inputs(rng, B, S, D, N):
    dt = np.log1p(np.exp(rng.normal(size=(B, S, D)))) * 0.1
    return [a.astype(np.float32) for a in (
        dt, rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N)),
        rng.normal(size=(B, S, D)), -np.exp(0.3 * rng.normal(size=(D, N))),
        rng.normal(size=(D,)), rng.normal(size=(B, D, N)))]


@pytest.mark.parametrize("B,S,D,N", [(2, 32, 128, 8), (1, 40, 64, 16),
                                     (3, 1, 64, 4)])
def test_mamba_scan_plain_matches_jax(B, S, D, N):
    args = _mamba_inputs(np.random.default_rng(S), B, S, D, N)
    y, h = ops.mamba_scan(*map(_t, args))
    for want_y, want_h in (jref.mamba_scan_ref(*map(_j, args)),
                           jops.mamba_scan(*map(_j, args), bd=min(D, 64),
                                           interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)


def test_mamba_scan_split_sequence_continues_h0():
    """scan(second half, h0 = scan(first half).h) == scan(whole), and
    pad lanes (dt = 0) leave the state unchanged."""
    dt, Bm, Cm, x, A, Dsk, h0 = map(
        _t, _mamba_inputs(np.random.default_rng(4), 2, 48, 64, 8))
    y, h = ops.mamba_scan(dt, Bm, Cm, x, A, Dsk, h0)
    _, h1 = ops.mamba_scan(dt[:, :20], Bm[:, :20], Cm[:, :20], x[:, :20], A,
                           Dsk, h0)
    y2, h2 = ops.mamba_scan(dt[:, 20:], Bm[:, 20:], Cm[:, 20:], x[:, 20:],
                            A, Dsk, h1)
    np.testing.assert_allclose(y2.numpy(), y[:, 20:].numpy(), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    dt_pad = dt.clone()
    dt_pad[:, 20:] = 0.0
    _, h_pad = ops.mamba_scan(dt_pad, Bm, Cm, x, A, Dsk, h0)
    np.testing.assert_array_equal(h_pad.numpy(), h1.numpy())
    want = jops.mamba_scan(*map(_j, (dt[:, 20:], Bm[:, 20:], Cm[:, 20:],
                                     x[:, 20:], A, Dsk, h1)),
                           bd=64, interpret=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(want[0]),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("B,S,W", [(2, 48, 256), (3, 7, 128), (2, 1, 64)])
def test_rglru_scan_plain_matches_jax(B, S, W):
    rng = np.random.default_rng(W + S)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, S, W))))).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    hs, h = ops.rglru_scan(_t(a), _t(b), _t(h0))
    for want_hs, want_h in (jref.rglru_scan_ref(_j(a), _j(b), _j(h0)),
                            jops.rglru_scan(_j(a), _j(b), _j(h0),
                                            bw=min(W, 64), interpret=True)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
    # split sequence: the second part continues the first part's state
    c = max(1, S // 2)
    _, h1 = ops.rglru_scan(_t(a[:, :c]), _t(b[:, :c]), _t(h0))
    if c < S:
        hs2, h1 = ops.rglru_scan(_t(a[:, c:]), _t(b[:, c:]), h1)
        np.testing.assert_array_equal(hs2.numpy(), hs[:, c:].numpy())
    np.testing.assert_array_equal(h1.numpy(), h.numpy())


# ------------------------------------------------------------------ blocks

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch):
    """(JAX model, JAX params, port model) with identical fp32 weights."""
    jm = jbuild(jsmoke(arch).replace(dtype="float32"))
    params = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_smoke_config(arch).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(_np_tree(params)))
    return jm, params, m


@pytest.fixture(scope="module")
def pairs():
    return {arch: _pair(arch)
            for arch in ("falcon_mamba_7b", "recurrentgemma_9b")}


def _state(rng, conv_shape, h_shape):
    return {"conv": rng.normal(size=conv_shape).astype(np.float32),
            "h": rng.normal(size=h_shape).astype(np.float32)}


BLOCKS = {
    # arch: (JAX extend, JAX decode, port extend, port decode, state shapes)
    "falcon_mamba_7b": (JM.mamba_block_extend, JM.mamba_block_decode,
                        M.mamba_block_extend, M.mamba_block_decode,
                        lambda c, B: ((B, c.ssm_conv - 1, c.d_inner),
                                      (B, c.d_inner, c.ssm_state))),
    "recurrentgemma_9b": (JRG.rglru_block_extend, JRG.rglru_block_decode,
                          RG.rglru_block_extend, RG.rglru_block_decode,
                          lambda c, B: ((B, RG.CONV_K - 1, c.lru_width),
                                        (B, c.lru_width))),
}


@pytest.mark.parametrize("masked", [True, False], ids=["valid", "all"])
@pytest.mark.parametrize("arch", list(BLOCKS))
def test_recurrent_block_matches_jax(pairs, arch, masked):
    """Layer 0 (mamba / rglru) of the smoke model: an extend over a
    suffix with trailing pad lanes (or none), then a decode step, from a
    nonzero state; outputs on valid lanes and the state after each step
    (conv tail and h) match.  A row with no valid lane keeps its state
    exactly."""
    jm, params, m = pairs[arch]
    jext, jdec, text, tdec, shapes = BLOCKS[arch]
    cfg, jcfg = m.cfg, jm.cfg
    jp = jax.tree_util.tree_map(lambda a: a[0], params["scan"][0])
    p = m.blocks[0]
    B, S = 3, 6
    rng = np.random.default_rng(7)
    state = _state(rng, *shapes(cfg, B))
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    nv = np.asarray([6, 2, 0] if masked else [S] * B, np.int32)
    valid = np.arange(S)[None, :] < nv[:, None]
    want, jstate = jext(jcfg, jp, _j(x), {k: _j(v) for k, v in state.items()},
                        _j(valid) if masked else None)
    tstate = {k: _t(v) for k, v in state.items()}
    got, tstate = text(cfg, p, _t(x), tstate,
                       _t(valid) if masked else None)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for k in state:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
    if masked:
        for k in state:                       # nv = 0: an exact no-op
            np.testing.assert_array_equal(tstate[k].numpy()[2], state[k][2])
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    want, jstate = jdec(jcfg, jp, _j(x1), jstate)
    got, tstate = tdec(cfg, p, _t(x1), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for k in state:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)


def test_conv_tail_at_matches_jax():
    from repro_torch.models import layers as L
    rng = np.random.default_rng(1)
    hist = rng.normal(size=(3, 3 + 6, 5)).astype(np.float32)
    nv = np.asarray([6, 2, 0], np.int32)
    got = L.conv_tail_at(_t(hist), _t(nv), 4)
    want = JL.conv_tail_at(_j(hist), _j(nv), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_9b"])
def test_transformer_paged_logits_match_jax(pairs, arch):
    """Chunked paged prefill of a 40-token prompt (uneven chunks per row,
    nv masking of recurrent state and of the rg_attn pool writes, past
    recurrentgemma's 32-slot window) then paged decode steps: logits of
    both packages agree to 1e-4."""
    jm, params, m = pairs[arch]
    cfg = m.cfg
    B, S, ps, NP = 2, 40, 4, 12
    tokens = np.random.default_rng(3).integers(3, cfg.vocab_size, (B, S))
    pt = np.stack([np.arange(NP) + b * NP for b in range(B)]).astype(np.int32)
    jcache = JL.init_empty_cache(jm.cache_defs_paged(B, B * NP, ps))
    jext = jax.jit(jm.prefill_extend, static_argnames=("all_logits",))
    jdec = jax.jit(jm.decode_step)
    tcache = m.init_cache_paged(B * NP, ps, device=torch.device("cpu"),
                                batch=B)
    sizes, prog = [7, 3], [0, 0]
    while min(prog) < S:
        blk = np.zeros((B, 7), np.int32)
        nv = np.zeros(B, np.int32)
        p0 = np.zeros(B, np.int32)
        for b in range(B):
            n = min(sizes[b], S - prog[b])
            blk[b, :n] = tokens[b, prog[b]:prog[b] + n]
            nv[b], p0[b] = n, prog[b]
            prog[b] += n
        want, jcache = jext(params, jcache, _j(blk), _j(p0), _j(nv),
                            page_table=_j(pt))
        got, tcache = m.prefill_extend(tcache, _t(blk), _t(p0), _t(nv),
                                       page_table=_t(pt))
        rows = nv > 0
        np.testing.assert_allclose(got.numpy()[rows],
                                   np.asarray(want)[rows], atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
    nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        want, jcache = jdec(params, jcache, _j(nxt), _j(pos),
                            page_table=_j(pt))
        got, tcache = m.decode_step(tcache, _t(nxt), _t(pos),
                                    page_table=_t(pt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        nxt = np.argmax(np.asarray(want), -1)[:, None].astype(np.int32)


def test_bridge_unstacks_recurrentgemma_unit_and_tail():
    """The 9-layer pattern scans a stacked (rglru, rglru, rg_attn) unit
    three times; layer order and the fp32 ``lam`` survive the bridge."""
    from repro.configs.base import recurrentgemma_pattern
    jcfg = jsmoke("recurrentgemma_9b").replace(
        num_layers=8, block_pattern=recurrentgemma_pattern(8),
        param_dtype="bfloat16")
    params = jbuild(jcfg).init(jax.random.PRNGKey(1))
    state = params_from_jax(_np_tree(params))
    unit, tail = params["scan"], params["tail"]
    assert len(unit) == 3 and len(tail) == 2         # 2 x unit + 2 tail
    assert state["blocks.5.attn.wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["blocks.5.attn.wq"].float().numpy(),
        np.asarray(unit[2]["attn"]["wq"][1], np.float32))
    np.testing.assert_array_equal(
        state["blocks.7.in_x"].float().numpy(),
        np.asarray(tail[1]["in_x"], np.float32))
    assert state["blocks.3.lam"].dtype == torch.float32
    m = build_model(get_smoke_config("recurrentgemma_9b").replace(
        num_layers=8, block_pattern=jcfg.block_pattern,
        param_dtype="bfloat16"))
    m.load_state_dict(state)


# ------------------------------------------- paged kernels at hd 256, G 16

@pytest.mark.parametrize("window", [None, 48])
def test_paged_plain_matches_jax_mqa_hd256(window):
    """recurrentgemma-9b's local attention shape: one KV head, 16 query
    heads, head_dim 256, against the JAX oracles."""
    rng = np.random.default_rng(5)
    B, Sx, K, G, hd, ps, NP, P = 2, 5, 1, 16, 256, 16, 6, 16
    q = rng.normal(size=(B, Sx, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    pt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    pos0 = np.asarray([37, 70], np.int32)
    pt[0, 3:] = -1
    got = ops.paged_extend_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                     _t(pos0), window=window).numpy()
    want = jref.paged_extend_attention_ref(_j(q), _j(kp), _j(vp), _j(pt),
                                           _j(pos0), window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    got = ops.paged_decode_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(pt),
                                     _t(pos0), window=window).numpy()
    want = jref.paged_decode_attention_ref(_j(q[:, 0]), _j(kp), _j(vp),
                                           _j(pt), _j(pos0), window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
