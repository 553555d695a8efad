"""The port's quick-fit fixtures (``repro_torch/train/quick_fit.py``)
against the JAX package's, on the CPU.

* ``reflect_sequence`` and the batches both fits draw are the
  reference's, token for token, for a seed (the reference's SGD step is
  replaced by a recorder, so no JAX step is compiled);
* the ``target_margin`` extension rounds run the reference's step counts
  under one scripted sequence of margins;
* the port's ``quick_fit_ramp`` makes the demo smoke config (float32)
  continue ramps inside the drawn range at 95% of positions or more,
  teacher-forced, with a median margin above 2.  Neither package reaches ``target_margin`` 2.0 on this config
  within the 6x cap: the vocab's last ramp (tokens 467-505, rarely
  drawn) stays below it (reference -4.19, port -10.43 after 720 steps);
* ``_ramp_margin`` of the port on the reference's fitted weights
  (bridged) equals the reference's to 1e-4 (float32 logits of a 2-layer
  model through two frameworks; margins are O(1)).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.train import quick_fit as jq
from repro_torch import bridge
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.train import quick_fit as q

ARCH = "reflect_demo_100m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run long loops of small tensor
    operations, which wait on every thread of the pool, and the suite's
    parallel workers would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reflect_sequence_matches_reference():
    for seed in range(4):
        for seq in (64, 96):
            a, b = np.random.default_rng(seed), np.random.default_rng(seed)
            for _ in range(20):
                assert q.reflect_sequence(a, seq, 512) == \
                    jq.reflect_sequence(b, seq, 512)
    assert q.ramp_prompt(10, 5) == jq.ramp_prompt(10, 5)


def _recorders(monkeypatch):
    """Replace both packages' SGD steps by recorders of the token batches
    they would train on; returns the two lists."""
    ref_toks, port_toks = [], []

    def fake_jit(step):
        return lambda p, toks: ref_toks.append(np.asarray(toks)) or p

    monkeypatch.setattr(jq, "jax", types.SimpleNamespace(
        jit=fake_jit, value_and_grad=jax.value_and_grad,
        tree_util=jax.tree_util, nn=jax.nn))
    monkeypatch.setattr(q, "_sgd_step", lambda m, toks, lr:
                        port_toks.append(np.asarray(toks)))
    return ref_toks, port_toks


def _models():
    jm = jbuild(jsmoke(ARCH))
    return jm, build_model(get_smoke_config(ARCH))


@pytest.mark.parametrize("fit", ["ramp", "reflect"])
def test_fit_draws_match_reference(fit, monkeypatch):
    ref_toks, port_toks = _recorders(monkeypatch)
    jm, m = _models()
    for seed in (0, 3):
        if fit == "ramp":
            jq.quick_fit_ramp(jm, None, steps=5, max_steps=5, seed=seed)
            q.quick_fit_ramp(m, steps=5, max_steps=5, seed=seed)
        else:
            jq.quick_fit_reflect(jm, None, steps=5, seed=seed)
            q.quick_fit_reflect(m, steps=5, seed=seed)
    assert len(ref_toks) == len(port_toks) == 10
    for a, b in zip(ref_toks, port_toks):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("margins", [[3.0], [0.5, 2.5], [0.1, 0.2, 1.9, 2.1],
                                     [-1.0] * 20])
def test_extension_rounds_match_reference(margins, monkeypatch):
    ref_toks, port_toks = _recorders(monkeypatch)
    jm, m = _models()
    for mod in (jq, q):
        script = iter(margins + [margins[-1]] * 20)
        monkeypatch.setattr(mod, "_ramp_margin",
                            lambda *a, _s=script, **kw: next(_s))
    jq.quick_fit_ramp(jm, None, steps=40, max_steps=130)
    q.quick_fit_ramp(m, steps=40, max_steps=130)
    assert len(ref_toks) == len(port_toks)
    for a, b in zip(ref_toks, port_toks):
        np.testing.assert_array_equal(a, b)


def _on_ramp(model, starts, probe_len=40, min_context=16):
    """Teacher-forced successor margins (correct logit minus best other)
    of ramps from ``starts``, at positions with ``min_context`` ramp
    tokens of context, as ``_ramp_margin`` takes them."""
    toks = torch.tensor([q.ramp_prompt(s, probe_len) for s in starts])
    with torch.no_grad():
        logits, _ = model.forward({"tokens": toks})
    lg, tgt = logits[:, 1:-1].float(), toks[:, 2:]
    hit = torch.gather(lg, -1, tgt[..., None])[..., 0]
    other = lg.scatter(-1, tgt[..., None], -1e30).amax(dim=-1)
    return (hit - other)[:, min_context:]


def test_port_fit_continues_ramps():
    """After the fit, ramps inside the drawn range (starts below 420) are
    continued at almost every position, with a margin of several logits
    in the median.  (SGD at lr 0.5 is chaotic: the last bits of a float32
    sum move single positions, so the bounds leave room.)"""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    m = build_model(cfg).init(torch.Generator().manual_seed(0))
    starts = list(range(3, 420, 13))
    before = _on_ramp(m, starts)
    assert q.quick_fit_ramp(m, steps=240, max_steps=240) is m
    after = _on_ramp(m, starts)
    print(f"on-ramp accuracy {float((before > 0).float().mean()):.3f} -> "
          f"{float((after > 0).float().mean()):.3f}, median margin "
          f"{float(before.median()):.2f} -> {float(after.median()):.2f}")
    assert float((after > 0).float().mean()) >= 0.95
    assert float(after.median()) > 2.0 > float(before.median())


def test_ramp_margin_matches_reference_on_bridged_weights():
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    params = jq.quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)),
                               steps=30, max_steps=30)
    m = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    m.load_state_dict(bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    want = jq._ramp_margin(jm, params)
    assert q._ramp_margin(m) == pytest.approx(want, abs=1e-4)
    for kw in (dict(probe_len=24, min_context=4),):
        assert q._ramp_margin(m, **kw) == pytest.approx(
            jq._ramp_margin(jm, params, **kw), abs=1e-4)
