"""The paper's reflection loop over the port's engine against the same loop
over the JAX engine, on the same weights.

Both packages run ``core/reflection.py``'s ``ReflectionController`` —
the reference's over ``repro.serving.engine.Engine``, the port's copy
over ``repro_torch.serving.engine.Engine`` — on the JAX package's
``quick_fit_ramp`` weights bridged into the port, with the example's
``ServeConfig`` (paged pool, page size 32, speculation on) at batch 2 and
two SQL tasks whose conversations are re-encoded text every round:

* the fixed loop for 0, 1 and 3 reflection rounds under no feedback,
  SQL execution feedback and the sampled LLM judge, eagerly and with
  ``aot_warmup=True`` on the port's side;
* the routed loop with a neutral ``ControllerConfig`` (which must also
  equal the fixed loop) and with the default one under an SLO;
* a two-tier ``CascadeBackend`` whose judged stalls hop to the large
  tier, the small tier's tokens drafting for the large engine;
* greedy best-of-3 (``core/parallel_sampling.py``) through each engine.

Responses, per-round ``TokenUsage``, ``correct`` flags, decision traces
(``Decision.key()``), stop reasons and both engines' step counters must
be identical.  The prompts are byte text, outside the ramp fit's
distribution, so each test prints the smallest top-1/top-2 logit gap the
port's engine sampled from: a near-tie would show there.
"""
import dataclasses
import importlib
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.serving.engine import Engine as JEngine
from repro.train.quick_fit import quick_fit_ramp
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving.engine import Engine

ARCH = "reflect_demo_100m"
KW = dict(max_batch=2, max_seq=1536, page_size=32, spec_decode=True)
MAX_NEW = 16
STEP_KEYS = ("prefill_tokens", "extend_tokens", "decode_tokens",
             "decode_batch_steps", "mixed_steps", "verify_steps",
             "spec_drafted", "spec_accepted", "preemptions",
             "prefill_chunks")


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


def _fit(seed):
    jm = jbuild(jsmoke(ARCH).replace(dtype="float32"))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(seed)),
                            steps=60, max_steps=60, seed=seed)
    m = build_model(get_smoke_config(ARCH).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


@pytest.fixture(scope="module")
def fitted():
    """Fitted weights: greedy streams with real top-2 gaps, so token-for-
    token parity across frameworks means something."""
    return _fit(0)


def _pkg(name):
    """The reflection stack of one package as a namespace."""
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in (
        ("R", "core.reflection"), ("C", "core.controller"),
        ("A", "core.accounting"), ("B", "core.budget"),
        ("F", "core.feedback"), ("PS", "core.parallel_sampling"),
        ("T", "data.tasks"),
        ("Tok", "data.tokenizer"))}
    return types.SimpleNamespace(**mods)


JAX, PORT = _pkg("repro"), _pkg("repro_torch")


def _engine(side, weights, aot=False):
    jm, params, m = weights
    if side is JAX:
        return JEngine(jm, params, JServeConfig(**KW))
    return MarginEngine(m, ServeConfig(**KW, aot_warmup=aot), device="cpu")


def _feedback(p, name):
    return {"none": p.F.NoFeedback(), "exec": p.F.ExecutionFeedback(),
            "judge": p.F.LLMJudgeFeedback(seed=0)}[name]


def _router(p, cfg):
    return p.C.SweetSpotController(p.A.CostModel.for_model("nova_micro"),
                                   p.A.LatencyModel.for_model("nova_micro"),
                                   cfg)


def _neutral(p, rounds):
    return p.C.ControllerConfig(max_rounds=rounds, stop_on_stable=False,
                                use_verdict=False, use_vote=False,
                                escalate=False, warm_start=False)


def _record(res):
    """A ReflectionResult as plain values."""
    return {"rounds": [(r.response, dataclasses.asdict(r.usage), r.correct)
                       for r in res.rounds],
            "usage": dataclasses.asdict(res.usage),
            "trace": [d.key() for d in res.trace],
            "stop_reason": res.stop_reason, "retries": res.retries}


def _steps(engine):
    st = engine.stats()
    return {k: st[k] for k in STEP_KEYS}


def _fixed(p, engine, fb):
    """Strategies 3, 1 and 0 rounds, in that order, over two SQL tasks on
    one engine (reflect3 first, on a fresh engine), a backend each as in
    the example."""
    tasks = p.T.make_sql_tasks(2, seed=0)
    out = []
    for rounds in (3, 1, 0):
        backend = p.R.EngineBackend(engine, p.Tok.ByteTokenizer(),
                                    max_new_tokens=MAX_NEW)
        ctrl = p.R.ReflectionController(
            p.B.InferenceStrategy(rounds, feedback=fb),
            feedback=_feedback(p, fb))
        out += [_record(ctrl.run_task(backend, t)) for t in tasks]
    return out


def _check_billing(records):
    """The paper's prompt-caching lever: every reflection round reads the
    conversation so far from the cache, and a third round's fresh input
    is smaller than what it reads."""
    for rec in records:
        for i, (_, usage, _) in enumerate(rec["rounds"]):
            if i >= 1:
                assert usage["cache_read_tokens"] > 0
            if i == 3:
                assert usage["input_tokens"] < usage["cache_read_tokens"]


@pytest.mark.parametrize("fb", ["none", "exec", "judge"])
def test_fixed_loop_matches_jax(fitted, fb):
    jeng = _engine(JAX, fitted)
    want = _fixed(JAX, jeng, fb)
    for aot in (False, True):
        eng = _engine(PORT, fitted, aot)
        got = _fixed(PORT, eng, fb)
        print(f"fixed loop, {fb} feedback, aot_warmup={aot}: smallest "
              f"top-1/top-2 gap sampled {eng.margin:.3e}")
        assert got == want
        assert _steps(eng) == _steps(jeng)
        assert eng.stats()["step_compiles"] == 0
        eng.pool.check()
    assert [len(r["rounds"]) for r in want] == [4, 4, 2, 2, 1, 1]
    _check_billing(want)
    assert _steps(jeng)["verify_steps"] > 0


@pytest.fixture(scope="module")
def routed(fitted):
    """The routed loop on both packages, on one fresh engine each: the
    neutral config (3 rounds, execution feedback) over the two tasks,
    then the default config under an SLO (the port's engine prices no
    SLO, so the controller enforces it alone) over the same tasks, then
    best-of-3 on the first task."""
    out = {}
    for side, p in (("jax", JAX), ("port", PORT)):
        eng = _engine(p, fitted, aot=p is PORT)
        backend = p.R.EngineBackend(eng, p.Tok.ByteTokenizer(),
                                    max_new_tokens=MAX_NEW)
        strategy = p.B.InferenceStrategy(3, feedback="exec")
        neutral = p.R.ReflectionController(
            strategy, feedback=_feedback(p, "exec"),
            router=_router(p, _neutral(p, 3)))
        default = p.R.ReflectionController(
            strategy, feedback=_feedback(p, "exec"),
            router=_router(p, p.C.ControllerConfig(max_rounds=3)))
        slos = [None, p.C.SLO(max_cost_usd=1e-4, max_latency_s=0.5)]
        tasks = p.T.make_sql_tasks(2, seed=0)
        runs = {"neutral": [_record(neutral.run_task(backend, t))
                            for t in tasks],
                "default": [_record(default.run_task(backend, t, slo))
                            for t, slo in zip(tasks, slos)]}
        # best-of-N through the same engine, greedy (temperature sampling
        # cannot share random bits across the two frameworks)
        bon = p.PS.run_best_of_n(eng, p.Tok.ByteTokenizer(), tasks[0], n=3,
                                 temperature=0.0, max_new_tokens=MAX_NEW)
        runs["best_of_n"] = {**bon, "usage": dataclasses.asdict(bon["usage"])}
        out[side] = runs, _steps(eng), eng
    return out


def test_routed_neutral_matches_jax_and_fixed_loop(fitted, routed):
    (want, jsteps, _), (got, steps, eng) = routed["jax"], routed["port"]
    print(f"routed loop: smallest top-1/top-2 gap sampled "
          f"{eng.margin:.3e}")
    assert got["neutral"] == want["neutral"]
    assert steps == jsteps
    assert eng.stats()["step_compiles"] == 0
    # a neutral router is the fixed loop, round for round
    fixed = _fixed(PORT, _engine(PORT, fitted), "exec")[:2]
    for a, b in zip(fixed, got["neutral"]):
        assert a["rounds"] == b["rounds"] and a["usage"] == b["usage"]
        assert [k[0] for k in b["trace"]] == ["reflect"] * 3 + ["stop"]


def test_routed_default_matches_jax(routed):
    (want, _, _), (got, _, _) = routed["jax"], routed["port"]
    assert got["default"] == want["default"]
    for rec in want["default"]:
        assert rec["trace"] and rec["trace"][-1][0] == "stop"
        assert rec["stop_reason"] == "finished"
    _check_billing(want["neutral"] + want["default"])


def test_best_of_n_matches_jax(routed):
    (want, jsteps, _), (got, steps, _) = routed["jax"], routed["port"]
    assert got["best_of_n"] == want["best_of_n"]
    assert steps == jsteps
    assert len(want["best_of_n"]["texts"]) == 3


def test_cascade_matches_jax(fitted):
    """Two tiers on distinct weights; a judge that reports every answer
    INCORRECT and ``stable_delta=1.0`` make each round a stall, so the
    first decision hops to the large tier, whose engine verifies the
    small tier's tokens as its draft."""
    large = _fit(1)
    out = {}
    for side, p in (("jax", JAX), ("port", PORT)):
        tok = p.Tok.ByteTokenizer()
        backend = p.R.CascadeBackend(
            p.R.EngineBackend(_engine(p, fitted, aot=p is PORT), tok,
                              max_new_tokens=MAX_NEW),
            p.R.EngineBackend(_engine(p, large, aot=p is PORT), tok,
                              max_new_tokens=MAX_NEW))
        router = p.C.SweetSpotController(
            p.A.CostModel.for_model("nova_micro"),
            p.A.LatencyModel.for_model("nova_micro"),
            p.C.ControllerConfig(max_rounds=2, stable_delta=1.0,
                                 stop_on_stable=False, use_vote=False,
                                 escalate=False, cascade=True,
                                 cascade_after_stalls=1, warm_start=False),
            tier_pricing={"large": (p.A.CostModel.for_model("sonnet37"),
                                    p.A.LatencyModel.for_model("sonnet37"))})
        ctrl = p.R.ReflectionController(
            p.B.InferenceStrategy(2, feedback="judge"),
            feedback=p.F.LLMJudgeFeedback(judge_accuracy=1.0, seed=0),
            router=router)
        records = [_record(ctrl.run_task(backend, t))
                   for t in p.T.make_sql_tasks(2, seed=0)]
        out[side] = (records, {t: _steps(b.engine)
                            for t, b in backend.tiers.items()},
                  [b.engine for b in backend.tiers.values()])
    (want, jsteps, _), (got, steps, engines) = out["jax"], out["port"]
    print("cascade: smallest top-1/top-2 gap sampled "
          + ", ".join(f"{e.margin:.3e}" for e in engines))
    assert got == want
    assert steps == jsteps
    assert all(e.stats()["step_compiles"] == 0 for e in engines)
    for rec in want:
        assert rec["trace"][0][0] == "escalate_model"
    assert jsteps["large"]["spec_drafted"] > 0


def test_engine_backend_refuses_a_fault_plan(fitted):
    """The backend takes a fault plan now (the port's ``FaultPlan``); a
    rate-0 plan at both backend sites serves as no plan, in the fixed
    loop, like the reference's backend under its own rate-0 plan."""
    from repro.serving.faults import FaultPlan as JPlan
    from repro.serving.faults import FaultSpec as JSpec
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    sites = ("backend.transient", "backend.garbage")
    out = {}
    for side, plan in ((JAX, JPlan([JSpec(s) for s in sites])),
                       (PORT, FaultPlan([FaultSpec(s) for s in sites])),
                       (PORT, None)):
        backend = side.R.EngineBackend(_engine(side, fitted),
                                       side.Tok.ByteTokenizer(),
                                       max_new_tokens=MAX_NEW, faults=plan)
        assert backend.faults is plan
        ctrl = side.R.ReflectionController(side.B.InferenceStrategy(1))
        task = side.T.make_sql_tasks(1, seed=0)[0]
        res = ctrl.run_task(backend, task)
        out.setdefault(side is PORT, []).append(
            [(r.response, dataclasses.asdict(r.usage)) for r in res.rounds])
        assert plan is None or plan.fired_total == 0
    assert out[True][0] == out[True][1] == out[False][0]
