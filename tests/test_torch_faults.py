"""The port's reliability layer against the JAX engine's, under the same
fault plans.

Both engines serve the same requests on the same weights — the JAX
package's ``quick_fit_ramp`` fixture, bridged into the port — each with
its own package's ``FaultPlan`` built from one schedule (same specs, same
seed, a ``VirtualClock`` where time matters), so the two plans fire at
the same opportunities only if both engines ask in the same order:

* the stall detector reaping a row stuck by ``engine.stuck``;
* deadline timeouts on a virtual clock, from a plan or passed as
  ``clock=`` (the submission is stamped on that clock);
* NaN / inf logits quarantined and replayed (bit-identical to a clean
  run), and quarantine exhausted (``error``);
* a crash mid-run, paged and ring, speculation on and off, and on the
  falcon-mamba smoke model;
* a rate-0 plan with every option on, against no plan;
* SLO rejection at admission (``slo_price_model``);
* a hostile plan over every engine site at once;
* ``EngineBackend``'s transient and garbage faults, and the routed loop
  with the engine's SLO backstop.

Token streams, stop reasons, ``TokenUsage``, decision traces (floats
exact), ``model_steps``, ``plan.stats``, ``pool.check()`` and used pages
must be equal.  ``corrupt_logits`` on a torch tensor is held to the
reference's on a jax array, and the sampler's guard to the reference's
draw on non-finite rows.
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
from repro.serving import faults as JF
from repro.serving import sampler as jsampler
from repro.serving.engine import Engine as JEngine
from repro.serving.request import DEADLINE_EPS
from repro.serving.request import Request as JRequest
from repro.train.quick_fit import quick_fit_ramp, ramp_prompt
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.serving import faults as F
from repro_torch.serving import sampler
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request

ALL_SITES = ("engine.crash", "engine.latency", "engine.logits",
             "engine.stuck", "backend.transient", "backend.garbage")
BASE = dict(max_batch=2, max_seq=128, page_size=8)


def _fit(arch, steps):
    jm = jbuild(jsmoke(arch).replace(dtype="float32"))
    params = quick_fit_ramp(jm, jm.init(jax.random.PRNGKey(0)), steps=steps,
                            max_steps=steps)
    m = build_model(get_smoke_config(arch).replace(dtype="float32"))
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


@pytest.fixture(scope="module")
def fitted():
    """reflect_demo_100m's smoke model on fitted weights: greedy streams
    with real top-2 gaps, so token-for-token parity means something."""
    return _fit("reflect_demo_100m", 60)


def _plans(specs, seed=0, tick=None):
    """One schedule as a plan of each package: (JAX plan, port plan)."""
    out = []
    for mod in (JF, F):
        clock = None if tick is None else mod.VirtualClock(tick_s=tick)
        out.append(mod.FaultPlan([mod.FaultSpec(**s) for s in specs],
                                 seed=seed, clock=clock))
    return out


def _serve(eng, request_cls, prompts, max_new, rounds=1, per_request=()):
    """``rounds`` reflection rounds of ``prompts`` (each round's prompt is
    the last plus its output and [99, 98]); ``per_request`` gives request
    keyword arguments by index.  Returns every round's requests."""
    convos = [list(p) for p in prompts]
    out = []
    for _ in range(rounds):
        reqs = [request_cls(prompt=list(c), max_new_tokens=max_new,
                            eos_id=None,
                            **(per_request[i] if i < len(per_request)
                               else {}))
                for i, c in enumerate(convos)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
        out += reqs
    return out


def _fingerprint(eng, reqs, plan):
    """What must be equal across the packages, as plain values."""
    if eng.paged:
        eng.pool.check()
    return {"outputs": [list(r.output) for r in reqs],
            "stops": [r.stop_reason for r in reqs],
            "errors": [r.error for r in reqs],
            "usage": [dataclasses.asdict(r.usage) for r in reqs],
            "traces": [list(r.decision_trace) for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "nan_retries": [r.nan_retries for r in reqs],
            "steps": dict(eng.model_steps),
            "plan": None if plan is None else dict(plan.stats),
            "pages": eng.pool.used_pages if eng.paged else None}


def _both(weights, kw, prompts, max_new, specs=None, tick=None, seed=0,
          rounds=1, per_request=()):
    """The same serve on the JAX engine and the port's, each under its
    package's copy of one plan (none when ``specs`` is None); the two
    fingerprints must be equal.  Returns the port's and its engine."""
    jm, params, m = weights
    jplan, plan = (_plans(specs, seed, tick) if specs is not None
                   else (None, None))
    jeng = JEngine(jm, params, JServeConfig(**kw), faults=jplan)
    want = _fingerprint(jeng, _serve(jeng, JRequest, prompts, max_new,
                                     rounds, per_request), jplan)
    eng = Engine(m, ServeConfig(**kw), device="cpu", faults=plan)
    got = _fingerprint(eng, _serve(eng, Request, prompts, max_new, rounds,
                                   per_request), plan)
    assert got == want
    assert set(eng.model_steps) == set(jeng.model_steps)
    return got, eng


PROMPTS = [ramp_prompt(10, 21), ramp_prompt(40, 16)]


# ------------------------------------------------------- the stall detector

def test_stall_detector_matches_jax(fitted):
    """A stuck decode row finalizes "stalled" after stall_limit steps
    without progress; its batchmate is unaffected."""
    got, _ = _both(fitted, dict(BASE, stall_limit=6), PROMPTS, 8,
                   [dict(site="engine.stuck", rate=1.0, start=4,
                         max_fires=1)])
    assert sorted(got["stops"]) == ["max_tokens", "stalled"]
    assert got["steps"]["stuck_rows"] == 1 and got["steps"]["stalls"] == 1
    stuck = got["stops"].index("stalled")
    assert {"action": "fault", "kind": "stuck"} in got["traces"][stuck]


# ---------------------------------------------------------------- deadlines

def test_deadline_timeout_matches_jax(fitted):
    """max_latency_s elapsing mid-decode on the plan's virtual clock (a
    rate-0 plan: the clock is its only active piece) stops the request
    with "timeout", its partial output billed as committed."""
    got, eng = _both(fitted, dict(BASE, prefix_cache=False,
                                  enforce_deadlines=True),
                     PROMPTS, 16, [dict(site=s) for s in ALL_SITES],
                     tick=0.5, per_request=[dict(max_latency_s=2.0)])
    assert got["stops"] == ["timeout", "max_tokens"]
    assert 0 < len(got["outputs"][0]) < 16
    assert got["usage"][0]["output_tokens"] == len(got["outputs"][0])
    assert got["steps"]["timeouts"] == 1 and got["pages"] == 0


def test_deadline_clock_stamps_submission(fitted):
    """With ``clock=`` the submission is stamped on that clock, as the
    reference stamps it: inside the admission epsilon past the deadline
    the request runs on, just past it both engines reap it."""
    jm, params, m = fitted
    kw = dict(BASE, prefix_cache=False, enforce_deadlines=True)
    out = []
    for req_cls, clk in ((JRequest, JF.VirtualClock()),
                         (Request, F.VirtualClock())):
        eng = (JEngine(jm, params, JServeConfig(**kw), clock=clk)
               if req_cls is JRequest else
               Engine(m, ServeConfig(**kw), device="cpu", clock=clk))
        clk.advance(100.0)
        req = req_cls(prompt=ramp_prompt(3, 16), max_new_tokens=32,
                      eos_id=None, max_latency_s=1.0)
        eng.submit(req)
        assert req.submitted_at == 100.0
        for _ in range(6):
            eng.step()
        assert req.status.value == "decoding"
        clk.advance(1.0 + DEADLINE_EPS / 2)
        eng.step()
        alive = req.stop_reason
        clk.advance(DEADLINE_EPS)
        eng.step()
        eng.pool.check()
        out.append((alive, req.stop_reason, list(req.output),
                    eng.model_steps["timeouts"], eng.pool.used_pages))
    assert out[0] == out[1]
    assert out[1][:2] == (None, "timeout") and out[1][3:] == (1, 0)


# ------------------------------------------------------------ NaN quarantine

@pytest.mark.parametrize("spec,value", [(False, "nan"), (True, "inf")],
                         ids=["plain-nan", "spec-inf"])
def test_nan_quarantine_replay_matches_jax(fitted, spec, value):
    """One non-finite logit row: quarantined, replayed through the
    preemption path, and the result is bit-identical to a clean run,
    bills included."""
    kw = dict(BASE, nan_quarantine=True, nan_retry_limit=2,
              spec_decode=spec, spec_tokens=3)
    clean, _ = _both(fitted, kw, PROMPTS[:1], 8)
    got, _ = _both(fitted, kw, PROMPTS[:1], 8,
                   [dict(site="engine.logits", rate=1.0, start=3,
                         max_fires=1, payload={"value": value})])
    assert got["plan"] == {"engine.logits": 1}
    assert got["steps"]["nan_quarantines"] == 1
    assert got["preemptions"][0] >= 1 and got["stops"] == ["max_tokens"]
    assert got["outputs"] == clean["outputs"]
    assert got["usage"] == clean["usage"]


def test_nan_quarantine_exhaustion_matches_jax(fitted):
    """Non-finite logits at every opportunity exhaust nan_retry_limit and
    finalize with "error"."""
    got, _ = _both(fitted, dict(BASE, nan_quarantine=True,
                                nan_retry_limit=1),
                   PROMPTS[:1], 8, [dict(site="engine.logits", rate=1.0)])
    assert got["stops"] == ["error"] and "non-finite" in got["errors"][0]
    assert got["nan_retries"] == [2]


def test_hot_nan_row_sampled_without_quarantine(fitted):
    """Quarantine off, a non-finite row at every opportunity: greedy rows
    commit the reference's token (the argmax, NaN counting as largest);
    temperature rows sample without error on the CPU, where
    ``torch.multinomial`` refuses a NaN row."""
    spec = [dict(site="engine.logits", rate=1.0, payload={"value": "nan"})]
    got, _ = _both(fitted, dict(BASE, spec_decode=True), PROMPTS, 6, spec)
    assert got["plan"]["engine.logits"] > 0
    assert got["steps"]["nan_quarantines"] == 0
    plan = F.FaultPlan([F.FaultSpec(**s) for s in spec])
    eng = Engine(fitted[2], ServeConfig(**BASE), device="cpu", faults=plan)
    reqs = _serve(eng, Request, PROMPTS, 6,
                  per_request=[dict(temperature=0.7)] * 2)
    assert [r.stop_reason for r in reqs] == ["max_tokens"] * 2
    assert plan.stats["engine.logits"] > 0
    eng.pool.check()


# ------------------------------------------------------------ crash recovery

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_crash_recovery_matches_jax(fitted, paged, spec):
    """A crash mid-run preempts every in-flight row; the replay (prefix
    snapshots and billed watermarks) gives the clean run's streams and
    bills, in both packages."""
    kw = dict(BASE, paged_kv=paged, spec_decode=spec, spec_tokens=3)
    clean, _ = _both(fitted, kw, PROMPTS, 8, rounds=2)
    got, _ = _both(fitted, kw, PROMPTS, 8,
                   [dict(site="engine.crash", rate=1.0, start=5,
                         max_fires=1)], rounds=2)
    assert got["steps"]["crash_recoveries"] == 1
    assert sum(got["preemptions"]) >= 1
    assert got["outputs"] == clean["outputs"]
    assert got["usage"] == clean["usage"]


def test_crash_recovery_falcon_mamba_matches_jax():
    """The same on the falcon-mamba smoke model, whose replay restarts the
    recurrent state from a prefix snapshot or from zero."""
    weights = _fit("falcon_mamba_7b", 40)
    kw = dict(BASE, max_seq=160, prefill_chunk=8)
    clean, _ = _both(weights, kw, PROMPTS, 8, rounds=2)
    got, _ = _both(weights, kw, PROMPTS, 8,
                   [dict(site="engine.crash", rate=1.0, start=4,
                         max_fires=1)], rounds=2)
    assert got["steps"]["crash_recoveries"] == 1
    assert got["outputs"] == clean["outputs"]
    assert got["usage"] == clean["usage"]


# ------------------------------------------------------------ rate-0 plans

def test_rate_zero_plan_equals_no_plan(fitted):
    """A rate-0 plan with every option on serves as the plain engine:
    streams, stop reasons and bills; in the port and in the reference."""
    hardened = dict(BASE, enforce_deadlines=True, nan_quarantine=True,
                    stall_limit=16, spec_decode=True)
    plain, _ = _both(fitted, dict(BASE, spec_decode=True), PROMPTS, 6,
                     rounds=2)
    got, eng = _both(fitted, hardened, PROMPTS, 6,
                     [dict(site=s) for s in ALL_SITES], seed=3, tick=0.01,
                     rounds=2)
    assert got["plan"] == {}
    for key in ("outputs", "stops", "usage", "traces", "pages"):
        assert got[key] == plain[key], key


# ----------------------------------------------------------- SLO admission

def test_slo_rejection_at_admission_matches_jax(fitted):
    """``slo_price_model`` prices each fresh request's predicted tokens
    at admission: a request whose ceiling cannot fund them finalizes
    "slo" without taking a slot, with the prices in its trace."""
    got, eng = _both(fitted, dict(BASE, slo_price_model="nova_micro"),
                     PROMPTS + [ramp_prompt(70, 12)], 6,
                     per_request=[dict(max_cost_usd=1e-12),
                                  dict(max_latency_s=1e-6),
                                  dict(max_cost_usd=1.0,
                                       max_latency_s=60.0)])
    assert got["stops"] == ["slo", "slo", "max_tokens"]
    assert got["steps"]["slo_rejections"] == 2
    assert got["traces"][0][0]["pred_cost_usd"] > 1e-12
    assert eng.cost_model is not None


# ------------------------------------------------------------------- chaos

def test_hostile_plan_matches_jax(fitted):
    """Every engine site at once — NaN and inf logits, a stuck row, a
    crash, latency spikes on the virtual clock — with deadlines, the
    stall detector and quarantine on: every request terminates and both
    packages agree on everything."""
    specs = [dict(site="engine.logits", rate=0.08),
             dict(site="engine.logits", rate=0.05,
                  payload={"value": "inf"}),
             dict(site="engine.stuck", rate=1.0, start=9, max_fires=1),
             dict(site="engine.crash", rate=1.0, start=14, max_fires=1),
             dict(site="engine.latency", rate=0.1,
                  payload={"delay_s": 0.4})]
    kw = dict(max_batch=3, max_seq=160, page_size=8, spec_decode=True,
              spec_tokens=3, enforce_deadlines=True, stall_limit=8,
              nan_quarantine=True, nan_retry_limit=2)
    prompts = [ramp_prompt(10 + 13 * i, 14 + 5 * i) for i in range(4)]
    got, eng = _both(fitted, kw, prompts, 10, specs, seed=7, tick=0.05,
                     rounds=2, per_request=[dict(max_latency_s=3.0), {},
                                            dict(max_latency_s=6.0)])
    print("hostile plan fires", got["plan"], "stops", got["stops"])
    assert set(got["stops"]) <= {"max_tokens", "eos", "budget", "timeout",
                                 "stalled", "error"}
    assert got["steps"]["crash_recoveries"] == 1
    assert got["plan"]["engine.logits"] >= 2
    while eng.prefix_cache.evict_lru():
        pass
    eng.pool.check()
    assert eng.pool.used_pages == 0


# ---------------------------------------------------------- the backend

def _routed(pkg, weights, plan, slo_price_model):
    """reflect3/exec and the routed loop over 2 SQL tasks on one engine
    with ``EngineBackend(faults=plan)``; the engine prices SLOs with the
    router's own book (the routed loop's backstop).  Returns the loop's
    records and the engine's counters."""
    import importlib
    R = importlib.import_module(f"{pkg}.core.reflection")
    C = importlib.import_module(f"{pkg}.core.controller")
    A = importlib.import_module(f"{pkg}.core.accounting")
    B = importlib.import_module(f"{pkg}.core.budget")
    Fb = importlib.import_module(f"{pkg}.core.feedback")
    T = importlib.import_module(f"{pkg}.data.tasks")
    Tok = importlib.import_module(f"{pkg}.data.tokenizer")
    jm, params, m = weights
    kw = dict(max_batch=2, max_seq=1536, page_size=32, spec_decode=True,
              slo_price_model=slo_price_model)
    eng = (JEngine(jm, params, JServeConfig(**kw)) if pkg == "repro"
           else Engine(m, ServeConfig(**kw), device="cpu"))
    backend = R.EngineBackend(eng, Tok.ByteTokenizer(), max_new_tokens=16,
                              faults=plan)
    router = C.SweetSpotController(A.CostModel.for_model("nova_micro"),
                                   A.LatencyModel.for_model("nova_micro"),
                                   C.ControllerConfig(max_rounds=3))
    out = []
    tasks = T.make_sql_tasks(2, seed=0)
    slos = [None, C.SLO(max_latency_s=0.5)]
    for rt in (None, router):
        ctrl = R.ReflectionController(B.InferenceStrategy(3, feedback="exec"),
                                      feedback=Fb.ExecutionFeedback(),
                                      router=rt)
        for task, slo in zip(tasks, slos):
            res = ctrl.run_task(backend, task, slo)
            out.append({"rounds": [(r.response, dataclasses.asdict(r.usage),
                                    r.correct) for r in res.rounds],
                        "trace": [d.key() for d in res.trace],
                        "stop": res.stop_reason, "retries": res.retries,
                        "usage": dataclasses.asdict(res.usage)})
    return out, dict(eng.model_steps), dict(plan.stats)


def test_engine_backend_faults_match_jax(fitted):
    """``EngineBackend(faults=...)``: a transient failure of one request
    of a batch and garbled round texts, through the fixed and the routed
    loop, the engine pricing SLOs with the router's book; the same
    records, retries, bills and counters in both packages."""
    specs = [dict(site="backend.transient", rate=0.3, start=1),
             dict(site="backend.garbage", rate=0.3,
                  payload={"mode": "garbage"})]
    jplan, plan = _plans(specs, seed=4)
    want = _routed("repro", fitted, jplan, "nova_micro")
    got = _routed("repro_torch", fitted, plan, "nova_micro")
    assert got == want
    records, _, stats = got
    assert stats["backend.transient"] > 0 and stats["backend.garbage"] > 0
    assert sum(r["retries"] for r in records) > 0


def test_engine_backend_transient_isolated_per_request(fitted):
    """One injected transient fault fails one request of a complete_many
    batch; the others complete, as in the reference."""
    from repro.core.reflection import EngineBackend as JBackend
    from repro.data.tokenizer import ByteTokenizer as JTok
    from repro_torch.core.reflection import EngineBackend
    from repro_torch.data.tokenizer import ByteTokenizer
    jm, params, m = fitted
    spec = [dict(site="backend.transient", rate=1.0, start=1, max_fires=1)]
    jplan, plan = _plans(spec)
    kw = dict(max_batch=4, max_seq=256, page_size=8)
    convos = [("what is 2+2?", "c0"), ("what is 3+3?", "c1"),
              ("what is 4+4?", "c2")]
    out = []
    for bk in (JBackend(JEngine(jm, params, JServeConfig(**kw)), JTok(),
                        max_new_tokens=6, faults=jplan),
               EngineBackend(Engine(m, ServeConfig(**kw), device="cpu"),
                             ByteTokenizer(), max_new_tokens=6,
                             faults=plan)):
        res = bk.complete_many(convos, _tier(bk))
        out.append(([(t, dataclasses.asdict(u)) for t, u in res],
                    [(r.stop_reason, r.error) for r in bk.last_requests]))
    assert out[0] == out[1]
    stops = out[1][1]
    assert stops[1] == ("error", "injected transient backend fault")
    assert stops[0][0] != "error" and stops[2][0] != "error"


def _tier(backend):
    """BudgetTier.NONE of the backend's own package."""
    import importlib
    pkg = type(backend).__module__.split(".")[0]
    return importlib.import_module(f"{pkg}.serving.request").BudgetTier.NONE


# ------------------------------------------------ the fault plan itself

def test_corrupt_logits_matches_reference():
    """On the same schedule the port's ``corrupt_logits`` writes the same
    value into the same row as the reference's, of a copy (the input is
    untouched), and returns the very object when nothing fires."""
    specs = [dict(site="engine.logits", rate=0.4),
             dict(site="engine.logits", rate=0.4, payload={"value": "inf"})]
    jplan, plan = _plans(specs, seed=11)
    base = np.random.default_rng(0).normal(size=(4, 3, 7)).astype(
        np.float32)
    fired = 0
    for i in range(40):
        rows = [0, 2, 3][: 1 + i % 3] if i % 5 else []
        ja, ta = jnp.asarray(base), torch.tensor(base)
        jout = jplan.corrupt_logits("engine.logits", ja, rows)
        tout = plan.corrupt_logits("engine.logits", ta, rows)
        assert (jout is ja) == (tout is ta)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(ta.numpy(), base)
        fired += tout is not ta
    assert fired > 5 and jplan.stats == plan.stats
    zero = F.FaultPlan([F.FaultSpec("engine.logits")])
    t = torch.zeros(2, 5)
    assert zero.corrupt_logits("engine.logits", t, [0, 1]) is t


def test_guard_draws_the_references_token():
    """The sampler's guard gives a row with NaN or +inf the reference's
    draw — the argmax, NaN counting as largest — for greedy and
    temperature rows, and leaves finite rows bit for bit."""
    rng = np.random.default_rng(1)
    lg = rng.normal(size=(6, 12)).astype(np.float32)
    lg[1] = np.nan
    lg[2] = np.inf
    lg[3, 5] = np.nan
    lg[4, 7] = np.inf
    temps = np.asarray([0.7, 0.7, 0.0, 0.9, 0.5, 0.0], np.float32)
    guarded, finite = sampler.guard(torch.tensor(lg))
    assert finite.tolist() == [True, False, False, False, False, True]
    assert torch.equal(guarded[finite], torch.tensor(lg)[finite])
    got = sampler.sample_batch(guarded, torch.tensor(temps),
                               torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(jsampler.sample_batch(
        jnp.asarray(lg), jax.random.PRNGKey(0), jnp.asarray(temps)))
    np.testing.assert_array_equal(got[~finite.numpy()],
                                  want[~finite.numpy()])
    assert got[1:5].tolist() == [0, 0, 5, 7]


def test_port_plan_api_matches_reference():
    """The copied plan: the same fire schedule, clone replay, one-shot
    schedule and virtual clock as the reference's."""
    specs = [dict(site="engine.logits", rate=0.3),
             dict(site="backend.transient", rate=0.2),
             dict(site="engine.crash", rate=1.0, start=5, max_fires=1),
             dict(site="engine.latency", rate=0.5, max_fires=3,
                  payload={"delay_s": 0.25})]
    jplan, plan = _plans(specs, seed=5, tick=0.1)

    def seq(p):
        out = []
        for _ in range(60):
            p.on_step()
            out.append(tuple(p.fire(s) is not None for s in ALL_SITES))
            out.append(p.corrupt_text("backend.garbage", "hello world"))
            out.append(p.clock())
        return out

    want = seq(jplan)
    assert seq(plan) == want and plan.stats == jplan.stats
    assert seq(plan.clone()) == want
