"""The port's copy of the reflection stack's pure modules (``repro_torch/core``,
``repro_torch/data``, and ``serving/faults.py``, ``serving/trace.py`` and
``serving/fleet.py``) against the JAX package's, on the same inputs.

Each copied module is checked twice: its source must equal the
reference's with ``repro.`` rewritten to ``repro_torch.``, apart from the
intended differences named below line by line; and the two packages'
functions, run on the same seeded inputs, must return equal results.
Results are compared as plain values (dataclasses as dicts, enums as
their values), since the two packages' classes are distinct types.
"""
import dataclasses
import difflib
import enum
import importlib
import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

MODULES = ("data/tokenizer.py", "data/tasks.py", "data/lm_data.py",
           "core/textmetrics.py",
           "core/accounting.py", "core/budget.py", "core/quality_sim.py",
           "core/pareto.py", "core/stats.py", "core/parallel_sampling.py",
           "core/feedback.py", "core/controller.py", "core/reflection.py",
           "serving/faults.py", "serving/trace.py", "serving/fleet.py")

# The port's intended differences from its reference: the reference's
# lines (by number) that the port drops or rewords, and the port's lines
# that stand in for them.  accounting.py carries the card's peaks and no
# dollar rate; faults.py's corrupt_logits writes into a copy of a torch
# tensor where the reference sets a jax array; three comments no longer
# name the reference's change history or a product.
INTENDED = {
    "core/accounting.py": (
        [7, 8, 54, 55, 105, 106, 107, 112, 121, 122],
        ["  * roofline_cost — $/step for OUR architectures, derived from "
         "roofline",
         "    terms x a $/card-hour ``rate`` that the caller supplies: "
         "there is no",
         "    measured dollar rate for the card, so none is assumed.",
         "",
         "``roofline_step_seconds`` defaults to the data-sheet peaks of one "
         "NVIDIA",
         "H100 SXM (989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3); on one "
         "card",
         "there is no collective term (``link_bw`` is infinite unless "
         "given).",
         "PAPER_PRICES and PAPER_LATENCY are the paper's Bedrock API "
         "figures, not",
         "hardware numbers.",
         "import math",
         "                          peak_flops: float = 989e12,",
         "                          hbm_bw: float = 3.35e12,",
         "                          link_bw: float = math.inf) -> "
         "Dict[str, float]:",
         '        "collective_s": collective_bytes / link_bw,',
         "def roofline_cost(step_s: float, chips: int, rate: float) -> "
         "float:"]),
    "core/reflection.py": (
        [276, 442],
        ["    large engine as ``Request.external_draft``.  That turns the "
         "engine's",
         "        # directly, preserving float-for-float parity)"]),
    "serving/faults.py": (
        [190, 192, 193],
        ['        val = float("inf" if sp.payload.get("value") == "inf" '
         'else "nan")',
         "        # a copy on the logits' device, as .at[].set makes: a "
         "captured",
         "        # step's logits are its graph's static output",
         "        out = logits.clone()",
         "        out[row] = val",
         "        return out"]),
    "core/controller.py": (
        [387],
        ["        omit them and get the single-tier pricing unchanged.  The "
         "controller"]),
    "core/quality_sim.py": (
        [16],
        ["                   recovery at r3; Sonnet improves; sonnet37-high "
         "best)"]),
}


def both(name):
    """(reference module, port module) for ``core.x`` / ``data.x``."""
    return (importlib.import_module("repro." + name),
            importlib.import_module("repro_torch." + name))


def plain(x):
    """A value of either package as plain Python: dataclasses as dicts
    (with their class name), enums as values, arrays as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


# ------------------------------------------------------------ drift guard

@pytest.mark.parametrize("module", MODULES)
def test_copy_matches_reference(module):
    ref = re.sub(r"\brepro\.", "repro_torch.",
                 (SRC / "repro" / module).read_text()).splitlines()
    port = (SRC / "repro_torch" / module).read_text().splitlines()
    removed, added = [], []
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag != "equal":
            removed += range(i1 + 1, i2 + 1)
            added += port[j1:j2]
    want_removed, want_added = INTENDED.get(module, ([], []))
    assert removed == want_removed and added == want_added, \
        "\n".join(difflib.unified_diff(ref, port, lineterm="", n=0))


def test_accounting_has_the_cards_peaks_and_no_tpu_figure():
    _, acc = both("core.accounting")
    sig = inspect.signature(acc.roofline_step_seconds).parameters
    assert sig["peak_flops"].default == 989e12       # H100 SXM dense bf16
    assert sig["hbm_bw"].default == 3.35e12          # H100 SXM HBM3
    assert sig["link_bw"].default == math.inf        # one card
    t = acc.roofline_step_seconds(1e12, 1e9, 1e9)
    assert t["collective_s"] == 0.0
    rate = inspect.signature(acc.roofline_cost).parameters["rate"]
    assert rate.default is inspect.Parameter.empty
    src = (SRC / "repro_torch/core/accounting.py").read_text()
    for figure in ("TPU", "v5e", "197e12", "819e9", "50e9", "1.20"):
        assert figure not in src, figure
    assert not [n for n in dir(acc) if "TPU" in n.upper()]


# --------------------------------------------------------- data/ modules

def test_tokenizer_matches():
    ref, port = both("data.tokenizer")
    rng = np.random.default_rng(0)
    texts = ["", "hello world", "héllo — ünïcode ✓",
             bytes(rng.integers(32, 127, 200).tolist()).decode()]
    for t in texts:
        for bos, eos in ((True, False), (False, True), (True, True)):
            ids = ref.ByteTokenizer().encode(t, bos=bos, eos=eos)
            assert port.ByteTokenizer().encode(t, bos=bos, eos=eos) == ids
            assert port.ByteTokenizer().decode(ids) == \
                ref.ByteTokenizer().decode(ids)
    junk = rng.integers(0, 600, 300).tolist()
    assert port.ByteTokenizer().decode(junk) == \
        ref.ByteTokenizer().decode(junk)
    assert (port.VOCAB_SIZE, port.PAD, port.BOS, port.EOS) == \
        (ref.VOCAB_SIZE, ref.PAD, ref.BOS, ref.EOS) == (259, 0, 1, 2)


def _responses(task, rng):
    """Right, wrong, malformed and tag-free answers to one task."""
    gold = {"math500": lambda t: f"<answer>{t.answer}</answer>",
            "spider": lambda t: f"<SQL>{t.gold_query}</SQL>",
            "imdb": lambda t: f"<sentiment>{t.label}</sentiment>",
            "flores": lambda t: f"<translation>{t.reference}</translation>"
            }[task.domain](task)
    noise = bytes(rng.integers(32, 127, 40).tolist()).decode()
    return [gold, "reasoning... " + gold, gold.replace(">", "> 1", 1),
            "<answer>7</answer>", "<SQL>SELECT id FROM orchestra</SQL>",
            "<SQL>DROP TABLE x</SQL>", "<sentiment>positive</sentiment>",
            "<translation>za miro</translation>", noise, ""]


@pytest.mark.parametrize("domain", ["math500", "spider", "imdb", "flores"])
def test_tasks_and_verifiers_match(domain):
    ref, port = both("data.tasks")
    rng = np.random.default_rng(1)
    for seed in (0, 7):
        rt = ref.make_tasks(domain, 6, seed=seed)
        pt = port.make_tasks(domain, 6, seed=seed)
        assert [t.prompt() for t in pt] == [t.prompt() for t in rt]
        assert plain(pt) == plain(rt)
        for a, b in zip(rt, pt):
            for resp in _responses(a, rng):
                assert b.verify(resp) == a.verify(resp), resp
                if domain == "flores":
                    assert b.score(resp) == a.score(resp)


def test_run_sql_matches():
    ref, port = both("data.tasks")
    tables = ref.make_sql_tasks(1, seed=3)[0].tables
    queries = ["SELECT * FROM orchestra", "SELECT COUNT(*) FROM orchestra",
               "SELECT id, size FROM orchestra WHERE year > 1950 "
               "ORDER BY size DESC LIMIT 3",
               "SELECT id FROM orchestra WHERE size <= 60.5",
               "SELECT id FROM orchestra WHERE year != 1999;",
               "SELECT nope FROM orchestra", "SELECT id FROM nowhere",
               "SELECT id FROM orchestra ORDER BY nope",
               "SELECT id FROM orchestra WHERE nope = 1", "DELETE FROM x"]
    kinds = []
    for q in queries:
        try:
            want = ("rows", ref.run_sql(q, tables))
        except ValueError as e:
            want = ("error", str(e))
        try:
            got = ("rows", port.run_sql(q, tables))
        except ValueError as e:
            got = ("error", str(e))
        assert got == want, q
        kinds.append(want[0])
    assert kinds.count("rows") == 5 and kinds.count("error") == 5


# --------------------------------------------------------- pure metrics

def _sentences(rng, n, words=("za", "miro", "worf", "dun", "vel", "po",
                              "tal", "arbo", "joy", "un", "et", "domu")):
    return [" ".join(rng.choice(words, rng.integers(0, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("fn", ["bleu", "meteor_lite"])
def test_textmetrics_match(fn):
    ref, port = both("core.textmetrics")
    rng = np.random.default_rng(2)
    cands, refs = _sentences(rng, 60), _sentences(rng, 60)
    refs[:10] = cands[:10]                       # exact matches score 1
    got = [getattr(port, fn)(c, r) for c, r in zip(cands, refs)]
    want = [getattr(ref, fn)(c, r) for c, r in zip(cands, refs)]
    assert got == want
    assert max(want) > 0.99 and min(want) < 0.5


def test_stats_match():
    ref, port = both("core.stats")
    rng = np.random.default_rng(3)
    for a, b, x in rng.uniform(0.1, 8, (20, 3)):
        x = x / 8
        assert port.betainc(a, b, x) == ref.betainc(a, b, x)
        assert port.gammainc_q(a, b) == ref.gammainc_q(a, b)
        assert port.t_sf(a - 4, b) == ref.t_sf(a - 4, b)
        assert port.norm_ppf(x) == ref.norm_ppf(x)
    correct = rng.random(200) < 0.6
    assert np.array_equal(port.bootstrap_scores(correct, 50, seed=4),
                          ref.bootstrap_scores(correct, 50, seed=4))
    xa, xb = rng.normal(0, 1, 30), rng.normal(0.4, 2, 45)
    assert port.welch_t_test(xa, xb) == ref.welch_t_test(xa, xb)
    assert port.welch_t_test([1, 1, 1], [1, 1]) == \
        ref.welch_t_test([1, 1, 1], [1, 1])
    scores = np.round(rng.random((25, 6)), 1)      # ties on purpose
    assert port.friedman_test(scores) == ref.friedman_test(scores)
    assert port.nemenyi_significant_fraction(scores) == \
        ref.nemenyi_significant_fraction(scores)
    for k, n in ((3, 10), (10, 100), (40, 400)):
        assert port.nemenyi_critical_difference(k, n) == \
            ref.nemenyi_critical_difference(k, n)


def _points(mod, rng, n):
    return [mod.ConfigPoint(f"p{i}", ["m0", "m1"][i % 2],
                            f"reflect{i % 4}",
                            float(np.round(rng.uniform(0, 100), 0)),
                            float(np.round(rng.uniform(1, 30), 1)),
                            float(rng.uniform(1e-5, 1e-2)))
            for i in range(n)]


def test_pareto_match():
    ref, port = both("core.pareto")
    rng = np.random.default_rng(5)
    state = rng.bit_generator.state
    rp = _points(ref, rng, 80)
    rng.bit_generator.state = state
    pp = _points(port, rng, 80)
    for objs in (("accuracy", "latency_s"), ("accuracy", "cost_usd"),
                 ("accuracy", "latency_s", "cost_usd")):
        assert plain(port.pareto_frontier(pp, objs)) == \
            plain(ref.pareto_frontier(rp, objs))
    for lat, cost in ((None, None), (10.0, None), (None, 3e-3), (5.0, 1e-3),
                      (0.5, None)):
        assert plain(port.sweet_spot(pp, lat, cost)) == \
            plain(ref.sweet_spot(rp, lat, cost))
    rf, pf = ref.OnlineFrontier(), port.OnlineFrontier()
    for a, b in zip(rp, pp):
        if a.name[-1] in "05":
            assert pf.upsert(b) == rf.upsert(a)
        else:
            assert pf.insert(b) == rf.insert(a)
    assert len(pf) == len(rf) > 1
    assert plain(pf.points) == plain(rf.points)
    for lat, cost in ((None, None), (8.0, 2e-3)):
        assert plain(pf.sweet_spot(lat, cost)) == \
            plain(rf.sweet_spot(lat, cost))


def test_quality_sim_and_sampling_match():
    qr, qp = both("core.quality_sim")
    sr, sp = both("core.parallel_sampling")
    assert plain(qp.QUALITY) == plain(qr.QUALITY)
    assert qp.TOKEN_PROFILE == qr.TOKEN_PROFILE
    for domain in qr.QUALITY:
        for model in qr.QUALITY[domain]:
            for r in (0, 1, 3):
                assert qp.accuracy_at(domain, model, r) == \
                    qr.accuracy_at(domain, model, r)
            tr = qr.simulate_trajectories(domain, model, 50, 3, seed=2)
            tp = qp.simulate_trajectories(domain, model, 50, 3, seed=2)
            assert np.array_equal(tp.correct, tr.correct)
            assert qp.transition_counts(tp) == qr.transition_counts(tr)
            for n in (1, 4, 5):
                assert plain(sp.evaluate_best_of_n(model, domain, n, 40)) == \
                    plain(sr.evaluate_best_of_n(model, domain, n, 40))
    for p in (0.0, 0.3, 0.5, 0.9):
        for n in (1, 2, 5, 8):
            assert sp.majority_accuracy(p, n) == sr.majority_accuracy(p, n)
    votes = [["a", "b", "a"], [None, None], ["x"], [None, "y", "y", "z"]]
    assert [sp.majority_vote(v) for v in votes] == \
        [sr.majority_vote(v) for v in votes]
    for t in ("<answer> 4 </answer> then <answer>5</answer>", "no tags"):
        assert sp.default_extract(t) == sr.default_extract(t)


@pytest.mark.parametrize("model", ["sonnet37", "sonnet35v2", "haiku35",
                                   "nova_premier", "nova_pro", "nova_lite",
                                   "nova_micro", "llama_maverick",
                                   "mistral_large", "mistral_small"])
def test_price_books_match(model):
    ar, ap = both("core.accounting")
    rr, rp = both("serving.request")
    assert set(ap.PAPER_PRICES) == set(ar.PAPER_PRICES)
    assert plain(ap.CostModel.for_model(model)) == \
        plain(ar.CostModel.for_model(model))
    assert plain(ap.LatencyModel.for_model(model)) == \
        plain(ar.LatencyModel.for_model(model))
    rng = np.random.default_rng(6)
    for inp, cr, cw, out in rng.integers(0, 5000, (12, 4)):
        kw = dict(input_tokens=int(inp), cache_read_tokens=int(cr),
                  cache_write_tokens=int(cw), output_tokens=int(out))
        for caching in (True, False):
            assert ap.CostModel.for_model(model).cost(
                rp.TokenUsage(**kw), caching) == \
                ar.CostModel.for_model(model).cost(rr.TokenUsage(**kw),
                                                   caching)
        assert ap.LatencyModel.for_model(model).latency(
            rp.TokenUsage(**kw)) == \
            ar.LatencyModel.for_model(model).latency(rr.TokenUsage(**kw))


def test_roofline_with_explicit_peaks_matches():
    ar, ap = both("core.accounting")
    rng = np.random.default_rng(7)
    for f, b, c in rng.uniform(1e9, 1e13, (10, 3)):
        peaks = (float(rng.uniform(1e13, 1e15)),
                 float(rng.uniform(1e11, 1e13)),
                 float(rng.uniform(1e10, 1e12)))
        t = ar.roofline_step_seconds(f, b, c, *peaks)
        assert ap.roofline_step_seconds(f, b, c, *peaks) == t
        assert ap.roofline_cost(t["step_s"], 4, 2.5) == \
            ar.roofline_cost(t["step_s"], 4, 2.5)


def test_controller_signals_and_breaker_match():
    cr, cp = both("core.controller")
    texts = ["<answer>42</answer>", "x <answer> 42 </answer>",
             "<answer>43</answer>", "<SQL>SELECT 1</SQL>", "abcd efgh",
             "abcd efgi", "", "Judge feedback: CORRECT — fine",
             "Judge feedback: INCORRECT — no",
             "Execution feedback: query failed with error: bad"]
    for a in texts:
        assert cp.extract_answer(a) == cr.extract_answer(a)
        assert cp.verdict_from_feedback(a) == cr.verdict_from_feedback(a)
        for b in [None] + texts:
            assert cp.answer_delta(b, a) == cr.answer_delta(b, a)
    answers = [cr.extract_answer(t) for t in texts]
    for k in range(1, len(answers) + 1):
        assert cp.vote_agreement(answers[:k]) == \
            cr.vote_agreement(answers[:k])
    br, bp = cr.CircuitBreaker(2, 3), cp.CircuitBreaker(2, 3)
    for ok in [False, False, True, False, False, False, True, True] * 2:
        assert bp.allow() == br.allow()
        br.record(ok), bp.record(ok)
        assert plain(vars(bp)) == plain(vars(br))
    br_, bp_ = both("core.budget")
    assert [s.name for s in bp_.standard_strategies()] == \
        [s.name for s in br_.standard_strategies()]


# ------------------------------------------- simulated reflection paths

GRID = [(0, "none"), (1, "none"), (3, "none"), (1, "judge"), (3, "exec")]


@pytest.mark.parametrize("domain", ["math500", "spider", "flores"])
def test_evaluate_strategy_matches(domain):
    rr, rp = both("core.reflection")
    br, bp = both("core.budget")
    qr, _ = both("core.quality_sim")
    models = [m for m in ("nova_micro", "sonnet37") if m in qr.QUALITY[domain]]
    for model in models:
        for rounds, fb in GRID:
            for caching in (True, False):
                want = rr.evaluate_strategy(
                    model, domain, br.InferenceStrategy(rounds, fb), 30,
                    seed=1, prompt_caching=caching)
                got = rp.evaluate_strategy(
                    model, domain, bp.InferenceStrategy(rounds, fb), 30,
                    seed=1, prompt_caching=caching)
                assert got == want
        for tier in ("low", "high"):
            if "think" in qr.QUALITY[domain][model]:
                assert rp.evaluate_strategy(
                    model, domain,
                    bp.InferenceStrategy(0, budget=bp.BudgetTier(tier)),
                    20) == rr.evaluate_strategy(
                    model, domain,
                    br.InferenceStrategy(0, budget=br.BudgetTier(tier)), 20)


def _simulated(pkg, rounds, fb, slos, cascade, routed):
    """One package's fixed or routed simulated loop over 10 seeded
    translation examples (whose wrong answers persist, so a judged
    cascade hops); returns every ReflectionResult and the router's
    frontier."""
    R = importlib.import_module(pkg + ".core.reflection")
    C = importlib.import_module(pkg + ".core.controller")
    A = importlib.import_module(pkg + ".core.accounting")
    B = importlib.import_module(pkg + ".core.budget")
    F = importlib.import_module(pkg + ".core.feedback")
    Q = importlib.import_module(pkg + ".core.quality_sim")
    traj = Q.simulate_trajectories("flores", "nova_micro", 10, 3, seed=4)
    small = R.SimulatedBackend("nova_micro", "flores", seed=3)
    sim = (R.SimulatedCascade(small, R.SimulatedBackend(
        "sonnet37", "flores", seed=3)) if cascade else small)
    router = None
    if routed:
        pricing = {"large": (A.CostModel.for_model("sonnet37"),
                             A.LatencyModel.for_model("sonnet37"))}
        router = C.SweetSpotController(
            A.CostModel.for_model("nova_micro"),
            A.LatencyModel.for_model("nova_micro"),
            C.ControllerConfig(cascade=cascade, cascade_after_stalls=1,
                               min_obs=3),
            tier_pricing=pricing if cascade else None)
    ctrl = R.ReflectionController(
        B.InferenceStrategy(rounds, feedback=fb),
        feedback=F.get_provider(fb, **({"seed": 0} if fb == "judge"
                                       else {})),
        router=router)
    rng = np.random.default_rng(8)
    out = []
    for i in range(10):
        slo = (C.SLO(*slos[i]) if slos is not None else None)
        if routed:
            out.append(ctrl.route_simulated(sim, traj.correct[i], slo, rng))
        else:
            out.append(ctrl.run_simulated(sim, traj.correct[i][:rounds + 1]))
    frontier = (plain(router.frontiers["flores"].points)
                if routed and "flores" in router.frontiers else None)
    return plain(out), frontier


@pytest.mark.parametrize("routed,cascade,slo", [
    (False, False, False), (True, False, False), (True, False, True),
    (True, True, False), (True, True, True)],
    ids=["fixed", "routed", "routed-slo", "cascade", "cascade-slo"])
@pytest.mark.parametrize("rounds,fb", [(1, "none"), (3, "judge")])
def test_simulated_loops_match(routed, cascade, slo, rounds, fb):
    rng = np.random.default_rng(9)
    slos = ([(float(3e-4 * rng.uniform(0.2, 4)),
              float(10.0 * rng.uniform(0.2, 4))) for _ in range(10)]
            if slo else None)
    want = _simulated("repro", rounds, fb, slos, cascade, routed)
    got = _simulated("repro_torch", rounds, fb, slos, cascade, routed)
    assert got == want
    results = want[0]
    assert len(results) == 10
    if routed:
        actions = [d[1]["action"] for r in results for d in r[1]["trace"]]
        assert all(r[1]["trace"] for r in results)
        # a judged cascade hops to the large tier unless the SLO cannot
        # fund the large tier's cold round
        assert ("escalate_model" in actions) == (cascade and fb == "judge"
                                                 and not slo)
