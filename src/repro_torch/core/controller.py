"""Online sweet-spot controller: per-request reflection/budget routing.

The paper's offline result is that the best (reflection depth, thinking
budget) point depends on the domain and the ceilings; this module makes
that decision PER REQUEST, AT SERVE TIME.  After every reflection round a
``SweetSpotController`` policy decides stop / reflect-again /
escalate-budget from cheap marginal-quality signals:

  * answer delta — did the revision actually change the answer?  "First
    Try Matters" (arXiv:2510.08308): most reflection rounds re-emit the
    prior answer, so a stable answer is strong evidence further rounds
    are pure cost;
  * feedback verdict — CORRECT/INCORRECT parsed from core/feedback.py
    provider output (LLM judge, SQL execution);
  * self-consistency vote — agreement of the answers emitted so far
    (core/parallel_sampling.py's majority vote, applied across rounds);

against per-request SLO ceilings (cost USD, deadline seconds) priced by
core/accounting.py's models.  Budget escalation is CONDITIONAL, following
"Increasing the Thinking Budget is Not All You Need" (arXiv:2512.19585):
only a request that is stably wrong — and whose ceilings can fund the
bigger round — gets a higher thinking tier.

With ``cascade=True`` the same stall evidence can instead trigger an
``escalate_model`` hop up the model ladder (small -> large), priced on
the large tier's models with a cold cache; which model answers moves the
quality/cost frontier far more than how long one model thinks, so the
cascade hop is checked BEFORE the thinking-budget hop.  Per-tier pricing
lives in ``tier_pricing`` and the online frontier keys its points by
(strategy, model tier) so warm starts can route a fresh request straight
to the tier whose sweet spot fits its ceilings (``plan_start``).

Completed requests feed an online per-domain Pareto frontier
(core/pareto.py::OnlineFrontier) that warm-starts future routing: once a
domain has enough observations, a frontier whose sweet spot is
``reflect0`` (reflection hurts — e.g. translation in the paper) routes
new requests straight to zero reflections.  The per-strategy running
means are OBSERVATIONAL — a request that stopped at round 1 stopped
because its signals looked good, so "reflect1"'s mean is biased up —
which is why the warm start only extracts the coarse reflect-vs-don't
call, never a depth cap.

The same ``decide`` policy runs under both reflection backends
(core/reflection.py): EngineBackend for live serving and
SimulatedBackend for paper-table reproduction.
"""
from __future__ import annotations

import difflib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core import quality_sim as QS
from repro_torch.core.accounting import CostModel, LatencyModel
from repro_torch.core.pareto import ConfigPoint, OnlineFrontier, sweet_spot
from repro_torch.core.parallel_sampling import majority_vote
from repro_torch.serving.request import DEADLINE_EPS, BudgetTier, TokenUsage

# escalation ladder: each stalled escalation moves one tier up
_NEXT_TIER = {BudgetTier.NONE: BudgetTier.LOW, BudgetTier.LOW: BudgetTier.HIGH}

# model-cascade ladder (small -> large).  A single hop by construction:
# "large" has no successor, so ``escalate_model`` can fire at most once
# per request (pinned by tests/test_engine_fuzz.py).
_NEXT_MODEL = {"small": "large"}


@dataclass(frozen=True)
class SLO:
    """Per-request service-level ceilings (None = unconstrained)."""
    max_cost_usd: Optional[float] = None
    max_latency_s: Optional[float] = None

    def admits(self, cost_usd: float, latency_s: float) -> bool:
        return ((self.max_cost_usd is None
                 or cost_usd <= self.max_cost_usd + 1e-12)
                and (self.max_latency_s is None
                     or latency_s <= self.max_latency_s + DEADLINE_EPS))


@dataclass
class RoundSignals:
    """Cheap marginal-quality evidence available after round ``round_idx``."""
    round_idx: int                   # reflection rounds completed (0 = first answer)
    answer_delta: float = 1.0        # 0 = identical answer to previous round
    verdict: Optional[bool] = None   # feedback verdict on the current answer
    vote_frac: float = 0.0           # self-consistency agreement across rounds
    stalls: int = 0                  # consecutive stable-but-INCORRECT rounds
    tier: BudgetTier = BudgetTier.NONE   # thinking tier the round ran at
    model_tier: str = "small"        # cascade tier the round ran on


@dataclass
class Decision:
    """One routing decision, recorded per completed round."""
    action: str            # "stop" | "reflect" | "escalate" | "escalate_model"
    reason: str
    round_idx: int
    tier: str                        # tier for the NEXT round (reflect/escalate)
    cost_usd: float                  # cumulative spend at decision time
    latency_s: float
    pred_cost_usd: float             # predicted marginal cost of the next round
    pred_latency_s: float
    model_tier: str = "small"        # cascade tier for the NEXT round

    def key(self) -> Tuple:
        """Compact hashable form for trace-equality assertions."""
        return (self.action, self.reason, self.round_idx, self.tier,
                self.model_tier,
                round(self.cost_usd, 10), round(self.latency_s, 7),
                round(self.pred_cost_usd, 10), round(self.pred_latency_s, 7))


# ---------------------------------------------------------------------------
# signal extraction
# ---------------------------------------------------------------------------

_TAG_RE = re.compile(r"(?is)<(answer|SQL|sentiment|translation)>"
                     r"\s*(.*?)\s*</\1>")


def extract_answer(text: str) -> Optional[str]:
    """Last tagged answer in a response, across the task suites' tag
    vocabularies (data/tasks.py).  None when no tag is present."""
    m = _TAG_RE.findall(text or "")
    return m[-1][1].strip() if m else None


def answer_delta(prev: Optional[str], cur: str) -> float:
    """How much the answer moved between consecutive rounds: 0.0 for a
    verbatim-equal extracted answer, else 1 - similarity of the raw
    texts.  A missing previous round is maximal novelty (1.0)."""
    if prev is None:
        return 1.0
    a, b = extract_answer(prev), extract_answer(cur)
    if a is not None and b is not None:
        return 0.0 if a == b else 1.0
    return 1.0 - difflib.SequenceMatcher(None, prev or "", cur or "").ratio()


def verdict_from_feedback(fb: str) -> Optional[bool]:
    """Parse a core/feedback.py provider string into a verdict.  Order
    matters: "INCORRECT" contains "CORRECT"."""
    if not fb:
        return None
    if "INCORRECT" in fb:
        return False
    if "CORRECT" in fb:
        return True
    if "failed with error" in fb or "no <SQL> block" in fb:
        return False
    return None                      # e.g. neutral execution output


def vote_agreement(answers: List[Optional[str]]) -> float:
    """Self-consistency across rounds: fraction of extractable answers
    agreeing with the majority (majority_vote from parallel_sampling —
    the same aggregation best-of-N uses, applied over the round axis)."""
    present = [a for a in answers if a is not None]
    if len(present) < 2:
        return 0.0
    winner = majority_vote(present)
    return sum(1 for a in present if a == winner) / len(present)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Consecutive-failure circuit breaker for one cascade tier.

    closed -> open after ``threshold`` consecutive recorded failures;
    open denies ``allow()`` for ``cooldown`` calls, then half-opens and
    lets probes through; a successful probe closes the breaker (failure
    counter reset), a failed one re-opens it.  Half-open allows every
    caller to probe — the routed loop is sequential per request, so a
    "probe storm" is bounded by request concurrency, and the design can
    never wedge waiting for a probe that was never executed (e.g. one
    denied by the SLO instead of the breaker)."""

    def __init__(self, threshold: int = 3, cooldown: int = 8):
        self.threshold = max(1, threshold)
        self.cooldown = max(1, cooldown)
        self.state = "closed"            # closed | open | half_open
        self.failures = 0                # consecutive failures
        self._denied = 0                 # denials since the breaker opened
        self.stats = {"trips": 0, "denials": 0, "probes": 0, "closes": 0,
                      "failures": 0, "successes": 0}

    def allow(self) -> bool:
        """May the caller route to this tier right now?"""
        if self.state == "closed":
            return True
        if self.state == "open":
            self._denied += 1
            self.stats["denials"] += 1
            if self._denied >= self.cooldown:
                self.state = "half_open"
                self.stats["probes"] += 1
                return True
            return False
        self.stats["probes"] += 1        # half_open: probe
        return True

    def record(self, ok: bool) -> None:
        """Outcome of a round actually executed on this tier."""
        if ok:
            self.stats["successes"] += 1
            if self.state != "closed":
                self.stats["closes"] += 1
            self.state = "closed"
            self.failures = 0
            self._denied = 0
        else:
            self.stats["failures"] += 1
            self.failures += 1
            if self.state == "half_open" or (self.state == "closed"
                                             and self.failures
                                             >= self.threshold):
                self.stats["trips"] += 1
                self.state = "open"
                self._denied = 0


@dataclass
class ControllerConfig:
    max_rounds: int = 3              # hard reflection ceiling per request
    stable_delta: float = 0.05       # answer_delta <= this counts as unchanged
    stop_on_stable: bool = True      # stable answer (no contrary verdict) stops
    use_verdict: bool = True         # trust feedback verdicts
    use_vote: bool = True            # cross-round consensus can stop
    vote_stop_frac: float = 0.67
    escalate: bool = True            # allow conditional budget escalation
    escalate_after_stalls: int = 2   # stable-but-INCORRECT rounds before escalating
    cascade: bool = False            # allow small->large model escalation
    cascade_after_stalls: int = 2    # stalled rounds before a model hop
    # ---- reliability (docs/SERVING.md#reliability) ----------------------
    # Transient-failure retries in the routed engine loop: a round that
    # ends in "error"/"stalled" is retried up to retry_max times with
    # exponential backoff (retry_base_s * 2^attempt, jittered by up to
    # retry_jitter), each delay priced against the request's remaining
    # latency SLO — an unfundable retry degrades instead (best committed
    # round, stop_reason "degraded", never an exception).
    retry_max: int = 2
    retry_base_s: float = 0.5
    retry_jitter: float = 0.25       # uniform multiplicative jitter fraction
    retry_seed: int = 0              # jitter rng seed (deterministic chaos)
    # Circuit breaker on escalation-target tiers: breaker_threshold
    # consecutive failed large-tier rounds trip it open; while open,
    # escalate_model falls back to the small tier with one extra
    # reflection round granted; after breaker_cooldown denials a
    # half-open probe is let through.
    breaker_threshold: int = 3
    breaker_cooldown: int = 8
    warm_start: bool = True          # consult the online frontier for planning
    min_obs: int = 8                 # per-(domain,strategy) observations needed
    # simulated-backend knobs (core/reflection.py::route_simulated):
    sim_judge_accuracy: float = 0.9  # P(simulated judge verdict is truthful)
    escalation_fix_p: float = 0.35   # P(escalated round fixes a wrong answer)
    cascade_fix_p: float = 0.65      # P(a large-tier round fixes a wrong answer)
    # mean thinking tokens an escalated round consumes per tier —
    # snapshotted from quality_sim.THINK_CONSUMED at config construction
    # so the default can never drift from the simulator's calibration
    # (a config built before a recalibration keeps its original values)
    think_tokens: Dict[str, int] = field(
        default_factory=lambda: dict(QS.THINK_CONSUMED))


class SweetSpotController:
    """Serve-time stop/reflect/escalate policy + online per-domain frontier."""

    def __init__(self, cost_model: CostModel, latency_model: LatencyModel,
                 config: Optional[ControllerConfig] = None,
                 tier_pricing: Optional[Dict[str, Tuple[CostModel,
                                                        LatencyModel]]] = None):
        self.cm = cost_model
        self.lm = latency_model
        self.cfg = config or ControllerConfig()
        # cascade pricing: model tier -> (CostModel, LatencyModel).  The
        # "small" tier defaults to the single-tier models above, so a
        # cascade-off controller prices exactly as before.
        self.tier_pricing = dict(tier_pricing or {})
        self.tier_pricing.setdefault("small", (cost_model, latency_model))
        self.frontiers: Dict[str, OnlineFrontier] = {}
        # (domain, model_tier, strategy) -> [n, sum_q, sum_cost, sum_lat]
        self._stats: Dict[Tuple[str, str, str], List[float]] = {}
        self._domain_obs: Dict[str, int] = {}
        # per-tier circuit breakers (escalation targets only); a closed
        # breaker is free — allow() touches no state — so cascade routing
        # without failures is byte-identical to the pre-breaker policy
        self.breakers: Dict[str, CircuitBreaker] = {}

    def _models(self, model_tier: str) -> Tuple[CostModel, LatencyModel]:
        return self.tier_pricing.get(model_tier, (self.cm, self.lm))

    # ---------------- circuit breaking ------------------------------------

    def _breaker(self, model_tier: str) -> CircuitBreaker:
        return self.breakers.setdefault(
            model_tier, CircuitBreaker(self.cfg.breaker_threshold,
                                       self.cfg.breaker_cooldown))

    def record_tier_result(self, model_tier: str, ok: bool) -> None:
        """Feed a round outcome on ``model_tier`` into its breaker.  Only
        escalation-target tiers are tracked: the base tier has no
        fallback, so a breaker there could only deny service."""
        if model_tier in _NEXT_MODEL.values():
            self._breaker(model_tier).record(ok)

    def breaker_stats(self) -> Dict[str, Dict]:
        return {t: {"state": b.state, **b.stats}
                for t, b in self.breakers.items()}

    # ---------------- warm start ------------------------------------------

    def plan_rounds(self, domain: str, slo: Optional[SLO] = None) -> int:
        """Reflection ceiling for a fresh request.

        Cold domain: deterministic round-robin over 0..max_rounds so the
        frontier observes every depth (exploration).  Warm domain: if the
        frontier's sweet spot under this request's ceilings is a
        zero-reflection strategy, reflection does not pay here — route
        straight to 0 rounds; otherwise allow the full ceiling and let
        the per-round signals decide the actual depth (the per-strategy
        means are stop-rule-biased, so only the coarse call is taken)."""
        R = self.cfg.max_rounds
        if not self.cfg.warm_start:
            return R
        n_obs = self._domain_obs.get(domain, 0)
        if n_obs < self.cfg.min_obs * (R + 1):
            return n_obs % (R + 1)
        fr = self.frontiers.get(domain)
        pts = [p for p in fr.points
               if p.meta.get("n", 0) >= self.cfg.min_obs] if fr else []
        best = sweet_spot(pts,
                          slo.max_latency_s if slo else None,
                          slo.max_cost_usd if slo else None)
        if best is None:
            return R
        return 0 if _strategy_rounds(best.strategy) == 0 else R

    def plan_start(self, domain: str,
                   slo: Optional[SLO] = None) -> Tuple[int, str]:
        """(reflection ceiling, starting model tier) for a fresh request.

        The tier choice mirrors ``plan_rounds``' coarse philosophy: cold
        domains (and cascade-off controllers) always start small — the
        cascade's whole premise is that most requests never need the
        large model — and a warm domain starts large only when the
        frontier's sweet spot under this request's ceilings is a
        large-tier point, i.e. observed small-tier strategies cannot
        match it within budget even after escalations."""
        rounds = self.plan_rounds(domain, slo)
        if not (self.cfg.cascade and self.cfg.warm_start):
            return rounds, "small"
        R = self.cfg.max_rounds
        if self._domain_obs.get(domain, 0) < self.cfg.min_obs * (R + 1):
            return rounds, "small"
        fr = self.frontiers.get(domain)
        pts = [p for p in fr.points
               if p.meta.get("n", 0) >= self.cfg.min_obs] if fr else []
        best = sweet_spot(pts,
                          slo.max_latency_s if slo else None,
                          slo.max_cost_usd if slo else None)
        if best is None or best.model not in self.tier_pricing:
            return rounds, "small"
        return rounds, best.model

    # ---------------- per-round policy ------------------------------------

    def decide(self, signals: RoundSignals, slo: Optional[SLO],
               spend: TokenUsage, next_round: TokenUsage,
               planned_rounds: Optional[int] = None, *,
               spent_cost_usd: Optional[float] = None,
               spent_latency_s: Optional[float] = None,
               extra_rounds: int = 0) -> Decision:
        """One stop/reflect/escalate decision after a completed round.

        ``spend`` is the request's cumulative usage; ``next_round`` the
        estimated marginal usage of one more (non-escalated) round, both
        priced at ``signals.model_tier``'s models.  A cascade caller
        whose request already spans two tiers passes the exact priced
        totals via ``spent_cost_usd``/``spent_latency_s`` instead (a
        single TokenUsage cannot carry two prices); single-tier callers
        omit them and get the single-tier pricing unchanged.  The controller
        never STARTS a round it cannot fund: reflect requires spend +
        next_round inside the ceilings, escalate additionally prices the
        tier's mean thinking tokens, and escalate_model prices the next
        round on the LARGE tier's models with a cold cache."""
        cm, lm = self._models(signals.model_tier)
        cost = cm.cost(spend) if spent_cost_usd is None else spent_cost_usd
        lat = lm.latency(spend) if spent_latency_s is None else spent_latency_s
        pred_c = cm.cost(next_round)
        pred_l = lm.latency(next_round)
        cfg = self.cfg

        def mk(action: str, reason: str, tier: BudgetTier) -> Decision:
            return Decision(action, reason, signals.round_idx, tier.value,
                            cost, lat, pred_c, pred_l,
                            model_tier=signals.model_tier)

        # ``extra_rounds`` is the breaker-fallback grant: a request whose
        # escalation was denied by an open breaker gets one round past
        # its plan (the fallback strategy is small tier + one extra
        # reflection), so the cap can exceed max_rounds by that grant
        cap = (cfg.max_rounds if planned_rounds is None
               else min(planned_rounds, cfg.max_rounds)) + extra_rounds
        if signals.round_idx >= cap:
            return mk("stop", "round-cap", signals.tier)
        if slo is not None and not slo.admits(cost + pred_c, lat + pred_l):
            return mk("stop", "slo", signals.tier)

        verdict = signals.verdict if cfg.use_verdict else None
        # ``unchanged`` is the raw signal (drives escalation, matching
        # the caller-side stalls counter); ``stable`` additionally obeys
        # the stop_on_stable switch (drives stopping only)
        unchanged = signals.answer_delta <= cfg.stable_delta
        stable = cfg.stop_on_stable and unchanged
        consensus = (cfg.use_vote
                     and signals.vote_frac >= cfg.vote_stop_frac)

        if verdict is True and signals.round_idx >= 1:
            # a confirmed answer makes further rounds pure cost ("First
            # Try Matters": confirmed-correct answers survive reflection).
            # Round 0 is never accepted on a verdict alone — the paper's
            # round-1 correction mass is too large to forgo on one noisy
            # signal; domains where round 0 IS the sweet spot are routed
            # there by the warm-start plan (cap 0), not by the verdict.
            return mk("stop", "verdict-correct", signals.tier)
        if verdict is not False and stable and signals.round_idx >= 1:
            return mk("stop", "stable", signals.tier)
        if verdict is not False and consensus and signals.round_idx >= 1:
            return mk("stop", "consensus", signals.tier)

        if (cfg.cascade and verdict is False and unchanged
                and signals.stalls >= cfg.cascade_after_stalls
                and signals.model_tier in _NEXT_MODEL
                and _NEXT_MODEL[signals.model_tier] in self.tier_pricing):
            # stably wrong on the small model: more of the same thinking
            # is unlikely to help ("Increasing the Thinking Budget is Not
            # All You Need") — hand the request to the large tier if the
            # ceilings can fund it.  The large engine starts with a COLD
            # cache, so every token the small tier would have re-read
            # from cache is priced as fresh input (and a fresh write).
            nxt_model = _NEXT_MODEL[signals.model_tier]
            ncm, nlm = self.tier_pricing[nxt_model]
            esc = TokenUsage(
                input_tokens=(next_round.input_tokens
                              + next_round.cache_read_tokens),
                cache_read_tokens=0,
                cache_write_tokens=(next_round.cache_write_tokens
                                    + next_round.cache_read_tokens),
                output_tokens=next_round.output_tokens)
            esc_c, esc_l = ncm.cost(esc), nlm.latency(esc)
            if slo is None or slo.admits(cost + esc_c, lat + esc_l):
                # breaker check comes AFTER the SLO admits, so a denial
                # here always means "tier is sick", and a granted
                # half-open probe is always actually executed (the loop
                # records its outcome, re-opening or closing the breaker)
                if not self._breaker(nxt_model).allow():
                    return mk("reflect", "breaker-fallback", signals.tier)
                return Decision("escalate_model", "stalled-wrong-model",
                                signals.round_idx, signals.tier.value,
                                cost, lat, esc_c, esc_l,
                                model_tier=nxt_model)

        if (cfg.escalate and verdict is False and unchanged
                and signals.stalls >= cfg.escalate_after_stalls
                and signals.tier in _NEXT_TIER):
            nxt = _NEXT_TIER[signals.tier]
            # next_round already reflects the CURRENT tier's thinking
            # consumption (it is the last round's usage / the simulator's
            # prediction at the current tier), so price only the tier
            # DELTA on top — else a LOW->HIGH escalation is denied under
            # ceilings that could in fact fund it
            think = max(0, cfg.think_tokens.get(nxt.value, 0)
                        - cfg.think_tokens.get(signals.tier.value, 0))
            esc = TokenUsage(input_tokens=next_round.input_tokens,
                             cache_read_tokens=next_round.cache_read_tokens,
                             cache_write_tokens=next_round.cache_write_tokens,
                             output_tokens=next_round.output_tokens + think)
            esc_c, esc_l = cm.cost(esc), lm.latency(esc)
            if slo is None or slo.admits(cost + esc_c, lat + esc_l):
                return Decision("escalate", "stalled-incorrect",
                                signals.round_idx, nxt.value, cost, lat,
                                esc_c, esc_l,
                                model_tier=signals.model_tier)
        return mk("reflect", "continue", signals.tier)

    # ---------------- online frontier -------------------------------------

    def observe(self, domain: str, rounds_run: int, tier: BudgetTier,
                quality: float, usage: TokenUsage,
                model_tier: str = "small", *,
                cost_usd: Optional[float] = None,
                latency_s: Optional[float] = None) -> None:
        """Fold a completed request into the domain's running stats and
        refresh its strategy point on the online frontier.

        The frontier point is keyed by (domain, strategy) in ``name`` and
        by ``model_tier`` in ``ConfigPoint.model`` — upsert identity is
        (name, model), so small- and large-tier observations of the same
        strategy keep separate running means.  The tier stays OUT of the
        strategy name: ``plan_rounds`` parses rounds via
        ``_strategy_rounds`` and a tier prefix would break it.  A request
        that escalated mid-flight spans two price books; its caller
        passes the exact priced totals via ``cost_usd``/``latency_s``."""
        name = f"reflect{rounds_run}"
        if tier is not BudgetTier.NONE:
            name += f"+think_{tier.value}"
        cm, lm = self._models(model_tier)
        st = self._stats.setdefault((domain, model_tier, name),
                                    [0, 0.0, 0.0, 0.0])
        st[0] += 1
        st[1] += quality
        st[2] += cm.cost(usage) if cost_usd is None else cost_usd
        st[3] += lm.latency(usage) if latency_s is None else latency_s
        self._domain_obs[domain] = self._domain_obs.get(domain, 0) + 1
        fr = self.frontiers.setdefault(domain, OnlineFrontier())
        n = st[0]
        fr.upsert(ConfigPoint(
            name=f"{domain}@{name}", model=model_tier, strategy=name,
            accuracy=st[1] / n, latency_s=st[3] / n, cost_usd=st[2] / n,
            meta={"n": n}))


def _strategy_rounds(strategy: str) -> int:
    m = re.match(r"reflect(\d+)", strategy)
    return int(m.group(1)) if m else 0


def trace_key(decisions: List[Decision]) -> Tuple:
    """Hashable per-request decision trace (determinism assertions)."""
    return tuple(d.key() for d in decisions)
