"""Self-reflection controller (paper §3.2, Appendix A.2).

Drives multi-round reflect-and-revise conversations through a backend:

  * EngineBackend    — the real serving engine; rounds share a
    conversation_id so the prefix cache makes round r+1's prefill cost
    proportional to the suffix (reflection instruction + feedback);
  * SimulatedBackend — token/quality simulation calibrated to the paper
    (core/quality_sim.py) driving the SAME controller + accounting path,
    used to reproduce the paper's tables offline.

With a ``router`` (core/controller.py::SweetSpotController) attached,
the fixed ``reflection_rounds`` loop is replaced by per-round
stop/reflect/escalate decisions against per-request SLO ceilings — the
SAME ``decide`` policy for both backends, so paper-table reproduction
and live serving share one decision path.  Without a router the original
fixed loop runs unchanged (bit-parity pinned by tests).

The reflection prompt template mirrors Appendix A.2 verbatim.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import quality_sim as QS
from repro_torch.core.accounting import CostModel, LatencyModel
from repro_torch.core.budget import InferenceStrategy
from repro_torch.core.controller import (Decision, RoundSignals, SLO,
                                   SweetSpotController, answer_delta,
                                   extract_answer, verdict_from_feedback,
                                   vote_agreement)
from repro_torch.core.feedback import FeedbackProvider, NoFeedback
from repro_torch.serving.request import BudgetTier, Request, Status, TokenUsage

REFLECT_TEMPLATE = ("Please reiterate your answer by thinking step by step, "
                    "making sure to state your answer at the end of the "
                    "response. {feedback} As a reminder, the original "
                    "question is {question}")


@dataclass
class RoundRecord:
    response: str
    usage: TokenUsage
    correct: Optional[bool] = None
    score: Optional[float] = None


@dataclass
class ReflectionResult:
    rounds: List[RoundRecord]
    usage: TokenUsage = field(default_factory=TokenUsage)
    # routed path only: one controller Decision per completed round
    trace: List[Decision] = field(default_factory=list)
    # How the request terminated (docs/SERVING.md#reliability):
    #   "finished" — normal stop decision or round cap;
    #   "slo"      — the engine refused to fund a round;
    #   "timeout"  — the deadline elapsed mid-round (partial round kept);
    #   "degraded" — retries exhausted/unfundable, best committed round
    #                returned;
    #   "error"    — failed before any round committed.
    # Failed rounds' billed tokens are absorbed into ``usage`` (spend is
    # monotone and honest), so under faults ``usage`` can exceed the sum
    # of the committed rounds' usages.
    stop_reason: str = "finished"
    retries: int = 0                 # transient-fault retries performed

    @property
    def final(self) -> RoundRecord:
        return self.rounds[-1]

    @property
    def rounds_run(self) -> int:
        """Reflection rounds actually executed (round 0 excluded)."""
        return max(0, len(self.rounds) - 1)


class EngineBackend:
    """Runs reflection through the real serving engine.

    Uses the engine's async submit/poll API: requests are enqueued
    non-blocking and the backend cooperatively ticks the scheduler until
    they finish, so many conversations' rounds can share the engine's
    chunked-prefill mixed steps instead of serializing whole prefills.
    """

    def __init__(self, engine, tokenizer, max_new_tokens: int = 64,
                 faults=None):
        self.engine = engine
        self.tok = tokenizer
        self.max_new_tokens = max_new_tokens
        # Backend-level fault injection (serving/faults.py): the
        # "backend.transient" and "backend.garbage" sites.  Independent
        # of any plan installed on the engine itself; None (default) and
        # rate-0 plans are byte-identical to the uninstrumented backend.
        self.faults = faults
        # per-conversation raw draft tokens from prior rounds, fed to the
        # engine's n-gram speculator (Request.spec_context): round r+1
        # mostly re-emits round r's answer ("First Try Matters"), so the
        # prior drafts are the highest-yield lookup corpus — and unlike
        # the quoted text in the prompt, the RAW token stream survives
        # truncation and lossy detokenization.  Purely advisory: the
        # verify step accepts only model-confirmed tokens.  LRU-bounded
        # (latest round per conversation, oldest conversations evicted)
        # so a long-lived backend never retains every conversation ever
        # — mirroring the engine's own request-registry pruning.
        self._prior_drafts: "OrderedDict[str, List[int]]" = OrderedDict()
        self._prior_drafts_max = 128
        # requests of the most recent complete_many (complete_routed reads
        # stop_reason / decision_trace off them)
        self.last_requests: List[Request] = []

    def _request(self, conversation: str, conversation_id: str,
                 budget: BudgetTier,
                 ceilings: Tuple[Optional[float], Optional[float]]
                 = (None, None),
                 external_draft: Optional[List[int]] = None) -> Request:
        return Request(prompt=self.tok.encode(conversation),
                       max_new_tokens=self.max_new_tokens,
                       eos_id=self.tok.eos_id, budget=budget,
                       conversation_id=conversation_id,
                       max_cost_usd=ceilings[0], max_latency_s=ceilings[1],
                       spec_context=list(
                           self._prior_drafts.get(conversation_id, [])),
                       external_draft=external_draft)

    def _decode_output(self, req: Request) -> str:
        out = req.output
        if out and out[-1] == self.tok.eos_id:
            out = out[:-1]
        return self.tok.decode(out)

    def complete(self, conversation: str, conversation_id: str,
                 budget: BudgetTier) -> Tuple[str, TokenUsage]:
        text, usage = self.complete_many([(conversation, conversation_id)],
                                         budget)[0]
        return text, usage

    def complete_routed(self, conversation: str, conversation_id: str,
                        budget: BudgetTier,
                        ceilings: Tuple[Optional[float], Optional[float]]
                        = (None, None),
                        external_draft: Optional[List[int]] = None
                        ) -> Tuple[str, TokenUsage, Request]:
        """One round with per-request SLO ceilings attached; returns the
        Request too so the routed loop can read stop_reason (the engine's
        SLO admission finalizes unfundable rounds) and append its
        decisions to the request's trace.  ``external_draft`` carries the
        cascade's cross-model handoff: the other tier's committed tokens,
        drafted positionally by this engine's verify step."""
        out = self.complete_many([(conversation, conversation_id)], budget,
                                 ceilings=ceilings,
                                 external_draft=external_draft)
        text, usage = out[0]
        return text, usage, self.last_requests[0]

    def complete_many(self, conversations: List[Tuple[str, str]],
                      budget: BudgetTier,
                      ceilings: Tuple[Optional[float], Optional[float]]
                      = (None, None),
                      external_draft: Optional[List[int]] = None
                      ) -> List[Tuple[str, TokenUsage]]:
        """Submit a batch of (conversation, conversation_id) and poll the
        engine until all are done — their prefill chunks and decode steps
        interleave inside the engine's mixed steps.

        Per-request error isolation: a request the engine rejects at
        submit (empty prompt, unfundable budget) or that hits an injected
        backend fault finishes with stop_reason "error" — the rest of the
        batch completes normally; this method never raises for a single
        bad request."""
        reqs = [self._request(c, cid, budget, ceilings, external_draft)
                for c, cid in conversations]
        self.last_requests = reqs
        for r in reqs:
            if (self.faults is not None
                    and self.faults.fire("backend.transient") is not None):
                r.status = Status.DONE
                r.stop_reason = "error"
                r.error = "injected transient backend fault"
                continue
            self.engine.submit(r)
        pending = set(r.uid for r in reqs)
        while pending:
            self.engine.poll()
            done = {r.uid for r in reqs if r.status is Status.DONE}
            pending -= done
            if pending and not any(uid in self.engine.requests
                                   for uid in pending):
                # the engine no longer tracks them and they never
                # finished: surface as per-request errors, never hang
                for r in reqs:
                    if r.uid in pending:
                        r.status = Status.DONE
                        r.stop_reason = "error"
                        r.error = "request lost by engine"
                pending.clear()
        for (_, cid), r in zip(conversations, reqs):
            # remember this round's raw draft for the next round's
            # speculator (latest round per conversation; LRU-evicted).
            # An SLO-finalized request has no output — keep the prior
            # round's draft instead of clobbering it with nothing.
            if r.conversation_id is not None and r.output:
                self._prior_drafts[cid] = list(r.output)
                self._prior_drafts.move_to_end(cid)
                while len(self._prior_drafts) > self._prior_drafts_max:
                    self._prior_drafts.popitem(last=False)
        out = []
        for r in reqs:
            text = self._decode_output(r)
            if self.faults is not None:
                # "backend.garbage": a corrupted round output is absorbed
                # as a bad round by the reflection loop, never an error
                text = self.faults.corrupt_text("backend.garbage", text)
            out.append((text, r.usage))
        return out


class SimulatedBackend:
    """Token accounting + calibrated correctness, no model execution.

    Correctness per round follows core.quality_sim trajectories; token
    counts follow the paper's per-domain profiles; prompt caching follows
    the engine's semantics (round r+1 reads the whole prior conversation
    from cache, pays fresh input only for the reflection suffix).
    """

    def __init__(self, model_name: str, domain: str, seed: int = 0,
                 prompt_caching: bool = True):
        self.model_name = model_name
        self.domain = domain
        self.prompt_caching = prompt_caching
        self.rng = np.random.default_rng(seed)
        self.profile = QS.TOKEN_PROFILE[domain]
        self._convo_cached: Dict[str, int] = {}

    def predict(self, conversation_tokens: int, conversation_id: str,
                thinking_tokens: int = 0) -> TokenUsage:
        """Exact usage the next ``complete`` call would bill, WITHOUT
        committing it — the router's next-round cost estimate (which is
        why simulated routing can guarantee hard SLO compliance)."""
        cached = (self._convo_cached.get(conversation_id, 0)
                  if self.prompt_caching else 0)
        cached = min(cached, conversation_tokens)
        fresh = conversation_tokens - cached
        out = self.profile["out"] + thinking_tokens
        return TokenUsage(input_tokens=fresh, cache_read_tokens=cached,
                          cache_write_tokens=fresh, output_tokens=out)

    def complete(self, conversation_tokens: int, conversation_id: str,
                 budget: BudgetTier, thinking_tokens: int = 0
                 ) -> TokenUsage:
        usage = self.predict(conversation_tokens, conversation_id,
                             thinking_tokens)
        # thinking tokens are billed as output but are NOT part of the
        # quoted conversation the next round re-reads — persisting them
        # as cached context would under-bill every post-thinking round's
        # fresh input (the reflection suffix would look already cached)
        self._convo_cached[conversation_id] = (
            conversation_tokens + usage.output_tokens - thinking_tokens)
        return usage


class CascadeBackend:
    """Two EngineBackends — distinct models, distinct engines, distinct
    prefix caches — behind one routed-loop interface.

    The routed loop starts every request on the ``small`` tier and, when
    the controller emits ``escalate_model``, replays the conversation on
    the ``large`` tier from a COLD cache (nothing of the small engine's
    KV transfers), feeding the small tier's committed answer to the
    large engine as ``Request.external_draft``.  That turns the engine's
    self-speculative verify machinery into true two-model speculative
    decoding: the large engine scores the small model's tokens in one
    batched verify lane per token, commits the longest accepted prefix,
    rolls the rest back (PagePool.truncate_tail) and bills only what it
    accepted — greedy output stays bit-identical to the large model
    decoding alone (tests/test_cascade.py)."""

    def __init__(self, small: EngineBackend, large: EngineBackend):
        self.tiers: Dict[str, EngineBackend] = {"small": small,
                                                "large": large}

    @property
    def small(self) -> EngineBackend:
        return self.tiers["small"]

    @property
    def large(self) -> EngineBackend:
        return self.tiers["large"]


class SimulatedCascade:
    """SimulatedBackend pair mirroring CascadeBackend for the offline
    path: one token/cache simulator per tier (small model, large model),
    same domain, independent prompt caches — escalating replays the
    conversation as ALL-FRESH input on the large simulator, exactly the
    cold-cache usage the controller's ``escalate_model`` pricing assumed,
    which is what keeps simulated SLO ceilings hard across a hop."""

    def __init__(self, small: SimulatedBackend, large: SimulatedBackend):
        assert small.domain == large.domain, "cascade tiers must share domain"
        self.tiers: Dict[str, SimulatedBackend] = {"small": small,
                                                   "large": large}
        self.domain = small.domain
        self.rng = small.rng             # cid source (parity with 1-tier)
        self.profile = small.profile


class ReflectionController:
    """Generic reflect-and-revise loop over either backend.

    ``router=None`` runs the strategy's FIXED round count — the original
    loop, byte-for-byte (pinned by tests/test_controller.py).  With a
    ``SweetSpotController`` the loop becomes adaptive: one
    stop/reflect/escalate decision per round, per-request SLO ceilings,
    and every completed request feeds the router's online frontier."""

    def __init__(self, strategy: InferenceStrategy,
                 feedback: Optional[FeedbackProvider] = None,
                 router: Optional[SweetSpotController] = None):
        self.strategy = strategy
        self.feedback = feedback or NoFeedback()
        self.router = router
        # retry-backoff jitter stream (routed engine path only); lazily
        # seeded from the router config so chaos runs are deterministic
        self._retry_rng: Optional[np.random.Generator] = None

    # ---------------- real-engine path -----------------------------------

    def run_task(self, backend: EngineBackend, task,
                 slo: Optional[SLO] = None) -> ReflectionResult:
        if self.router is not None:
            return self._run_task_routed(backend, task, slo)
        if isinstance(backend, CascadeBackend):
            backend = backend.small      # fixed loop has no tier policy
        convo = task.prompt()
        cid = f"task-{id(task)}"
        result = ReflectionResult(rounds=[])
        response, usage = backend.complete(convo, cid, self.strategy.budget)
        rec = RoundRecord(response, usage, correct=bool(task.verify(response)))
        result.rounds.append(rec)
        result.usage += usage
        for _ in range(self.strategy.reflection_rounds):
            fb = self.feedback.feedback(task, response)
            convo = (convo + " " + response + " "
                     + REFLECT_TEMPLATE.format(feedback=fb,
                                               question=task.prompt()))
            response, usage = backend.complete(convo, cid, self.strategy.budget)
            rec = RoundRecord(response, usage,
                              correct=bool(task.verify(response)))
            result.rounds.append(rec)
            result.usage += usage
        return result

    @staticmethod
    def _engine_cap(backend: EngineBackend, tier: BudgetTier) -> int:
        """Effective decode cap of a round at ``tier`` on this backend —
        mirrors Engine._budget_cap (tiers cap, never extend)."""
        scfg = backend.engine.scfg
        caps = {BudgetTier.NONE: backend.max_new_tokens,
                BudgetTier.LOW: scfg.max_think_tokens_low,
                BudgetTier.HIGH: scfg.max_think_tokens_high}
        return min(backend.max_new_tokens, caps[tier])

    def _remaining(self, slo: Optional[SLO], usage: TokenUsage,
                   spent: Optional[Tuple[float, float]] = None,
                   extra_latency_s: float = 0.0
                   ) -> Tuple[Optional[float], Optional[float]]:
        """Ceilings minus spend so far — the per-round Request ceilings
        the engine's SLO admission checks against.  Dollars and seconds
        are model-agnostic, so a cascade caller whose spend spans two
        price books passes the exact priced totals via ``spent``;
        single-tier callers price the cumulative usage as before.
        ``extra_latency_s`` adds latency the usage cannot carry — retry
        backoff delays — for single-tier callers (cascade callers fold
        delays into ``spent`` directly)."""
        if slo is None:
            return (None, None)
        router = self.router
        c, lt = spent if spent is not None else (
            router.cm.cost(usage),
            router.lm.latency(usage) + extra_latency_s)
        rc = (None if slo.max_cost_usd is None
              else max(0.0, slo.max_cost_usd - c))
        rl = (None if slo.max_latency_s is None
              else max(0.0, slo.max_latency_s - lt))
        return (rc, rl)

    def _run_task_routed(self, backend, task,
                         slo: Optional[SLO]) -> ReflectionResult:
        router = self.router
        # cascade dimension: a CascadeBackend plus cfg.cascade activates
        # model-tier routing; everything else runs the single-tier loop
        # byte-for-byte (pinned by tests/test_engine_fuzz.py).  A
        # CascadeBackend under a cascade-off config just serves the
        # small tier.
        if isinstance(backend, CascadeBackend):
            tiers = backend.tiers
            cascade = router.cfg.cascade
        else:
            tiers = {"small": backend}
            cascade = False
        # the engine backstop is optional (slo_price_model=None leaves
        # enforcement to the controller alone), but when BOTH sides
        # price ceilings they must price them identically — remaining
        # dollars computed under one model are meaningless to the other.
        # Each tier's engine is checked against that TIER's price book.
        if slo is not None:
            for mt, b in tiers.items():
                eng_cm = getattr(b.engine, "cost_model", None)
                if eng_cm is not None:
                    rcm, rlm = router._models(mt)
                    assert (eng_cm == rcm
                            and b.engine.latency_model == rlm), \
                        f"engine slo_price_model disagrees with the " \
                        f"router's {mt}-tier models"
        convo = task.prompt()
        cid = f"task-{id(task)}"
        domain = getattr(task, "domain", "default")
        result = ReflectionResult(rounds=[])
        # ``tier`` is the tier of the last EXECUTED round (what observe()
        # attributes); ``next_tier`` carries a pending escalation, which
        # only commits once the escalated round actually runs — an
        # engine SLO refusal must not tag the request with a thinking
        # tier it never paid for
        tier = next_tier = self.strategy.budget
        if cascade:
            planned, model_tier = router.plan_start(domain, slo)
        else:
            planned = router.plan_rounds(domain, slo)
            model_tier = "small"
        bk = tiers[model_tier]
        # exact priced spend across tiers: a request that escalates spans
        # two price books, so cumulative TokenUsage alone cannot be
        # priced after the hop — the floats are the source of truth for
        # cascade SLO math (single-tier paths keep pricing usage
        # directly, preserving float-for-float parity)
        spent_c = spent_l = 0.0
        # cross-model handoff: the small tier's committed tokens become
        # the large tier's draft for ONE round (the first escalated one)
        pending_draft: Optional[List[int]] = None
        responses: List[str] = []
        prev_response: Optional[str] = None
        stalls = 0
        idx = 0
        # reliability state (docs/SERVING.md#reliability): per-round
        # transient-retry attempts, cumulative backoff latency (counted
        # against the latency SLO — the usage cannot carry it), and the
        # one-shot extra-round grant of a breaker fallback
        if self._retry_rng is None:
            self._retry_rng = np.random.default_rng(router.cfg.retry_seed)
        attempts = 0
        retry_lat = 0.0
        fb_bonus = 0
        while True:
            response, usage, req = bk.complete_routed(
                convo, cid, next_tier,
                self._remaining(slo, result.usage,
                                (spent_c, spent_l) if cascade else None,
                                extra_latency_s=retry_lat),
                external_draft=pending_draft)
            pending_draft = None
            cm_t, lm_t = router._models(model_tier)
            if req.stop_reason == "slo":
                # the engine refused to fund the round: the previous
                # answer stands (a refused round 0 records an empty one,
                # and contributes no frontier observation — no strategy
                # actually ran).  The terminal decision lands in
                # result.trace exactly like the simulated path's refusal
                result.usage += usage
                spent_c += cm_t.cost(usage)
                spent_l += lm_t.latency(usage)
                rec = req.decision_trace[-1] if req.decision_trace else {}
                result.trace.append(Decision(
                    "stop", "slo", idx, next_tier.value,
                    spent_c if cascade else router.cm.cost(result.usage),
                    spent_l if cascade else router.lm.latency(result.usage),
                    rec.get("pred_cost_usd", 0.0),
                    rec.get("pred_latency_s", 0.0),
                    model_tier=model_tier))
                result.stop_reason = "slo"
                if idx == 0:
                    result.rounds.append(RoundRecord(response, usage,
                                                     correct=False))
                    return result
                break
            if req.stop_reason == "timeout":
                # the deadline elapsed mid-round: whatever partial output
                # the engine committed before freezing billing IS this
                # round's answer — record it, bill it, and stop.  A
                # timeout is terminal (retrying cannot buy back wall
                # time), and it counts against the tier's breaker.
                result.usage += usage
                spent_c += cm_t.cost(usage)
                spent_l += lm_t.latency(usage)
                router.record_tier_result(model_tier, False)
                result.rounds.append(RoundRecord(
                    response, usage, correct=bool(task.verify(response))))
                result.trace.append(Decision(
                    "stop", "timeout", idx, next_tier.value,
                    spent_c if cascade else router.cm.cost(result.usage),
                    spent_l if cascade else (router.lm.latency(result.usage)
                                             + retry_lat),
                    0.0, 0.0, model_tier=model_tier))
                result.stop_reason = "timeout"
                break
            if req.stop_reason in ("error", "stalled"):
                # transient failure: the round produced nothing usable,
                # but its tokens were still spent — bill them, then retry
                # the SAME round with exponential backoff, pricing each
                # retry's delay against the remaining latency SLO.  An
                # unfundable or exhausted retry degrades to the best
                # committed round (stop_reason "degraded") — the caller
                # NEVER sees an exception from the routed loop.
                result.usage += usage
                spent_c += cm_t.cost(usage)
                spent_l += lm_t.latency(usage)
                router.record_tier_result(model_tier, False)
                delay = (router.cfg.retry_base_s * (2 ** attempts)
                         * (1.0 + router.cfg.retry_jitter
                            * float(self._retry_rng.random())))
                _, rl = self._remaining(slo, result.usage,
                                        (spent_c, spent_l) if cascade
                                        else None,
                                        extra_latency_s=retry_lat)
                fundable = rl is None or delay <= rl
                if attempts < router.cfg.retry_max and fundable:
                    attempts += 1
                    result.retries += 1
                    retry_lat += delay
                    if cascade:
                        spent_l += delay
                    req.decision_trace.append({
                        "action": "retry", "attempt": attempts,
                        "delay_s": delay, "cause": req.stop_reason})
                    # re-issue the identical conversation: the prefix
                    # cache makes the replay a near-pure cache hit
                    continue
                result.stop_reason = ("degraded" if result.rounds
                                      else "error")
                if not result.rounds:
                    result.rounds.append(RoundRecord("", TokenUsage(),
                                                     correct=False))
                result.trace.append(Decision(
                    "stop", result.stop_reason, idx, next_tier.value,
                    spent_c if cascade else router.cm.cost(result.usage),
                    spent_l if cascade else (router.lm.latency(result.usage)
                                             + retry_lat),
                    0.0, 0.0, model_tier=model_tier))
                break
            attempts = 0
            router.record_tier_result(model_tier, True)
            tier = next_tier
            rec = RoundRecord(response, usage,
                              correct=bool(task.verify(response)))
            result.rounds.append(rec)
            result.usage += usage
            spent_c += cm_t.cost(usage)
            spent_l += lm_t.latency(usage)
            responses.append(response)
            fb = self.feedback.feedback(task, response)
            delta = answer_delta(prev_response, response)
            verdict = verdict_from_feedback(fb)
            stable = delta <= router.cfg.stable_delta
            if stable and verdict is False:
                stalls += 1
            elif not stable:
                stalls = 0
            signals = RoundSignals(
                round_idx=idx, answer_delta=delta, verdict=verdict,
                vote_frac=vote_agreement([extract_answer(r)
                                          for r in responses]),
                stalls=stalls, tier=tier, model_tier=model_tier)
            # exact-shape next-round estimate: tokenize the conversation
            # the next round WOULD submit; the just-published snapshot
            # makes everything up to this round's end a cache hit, the
            # reflection suffix is fresh, decode is priced at the cap
            # (worst case).  The engine's admission check (when
            # ServeConfig.slo_price_model is set) is the refusing
            # backstop for cache evictions this estimate can't see.
            next_convo = (convo + " " + response + " "
                          + REFLECT_TEMPLATE.format(feedback=fb,
                                                    question=task.prompt()))
            ntok = len(bk.tok.encode(next_convo))
            cached_est = min(len(req.prompt) + len(req.output), ntok - 1)
            pred = TokenUsage(input_tokens=ntok - cached_est,
                              cache_read_tokens=cached_est,
                              cache_write_tokens=ntok - cached_est,
                              output_tokens=bk.max_new_tokens)
            if cascade:
                # retry delays were folded into spent_l as they accrued
                decision = router.decide(signals, slo, result.usage, pred,
                                         planned_rounds=planned,
                                         spent_cost_usd=spent_c,
                                         spent_latency_s=spent_l,
                                         extra_rounds=fb_bonus)
            elif retry_lat > 0.0:
                # single-tier with backoff spent: price the usage as
                # usual but surface the retry wall-time to the SLO check
                decision = router.decide(
                    signals, slo, result.usage, pred,
                    planned_rounds=planned,
                    spent_cost_usd=router.cm.cost(result.usage),
                    spent_latency_s=(router.lm.latency(result.usage)
                                     + retry_lat),
                    extra_rounds=fb_bonus)
            else:
                decision = router.decide(signals, slo, result.usage, pred,
                                         planned_rounds=planned,
                                         extra_rounds=fb_bonus)
            result.trace.append(decision)
            req.decision_trace.append(decision.key())
            if decision.reason == "breaker-fallback" and fb_bonus == 0:
                # the breaker denied an escalation: grant the small tier
                # ONE extra reflection round in compensation (once)
                fb_bonus = 1
            if decision.action == "stop":
                break
            if decision.action == "escalate_model":
                # hand the request to the large tier: cold cache there
                # (decide() priced the next round as all-fresh input),
                # and this round's committed tokens ride along as the
                # large engine's speculative draft
                model_tier = decision.model_tier
                bk = tiers[model_tier]
                pending_draft = list(req.output)
            if decision.action == "escalate":
                # the engine's budget tiers CAP decode steps (they never
                # add capacity) — apply an escalation only when the new
                # tier actually raises this request's effective cap,
                # e.g. LOW->HIGH with max_new_tokens above the LOW cap;
                # otherwise run a plain round at the current tier so the
                # frontier never records a tier that changed nothing
                cand = BudgetTier(decision.tier)
                if self._engine_cap(bk, cand) > \
                        self._engine_cap(bk, tier):
                    next_tier = cand
            prev_response = response
            convo = next_convo
            idx += 1
        if result.stop_reason in ("finished", "slo"):
            # backend-failure outcomes (timeout/degraded/error) say
            # nothing about the strategy's quality — keep them out of
            # the frontier the planner learns from
            if cascade:
                router.observe(domain, result.rounds_run, tier,
                               100.0 * bool(result.final.correct),
                               result.usage, model_tier=model_tier,
                               cost_usd=spent_c, latency_s=spent_l)
            else:
                router.observe(domain, result.rounds_run, tier,
                               100.0 * bool(result.final.correct),
                               result.usage)
        return result

    # ---------------- simulated path (paper reproduction) ----------------

    def run_simulated(self, sim: SimulatedBackend, correct_by_round,
                      think_tokens: int = 0) -> ReflectionResult:
        """correct_by_round: bool per round from quality_sim trajectories."""
        if isinstance(sim, SimulatedCascade):
            sim = sim.tiers["small"]     # fixed loop has no tier policy
        prof = sim.profile
        convo_tokens = prof["prompt"]
        cid = f"sim-{sim.rng.integers(1 << 62)}"
        result = ReflectionResult(rounds=[])
        usage = sim.complete(convo_tokens, cid, self.strategy.budget,
                             think_tokens)
        result.rounds.append(RoundRecord("", usage,
                                         correct=bool(correct_by_round[0])))
        result.usage += usage
        for r in range(self.strategy.reflection_rounds):
            convo_tokens += prof["out"] + QS.REFLECT_PROMPT_TOKENS \
                + prof["prompt"]          # response + instruction + re-quote
            usage = sim.complete(convo_tokens, cid, self.strategy.budget)
            result.rounds.append(RoundRecord(
                "", usage, correct=bool(correct_by_round[r + 1])))
            result.usage += usage
        return result

    def route_simulated(self, sim, correct_by_round,
                        slo: Optional[SLO] = None,
                        rng: Optional[np.random.Generator] = None,
                        large_correct_by_round=None) -> ReflectionResult:
        """Adaptive counterpart of ``run_simulated`` (requires a router):
        the same decide() policy as the engine path, driven by simulated
        signals.

        Signal model (deterministic given ``rng``): reflection re-emits
        the prior answer unless correctness flips ("First Try Matters"),
        so the simulated answer changes iff correctness changes — across
        both fixes and regressions; the judge verdict is truthful w.p.
        ``cfg.sim_judge_accuracy`` (only when the strategy carries a
        feedback provider); the self-consistency vote counts agreeing
        answer ids across rounds.  Because the backend's ``predict`` is
        exact, SLO ceilings are HARD here: a round that would breach its
        ceiling is never started (pinned by tests/test_engine_fuzz.py).

        Escalated rounds consume the tier's mean thinking tokens and fix
        a still-wrong answer w.p. ``cfg.escalation_fix_p`` (modelling
        arXiv:2512.19585's conditional-escalation gains); a fix obtained
        this way is retained like any other correct answer.

        The hard-ceiling guarantee covers round 0 too: an SLO that
        cannot fund even the first answer refuses the request up front —
        an empty zero-usage round with a "slo" stop decision and no
        frontier observation, mirroring the engine backend's admission
        finalize.

        Cascade: with a ``SimulatedCascade`` and ``cfg.cascade`` on, the
        loop grows the model-tier dimension.  An ``escalate_model``
        decision replays the conversation all-fresh on the large
        simulator (cold cache — the exact usage the decision priced) and
        every large-tier round fixes a still-wrong answer w.p.
        ``cfg.cascade_fix_p`` (fixes retained).  A warm start that
        routes round 0 straight to the large tier follows
        ``large_correct_by_round`` when provided (the large model's own
        quality trajectory), else falls back to ``correct_by_round``."""
        router = self.router
        assert router is not None, "route_simulated requires a router"
        cfg = router.cfg
        if isinstance(sim, SimulatedCascade):
            tiers = sim.tiers
            cascade = cfg.cascade
        else:
            tiers = {"small": sim}
            cascade = False
        rng = np.random.default_rng(0) if rng is None else rng
        prof = sim.profile
        convo_tokens = prof["prompt"]
        cid = f"sim-{sim.rng.integers(1 << 62)}"
        domain = sim.domain
        result = ReflectionResult(rounds=[])
        tier = self.strategy.budget
        if cascade:
            planned, model_tier = router.plan_start(domain, slo)
        else:
            planned = router.plan_rounds(domain, slo)
            model_tier = "small"
        sim_t = tiers[model_tier]
        started_large = model_tier == "large"
        # warm-started large requests follow the large model's own
        # trajectory; a mid-flight hop uses the cascade_fix_p model
        traj = (large_correct_by_round
                if started_large and large_correct_by_round is not None
                else correct_by_round)
        use_judge = self.feedback.name != "none"

        def tier_think(t: BudgetTier) -> int:
            return cfg.think_tokens.get(t.value, 0) \
                if t is not BudgetTier.NONE else 0

        cm_t, lm_t = router._models(model_tier)
        pred0 = sim_t.predict(convo_tokens, cid, tier_think(tier))
        if slo is not None and not slo.admits(cm_t.cost(pred0),
                                              lm_t.latency(pred0)):
            result.rounds.append(RoundRecord("", TokenUsage(),
                                             correct=False))
            result.trace.append(Decision(
                "stop", "slo", 0, tier.value, 0.0, 0.0,
                cm_t.cost(pred0), lm_t.latency(pred0),
                model_tier=model_tier))
            return result
        usage = sim_t.complete(convo_tokens, cid, tier, tier_think(tier))
        spent_c, spent_l = cm_t.cost(usage), lm_t.latency(usage)
        history = [bool(traj[0])]
        aids = [0]                       # simulated answer ids (vote signal)
        result.rounds.append(RoundRecord("", usage, correct=history[0]))
        result.usage += usage
        forced = False                   # escalation fixed it: retained
        stalls = 0
        idx = 0
        while True:
            delta = (1.0 if len(history) < 2
                     else float(history[-1] != history[-2]))
            verdict = None
            if use_judge:
                truth = history[-1]
                verdict = (truth if rng.random() < cfg.sim_judge_accuracy
                           else not truth)
            stable = delta <= cfg.stable_delta
            if stable and verdict is False:
                stalls += 1
            elif not stable:
                stalls = 0
            # same consensus rule as the engine path: answer ids stand
            # in for extracted answers
            vote = vote_agreement([str(a) for a in aids])
            nxt_tokens = (convo_tokens + prof["out"]
                          + QS.REFLECT_PROMPT_TOKENS + prof["prompt"])
            pred = sim_t.predict(nxt_tokens, cid, tier_think(tier))
            signals = RoundSignals(round_idx=idx, answer_delta=delta,
                                   verdict=verdict, vote_frac=vote,
                                   stalls=stalls, tier=tier,
                                   model_tier=model_tier)
            if cascade:
                decision = router.decide(signals, slo, result.usage, pred,
                                         planned_rounds=planned,
                                         spent_cost_usd=spent_c,
                                         spent_latency_s=spent_l)
            else:
                decision = router.decide(signals, slo, result.usage, pred,
                                         planned_rounds=planned)
            result.trace.append(decision)
            if decision.action == "stop":
                break
            escalated = decision.action == "escalate"
            if escalated:
                tier = BudgetTier(decision.tier)
            if decision.action == "escalate_model":
                # replay on the large simulator from a cold cache — its
                # complete() bills the whole conversation as fresh
                # input, byte-matching the decision's esc pricing, so
                # the hop can never breach a ceiling decide() admitted
                model_tier = decision.model_tier
                sim_t = tiers[model_tier]
            convo_tokens = nxt_tokens
            usage = sim_t.complete(convo_tokens, cid, tier, tier_think(tier))
            cm_t, lm_t = router._models(model_tier)
            spent_c += cm_t.cost(usage)
            spent_l += lm_t.latency(usage)
            idx += 1
            nxt_correct = (bool(traj[idx])
                           if idx < len(traj) else history[-1])
            if forced:
                nxt_correct = True
            if (escalated and not nxt_correct
                    and rng.random() < cfg.escalation_fix_p):
                nxt_correct = True
                forced = True
            if (cascade and model_tier == "large" and not started_large
                    and not nxt_correct
                    and rng.random() < cfg.cascade_fix_p):
                # the large model re-answers a question the small model
                # was stably wrong on — the conditional-cascade gain of
                # arXiv:2512.19585 / SNIPPETS #2; retried every large
                # round, retained once fixed
                nxt_correct = True
                forced = True
            aids.append(aids[-1] + 1 if nxt_correct != history[-1]
                        else aids[-1])
            history.append(nxt_correct)
            result.rounds.append(RoundRecord("", usage, correct=nxt_correct))
            result.usage += usage
        if cascade:
            router.observe(domain, idx, tier, 100.0 * history[-1],
                           result.usage, model_tier=model_tier,
                           cost_usd=spent_c, latency_s=spent_l)
        else:
            router.observe(domain, idx, tier, 100.0 * history[-1],
                           result.usage)
        return result


def evaluate_strategy(model_name: str, domain: str,
                      strategy: InferenceStrategy, n_examples: int = 100,
                      seed: int = 0, prompt_caching: bool = True
                      ) -> Dict[str, float]:
    """Paper-grid evaluation of one (model, domain, strategy) cell:
    accuracy from the calibrated simulator + cost/latency from accounting.
    Returns dict(accuracy, cost_usd, latency_s) of per-example means.
    """
    think = 0
    if strategy.budget is not BudgetTier.NONE:
        think = QS.THINK_CONSUMED[strategy.budget.value]
        acc = QS.QUALITY[domain][model_name].get("think", {}).get(
            strategy.budget.value)
        if acc is None:
            acc = QS.accuracy_at(domain, model_name, 0)
        rounds_correct = None
    else:
        traj = QS.simulate_trajectories(domain, model_name, n_examples,
                                        strategy.reflection_rounds, seed)
        acc = None
        rounds_correct = traj.correct

    sim = SimulatedBackend(model_name, domain, seed,
                           prompt_caching=prompt_caching)
    cm = CostModel.for_model(model_name)
    lm = LatencyModel.for_model(model_name)
    ctrl = ReflectionController(strategy)
    costs, lats, correct = [], [], []
    for i in range(n_examples):
        if rounds_correct is not None:
            res = ctrl.run_simulated(sim, rounds_correct[i])
            correct.append(bool(rounds_correct[i][-1]))
        else:
            res = ctrl.run_simulated(sim, [True], think_tokens=think)
        costs.append(cm.cost(res.usage, prompt_caching=prompt_caching))
        lats.append(lm.latency(res.usage))
    accuracy = (float(np.mean(correct)) * 100.0
                if correct else float(acc))
    return {"accuracy": accuracy, "cost_usd": float(np.mean(costs)),
            "latency_s": float(np.mean(lats))}
