"""Request / usage dataclasses for the reflection-aware serving engine."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

_uid = itertools.count()

# One epsilon for EVERY deadline comparison — controller SLO admission,
# engine admission pricing, and the runtime timeout sweep.  The three
# checks must agree on the boundary: a request admitted exactly at its
# deadline (admission accepts lat <= max_latency_s + eps) must not be
# finalized "timeout" on its first tick because the sweep used a
# stricter boundary.
DEADLINE_EPS = 1e-9


class Status(Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"   # admitted to a slot, chunks still pending
    DECODING = "decoding"
    DONE = "done"
    CANCELLED = "cancelled"


class BudgetTier(Enum):
    """Paper §3.2 thinking budgets."""
    NONE = "none"
    LOW = "low"       # 1024 thinking tokens
    HIGH = "high"     # 4096 thinking tokens


@dataclass
class TokenUsage:
    """Bedrock-style token accounting (cache-aware, Appendix B.4)."""
    input_tokens: int = 0          # fresh prefill tokens
    cache_read_tokens: int = 0     # prefix-cache hits (billed at discount)
    cache_write_tokens: int = 0    # tokens newly written to the prefix cache
    output_tokens: int = 0

    def __iadd__(self, o: "TokenUsage"):
        self.input_tokens += o.input_tokens
        self.cache_read_tokens += o.cache_read_tokens
        self.cache_write_tokens += o.cache_write_tokens
        self.output_tokens += o.output_tokens
        return self


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    eos_id: Optional[int] = 2
    budget: BudgetTier = BudgetTier.NONE
    conversation_id: Optional[str] = None   # prefix-cache key namespace
    round_idx: int = 0                      # reflection round
    uid: int = field(default_factory=lambda: next(_uid))

    # ---- SLO routing (docs/SERVING.md#slo-routing) ------------------
    # REMAINING per-request ceilings (the reflection controller deducts
    # prior rounds' spend before each round's request), priced via
    # ServeConfig.slo_price_model.  When that model is configured and a
    # ceiling is set, the engine's admission check finalizes (stop_reason
    # "slo", empty output) requests whose predicted tokens cannot fit —
    # freeing pages and step budget for requests that can still finish.
    # None disables the check for this request.
    max_cost_usd: Optional[float] = None
    max_latency_s: Optional[float] = None
    # Per-request decision log: controller Decision.key() tuples appended
    # by core/reflection.py's routed loop, dict records appended by the
    # engine's SLO admission check.  Purely observational — replaying a
    # preempted request must not change it.
    decision_trace: List = field(default_factory=list)

    # runtime state
    status: Status = Status.QUEUED
    output: List[int] = field(default_factory=list)
    usage: TokenUsage = field(default_factory=TokenUsage)
    prefill_steps: int = 0
    decode_steps: int = 0
    stop_reason: Optional[str] = None
    # Human-readable failure detail when stop_reason is "error"
    # (malformed request, exhausted NaN quarantine, backend fault, ...).
    error: Optional[str] = None

    # ---- reliability (docs/SERVING.md#reliability) ------------------
    # Engine clock reading at submit(); with ServeConfig.enforce_deadlines
    # a request whose max_latency_s elapses mid-flight is finalized with
    # stop_reason "timeout" (pages released, billing frozen at the
    # committed watermark).
    submitted_at: Optional[float] = None
    # Times this request's logits came back non-finite and the row was
    # quarantined (preempt + replay); past ServeConfig.nan_retry_limit the
    # request is finalized with stop_reason "error".
    nan_retries: int = 0
    # Fault-injection state (serving/faults.py "engine.stuck"): a stuck
    # row's commits are suppressed so it makes no progress — the stall
    # detector (ServeConfig.stall_limit) is what reaps it.
    stuck: bool = False

    # chunked-prefill scheduling state (owned by the engine)
    prefill_pos: int = 0        # prompt tokens already in the slot cache
    cached_len: int = 0         # prefix-cache hit length at admission
    prefill_chunks: int = 0     # mixed-step chunks this request consumed
    admit_seq: int = 0          # admission order (budget fairness key)
    # tokens to (re)prefill this admission: prompt, plus any output already
    # generated before a page-pool preemption requeued the request — the
    # replay restores the exact decode state so generation continues
    prefill_target: Optional[List[int]] = None
    preemptions: int = 0        # times evicted from the page pool & requeued
    # highest prefill position already billed to usage (input/cache_read/
    # output): a preemption replay RECOMPUTES those positions but must not
    # re-bill them — TokenUsage stays what the user would be charged
    billed_prefill: int = 0

    # ---- self-speculative decoding (docs/SERVING.md) ----------------
    # Extra drafting corpus for the n-gram speculator, searched BEFORE
    # prompt+output: the reflection controller feeds prior-round raw
    # drafts here (they are quoted in the round's prompt text, but the
    # raw token stream survives truncation / lossy detokenization).
    # Never fed to the model — proposals from it are verified like any
    # other draft, so a stale context can only cost masked lanes.
    spec_context: Optional[List[int]] = None
    spec_drafted: int = 0       # draft tokens submitted to verify steps
    spec_accepted: int = 0      # of those, accepted (never billed unless
    #                             accepted: output_tokens counts only
    #                             committed tokens — the paper's cost axis)
    # ---- two-model cascade speculation (docs/ARCHITECTURE.md) -------
    # A VERBATIM candidate continuation from another model: the cascade
    # feeds the small tier's committed answer here when escalating, and
    # the large engine drafts from it positionally — external_draft[i]
    # is proposed as output token i while the committed output is still
    # a prefix of the draft, then drafting falls back to n-gram lookup
    # on first divergence.  Verified like any other draft (accepted-
    # prefix + rollback), so a bad draft costs masked lanes, never a
    # wrong token, and rejected tokens are never billed.
    external_draft: Optional[List[int]] = None

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def prefill_remaining(self) -> int:
        target = self.prefill_target if self.prefill_target is not None \
            else self.prompt
        return len(target) - self.prefill_pos
