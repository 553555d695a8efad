"""Seeded, replayable fleet-workload traces (docs/SERVING.md#fleet-routing).

The paper's deployment story is decided at FLEET level: reflection's
value under real traffic mixes with per-market SLOs, not one request at
a time.  This module generates the workload half of that experiment — a
time-stamped request trace with the statistical structure production
serving actually sees:

  * heavy-tailed interarrivals: Pareto gaps (index ``pareto_alpha``)
    instead of Poisson, so bursts arrive in clumps and the p99 queueing
    behavior is non-trivial;
  * diurnal modulation: the instantaneous arrival rate swings by
    ``diurnal_amp`` around the mean on a ``diurnal_period_s`` cycle
    (a compressed day), so routers are tested through overload peaks
    AND idle troughs;
  * mixed domains (math / translation / SQL), each with
    ``groups_per_domain`` SHARED-PREFIX groups: requests in one group
    open with the same page-aligned token prefix (a system prompt +
    few-shot block), which is what makes prefix-cache-affinity routing
    matter — the group prefix is the unit of cache reuse;
  * per-class SLOs reused from :class:`repro_torch.core.controller.SLO`
    (interactive / standard / batch), plus a TTFT target per class —
    fleet goodput counts a completion iff both were met.

Everything is a pure function of ``TraceConfig`` (numpy Generator from
``seed``): ``generate_trace(cfg)`` called twice returns identical
traces, which is what makes fleet A/Bs (affinity vs round-robin) and
router-determinism tests exact.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.controller import SLO

# Per-class service objectives.  The SLO deadline is enforced the same
# way the engine enforces Request.max_latency_s; the TTFT target is the
# fleet goodput axis (benchmarks/fleet.py): a completion is "good" iff
# its first token met the class TTFT target AND the request finished
# inside its SLO deadline.
SLO_CLASSES: Dict[str, SLO] = {
    "interactive": SLO(max_latency_s=2.0),
    "standard": SLO(max_latency_s=8.0),
    "batch": SLO(max_latency_s=None),
}
TTFT_TARGET_S: Dict[str, float] = {
    "interactive": 0.35,
    "standard": 1.5,
    "batch": 6.0,
}


@dataclass(frozen=True)
class TraceRequest:
    """One trace arrival.  Frozen — routers must not mutate the trace
    (replica-side scheduling state lives in serving/fleet.py)."""
    idx: int
    arrival_s: float
    prompt: Tuple[int, ...]
    domain: str
    group: int                  # shared-prefix group within the domain
    slo_class: str
    slo: SLO
    ttft_slo_s: float
    max_new_tokens: int


@dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 512
    seed: int = 0
    mean_rate: float = 40.0         # long-run arrivals/s (diurnal midpoint)
    pareto_alpha: float = 1.8       # interarrival tail index (>1; lower =
    #                                 heavier tail, clumpier arrivals)
    diurnal_amp: float = 0.6        # rate modulation depth in [0, 1)
    diurnal_period_s: float = 20.0  # one compressed "day"
    page_size: int = 16             # must match the replicas' page size —
    #                                 group prefixes are page-aligned so
    #                                 the shared region is snapshot-reusable
    prefix_pages: int = 6           # shared group prefix length, in pages
    #                                 (96 tokens at page_size 16 — a system
    #                                 prompt + few-shot block, heavy enough
    #                                 that cache reuse moves service time)
    groups_per_domain: int = 4      # scale with the fleet: more replicas
    #                                 than groups turns affinity into
    #                                 hotspotting (benchmarks/fleet.py's
    #                                 64-replica sweep uses 64/domain)
    domain_mix: Tuple[Tuple[str, float], ...] = (
        ("math", 0.40), ("translation", 0.35), ("sql", 0.25))
    slo_mix: Tuple[Tuple[str, float], ...] = (
        ("interactive", 0.50), ("standard", 0.35), ("batch", 0.15))
    suffix_tokens: Tuple[int, int] = (16, 64)   # unique tail length range
    out_tokens: Tuple[int, int] = (8, 48)       # decode budget range
    vocab: int = 50_000             # token id range [3, vocab); live
    #                                 engine replicas pass their model's
    #                                 vocab_size here


def group_prefix(domain: str, group: int, n_tokens: int,
                 vocab: int) -> Tuple[int, ...]:
    """The shared page-aligned opening of every group member's prompt.
    Deterministic from (domain, group) alone — independent of trace seed,
    so separately-generated traces agree on what a group looks like."""
    h = zlib.crc32(f"{domain}/{group}".encode())
    rng = np.random.default_rng(h)
    return tuple(int(t) for t in rng.integers(3, vocab, n_tokens))


def generate_trace(cfg: TraceConfig) -> List[TraceRequest]:
    """Materialize the trace: same cfg -> identical list, always."""
    assert cfg.pareto_alpha > 1.0, "interarrival mean diverges at alpha<=1"
    assert 0.0 <= cfg.diurnal_amp < 1.0
    rng = np.random.default_rng(cfg.seed)
    domains = [d for d, _ in cfg.domain_mix]
    dweights = np.array([w for _, w in cfg.domain_mix], np.float64)
    dweights /= dweights.sum()
    classes = [c for c, _ in cfg.slo_mix]
    cweights = np.array([w for _, w in cfg.slo_mix], np.float64)
    cweights /= cweights.sum()
    # (pareto(a) + 1) has mean a / (a - 1); normalize so the long-run
    # rate is mean_rate before diurnal modulation
    mean_excess = cfg.pareto_alpha / (cfg.pareto_alpha - 1.0)
    base_gap = 1.0 / (cfg.mean_rate * mean_excess)

    npfx = cfg.prefix_pages * cfg.page_size
    trace: List[TraceRequest] = []
    t = 0.0
    for i in range(cfg.n_requests):
        gap = (float(rng.pareto(cfg.pareto_alpha)) + 1.0) * base_gap
        # diurnal burst: the local rate multiplier stretches/compresses
        # this gap (peak rate = mean * (1 + amp))
        rate_mult = 1.0 + cfg.diurnal_amp * math.sin(
            2.0 * math.pi * t / cfg.diurnal_period_s)
        t += gap / max(rate_mult, 1e-6)
        domain = domains[int(rng.choice(len(domains), p=dweights))]
        group = int(rng.integers(cfg.groups_per_domain))
        klass = classes[int(rng.choice(len(classes), p=cweights))]
        nsuf = int(rng.integers(cfg.suffix_tokens[0],
                                cfg.suffix_tokens[1] + 1))
        suffix = tuple(int(x) for x in rng.integers(3, cfg.vocab, nsuf))
        out = int(rng.integers(cfg.out_tokens[0], cfg.out_tokens[1] + 1))
        trace.append(TraceRequest(
            idx=i, arrival_s=t,
            prompt=group_prefix(domain, group, npfx, cfg.vocab) + suffix,
            domain=domain, group=group, slo_class=klass,
            slo=SLO_CLASSES[klass], ttft_slo_s=TTFT_TARGET_S[klass],
            max_new_tokens=out))
    return trace
