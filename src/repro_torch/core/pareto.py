"""Pareto frontiers over (accuracy, latency, cost) — paper Figs 1-4(b).

A configuration dominates another if it is no worse on every objective
and strictly better on at least one.  ``sweet_spot`` implements the
paper's practitioner guidance: best accuracy subject to cost/latency
ceilings.

``OnlineFrontier`` is the incremental counterpart used by the serve-time
sweet-spot controller (core/controller.py): points stream in one request
at a time and the non-dominated set is maintained per insert, so routing
decisions can consult the current frontier in O(frontier) instead of
recomputing over every observation ever made.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class ConfigPoint:
    name: str                       # e.g. "nova_micro@r1"
    model: str
    strategy: str                   # "reflect0/1/3" | "think_low/high"
    accuracy: float
    latency_s: float
    cost_usd: float
    meta: Dict = field(default_factory=dict, hash=False, compare=False)


def dominates(a: ConfigPoint, b: ConfigPoint) -> bool:
    ge = (a.accuracy >= b.accuracy and a.latency_s <= b.latency_s
          and a.cost_usd <= b.cost_usd)
    gt = (a.accuracy > b.accuracy or a.latency_s < b.latency_s
          or a.cost_usd < b.cost_usd)
    return ge and gt


def better_or_equal(a: ConfigPoint, b: ConfigPoint,
                    objectives: Sequence[str]) -> bool:
    """Dominance w.r.t. ``objectives``: ``a`` no worse everywhere and
    strictly better somewhere (accuracy maximized; latency/cost
    minimized).  The ONE predicate shared by the batch frontier and the
    incremental OnlineFrontier — their equivalence (pinned by
    tests/test_pareto_properties.py) requires identical dominance."""
    ok_all, strict = True, False
    for obj in objectives:
        av, bv = getattr(a, obj), getattr(b, obj)
        if obj == "accuracy":
            ok_all &= av >= bv
            strict |= av > bv
        else:
            ok_all &= av <= bv
            strict |= av < bv
    return ok_all and strict


def pareto_frontier(points: Sequence[ConfigPoint],
                    objectives: Sequence[str] = ("accuracy", "latency_s"),
                    ) -> List[ConfigPoint]:
    """Non-dominated subset w.r.t. the given objectives (accuracy is
    maximized; latency/cost minimized), sorted by latency."""
    out = [p for p in points
           if not any(better_or_equal(q, p, objectives)
                      for q in points if q is not p)]
    return sorted(out, key=lambda p: p.latency_s)


def sweet_spot(points: Sequence[ConfigPoint],
               max_latency_s: Optional[float] = None,
               max_cost_usd: Optional[float] = None) -> Optional[ConfigPoint]:
    """Highest-accuracy config under resource ceilings; ties broken by
    cost then latency (the paper's deployment selection rule)."""
    feas = [p for p in points
            if (max_latency_s is None or p.latency_s <= max_latency_s)
            and (max_cost_usd is None or p.cost_usd <= max_cost_usd)]
    if not feas:
        return None
    return max(feas, key=lambda p: (p.accuracy, -p.cost_usd, -p.latency_s))


class OnlineFrontier:
    """Incrementally-maintained non-dominated set.

    Invariant (pinned by tests/test_pareto_properties.py): after any
    sequence of ``insert`` calls, ``points`` equals
    ``pareto_frontier(everything ever inserted, objectives)`` up to
    ordering — a point rejected or evicted by an insert can never rejoin
    the frontier (domination is transitive), so the incremental update
    loses nothing relative to a batch recompute.

    ``upsert`` additionally replaces any same-identity point first; the
    controller uses it to refresh a strategy's running-mean point as new
    observations arrive (after an upsert the batch-equivalence invariant
    applies to the surviving points only, since old means are retracted).
    Identity is ``(name, model)``, NOT name alone: the cascade controller
    publishes one running-mean point per (domain, strategy) AND model
    tier, and a small-tier point must never retract the large-tier point
    that happens to share its strategy name (pinned by
    tests/test_pareto_properties.py).
    """

    def __init__(self, objectives: Sequence[str] = ("accuracy", "latency_s",
                                                    "cost_usd")):
        self.objectives = tuple(objectives)
        self._points: List[ConfigPoint] = []
        self.stats = {"inserted": 0, "rejected": 0, "evicted": 0}

    @property
    def points(self) -> List[ConfigPoint]:
        return list(self._points)

    def __len__(self) -> int:
        return len(self._points)

    def _better_or_equal(self, a: ConfigPoint, b: ConfigPoint) -> bool:
        return better_or_equal(a, b, self.objectives)

    def insert(self, p: ConfigPoint) -> bool:
        """Add a point; returns True iff it joins the frontier (evicting
        any now-dominated incumbents), False if it is dominated."""
        if any(self._better_or_equal(q, p) for q in self._points):
            self.stats["rejected"] += 1
            return False
        keep = [q for q in self._points if not self._better_or_equal(p, q)]
        self.stats["evicted"] += len(self._points) - len(keep)
        keep.append(p)
        keep.sort(key=lambda q: q.latency_s)
        self._points = keep
        self.stats["inserted"] += 1
        return True

    def upsert(self, p: ConfigPoint) -> bool:
        """Retract any same-identity point, then insert (running-mean
        refresh).  Identity is ``(name, model)``: points that share a
        strategy name but belong to different model tiers coexist — an
        equal-cost refresh of one tier must not clobber the other."""
        self._points = [q for q in self._points
                        if (q.name, q.model) != (p.name, p.model)]
        return self.insert(p)

    def sweet_spot(self, max_latency_s: Optional[float] = None,
                   max_cost_usd: Optional[float] = None
                   ) -> Optional[ConfigPoint]:
        return sweet_spot(self._points, max_latency_s, max_cost_usd)
