"""Budget tuning (paper §3.2): thinking-token tiers as engine decode caps.

Providers expose budgets as opaque API knobs ("low"/"high"); here they are
white-box decode-step budgets enforced by the serving engine, plus a
planner that picks (strategy, budget) under cost/latency ceilings using
the Pareto machinery.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.serving.request import BudgetTier

TIER_TOKENS: Dict[BudgetTier, Optional[int]] = {
    BudgetTier.NONE: None,
    BudgetTier.LOW: 1024,          # paper's 1024-token budget
    BudgetTier.HIGH: 4096,         # paper's 4096-token budget
}


@dataclass(frozen=True)
class InferenceStrategy:
    """One point in the strategy space the paper sweeps."""
    reflection_rounds: int = 0           # 0 | 1 | 3
    feedback: str = "none"               # none | judge | exec
    budget: BudgetTier = BudgetTier.NONE

    @property
    def name(self) -> str:
        if self.budget is not BudgetTier.NONE:
            return f"think_{self.budget.value}"
        s = f"reflect{self.reflection_rounds}"
        if self.feedback != "none":
            s += f"+{self.feedback}"
        return s


def standard_strategies(include_thinking: bool = True
                        ) -> List[InferenceStrategy]:
    """The paper's grid: 0/1/3 reflections (+ low/high budgets on models
    that support built-in reasoning)."""
    out = [InferenceStrategy(0), InferenceStrategy(1), InferenceStrategy(3)]
    if include_thinking:
        out += [InferenceStrategy(0, budget=BudgetTier.LOW),
                InferenceStrategy(0, budget=BudgetTier.HIGH)]
    return out
