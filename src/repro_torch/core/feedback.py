"""Feedback mechanisms for self-reflection rounds (paper §4.5, Table 1).

Three providers, matching the paper's comparison:
  * NoFeedback        — bare "reiterate your answer" reflection;
  * ExecutionFeedback — REALLY executes the candidate SQL against the
                        task's tables and feeds back results/errors;
  * LLMJudgeFeedback  — a second model judges CORRECT/INCORRECT; backed
                        either by a real Engine or a calibrated verdict
                        sampler (judge_accuracy).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.data.tasks import run_sql


class FeedbackProvider:
    name = "none"

    def feedback(self, task: Any, response: str) -> str:
        return ""


class NoFeedback(FeedbackProvider):
    name = "none"


class ExecutionFeedback(FeedbackProvider):
    """SQL execution feedback (paper: 'output of SQL query execution')."""
    name = "exec"

    def feedback(self, task: Any, response: str) -> str:
        extract = getattr(task, "extract", None)
        tables = getattr(task, "tables", None)
        if extract is None or tables is None:
            return ""
        q = extract(response)
        if q is None:
            return "Execution feedback: no <SQL> block found in the response."
        try:
            rows = run_sql(q, tables)
        except ValueError as e:
            return f"Execution feedback: query failed with error: {e}"
        head = rows[:5]
        return (f"Execution feedback: query returned {len(rows)} row(s); "
                f"first rows: {head}")


class LLMJudgeFeedback(FeedbackProvider):
    """Binary CORRECT/INCORRECT + justification (paper Appendix A.2).

    ``judge_fn(prompt) -> str`` may be a real engine call; when absent,
    the verdict is sampled with ``judge_accuracy`` against the task's own
    verifier — modelling an imperfect Nova-Pro-class judge.
    """
    name = "judge"

    def __init__(self, judge_fn: Optional[Callable[[str], str]] = None,
                 judge_accuracy: float = 0.85, seed: int = 0):
        self.judge_fn = judge_fn
        self.judge_accuracy = judge_accuracy
        self.rng = random.Random(seed)

    def feedback(self, task: Any, response: str) -> str:
        if self.judge_fn is not None:
            prompt = (f"Review this Q/A. Question: {task.prompt()} "
                      f"Answer: {response}. Reply CORRECT or INCORRECT.")
            return f"Judge feedback: {self.judge_fn(prompt)}"
        truth = bool(task.verify(response))
        verdict = truth if self.rng.random() < self.judge_accuracy else not truth
        return ("Judge feedback: CORRECT — the answer addresses the question."
                if verdict else
                "Judge feedback: INCORRECT — re-examine your reasoning.")


def get_provider(name: str, **kw) -> FeedbackProvider:
    return {"none": NoFeedback, "exec": ExecutionFeedback,
            "judge": LLMJudgeFeedback}[name](**kw) if name != "none" else NoFeedback()
