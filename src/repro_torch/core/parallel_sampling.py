"""Parallel sampling + majority voting (best-of-N) — the paper's §6
future-work item, implemented as a first-class strategy so it composes
with the Pareto machinery against self-reflection and budget tuning.

Engine path: N temperature-sampled completions per prompt (batched in
one continuous-batching engine pass), answers extracted and
majority-voted.  Simulated path: the vote accuracy follows the binomial
majority model over the calibrated per-sample accuracy, with cost/latency
= N parallel samples (latency amortized: max over N ~ single decode if
slots are free).
"""
from __future__ import annotations

import math
import re
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import quality_sim as QS
from repro_torch.core.accounting import CostModel, LatencyModel
from repro_torch.serving.request import Request, TokenUsage


def majority_vote(answers: List[Optional[str]]) -> Optional[str]:
    votes = Counter(a for a in answers if a is not None)
    if not votes:
        return None
    return votes.most_common(1)[0][0]


def majority_accuracy(p: float, n: int) -> float:
    """P(majority of n iid samples is correct); ties broken uniformly.

    Standard binomial-majority model (each sample independently correct
    w.p. p and incorrect answers assumed distinct enough not to collude —
    the optimistic-but-standard self-consistency assumption)."""
    if n == 1:
        return p
    total = 0.0
    for k in range(n + 1):
        prob = math.comb(n, k) * p ** k * (1 - p) ** (n - k)
        if 2 * k > n:
            total += prob
        elif 2 * k == n:
            total += 0.5 * prob
    return total


def run_best_of_n(engine, tokenizer, task, n: int = 5,
                  temperature: float = 0.7, max_new_tokens: int = 64,
                  extract: Optional[Callable[[str], Optional[str]]] = None
                  ) -> Dict:
    """Best-of-N through the real engine (one batched pass)."""
    prompt = tokenizer.encode(task.prompt())
    reqs = [Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                    temperature=temperature, eos_id=tokenizer.eos_id,
                    conversation_id=f"bon-{task_id(task)}")
            for _ in range(n)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    texts = [tokenizer.decode([t for t in r.output
                               if t != tokenizer.eos_id]) for r in reqs]
    ex = extract or default_extract
    answer = majority_vote([ex(t) for t in texts])
    usage = TokenUsage()
    for r in reqs:
        usage += r.usage
    return {"answer": answer, "texts": texts, "usage": usage,
            "correct": bool(answer is not None
                            and task.verify(wrap_answer(answer)))}


def task_id(task) -> int:
    return id(task)


def default_extract(text: str) -> Optional[str]:
    m = re.findall(r"<answer>\s*(.*?)\s*</answer>", text, re.S)
    return m[-1] if m else None


def wrap_answer(ans: str) -> str:
    return f"<answer>{ans}</answer>"


def evaluate_best_of_n(model_name: str, domain: str, n: int,
                       n_examples: int = 400, seed: int = 0) -> Dict:
    """Simulated grid cell for best-of-N (parallel to
    reflection.evaluate_strategy): accuracy via the binomial-majority
    model over the calibrated base accuracy; cost = N samples; latency =
    one prefill + one decode stream (samples run in parallel slots)."""
    p = QS.accuracy_at(domain, model_name, 0) / 100.0
    acc = majority_accuracy(p, n) * 100.0
    prof = QS.TOKEN_PROFILE[domain]
    cm = CostModel.for_model(model_name)
    lm = LatencyModel.for_model(model_name)
    # N samples share the cached prompt after the first (prompt caching)
    usage = TokenUsage(input_tokens=prof["prompt"],
                       cache_read_tokens=prof["prompt"] * (n - 1),
                       cache_write_tokens=prof["prompt"],
                       output_tokens=prof["out"] * n)
    one = TokenUsage(input_tokens=prof["prompt"],
                     output_tokens=prof["out"])
    return {"accuracy": acc,
            "cost_usd": cm.cost(usage),
            "latency_s": lm.latency(one)}   # parallel slots: 1-sample time
