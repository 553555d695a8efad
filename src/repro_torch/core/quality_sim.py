"""Calibrated quality simulator — the paper's un-reproducible gate.

The paper measured commercial LLMs through Bedrock; offline we cannot.
This module encodes the paper's REPORTED accuracies per (domain, model,
strategy) and the reflection-transition invariants it observed, so the
rest of the stack (engine, accounting, Pareto, statistics) can be
validated end-to-end against the paper's own numbers.

Calibration sources (paper section in brackets):
  * math500      — §4.1, Fig 1, Fig 5/8 (exact quotes for sonnet37 74/86/88,
                   nova_micro 22/71/72 = the +220% headline, haiku 64 base,
                   think-budget high 93 @ $0.0224/27.9 s, low dominated)
  * spider       — §4.2, Fig 2 + Table 1 (no-feedback column is exact)
  * imdb         — §4.3, Fig 3 (nova_micro 85->95, sonnet37 95.7 base...)
  * flores       — §4.4, Fig 4 (METEOR x100; Nova dips at r1, partial
                   recovery at r3; Sonnet improves; sonnet37-high best)
Entries not literally printed in the paper are interpolated from its
figure descriptions and marked est=True.

Transition invariants (Fig 5/8): correct answers are NEVER lost across
rounds ("perfect preservation"); most correction happens in round 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# accuracy (%) at reflection rounds {0, 1, 3}; think budgets where offered
QUALITY: Dict[str, Dict[str, Dict]] = {
    "math500": {
        "sonnet37":     {"r": (74.0, 86.0, 88.0), "think": {"low": 84.0, "high": 93.0}},
        "sonnet35v2":   {"r": (68.0, 68.0, 74.0)},          # Fig 5
        "haiku35":      {"r": (64.0, 67.8, 69.8)},          # ~+9%
        "nova_premier": {"r": (70.0, 73.5, 74.0), "est": True},
        "nova_pro":     {"r": (34.0, 72.0, 74.0)},          # ~+110%
        "nova_lite":    {"r": (30.0, 66.0, 69.0)},          # ~+130%
        "nova_micro":   {"r": (22.0, 71.0, 72.0)},          # +220% headline
        "llama_maverick": {"r": (60.0, 86.0, 86.5), "est": True},
        "mistral_large": {"r": (52.0, 62.0, 64.0), "est": True},
        "mistral_small": {"r": (40.0, 48.0, 50.0), "est": True},
    },
    "spider": {
        # §4.2 percentages; Table 1 no-feedback col gives exact r1/r3
        "sonnet37":     {"r": (69.2, 70.78, 72.69), "think": {"low": 69.8, "high": 70.4}},
        "sonnet35v2":   {"r": (69.0, 65.71, 64.99)},        # -4.8%
        "haiku35":      {"r": (69.3, 67.09, 66.36)},
        "nova_premier": {"r": (72.0, 72.58, 74.98)},
        "nova_pro":     {"r": (73.5, 71.75, 73.67)},
        "nova_lite":    {"r": (72.9, 75.41, 73.05)},        # +1.5 then -1.5
        "nova_micro":   {"r": (68.0, 70.73, 72.14)},        # fastest/cheapest 68%
        "llama_maverick": {"r": (73.0, 74.5, 75.0), "est": True},
        "mistral_large": {"r": (70.0, 72.0, 69.5), "est": True},
        "mistral_small": {"r": (68.5, 67.0, 70.0), "est": True},
    },
    "imdb": {
        "sonnet37":     {"r": (95.7, 96.2, 96.3), "think": {"low": 96.1, "high": 96.2}},
        "sonnet35v2":   {"r": (96.5, 96.6, 96.6)},          # best no-reflection
        "haiku35":      {"r": (93.0, 94.5, 95.0), "est": True},
        "nova_premier": {"r": (95.0, 95.0, 95.1)},          # unaffected
        "nova_pro":     {"r": (94.0, 94.0, 94.0)},          # unaffected
        "nova_lite":    {"r": (91.0, 93.5, 94.0), "est": True},
        "nova_micro":   {"r": (85.0, 95.0, 95.3)},          # §4.3 quote
        "llama_maverick": {"r": (94.5, 94.5, 94.5)},        # unaffected
        "mistral_large": {"r": (93.5, 94.2, 94.5), "est": True},
        "mistral_small": {"r": (92.0, 90.5, 89.5)},         # outlier: degrades
    },
    "flores": {   # METEOR x100
        "sonnet37":     {"r": (58.0, 59.5, 60.0), "think": {"low": 59.0, "high": 61.5}},
        "sonnet35v2":   {"r": (57.5, 58.5, 59.0), "est": True},
        "haiku35":      {"r": (55.0, 56.0, 56.5), "est": True},
        "nova_premier": {"r": (62.0, 62.5, 63.0)},          # only Nova that gains
        "nova_pro":     {"r": (63.0, 60.0, 61.5)},          # dip, partial recovery
        "nova_lite":    {"r": (61.0, 57.5, 59.0)},
        "nova_micro":   {"r": (59.0, 54.0, 56.0)},
        "llama_maverick": {"r": (60.0, 57.0, 56.5)},        # no recovery
        "mistral_large": {"r": (59.5, 61.0, 58.5)},         # gain@1 then degrade
        "mistral_small": {"r": (58.0, 55.5, 55.0)},         # no recovery
    },
}

# Table 1 — Spider accuracy under feedback mechanisms (EXACT paper values)
FEEDBACK_TABLE1: Dict[str, Dict[str, Tuple[float, float]]] = {
    #                 no-feedback        LLM-judge          SQL-exec
    "nova_premier": {"none": (72.58, 74.98), "judge": (73.97, 72.58), "exec": (73.74, 71.14)},
    "nova_pro":     {"none": (71.75, 73.67), "judge": (71.71, 66.96), "exec": (68.62, 73.50)},
    "nova_lite":    {"none": (75.41, 73.05), "judge": (79.57, 74.02), "exec": (72.63, 72.83)},
    "nova_micro":   {"none": (70.73, 72.14), "judge": (77.34, 75.77), "exec": (73.15, 70.41)},
    "sonnet37":     {"none": (70.78, 72.69), "judge": (70.82, 66.78), "exec": (67.20, 73.32)},
    "sonnet35v2":   {"none": (65.71, 64.99), "judge": (67.28, 65.43), "exec": (67.22, 67.33)},
    "haiku35":      {"none": (67.09, 66.36), "judge": (68.16, 68.64), "exec": (68.56, 72.58)},
}

# Table 2 — Zalando localisation technical metrics (EXACT paper values)
DEPLOYMENT_TABLE2 = {
    "french":  {"none": {"bleu": 0.16, "meteor": 0.47, "judge": 0.61},
                "reflect": {"bleu": 0.14, "meteor": 0.42, "judge": 0.62}},
    "spanish": {"none": {"bleu": 0.29, "meteor": 0.61, "judge": 0.49},
                "reflect": {"bleu": 0.29, "meteor": 0.59, "judge": 0.50}},
    "german":  {"none": {"bleu": 0.32, "meteor": 0.61, "judge": 0.38},
                "reflect": {"bleu": 0.33, "meteor": 0.62, "judge": 0.47}},
}

# Table 3 — expert-identified issues (EXACT paper values)
DEPLOYMENT_TABLE3 = {
    "french": (384, 46),    # -88%
    "spanish": (49, 30),    # -39%
    "german": (15, 0),      # -100%
}

MODELS = list(QUALITY["math500"].keys())
DOMAINS = list(QUALITY.keys())

# output-token profile per domain (drives cost/latency): (prompt, output/round)
# math500 out=330 calibrates haiku35@r0 to the paper's quoted $0.0015/7.5s.
TOKEN_PROFILE = {
    "math500": {"prompt": 250, "out": 330},
    # prompt ~1000 tokens per Appendix B.4; output "minimal 100's of
    # tokens" — 320 calibrates the 3-round caching saving to the paper's
    # reported 28% under Bedrock cache pricing.
    "spider": {"prompt": 1000, "out": 320},
    "imdb": {"prompt": 350, "out": 12},
    "flores": {"prompt": 180, "out": 160},
}
REFLECT_PROMPT_TOKENS = 45      # "Please reiterate your answer..." suffix
THINK_TOKENS = {"low": 1024, "high": 4096}          # budget CAPS (§3.2)
# average thinking-token CONSUMPTION under each cap; "high" calibrates
# sonnet37 think-high to the paper's quoted $0.0224 / 27.9 s on Math500.
THINK_CONSUMED = {"low": 400, "high": 1113}


def accuracy_at(domain: str, model: str, rounds: int) -> float:
    r = QUALITY[domain][model]["r"]
    return {0: r[0], 1: r[1], 3: r[2]}[rounds]


def interp_round2(domain: str, model: str) -> float:
    """Round-2 accuracy: most gain in round 1, geometric approach to r3."""
    r0, r1, r3 = QUALITY[domain][model]["r"]
    return r1 + 0.6 * (r3 - r1)


@dataclass
class Trajectory:
    """Per-example correctness across rounds (perfect retention)."""
    correct: np.ndarray        # [n_examples, rounds+1] bool


def simulate_trajectories(domain: str, model: str, n_examples: int = 100,
                          rounds: int = 3, seed: int = 0) -> Trajectory:
    """Sample per-example correctness matching the calibrated marginals
    under the paper's transition invariants:
      * correct stays correct (Fig 5/8 "perfect preservation");
      * incorrect -> correct with the rate implied by consecutive marginals.
    """
    accs = [accuracy_at(domain, model, 0)]
    if rounds >= 1:
        accs.append(accuracy_at(domain, model, 1))
    if rounds >= 2:
        accs.append(interp_round2(domain, model))
    if rounds >= 3:
        accs.append(accuracy_at(domain, model, 3))
    accs = [a / 100.0 for a in accs[:rounds + 1]]

    # For domains where reflection HURTS (acc drops), retention breaks —
    # the paper observed this for translation-like tasks: model revises
    # good answers into bad ones.  We model a drop as correct->incorrect.
    # Transition probabilities use the THEORETICAL marginal chain (not the
    # empirical sample means) so expectations match the calibration
    # exactly and sampling noise does not compound across rounds.
    # Per-(model, domain) seed decorrelates cells of the evaluation grid
    # (crc32, not hash(): PYTHONHASHSEED randomization would make results
    # differ across processes).
    import zlib
    rng = np.random.default_rng(
        [seed, zlib.crc32(model.encode()), zlib.crc32(domain.encode())])
    out = np.zeros((n_examples, len(accs)), bool)
    out[:, 0] = rng.random(n_examples) < accs[0]
    for t in range(1, len(accs)):
        prev, target = accs[t - 1], accs[t]
        if target >= prev:
            p_fix = min(1.0, (target - prev) / max(1 - prev, 1e-9))
            fix = (~out[:, t - 1]) & (rng.random(n_examples) < p_fix)
            out[:, t] = out[:, t - 1] | fix
        else:
            p_break = min(1.0, (prev - target) / max(prev, 1e-9))
            brk = out[:, t - 1] & (rng.random(n_examples) < p_break)
            out[:, t] = out[:, t - 1] & ~brk
    return Trajectory(out)


def transition_counts(traj: Trajectory) -> List[Dict[str, int]]:
    """Sankey data: per round, counts of C->C, C->I, I->C, I->I."""
    out = []
    for t in range(1, traj.correct.shape[1]):
        a, b = traj.correct[:, t - 1], traj.correct[:, t]
        out.append({
            "CC": int((a & b).sum()), "CI": int((a & ~b).sum()),
            "IC": int((~a & b).sum()), "II": int((~a & ~b).sum()),
        })
    return out
