"""Cost & latency accounting (paper §3.2, §4, Appendix B.4).

Two pricing sources:
  * PAPER_PRICES — Bedrock on-demand $/1k tokens as of 02/05/2025 for the
    10 commercial models the paper benchmarks (used to reproduce the
    paper's Pareto frontiers and the 28% prompt-caching saving);
  * roofline_cost — $/step for OUR architectures, derived from roofline
    terms x a $/card-hour ``rate`` that the caller supplies: there is no
    measured dollar rate for the card, so none is assumed.

``roofline_step_seconds`` defaults to the data-sheet peaks of one NVIDIA
H100 SXM (989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3); on one card
there is no collective term (``link_bw`` is infinite unless given).
PAPER_PRICES and PAPER_LATENCY are the paper's Bedrock API figures, not
hardware numbers.

Cache pricing follows Bedrock semantics: cache reads at 10% of the input
price; cache writes billed at the input price (+25% premium on Anthropic
models).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.serving.request import TokenUsage

CACHE_READ_DISCOUNT = 0.1
ANTHROPIC_CACHE_WRITE_PREMIUM = 1.25

# $/1k tokens (input, output), Bedrock on-demand, 02/05/2025.
PAPER_PRICES: Dict[str, Dict] = {
    "sonnet37":     {"in": 0.003,    "out": 0.015,   "anthropic": True},
    "sonnet35v2":   {"in": 0.003,    "out": 0.015,   "anthropic": True},
    "haiku35":      {"in": 0.0008,   "out": 0.004,   "anthropic": True},
    "nova_premier": {"in": 0.0025,   "out": 0.0125,  "anthropic": False},
    "nova_pro":     {"in": 0.0008,   "out": 0.0032,  "anthropic": False},
    "nova_lite":    {"in": 0.00006,  "out": 0.00024, "anthropic": False},
    "nova_micro":   {"in": 0.000035, "out": 0.00014, "anthropic": False},
    "llama_maverick": {"in": 0.00024, "out": 0.00097, "anthropic": False},
    "mistral_large": {"in": 0.004,   "out": 0.012,   "anthropic": False},
    "mistral_small": {"in": 0.001,   "out": 0.003,   "anthropic": False},
}

# Latency model per commercial model: time-to-first-token per 1k prompt
# tokens + steady decode rate.  Calibrated to the latency ranges quoted in
# the paper's Pareto figures (e.g. Haiku 3.5 no-reflection ~7.5 s on
# Math500; Sonnet 3.7 high budget ~27.9 s).
PAPER_LATENCY: Dict[str, Dict] = {
    "sonnet37":     {"ttft_per_1k": 0.90, "tok_per_s": 52.0},
    "sonnet35v2":   {"ttft_per_1k": 0.85, "tok_per_s": 42.0},
    "haiku35":      {"ttft_per_1k": 0.55, "tok_per_s": 47.0},
    "nova_premier": {"ttft_per_1k": 0.80, "tok_per_s": 45.0},
    "nova_pro":     {"ttft_per_1k": 0.45, "tok_per_s": 70.0},
    "nova_lite":    {"ttft_per_1k": 0.30, "tok_per_s": 110.0},
    "nova_micro":   {"ttft_per_1k": 0.20, "tok_per_s": 160.0},
    "llama_maverick": {"ttft_per_1k": 0.40, "tok_per_s": 85.0},
    "mistral_large": {"ttft_per_1k": 0.70, "tok_per_s": 45.0},
    "mistral_small": {"ttft_per_1k": 0.35, "tok_per_s": 90.0},
}


@dataclass
class CostModel:
    price_in: float                     # $/1k tokens
    price_out: float
    anthropic: bool = False
    cache_read_discount: float = CACHE_READ_DISCOUNT

    @classmethod
    def for_model(cls, name: str) -> "CostModel":
        p = PAPER_PRICES[name]
        return cls(p["in"], p["out"], p["anthropic"])

    def cost(self, usage: TokenUsage, prompt_caching: bool = True) -> float:
        """Dollar cost of a request under Bedrock billing."""
        if not prompt_caching:
            fresh = usage.input_tokens + usage.cache_read_tokens
            return (fresh * self.price_in
                    + usage.output_tokens * self.price_out) / 1000.0
        write_mult = (ANTHROPIC_CACHE_WRITE_PREMIUM if self.anthropic else 1.0)
        # cache-written tokens are billed at the (premium) input price;
        # input tokens NOT written to cache are billed at the plain price.
        plain_in = max(0, usage.input_tokens - usage.cache_write_tokens)
        return (plain_in * self.price_in
                + usage.cache_write_tokens * self.price_in * write_mult
                + usage.cache_read_tokens * self.price_in * self.cache_read_discount
                + usage.output_tokens * self.price_out) / 1000.0


@dataclass
class LatencyModel:
    ttft_per_1k: float                  # s per 1k prompt tokens (prefill)
    tok_per_s: float                    # decode rate
    cache_read_per_1k: float = 0.05     # near-free re-attach of cached KV

    @classmethod
    def for_model(cls, name: str) -> "LatencyModel":
        p = PAPER_LATENCY[name]
        return cls(p["ttft_per_1k"], p["tok_per_s"])

    def latency(self, usage: TokenUsage) -> float:
        return (usage.input_tokens / 1000.0 * self.ttft_per_1k
                + usage.cache_read_tokens / 1000.0 * self.cache_read_per_1k
                + usage.output_tokens / self.tok_per_s)


def roofline_step_seconds(flops_per_dev: float, bytes_per_dev: float,
                          collective_bytes: float,
                          peak_flops: float = 989e12,
                          hbm_bw: float = 3.35e12,
                          link_bw: float = math.inf) -> Dict[str, float]:
    """The three §Roofline terms (seconds) + dominant bottleneck."""
    terms = {
        "compute_s": flops_per_dev / peak_flops,
        "memory_s": bytes_per_dev / hbm_bw,
        "collective_s": collective_bytes / link_bw,
    }
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    terms["step_s"] = max(terms["compute_s"], terms["memory_s"],
                          terms["collective_s"])
    return terms


def roofline_cost(step_s: float, chips: int, rate: float) -> float:
    return step_s * chips * rate / 3600.0
