"""Text quality metrics: BLEU and METEOR-lite (paper §3.3, §5.1).

Self-contained implementations (no nltk): BLEU-4 with brevity penalty;
METEOR-lite = unigram F-mean with fragmentation penalty (exact-match
alignment — the synonym/stem modules of full METEOR need external
resources, noted as an adaptation).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(candidate: str, reference: str, max_n: int = 4) -> float:
    cand, ref = candidate.split(), reference.split()
    if not cand or not ref:
        return 0.0
    max_n = min(max_n, len(cand), len(ref))   # orders longer than the
    log_p = 0.0                               # sentence carry no signal
    for n in range(1, max_n + 1):
        cg, rg = _ngrams(cand, n), _ngrams(ref, n)
        overlap = sum((cg & rg).values())
        total = max(sum(cg.values()), 1)
        # add-1 smoothing for higher-order n-grams
        p = (overlap + (1.0 if n > 1 else 0.0)) / (total + (1.0 if n > 1 else 0.0))
        if p == 0:
            return 0.0
        log_p += math.log(p) / max_n
    bp = 1.0 if len(cand) > len(ref) else math.exp(1.0 - len(ref) / max(len(cand), 1))
    return bp * math.exp(log_p)


def meteor_lite(candidate: str, reference: str, alpha: float = 0.9,
                beta: float = 3.0, gamma: float = 0.5) -> float:
    cand, ref = candidate.split(), reference.split()
    if not cand or not ref:
        return 0.0
    # greedy left-to-right unigram alignment on exact matches
    ref_used = [False] * len(ref)
    align: List[int] = []
    for i, w in enumerate(cand):
        for j, r in enumerate(ref):
            if not ref_used[j] and r == w:
                ref_used[j] = True
                align.append(j)
                break
        else:
            align.append(-1)
    m = sum(1 for j in align if j >= 0)
    if m == 0:
        return 0.0
    p = m / len(cand)
    r = m / len(ref)
    fmean = p * r / (alpha * p + (1 - alpha) * r)
    # fragmentation: count chunks of contiguous alignment
    chunks, prev = 0, -2
    for j in align:
        if j < 0:
            prev = -2
            continue
        if j != prev + 1:
            chunks += 1
        prev = j
    frag = chunks / m
    penalty = gamma * frag ** beta
    return fmean * (1.0 - penalty)
