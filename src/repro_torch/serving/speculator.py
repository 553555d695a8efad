"""Draft-free (self-)speculative drafting: prompt-lookup n-gram matching.

Reflection traffic is the best case for draft-model-free speculation:
"First Try Matters" (arXiv:2510.08308) measures that revision rounds
mostly *confirm and reuse* the previous answer, so the tokens a round-2
request is about to emit usually already exist verbatim inside its own
context — the prompt quotes the prior draft.  The drafter therefore
needs no model at all: match the current suffix n-gram against earlier
positions of the request's context and propose the tokens that followed
the most recent match (prompt-lookup decoding).

The corpus searched is ``spec_context + prompt + output``:

  * ``output`` ends at the last committed token (the one about to be fed
    to the model), so the suffix being matched is exactly the model's
    current decode frontier;
  * ``prompt`` contains the quoted prior-round draft for reflection
    rounds — the high-overlap region;
  * ``Request.spec_context`` lets the reflection controller prepend
    PRIOR-ROUND raw drafts that are not part of the model context (e.g.
    when conversation text was truncated or detokenization is lossy) —
    matches found there propose continuations just as well, because the
    drafter only ever *proposes*; the verify step is what decides.

Proposals are verified by the engine's batched multi-token verify step
(serving/engine.py); a wrong proposal costs one extra masked lane, never
a wrong token.  The drafter is pure host-side numpy — O(n-gram tries x
corpus) per call with vectorized matching — and stateless, so preemption
replay and COW fan-out need no drafter bookkeeping.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class NGramSpeculator:
    """Prompt-lookup drafter (Saxena-style n-gram matching).

    ``ngram_max`` down to ``ngram_min`` suffix lengths are tried longest
    first; the MOST RECENT earlier occurrence wins (recency tracks the
    revision the model is currently paraphrasing).
    """

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        assert 1 <= ngram_min <= ngram_max
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.stats = {"proposals": 0, "empty": 0}

    def propose(self, corpus: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` continuation tokens for the suffix of ``corpus``.

        Returns [] when no suffix n-gram recurs earlier in the corpus
        (the engine then falls back to plain one-token decode for that
        row — speculation is strictly opportunistic).
        """
        if k <= 0 or len(corpus) < self.ngram_min + 1:
            self.stats["empty"] += 1
            return []
        arr = np.asarray(corpus, dtype=np.int64)
        L = arr.shape[0]
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            pattern = arr[L - n:]
            # candidate start positions of earlier occurrences: the match
            # must END strictly before the final position so at least one
            # continuation token exists
            windows = np.lib.stride_tricks.sliding_window_view(
                arr[:L - 1], n)                       # [L-n, n]
            hits = np.nonzero((windows == pattern[None, :]).all(axis=1))[0]
            if hits.size == 0:
                continue
            start = int(hits[-1])                     # most recent match
            cont = arr[start + n:start + n + k]
            if cont.size:
                self.stats["proposals"] += 1
                return [int(t) for t in cont]
        self.stats["empty"] += 1
        return []


def draft_corpus(prompt: Sequence[int], output: Sequence[int],
                 spec_context: Optional[Sequence[int]] = None) -> List[int]:
    """The lookup corpus for one request (see module docstring)."""
    ctx = list(spec_context) if spec_context else []
    return ctx + list(prompt) + list(output)


def external_draft_proposal(draft: Sequence[int], output: Sequence[int],
                            k: int) -> Optional[List[int]]:
    """Positional drafting from another model's committed output.

    The cascade's two-model speculative decode (docs/ARCHITECTURE.md):
    ``draft`` is the SMALL tier's answer, ``output`` the large tier's
    committed tokens so far.  While the committed output is still a
    verbatim prefix of the draft, the next ``k`` draft tokens are the
    proposal — no n-gram search needed, the small model already decoded
    this exact continuation.  Returns None once the large model has
    diverged from (or consumed) the draft; the engine then falls back to
    n-gram lookup for the rest of the request.  Like every proposal, the
    result is only ever fed to the verify step — acceptance is decided
    by the LARGE model's logits, which is what makes the greedy output
    bit-identical to large-alone decoding (tests/test_cascade.py).
    """
    m = len(output)
    if m >= len(draft) or list(output) != list(draft[:m]):
        return None
    cont = list(draft[m:m + k])
    return cont if cont else None
