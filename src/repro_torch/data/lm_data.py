"""LM training pipeline: synthetic task corpus -> packed token batches.

Renders the verifiable task suites (data/tasks.py) as supervised
prompt/answer text, byte-tokenizes, and packs into fixed-length training
batches with next-token labels and loss masking over padding.
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, List

import numpy as np

from repro_torch.data.tasks import (CIPHER, make_math_tasks, make_sentiment_tasks,
                              make_sql_tasks, make_translation_tasks)
from repro_torch.data.tokenizer import ByteTokenizer


def render_examples(n: int, seed: int = 0) -> List[str]:
    rng = random.Random(seed)
    out = []
    for t in make_math_tasks(n // 4, seed):
        out.append(f"{t.prompt()} <answer>{t.answer}</answer>")
    for t in make_sentiment_tasks(n // 4, seed + 1):
        out.append(f"{t.prompt()} <sentiment>{t.label}</sentiment>")
    for t in make_sql_tasks(n // 4, seed + 2):
        out.append(f"{t.prompt()} <SQL>{t.gold_query}</SQL>")
    for t in make_translation_tasks(n - 3 * (n // 4), seed + 3):
        out.append(f"{t.prompt()} <translation>{t.reference}</translation>")
    rng.shuffle(out)
    return out


def lm_batches(seq_len: int, batch_size: int, steps: int, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {tokens, labels, loss_mask} packed batches forever-ish."""
    tok = ByteTokenizer()
    texts = render_examples(max(512, batch_size * 8), seed)
    rng = np.random.default_rng(seed)
    stream: List[int] = []
    i = 0
    for _ in range(steps):
        need = batch_size * (seq_len + 1)
        while len(stream) < need:
            stream.extend(tok.encode(texts[i % len(texts)], eos=True))
            i += 1
        chunk = np.asarray(stream[:need], np.int32).reshape(
            batch_size, seq_len + 1)
        stream = stream[need:]
        yield {
            "tokens": chunk[:, :-1],
            "labels": chunk[:, 1:],
            "loss_mask": (chunk[:, 1:] != tok.pad_id).astype(np.float32),
        }
