"""Quickly fit a smoke model to +1 token ramps (a deterministic fixture);
port of ``repro/train/quick_fit.py``.

A randomly initialised LM has near-uniform logits: top-2 argmax gaps are
O(1e-2), so ANY cache perturbation — including int8 KV quantization
error — flips greedy tokens, which says nothing about the quantizer and
everything about the degenerate fixture.  Real checkpoints have O(1)
logit gaps.  This helper restores that property: plain SGD on sequences
``[s, s+1, s+2, ...]`` teaches the model the successor function, after
which greedy continuations of ramp prompts are sharply peaked.

The fits update the model's parameters in place and return the model.
They draw their batches from the same numpy generator in the same order
as the reference, and run on the model's device: on the card the
gradients go through the hand-written flash and scan backward kernels.  SGD in
float32 is not bit-identical across frameworks, so the fixture's contract
is the same as the reference's: the margin, not the weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.train.loop import grads_of, params_of, trainable


MARGIN_ROWS = 256     # probe sequences a forward of ``_ramp_margin``


def ramp_prompt(start: int, n: int) -> list:
    """The prompt family the fitted model continues confidently."""
    return [1] + list(range(start, start + n - 1))


@torch.no_grad()
def _ramp_margin(model, *, probe_len: int = 40,
                 min_context: int = 16) -> float:
    """Worst-case greedy sharpness of the fitted successor function.

    Teacher-forces a battery of ``ramp_prompt``-shaped sequences whose
    starts tile the vocab and returns the MINIMUM logit margin
    (correct-successor logit minus best-other logit) over all rows at
    positions with at least ``min_context`` ramp tokens of context.  If
    every on-ramp context clears margin m, greedy stays on the ramp and
    tolerates any cache perturbation whose logit effect is below m/2.
    The battery runs ``MARGIN_ROWS`` sequences at a time, so that a large
    vocab's logits (falcon-mamba-7b's 65,024: 2,240 rows) stay small.
    """
    vocab = model.cfg.vocab_size
    starts = list(range(3, vocab - probe_len - 1, 29))
    toks = torch.tensor([[1] + list(range(s, s + probe_len - 1))
                         for s in starts], dtype=torch.int32,
                        device=model.embed.device)
    worst = float("inf")
    for i in range(0, len(starts), MARGIN_ROWS):
        rows = toks[i:i + MARGIN_ROWS]
        logits, _ = model.forward({"tokens": rows})
        lg = logits[:, 1:-1].float()                   # predict from ramp toks
        tgt = rows[:, 2:].long()
        hit = torch.gather(lg, -1, tgt[..., None])[..., 0]
        other = lg.scatter(-1, tgt[..., None], -1e30).amax(dim=-1)
        worst = min(worst, float((hit - other)[:, min_context:].min()))
    return worst


def _next_token_loss(model, toks: torch.Tensor) -> torch.Tensor:
    logits, _ = model.forward({"tokens": toks})
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = toks[:, 1:].long()
    return -torch.gather(lp, -1, tgt[..., None]).mean()


def _sgd_step(model, toks: np.ndarray, lr: float) -> None:
    params = params_of(model)
    toks = torch.as_tensor(toks, dtype=torch.int32).to(model.embed.device)
    with trainable(model), torch.enable_grad():
        grads = grads_of(_next_token_loss(model, toks), params)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(p - lr * grads[name])


def quick_fit_ramp(model, *, steps: int = 120, batch: int = 8,
                   seq: int = 48, lr: float = 0.5, seed: int = 0,
                   target_margin: float = 2.0, max_steps: int = None):
    """Fits ``model`` in place by SGD so greedy continues ``ramp_prompt``s.

    Deterministic for a fixed (model, steps, seed) on one device.  After
    the base ``steps`` the fit is extended in deterministic rounds until
    the worst-case deep-context successor margin (``_ramp_margin``)
    clears ``target_margin``, capped at ``max_steps`` (default
    ``6 * steps``), as the reference does.
    """
    vocab = model.cfg.vocab_size
    assert seq + 1 < vocab, "ramp sequences must fit the vocab"
    max_steps = 6 * steps if max_steps is None else max_steps

    def run(n, rng):
        for _ in range(n):
            starts = rng.integers(1, vocab - seq, batch)
            _sgd_step(model, starts[:, None] + np.arange(seq)[None, :], lr)

    rng = np.random.default_rng(seed)
    run(steps, rng)
    done = steps
    round_ = max(steps // 2, 30)
    while done < max_steps and _ramp_margin(model) < target_margin:
        run(min(round_, max_steps - done), rng)
        done += round_
    return model


def reflect_sequence(rng, seq: int, vocab: int) -> list:
    """One reflection-round-shaped training sequence:
    ``[1] question answer [2] [1] question answer`` where the question is
    a ramp and the answer continues it — the round-2 serving pattern
    (prompt quotes the prior draft, restates the question, and the model
    re-derives the same answer).  Trimmed to ``seq`` tokens, so the tail
    usually ends mid-second-answer: exactly the decode frontier the
    speculative benchmark measures."""
    L1 = int(rng.integers(10, 22))
    L2 = max(4, (seq - 2 * L1 - 3 + 1) // 2)
    s = int(rng.integers(3, vocab - (L1 + L2) - 2))
    q = [1] + list(range(s, s + L1))
    a = list(range(s + L1, s + L1 + L2))
    toks = q + a + [2] + q + a
    return toks[:seq]


def quick_fit_reflect(model, *, steps: int = 200, batch: int = 8,
                      seq: int = 96, lr: float = 0.5, seed: int = 0):
    """Fits ``model`` in place on REFLECTION-ROUND sequences (see
    reflect_sequence), so greedy round 2 confidently re-emits the round-1
    answer: the high-overlap regime speculative decoding exploits."""
    vocab = model.cfg.vocab_size
    assert seq < vocab - 2, "reflection sequences must fit the vocab"
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = np.stack([reflect_sequence(rng, seq, vocab)
                         for _ in range(batch)])
        _sgd_step(model, toks, lr)
    return model
