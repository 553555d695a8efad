"""Token sampling (greedy / temperature), port of ``repro/serving/sampler.py``.

Random draws come from an explicit ``torch.Generator`` on the logits'
device.  They cannot share bits with ``jax.random``: greedy rows are
bit-exact with the reference, temperature rows agree in distribution.
"""
from __future__ import annotations

from typing import Tuple

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _categorical(probs: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row of [N, V] probabilities."""
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def guard(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits, finite)``: every lane (last axis) that holds a NaN or an
    infinity becomes a point mass on its argmax, which counts NaN as the
    largest value as the reference's argmax does, and ``finite`` flags the
    lanes that were left alone.  Greedy and temperature rows then draw the
    token the reference draws from such a lane, and no NaN reaches
    ``torch.multinomial``, whose check on a card is a device-side assert.
    Runs on the logits' device, without a host synchronisation."""
    finite = torch.isfinite(logits).all(dim=-1)
    top = torch.argmax(logits, dim=-1, keepdim=True)
    point = torch.full_like(logits, float("-inf")).scatter_(-1, top, 0.0)
    return torch.where(finite[..., None], logits, point), finite


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """Sample one token per row in a single call.

    logits: [B, V]; temperature: [B] (<= 0 means greedy for that row).
    """
    hot = temperature > 0.0
    scaled = logits.float() / torch.clamp_min(temperature, 1e-6)[:, None]
    # greedy rows draw from a uniform row: their sample is discarded
    scaled = torch.where(hot[:, None], scaled, torch.zeros_like(scaled))
    sampled = _categorical(torch.softmax(scaled, dim=-1), generator)
    return torch.where(hot, sampled, torch.argmax(logits, dim=-1)).to(
        torch.int32)


def verify_batch(logits: torch.Tensor, tokens: torch.Tensor,
                 nv: torch.Tensor, n_draft: torch.Tensor,
                 temperature: torch.Tensor, generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept/reject drafted tokens against one verify step's logits.

    logits: [B, W, V] per-lane next-token distributions from the model's
    all-lane verify step; tokens: [B, W] the lanes that were fed in;
    nv: [B] valid lanes per row; n_draft: [B] of those, how many trailing
    lanes are speculator drafts (0 = plain decode/prefill row);
    temperature: [B] (<= 0 greedy).  Lanes [nv-1-n_draft .. nv-1] of a row
    are its verification window: the last committed token, then drafts.

    Returns ``(n_emit [B], emit [B, W])``: row b commits exactly
    ``emit[b, :n_emit[b]]`` — the longest accepted draft prefix plus one
    token sampled from the model.  Greedy rows accept a draft iff it
    equals the argmax (speculative output bit-identical to plain greedy
    decode); temperature rows accept draft d with probability p(d) and
    resample from p with d's mass removed on rejection, so the emitted
    tokens are distributed as ancestral sampling from p.
    """
    B, W, V = logits.shape
    dev = logits.device
    nv, n_draft, tokens = nv.long(), n_draft.long(), tokens.long()
    lane = torch.arange(W, device=dev)[None, :]                  # [1, W]
    b0 = nv - 1 - n_draft                                        # [B]
    vlane = torch.clamp(b0[:, None] + lane, 0, W - 1)            # [B, W]
    lg = torch.gather(logits, 1, vlane[..., None].expand(B, W, V)).float()
    greedy_g = torch.argmax(lg, dim=-1)                          # [B, W]
    # draft token checked at verification position j sits one lane later
    dtok = torch.gather(tokens, 1, torch.clamp(vlane + 1, 0, W - 1))
    in_window = lane < n_draft[:, None]                          # [B, W]

    hot = temperature > 0.0
    temp = torch.clamp_min(temperature, 1e-6)[:, None, None]
    probs = torch.softmax(lg / temp, dim=-1)                     # [B, W, V]
    u = torch.rand((B, W), generator=generator, device=dev)
    p_draft = torch.gather(probs, 2, dtok[..., None])[..., 0]
    acc = torch.where(hot[:, None], u < p_draft, dtok == greedy_g) & in_window
    # longest accepted prefix: cumprod zeroes everything past the first miss
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)          # [B]
    # residual distribution at the first unaccepted verification lane: p
    # with the rejected draft's mass removed (full p on full acceptance)
    rows = torch.arange(B, device=dev)
    p_end = probs[rows, n_acc]                                   # [B, V]
    d_end = dtok[rows, n_acc]
    rejected = n_acc < n_draft
    zero_d = torch.arange(V, device=dev)[None, :] == d_end[:, None]
    p_end = torch.where(rejected[:, None] & zero_d, 0.0, p_end)
    # greedy rows discard this draw: a uniform row keeps it well defined
    p_end = torch.where(hot[:, None], p_end, torch.ones_like(p_end))
    res_tok = _categorical(p_end, generator)
    emit_temp = torch.where(lane < n_acc[:, None], dtok,
                            torch.where(lane == n_acc[:, None],
                                        res_tok[:, None], 0))
    emit = torch.where(hot[:, None], emit_temp, greedy_g)
    return (n_acc + 1).to(torch.int32), emit.to(torch.int32)
