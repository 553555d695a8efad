"""AdamW and Adafactor (factored second moments) over a model's tensors
(port of ``repro/train/optimizer.py``).

The reference's functional updates become in-place ones: ``opt_update``
writes the new parameters into the model's tensors and the new moments
into the state, under ``torch.no_grad()``.  Parameters and gradients are
dicts ``{name: tensor}`` keyed by the port's parameter names.

AdamW, ``global_norm`` and ``lr_schedule`` act elementwise or over all
tensors at once, so the port's per-layer parameters give the reference's
update.  Adafactor does not: the reference stacks a repeated unit's
layers into one leaf (``params["scan"]``), and Adafactor factors a
stacked ``[R, ..., r, c]`` leaf and clips its update by the RMS over all
``R`` repeats at once.  So its state is keyed by reference leaf
(``bridge.reference_groups``): each update stacks the leaf's group,
updates it as the reference does, and writes the slices back.  Without
groups every tensor is its own leaf.

Scalars (step, learning rate, bias corrections, Adafactor's decay) are
computed in float32 as the reference computes them.  AdamW and the clip
run as multi-tensor (``torch._foreach_*``) ops, one launch per step of
the update over all tensors (AdamW: over each group of at most 268 M
elements, which bounds its temporaries), where a loop over 100-odd
parameters would launch each of its dozen operations per tensor from the
host.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.bridge import is_stacked, stacked, unstacked
from repro_torch.configs.base import TrainConfig

Tensors = Dict[str, torch.Tensor]
Groups = Dict[tuple, List[str]]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's float32 scalars."""
    return float(torch.tensor(x, dtype=torch.float32))


def lr_schedule(tcfg: TrainConfig, step: int) -> float:
    """Linear warmup + cosine decay to 10%."""
    s = torch.tensor(step, dtype=torch.float32)
    warm = torch.clamp(s / max(tcfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return float(tcfg.learning_rate * warm * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, float32 (a 0-dim tensor
    on the tensors' device)."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) \
        else list(tensors)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(torch.stack(norms).square().sum())


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns them and their norm before clipping."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    torch._foreach_mul_(list(grads.values()), scale)
    return grads, gnorm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Tensors) -> Dict:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return {"m": zeros, "v": {n: z.clone() for n, z in zeros.items()},
            "step": 0}


FOREACH_ELEMENTS = 1 << 28   # elements of a group of AdamW's tensors


def _groups(params: Tensors) -> List[List[str]]:
    """The parameter names in order, cut into groups of at most
    ``FOREACH_ELEMENTS`` elements (a larger tensor alone): the
    multi-tensor ops of one group make temporaries the size of the group,
    so the update's memory stays bounded (recurrentgemma-9b's 2 B
    embedding and unembedding would otherwise need four temporary copies
    of every parameter at once)."""
    groups, size = [[]], 0
    for name, t in params.items():
        if groups[-1] and size + t.numel() > FOREACH_ELEMENTS:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += t.numel()
    return groups


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: Dict,
                 tcfg: TrainConfig) -> Dict:
    """The reference's per-leaf update as multi-tensor (``_foreach``) ops,
    one call per elementwise step over every tensor of a group
    (``_groups``: one group below 268 M parameters)."""
    step = state["step"] + 1
    lr = lr_schedule(tcfg, step)
    bc1 = _f32(1.0 - _f32(tcfg.beta1) ** _f32(step))
    bc2 = _f32(1.0 - _f32(tcfg.beta2) ** _f32(step))
    for names in _groups(params):
        _adamw_group(names, params, grads, state, tcfg, lr, bc1, bc2)
    state["step"] = step
    return {"lr": lr}


def _adamw_group(names, params, grads, state, tcfg, lr, bc1, bc2) -> None:
    b1, b2, eps = tcfg.beta1, tcfg.beta2, tcfg.eps
    p = [params[n] for n in names]
    pf = [x.float() for x in p]
    g = [grads[n].float() for n in names]
    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - b2))
    u = torch._foreach_div(m, bc1)
    den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(den, eps)
    torch._foreach_div_(u, den)
    torch._foreach_add_(u, torch._foreach_mul(pf, tcfg.weight_decay))
    torch._foreach_copy_(p, torch._foreach_sub(pf, torch._foreach_mul(u, lr)))


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moments, no momentum
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _own_groups(params: Tensors) -> Groups:
    return {(n,): [n] for n in params}


def adafactor_init(params: Tensors, groups: Optional[Groups] = None) -> Dict:
    groups = groups or _own_groups(params)
    slots = {}
    for path, names in groups.items():
        p = params[names[0]]
        shape = ((len(names),) if is_stacked(names) else ()) + tuple(p.shape)
        kw = dict(dtype=torch.float32, device=p.device)
        if _factored(shape):
            slots[path] = {"vr": torch.zeros(shape[:-1], **kw),
                           "vc": torch.zeros(shape[:-2] + shape[-1:], **kw)}
        else:
            slots[path] = {"v": torch.zeros(shape, **kw)}
    return {"slots": slots, "groups": groups, "step": 0}


@torch.no_grad()
def adafactor_update(params: Tensors, grads: Tensors, state: Dict,
                     tcfg: TrainConfig) -> Dict:
    step = state["step"] + 1
    lr = lr_schedule(tcfg, step)
    beta2 = _f32(1.0 - _f32(_f32(step) + 1.0) ** -0.8)
    eps = 1e-30
    for path, names in state["groups"].items():
        slot = state["slots"][path]
        p = stacked(params, names)
        g = stacked(grads, names).float()
        g2 = g.square() + eps
        if "vr" in slot:
            vr = slot["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
            vc = slot["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
            denom = vr.mean(dim=-1, keepdim=True)
            rfac = (vr / torch.clamp_min(denom, eps))[..., None]
            u = g * torch.rsqrt(torch.clamp_min(rfac * vc[..., None, :],
                                                eps))
        else:
            v = slot["v"].mul_(beta2).add_((1 - beta2) * g2)
            u = g * torch.rsqrt(torch.clamp_min(v, eps))
        # update clipping (RMS <= 1) over the whole reference leaf
        rms = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp_min(rms, 1.0)
        u = u + tcfg.weight_decay * p.float()
        new = (p.float() - lr * u).to(p.dtype)
        for name, part in unstacked(new, names).items():
            params[name].copy_(part)
    state["step"] = step
    return {"lr": lr}


# ---------------------------------------------------------------------------

def opt_init(params: Tensors, tcfg: TrainConfig,
             groups: Optional[Groups] = None) -> Dict:
    """Optimizer state for ``params``; ``groups`` (Adafactor only) maps each
    reference leaf to the parameters stacked into it
    (``bridge.reference_groups``)."""
    if tcfg.optimizer == "adafactor":
        return adafactor_init(params, groups)
    return adamw_init(params)


def opt_update(params: Tensors, grads: Tensors, state: Dict,
               tcfg: TrainConfig) -> Dict:
    """One update of ``params`` and ``state`` in place; returns
    ``{"lr": ...}``."""
    if tcfg.optimizer == "adafactor":
        return adafactor_update(params, grads, state, tcfg)
    return adamw_update(params, grads, state, tcfg)
