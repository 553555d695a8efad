"""Training step construction: loss, gradient accumulation, clipping (port
of ``repro/train/loop.py``).

``make_train_step(model, cfg, tcfg)`` returns ``train_step(opt_state,
batch) -> metrics``, which updates the model's parameters and the
optimizer state in place: the reference's pure ``(params, opt_state,
batch) -> (params, opt_state, metrics)`` with the parameters living in
the ``nn.Module``.  Gradients come from ``torch.autograd`` through
``TransformerLM.forward``: on the card its attention runs the
hand-written flash forward and backward kernels, and its mamba and RG-LRU
scans the hand-written scan forward and backward kernels.  Metrics are 0-dim
tensors on the model's device (and the learning rate a float), under the
reference's keys.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import reference_groups
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.train import optimizer as opt


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 0.0, mask: torch.Tensor = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Mean cross entropy in f32 with optional z-loss regularizer."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    hits = (logits.argmax(dim=-1) == labels).float()
    if mask is not None:
        mask = mask.float()
        denom = torch.clamp_min(mask.sum(), 1.0)
        loss = (nll * mask).sum() / denom
        acc = (hits * mask).sum() / denom
    else:
        loss = nll.mean()
        acc = hits.mean()
    return loss, {"xent": loss, "accuracy": acc}


def chunked_xent(model, hidden: torch.Tensor, labels: torch.Tensor,
                 chunk: int, z_loss: float, mask: torch.Tensor = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Cross entropy without materializing the full [B,S,V] logits.

    The unembed matmul + softmax run one sequence-chunk at a time, each
    chunk recomputed in the backward pass (``torch.utils.checkpoint``), so
    peak memory is O(B * chunk * V) — required for the 256k-vocab
    architectures at 4k sequence length.
    """
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    if mask is None:
        mask = torch.ones(B, S, dtype=torch.float32, device=hidden.device)
    labels, mask = labels.long(), mask.float()

    def one(hc, lc, mc):
        logits = model.logits(hc).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc[..., None])[..., 0]
        nll = lse - ll
        if z_loss:
            nll = nll + z_loss * lse.square()
        hits = (logits.argmax(dim=-1) == lc).float()
        return (nll * mc).sum(), (hits * mc).sum()

    nll_sum = torch.zeros((), device=hidden.device)
    hit_sum = torch.zeros((), device=hidden.device)
    for i in range(0, S, c):
        args = (hidden[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
        a, b = (checkpoint(one, *args, use_reentrant=False)
                if torch.is_grad_enabled() else one(*args))
        nll_sum, hit_sum = nll_sum + a, hit_sum + b
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll_sum / denom
    return loss, {"xent": loss, "accuracy": hit_sum / denom}


def make_loss_fn(model, cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    def loss_fn(batch: Dict) -> Tuple[torch.Tensor, Dict]:
        mask = batch.get("loss_mask")
        if tcfg.loss_chunk:
            hidden, aux = model.forward(batch, remat=tcfg.remat,
                                        return_hidden=True)
            loss, metrics = chunked_xent(model, hidden, batch["labels"],
                                         tcfg.loss_chunk, tcfg.z_loss, mask)
        else:
            logits, aux = model.forward(batch, remat=tcfg.remat)
            loss, metrics = softmax_xent(logits, batch["labels"],
                                         tcfg.z_loss, mask)
        if cfg.num_experts:
            loss = loss + cfg.router_aux_weight * aux
            metrics["router_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def params_of(model) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by name, the dict the optimizer updates."""
    return dict(model.named_parameters())


@contextlib.contextmanager
def trainable(model):
    """Parameters require gradients inside the block (they are created
    without: serving never differentiates), and their flags are restored
    after it."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    model.requires_grad_(True)
    try:
        yield model
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def grads_of(loss: torch.Tensor, params: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """d loss / d each parameter (zeros where the loss does not reach
    one, as JAX gives)."""
    names = list(params)
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g
            for n, g in zip(names, gs)}


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy or torch batch arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``train_step(opt_state, batch) -> metrics``; the optimizer state comes
    from ``init_opt_state(model, cfg, tcfg)``.  The whole batch reaches
    ``model.forward``: whisper's ``frames`` and the VLM's ``patch_embeds``
    with the tokens (microbatches slice them alike)."""
    loss_fn = make_loss_fn(model, cfg, tcfg)

    def train_step(opt_state: Dict, batch: Dict) -> Dict:
        device = model.embed.device
        batch = to_device(batch, device)
        params = params_of(model)
        with trainable(model), torch.enable_grad():
            mb = tcfg.microbatch
            B = batch["tokens"].shape[0]
            if mb and mb < B:
                assert B % mb == 0, (B, mb)
                n = B // mb
                grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=device)
                         for k, p in params.items()}
                loss_acc = torch.zeros((), device=device)
                for i in range(n):
                    part = {k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()}
                    loss, metrics = loss_fn(part)
                    g = grads_of(loss, params)
                    for k in grads:
                        grads[k] = grads[k] + g[k].float() / n
                    loss_acc = loss_acc + loss.detach() / n
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["loss"] = loss_acc
            else:
                loss, metrics = loss_fn(batch)
                grads = grads_of(loss, params)
                metrics = {k: v.detach() for k, v in metrics.items()}
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        metrics.update(opt.opt_update(params, grads, opt_state, tcfg))
        metrics["grad_norm"] = gnorm
        return metrics

    return train_step


def init_opt_state(model, cfg: ModelConfig, tcfg: TrainConfig) -> Dict:
    """``opt.opt_init`` over the model's parameters, Adafactor keyed by the
    reference's stacked leaves."""
    params = params_of(model)
    return opt.opt_init(params, tcfg, reference_groups(params, cfg))
