"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--steps N --batch B --seq S] [--device cuda|cpu]``.

The port of ``repro/launch/train.py``: builds the architecture (the
reduced config with ``--smoke``, else the full one) with seeded random
weights on ``--device`` (the card unless ``--device cpu``), and trains it
with AdamW on the synthetic task corpus (``data/lm_data.py``) through
``train/loop.py``'s step, printing the loss every 10 steps.  On the card
attention's forward and backward run in the hand-written flash kernels,
and the mamba and RG-LRU scans' in the hand-written scan kernels
(``csrc/mamba_scan_bwd.cu``, ``csrc/rglru_scan_bwd.cu``), so every
registry family (dense, MoE, recurrent, the VLM, whisper) trains there.
The VLM and whisper get zero patch embeddings or frames beside each
batch, as in the reference.  ``--dryrun`` prints the reference's
production plan — the arch, its train overrides and sharding rules
(``launch/dryrun.py``) — and the dry-run command that counts it.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.data.lm_data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models.registry import (ARCH_IDS, EXTRA_ARCH_IDS,
                                         build_model, get_config,
                                         get_smoke_config, side_input)
from repro_torch.train.loop import init_opt_state, make_train_step


def build(cfg, device, seed: int = 0):
    """``cfg``'s model on ``device`` with weights from a seeded generator
    on that device."""
    with torch.device(device):
        model = build_model(cfg)
    return model.init(torch.Generator(device=device).manual_seed(seed))


def stub_inputs(cfg, batch: int, device) -> dict:
    """The inputs the VLM (``patch_embeds``) and whisper (``frames``) take
    beside the tokens (``registry.side_input``), as zeros, as the
    reference's launcher feeds them; nothing for the other families."""
    side = side_input(cfg)
    if side is None:
        return {}
    key, n = side
    return {key: torch.zeros(batch, n, cfg.d_model,
                             dtype=getattr(torch, cfg.dtype), device=device)}


def train(model, cfg, tcfg: TrainConfig, steps: int, batch: int, seq: int,
          log_every: int = 10, log=print, extra=None) -> dict:
    """``steps`` train steps of ``batch`` x ``seq`` tokens of the task
    corpus, with ``extra`` (default ``stub_inputs``) beside each batch.
    Returns the per-step losses and accuracies and, past the first step
    (which builds the kernels on a card), the mean wall time a step in ms
    and tokens a second."""
    state = init_opt_state(model, cfg, tcfg)
    step = make_train_step(model, cfg, tcfg)
    dev = model.embed.device
    if extra is None:
        extra = stub_inputs(cfg, batch, dev)
    losses, accs = [], []
    t1 = None
    for i, b in enumerate(lm_batches(seq, batch, steps)):
        m = step(state, {**b, **extra})
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
        if i == 0:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"step {i:4d} loss {losses[-1]:.3f} acc {accs[-1]:.3f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n = max(steps - 1, 1)
    ms = (time.perf_counter() - t1) / n * 1e3
    return {"losses": losses, "accuracy": accs, "ms_per_step": ms,
            "tokens_per_s": batch * seq / ms * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="reflect_demo_100m",
                    help="an architecture id of models/registry.py "
                    f"({', '.join(ARCH_IDS + EXTRA_ARCH_IDS)})")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dryrun", action="store_true",
                    help="print the production plan, do not execute")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    if args.dryrun:
        from repro_torch.launch.dryrun import TRAIN_OVERRIDES, rules_for
        cfg = get_config(args.arch)
        print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model}")
        print(f"train overrides: {TRAIN_OVERRIDES.get(args.arch, {})}")
        print(f"sharding rules: {rules_for(args.arch, 'train')}")
        print("meta-device dry run: python -m repro_torch.launch.dryrun "
              f"--arch {args.arch} --shape train_4k --mesh both")
        return None
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=10,
                       learning_rate=1e-3, remat=False)
    model = build(cfg, dev, tcfg.seed)
    out = train(model, cfg, tcfg, args.steps, args.batch, args.seq)
    print(f"final loss {np.mean(out['losses'][-5:]):.3f} on {dev} "
          f"({out['ms_per_step']:.1f} ms a step)")
    return out


if __name__ == "__main__":
    main()
