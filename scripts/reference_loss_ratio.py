#!/usr/bin/env python3
"""The JAX package's training example recipe (examples/train_100m.py:
AdamW, lr 1e-3, warmup 20, 200 steps of 8 x 256 tokens of the task
corpus) at a reduced size, on the CPU: the loss ratio (mean of the last 10
steps over the first 10) that the example asserts is below 0.7.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_loss_ratio.py \\
        --layers 12 --d-model 128 --heads 4 --kv-heads 2

Widths and depth replace those of reflect_demo_100m's smoke config (head
dim d_model / heads, d_ff 4 x d_model); the full config is not run here.
It is the yardstick for the port's ratio on the card (chip_smoke.py
``[train]``, scripts/train_variants.py), which trains the same recipe.
"""
import argparse
import time

import jax
import numpy as np

from repro.configs.base import TrainConfig
from repro.data.lm_data import lm_batches
from repro.models.registry import build_model, get_smoke_config
from repro.train import optimizer as opt
from repro.train.loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    L, D = args.layers, args.d_model
    cfg = get_smoke_config("reflect_demo_100m").replace(
        num_layers=L, block_pattern=("attn",) * L, d_model=D,
        num_heads=args.heads, num_kv_heads=args.kv_heads,
        head_dim=D // args.heads, d_ff=4 * D)
    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=20,
                       learning_rate=1e-3, remat=False)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(tcfg.seed))
    state = opt.opt_init(params, tcfg)
    step = jax.jit(make_train_step(model, cfg, tcfg))
    losses = []
    t0 = time.time()
    for b in lm_batches(256, 8, args.steps):
        params, state, m = step(params, state,
                                {k: jax.numpy.asarray(v)
                                 for k, v in b.items()})
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"layers {L} d_model {D} heads {args.heads}/{args.kv_heads}: "
          f"first10 {first:.3f} last10 {last:.3f} ratio {last / first:.3f}; "
          f"every 20: {[round(x, 2) for x in losses[::20]]} "
          f"({time.time() - t0:.1f}s on the CPU)")


if __name__ == "__main__":
    main()
