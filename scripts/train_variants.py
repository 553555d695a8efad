#!/usr/bin/env python3
"""Loss curves of examples/torch_train_100m.py's run under variants, one
after the other on one card: full-width, full-depth reflect_demo_100m,
200 AdamW steps of 8 x 256 tokens of the task corpus (the example's
``TrainConfig``), bf16 or float32 activations, attention through the
hand-written flash kernels or through autograd of their plain version
(``kernels.ref.flash_attention_ref`` on CUDA tensors), weights from seed
0 or 1; and two witnesses on seed 0: the forward kernel with the plain
backward (``chip_smoke.kernel_forward_plain_backward``), and plain
attention with P rounded to bf16 before P V as the forward kernel rounds
it (``chip_smoke.plain_bf16_p``).

    python3 scripts/train_variants.py [--steps 200] [--only LABEL ...]

Each variant prints the mean loss of its first and last 10 steps, their
ratio (the reference example asks < 0.7), ms a step and every 20th loss,
so that what the kernels do to training can be told from what the
model and its recipe do.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (kernel_forward_plain_backward,  # noqa: E402
                        plain_attention, plain_bf16_p)
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.train import build, train  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--only", nargs="+", default=None,
                    help="run only the variants of these labels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kern = A.ops.flash_attention
    cfg = get_config("reflect_demo_100m")
    fp32 = cfg.replace(dtype="float32")
    variants = (("bf16 kernels", cfg, kern, 0),
                ("bf16 plain attention", cfg, plain_attention, 0),
                ("fp32 kernels", fp32, kern, 0),
                ("bf16 kernels seed 1", cfg, kern, 1),
                ("fp32 plain attention", fp32, plain_attention, 0),
                ("bf16 kernel forward, plain backward", cfg,
                 kernel_forward_plain_backward, 0),
                ("bf16 plain attention, bf16 P", cfg, plain_bf16_p, 0))
    unknown = set(args.only or ()) - {v[0] for v in variants}
    if unknown:
        raise SystemExit(f"unknown variants: {sorted(unknown)}")
    for label, c, attn, seed in variants:
        if args.only is not None and label not in args.only:
            continue
        A.ops.flash_attention = attn
        tcfg = TrainConfig(total_steps=args.steps, warmup_steps=20,
                           learning_rate=1e-3, remat=False, seed=seed)
        model = build(c, dev, seed)
        t0 = time.time()
        out = train(model, c, tcfg, args.steps, 8, 256, log_every=0)
        losses = out["losses"]
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"[variants] {label}: first10 {first:.4f} last10 {last:.4f} "
              f"ratio {last / first:.4f}; {out['ms_per_step']:.2f} ms a "
              f"step; every 20: {[round(x, 3) for x in losses[::20]]}; "
              f"{time.time() - t0:.1f}s", flush=True)
        del model
        torch.cuda.empty_cache()
    A.ops.flash_attention = kern


if __name__ == "__main__":
    main()
