#!/usr/bin/env python3
"""Loss curves of examples/torch_train_100m.py's run under variants, one
after the other on one card: full-width, full-depth reflect_demo_100m,
200 AdamW steps of 8 x 256 tokens of the task corpus (the example's
``TrainConfig``), bf16 or float32 activations, attention through the
hand-written flash kernels or through autograd of their plain version
(``kernels.ref.flash_attention_ref`` on CUDA tensors), weights from seed
0 or 1.

    python3 scripts/train_variants.py [--steps 200]

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

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.train import build, train  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402


def plain(q, k, v, window=None, lengths=None):
    return ref.flash_attention_ref(q, k, v, window=window, lengths=lengths)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kern = A.ops.flash_attention
    cfg = get_config("reflect_demo_100m")
    fp32 = cfg.replace(dtype="float32")
    for label, c, attn, seed in (("bf16 kernels", cfg, kern, 0),
                                 ("bf16 plain attention", cfg, plain, 0),
                                 ("fp32 kernels", fp32, kern, 0),
                                 ("bf16 kernels seed 1", cfg, kern, 1),
                                 ("fp32 plain attention", fp32, plain, 0)):
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
