"""End-to-end training example on the PyTorch port: train the reflect-demo
LM on the synthetic reflection-task corpus (the counterpart of
``examples/train_100m.py``).

    PYTHONPATH=src python examples/torch_train_100m.py                 # H100
    PYTHONPATH=src python examples/torch_train_100m.py --smoke --device cpu

The full config is the ~100M-parameter ``reflect_demo_100m`` (12 layers,
d_model 768, bf16 activations, fp32 parameters), 200 steps of 8 x 256 by
default, on the card: attention's forward and backward run in the
hand-written flash kernels.  ``--smoke`` trains the reduced variant.  The
run asserts the reference's "loss should drop markedly" (the mean of the
last 10 losses under 0.7 x the mean of the first 10) and saves a
checkpoint in the reference's format (``repro_torch/train/checkpoint.py``),
by default under the checkout's ``build/``.
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import build, train
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.train import checkpoint as ckpt

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / \
    "reflect_demo.msgpack"


def train_demo(steps=200, batch=8, seq=256, smoke=False, device=None,
               log=print) -> dict:
    """Build and train the demo model; returns ``launch.train.train``'s
    figures with the first and last 10 steps' mean losses, the peak device
    memory (bytes; 0 on the CPU) and the trained model."""
    cfg = (get_smoke_config("reflect_demo_100m") if smoke
           else get_config("reflect_demo_100m"))
    dev = resolve_device(device)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=20,
                       learning_rate=1e-3, remat=False)
    model = build(cfg, dev, tcfg.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"training {cfg.name}: {n_params / 1e6:.1f}M params, {steps} steps "
        f"of {batch}x{seq} on {dev}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = train(model, cfg, tcfg, steps, batch, seq, log_every=20, log=log)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    out.update(first=float(np.mean(out["losses"][:10])),
               last=float(np.mean(out["losses"][-10:])), model=model)
    log(f"loss {out['first']:.2f} -> {out['last']:.2f}; "
        f"{out['ms_per_step']:.2f} ms a step, {out['tokens_per_s']:,.0f} "
        "tok/s")
    return out


def run(steps=200, batch=8, seq=256, smoke=False, device=None,
        ckpt_path=DEFAULT_CKPT, log=print) -> dict:
    """Train, check the loss drop as the reference example does, save."""
    out = train_demo(steps, batch, seq, smoke, device, log)
    assert out["last"] < out["first"] * 0.7, "loss should drop markedly"
    ckpt.save_model(str(ckpt_path), out["model"], step=steps)
    log(f"checkpoint saved to {ckpt_path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.steps, args.batch, args.seq, args.smoke, args.device,
               args.ckpt)


if __name__ == "__main__":
    main()
