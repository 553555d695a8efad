#!/usr/bin/env python3
"""Where a recurrent model's training step spends the card, and what
``quick_fit_ramp``'s learning rate does to falcon-mamba-7b's full-width
cut, on one card.

    python3 scripts/train_profile.py [--steps 20] [--fit-lrs 0.5 0.1 0.02]

For falcon-mamba-7b at full width and 4 layers and recurrentgemma-9b at
full width and 3 layers (bf16 activations, fp32 parameters, 8 x 256
tokens of the task corpus, AdamW, as ``chip_smoke.py``'s ``[train]``
runs): ``launch/train.py``'s ms a step over ``--steps`` steps, then three
more steps under ``torch.profiler``, whose device time a step is printed
by group (AdamW's and the clip's multi-tensor kernels, the GEMMs, the
hand-written kernels by name, the rest) and by kernel (the largest ten).
Then, for each of ``--fit-lrs``, ``quick_fit_ramp`` at that SGD learning
rate on falcon-mamba-7b's 2-layer fp32 cut: the worst-case ramp margin
before and after, and the fitted model's share of exact top-2 logit ties
on random prompts and mean final hidden norm (``chip_smoke.tie_share``;
a share near 1 means its logits have collapsed).  Prints the card's name
and power limit.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.lm_data import lm_batches  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.launch.train import build, train  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.train.loop import init_opt_state, make_train_step  # noqa
from repro_torch.train.quick_fit import _ramp_margin, quick_fit_ramp  # noqa


# kernel symbols of the flash libraries that do not carry the kernel's name
FLASH_SYMBOLS = (("flash_tc_kernel", "flash_attention"),
                 ("dkdv_kernel", "flash_attention_bwd"),
                 ("dq_kernel", "flash_attention_bwd"),
                 ("delta_kernel", "flash_attention_bwd"))


def group(name: str) -> str:
    if "multi_tensor_apply" in name:
        return "AdamW and clip (multi-tensor)"
    for kernel in cuda_lib.SOURCES:
        if f"{kernel}_kernel" in name or f"{kernel}_sum" in name:
            return kernel
    for symbol, kernel in FLASH_SYMBOLS:
        if symbol in name:
            return kernel
    if "gemm" in name or "nvjet" in name or "cutlass" in name:
        return "GEMM"
    return "other"


def profile_step(arch, n_layers, steps, dev, smi):
    from torch.profiler import ProfilerActivity, profile
    cfg = cs.cut(get_config(arch), n_layers).replace(dtype="bfloat16",
                                                     param_dtype="float32")
    model = build(cfg, dev, seed=0)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=5,
                       learning_rate=1e-3, remat=False)
    out = train(model, cfg, tcfg, steps, 8, 256, log_every=0)
    print(f"[train] {arch}, {n_layers} layers: {out['ms_per_step']:.3f} ms "
          f"a step, {out['tokens_per_s']:.1f} tokens/s over {steps} steps; "
          f"{smi}", flush=True)
    state = init_opt_state(model, cfg, tcfg)
    step = make_train_step(model, cfg, tcfg)
    batches = list(lm_batches(256, 8, 4))
    step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            step(state, b)
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "device_time_total", 0) / 3e3, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0) > 0), reverse=True)
    busy = sum(ms for ms, _ in rows)
    groups = {}
    for ms, key in rows:
        groups[group(key)] = groups.get(group(key), 0.0) + ms
    print(f"[profile] {arch}: device busy {busy:.3f} ms a step (3 steps, "
          f"profiler) against {out['ms_per_step']:.3f} ms of wall; by "
          "group: " + ", ".join(f"{k} {v:.3f} ms ({v / busy:.3f})" for k, v
                                in sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
          flush=True)
    for ms, key in rows[:10]:
        print(f"[profile] {arch}   {ms:8.3f} ms  {key[:100]}", flush=True)
    del model, state, step
    cs.release()


def fit(lr, dev):
    cfg = cs.cut(get_config("falcon_mamba_7b"), 2).replace(
        dtype="float32", param_dtype="float32")
    model = build(cfg, dev, seed=0)
    before = (_ramp_margin(model), cs.tie_share(model, dev))
    t0 = time.perf_counter()
    quick_fit_ramp(model, lr=lr)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    toks = torch.tensor(rng.integers(3, cfg.vocab_size, (8, 300)),
                        dtype=torch.int32, device=dev)
    with torch.no_grad():
        hidden = model.forward({"tokens": toks}, return_hidden=True)[0]
    print(f"[fit] falcon-mamba-7b 2 layers fp32, quick_fit_ramp lr {lr}: "
          f"margin {before[0]:.4f} -> {_ramp_margin(model):.4f} (target "
          f"2.0) in {took:.1f}s; exact top-2 ties on random prompts "
          f"{before[1]:.4f} -> {cs.tie_share(model, dev):.4f}; mean final "
          f"hidden norm {float(hidden.float().norm(dim=-1).mean()):.4f}",
          flush=True)
    del model
    cs.release()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fit-lrs", type=float, nargs="*",
                    default=[0.5, 0.1, 0.02])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("train_profile: needs a CUDA device")
    dev = torch.device("cuda")
    smi = cs.phase_device()
    cuda_lib.build()
    for arch, n_layers, _ in cs.RECURRENT_TRAIN:
        profile_step(arch, n_layers, args.steps, dev, smi)
    for lr in args.fit_lrs:
        fit(lr, dev)


if __name__ == "__main__":
    main()
