"""Production dry run: every (arch x shape) combo on the ``meta`` device.

The port of ``repro/launch/dryrun.py``.  Each combo builds the full
config (``registry.get_config``, with the reference's per-shape and
per-arch overrides) on ``meta`` tensors — shapes and dtypes, no data, no
device memory — and reports:

* ``params_total`` / ``params_active``, as the reference's
  ``param_stats`` (active discounts the unused experts);
* the per-device argument bytes — parameters, optimizer state (train),
  cache (decode) and batch — placed by the reference's rules
  (``rules_for``) on the production mesh shape, 16x16 (``--mesh
  single``) or 2x16x16 (``multi``), summed over each leaf's shard
  (``rules.spec_for``);
* the FLOPs and bytes of one step over the global batch, counted over a
  meta-device run by ``launch/stepcost.py``: a train step's forward and
  backward (the optimizer's update is elementwise and not counted), a
  prefill, or one decode step over a cache of ``seq_len``.

XLA's temporary-buffer size and collective bytes have no counterpart
without a partitioning compiler: the output says so, and ROADMAP A17
keeps them open.

    python -m repro_torch.launch.dryrun --arch whisper_tiny \\
        --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.bridge import reference_groups
from repro_torch.configs.base import (LONG_CONTEXT_WINDOW, SHAPES,
                                      ModelConfig, ShapeConfig, TrainConfig)
from repro_torch.launch import sharding as SH
from repro_torch.launch import stepcost
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.rules import shard_bytes, spec_for
from repro_torch.models.registry import ARCH_IDS, build_model, get_config

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

NOT_COUNTED = ("temp bytes and collectives: not counted (no partitioning "
               "compiler; ROADMAP A17)")

# Combos skipped by design.
SKIPS = {
    ("whisper_tiny", "long_500k"): "enc-dec with 1.5k-frame encoder has no "
                                   "524k-token decode regime",
}

# Training knobs per arch (gradient accumulation, chunked loss, adafactor,
# Megatron-SP activations) that make the 256-chip memory budget closeable.
# microbatch is a multiple of 32 so each (pod,data) shard keeps >=1 row.
TRAIN_OVERRIDES = {
    "qwen3_0_6b": dict(microbatch=64, loss_chunk=512),
    "granite_moe_1b_a400m": dict(microbatch=64, loss_chunk=1024),
    "recurrentgemma_9b": dict(microbatch=32, loss_chunk=256),
    "nemotron_4_340b": dict(optimizer="adafactor", microbatch=64,
                            loss_chunk=128),
    "minitron_4b": dict(microbatch=64, loss_chunk=512),
    "kimi_k2_1t_a32b": dict(optimizer="adafactor", microbatch=64,
                            loss_chunk=256),
    "yi_6b": dict(microbatch=64, loss_chunk=512),
    "internvl2_76b": dict(optimizer="adafactor", microbatch=64,
                          loss_chunk=128),
    "falcon_mamba_7b": dict(microbatch=32, loss_chunk=512),
    "whisper_tiny": dict(microbatch=64, loss_chunk=512),
    # extra pool archs
    "mixtral_8x7b": dict(optimizer="adafactor", microbatch=64,
                         loss_chunk=512),
    "llama3_70b": dict(optimizer="adafactor", microbatch=32, loss_chunk=128),
}

# Model-level overrides applied on top of the shape overrides: Megatron-SP
# on every decoder-only arch (whisper's enc-dec path has no SP hook).
MODEL_OVERRIDES = {
    a: dict(shard_seq_activations=True) for a in (
        "qwen3_0_6b", "granite_moe_1b_a400m", "recurrentgemma_9b",
        "nemotron_4_340b", "minitron_4b", "kimi_k2_1t_a32b", "yi_6b",
        "internvl2_76b", "falcon_mamba_7b", "mixtral_8x7b", "llama3_70b",
    )
}

# FSDP (embed-dim weight sharding over 'data') only where params+optimizer
# cannot fit model-sharded per chip.  Everything else runs pure TP+DP.
FSDP_ARCHS = {"nemotron_4_340b", "kimi_k2_1t_a32b", "internvl2_76b",
              "llama3_70b"}


def rules_for(arch: str, kind: str = "train"):
    from repro_torch.launch.rules import DEFAULT_RULES, decode_rules, tp_rules
    if arch in FSDP_ARCHS:
        # decode has no optimizer state: the row-parallel layout avoids the
        # per-step FSDP weight gather
        return decode_rules() if kind == "decode" else DEFAULT_RULES
    return tp_rules()


def arch_shape_config(arch: str, shape: ShapeConfig) -> ModelConfig:
    """Apply per-shape overrides (sliding window for long-context decode)."""
    cfg = get_config(arch)
    if shape.name == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
        cfg = cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    if arch in MODEL_OVERRIDES and shape.kind == "train":
        cfg = cfg.replace(**MODEL_OVERRIDES[arch])
    return cfg


def param_stats(cfg: ModelConfig, pdefs) -> Tuple[int, int]:
    """(total, active) parameter counts; active discounts unused experts."""
    total = expert = 0
    for d in SH.tree_defs(pdefs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
        if "experts" in d.axes:
            expert += n
    if cfg.num_experts and cfg.experts_per_token:
        frac = cfg.experts_per_token / cfg.num_experts
        active = total - expert + int(expert * frac)
    else:
        active = total
    return total, active


def device_bytes(defs, mesh, rules) -> int:
    """Bytes of one device's shards of every leaf of a defs tree."""
    return sum(shard_bytes(d.shape, d.dtype,
                           spec_for(d.shape, d.axes, mesh, rules), mesh)
               for d in SH.tree_defs(defs))


def batch_defs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The step's inputs beside params and cache, as ``LeafDef``s with a
    leading ``batch`` axis."""
    from repro_torch.models.layers import LeafDef
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)

    def tok(*s):
        return LeafDef(s, torch.int32, ("batch",) + (None,) * (len(s) - 1))

    def emb(n):
        return LeafDef((B, n, cfg.d_model), act, ("batch", None, None))

    if shape.kind == "decode":
        return {"tokens": tok(B, 1), "pos": tok(B)}
    n_tok = S - cfg.num_patches if cfg.arch_type == "vlm" else S
    out = ({"tokens": tok(B, n_tok), "labels": tok(B, n_tok)}
           if shape.kind == "train" else
           {"tokens": tok(B, n_tok), "lengths": tok(B)})
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = emb(cfg.num_patches)
    if cfg.arch_type == "audio":
        out["frames"] = emb(cfg.encoder_seq)
    return out


def _meta(defs) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(d.shape, dtype=d.dtype, device="meta")
            for k, d in defs.items()}


def build_step(arch: str, shape_name: str, mesh):
    """(the step as a thunk over meta tensors, the per-device argument
    bytes by kind, meta: cfg and the parameter counts)."""
    from repro_torch.models import attention as A
    from repro_torch.train.loop import make_loss_fn, trainable
    shape = SHAPES[shape_name]
    cfg = arch_shape_config(arch, shape)
    with torch.device("meta"):
        model = build_model(cfg)
    rules = rules_for(arch, shape.kind)
    p_total, p_active = param_stats(cfg, model)
    args = {"params": device_bytes(model, mesh, rules)}
    bdefs = batch_defs(cfg, shape)
    args["batch"] = device_bytes(bdefs, mesh, rules)
    batch = _meta(bdefs)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        tcfg = TrainConfig(**TRAIN_OVERRIDES.get(arch, {}))
        groups = (reference_groups(dict(model.named_parameters()), cfg)
                  if tcfg.optimizer == "adafactor" else None)
        args["opt_state"] = device_bytes(
            SH.opt_state_defs(model, tcfg.optimizer, groups), mesh, rules)
        loss_fn = make_loss_fn(model, cfg, tcfg)

        def step():
            with trainable(model):
                loss, _ = loss_fn(batch)
                torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
    elif shape.kind == "prefill":
        extra = {k: batch[k] for k in ("patch_embeds", "frames")
                 if k in batch}

        def step():
            model.prefill(batch["tokens"], lengths=batch["lengths"],
                          max_seq=S, **extra)
    else:
        cdefs = model.cache_defs(B, S, seq_shard=True)
        args["cache"] = device_bytes(cdefs, mesh, rules)
        cache = [A.empty_cache(layer, torch.device("meta"))
                 for layer in cdefs]

        def step():
            model.decode_step(cache, batch["tokens"], batch["pos"])

    return step, args, dict(cfg=cfg, params_total=p_total,
                            params_active=p_active)


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               verbose: bool = True) -> Optional[Dict]:
    if (arch, shape_name) in SKIPS:
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {SKIPS[(arch, shape_name)]}")
        return None
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    step, args, meta = build_step(arch, shape_name, mesh)
    t_build = time.time() - t0
    cost = stepcost.count(step)
    t_step = time.time() - t0 - t_build
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh_chips(mesh),
        "build_s": round(t_build, 2),
        "count_s": round(t_step, 2),
        # the whole step, unpartitioned (launch/stepcost.py)
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes"],
        "ops": cost["ops"],
        "kernel_calls": cost["kernel_calls"],
        "params_total": meta["params_total"],
        "params_active": meta["params_active"],
        "memory": {"argument_bytes_per_device": sum(args.values()),
                   **{f"{k}_bytes_per_device": v for k, v in args.items()}},
        "not_counted": NOT_COUNTED,
    }
    if verbose:
        print(f"OK   {arch} x {shape_name} [{result['mesh']}] "
              f"params={meta['params_total']:.4g} "
              f"(active {meta['params_active']:.4g}) "
              f"flops/step={result['flops']:.3e} "
              f"bytes/step={result['bytes_accessed']:.3e} "
              f"args/dev={sum(args.values()) / 2**30:.2f}GiB "
              f"({', '.join(f'{k} {v / 2**30:.2f}' for k, v in args.items())}"
              f") count={t_step:.1f}s; {NOT_COUNTED}")
    return result


def save_result(res: Dict) -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, f"{res['arch']}__{res['shape']}__"
                        f"{res['mesh'].replace('x', '_')}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--save", action="store_true", help="write artifact JSON")
    args = ap.parse_args(argv)

    archs = [a for a in ARCH_IDS if a != "reflect_demo_100m"] \
        if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    res = dryrun_one(arch, shape, multi_pod=mp)
                    if res and args.save:
                        save_result(res)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append((arch, shape, mp, repr(e)[:400]))
                    print(f"FAIL {arch} x {shape} multi_pod={mp}: "
                          f"{repr(e)[:400]}")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
