#!/usr/bin/env python3
"""Time variants of the bf16 tensor-core flash kernel against the tree's
on one NVIDIA card, in turns within one loop, with SDPA beside them.

    python3 scripts/flash_variants.py

Each variant is ``src/repro_torch/kernels/csrc`` copied into
``build/variants/<name>`` with one constant of ``flash_tc.cuh`` replaced,
built by nvcc with the port's flags and called through ctypes with the
same C signature as the tree's library:

* ``one-warpgroup`` (``kGroups = 1``): 64 query rows a block, so every
  block stages its own K/V tiles (twice the K/V loads from L2);
* ``two-ahead`` (``kAhead = 2``): three stages, two K/V tiles loading
  while one is computed.

The cases are chip_smoke.py's bf16 flash cases (cold L2: a 256 MB write
before each call); each variant's output is held against the plain
version first (2e-2).  Prints one line per case with the median
milliseconds of each; exits non-zero without a CUDA device.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"one-warpgroup": ("kGroups = 2;", "kGroups = 1;"),
            "two-ahead": ("kAhead = 1;", "kAhead = 2;")}
CASES = (("demo", (8, 12, 4, 2048, 64), None, False),
         ("demo", (8, 12, 4, 2048, 64), 48, False),
         ("rg", (4, 16, 1, 4096, 256), 2048, False),
         ("ragged", (8, 12, 4, 1000, 64), None, True))


def build_variant(cuda_lib, name, was, now):
    """The variant's flash_attention entry point, built from a copy."""
    out = ROOT / "build" / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, out)
    header = out / "flash_tc.cuh"
    text = header.read_text()
    if f"constexpr int {was}" not in text:
        raise RuntimeError(f"flash_tc.cuh has no 'constexpr int {was}'")
    header.write_text(text.replace(f"constexpr int {was}",
                                   f"constexpr int {now}"))
    so = out / "flash_attention.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                    str(out / "flash_attention.cu")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).flash_attention
    fn.argtypes = cuda_lib._ARGTYPES["flash_attention"]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, window, lengths):
    B, H, S, hd = q.shape
    K = k.shape[1]
    out = torch.empty_like(q)
    err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             0 if lengths is None else lengths.data_ptr(), out.data_ptr(), B,
             K, H // K, hd, S, window or 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return out


def turns(fns, flush, rounds=10):
    """Median cold-L2 milliseconds of each of fns, called in turns (all
    forwards, then all backwards, a round)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(rounds):
        for i in order + order[::-1]:
            flush()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fns[i]()
            e.record()
            torch.cuda.synchronize()
            times[i].append(s.elapsed_time(e))
    return [float(np.median(t)) for t in times]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import flash_valid
    from repro_torch.kernels import cuda_lib, ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cuda_lib.build(["flash_attention"])
    variants = {n: build_variant(cuda_lib, n, *w)
                for n, w in VARIANTS.items()}
    dev = torch.device("cuda")
    F = torch.nn.functional
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev).zero_
    g = torch.Generator().manual_seed(7)
    for tag, (B, H, K, S, hd), window, ragged in CASES:
        q, k, v = (torch.randn(B, n, S, hd, generator=g).to(dev,
                                                            torch.bfloat16)
                   for n in (H, K, K))
        lengths = (torch.randint(S // 2, S + 1, (B,), generator=g)
                   .to(dev, torch.int32) if ragged else None)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       window=window, lengths=lengths)
        for name, fn in variants.items():
            err = float((call(fn, q, k, v, window, lengths).float()
                         - want).abs().max())
            if err > 2e-2:
                raise AssertionError(f"{name} disagrees: {err:.3e}")
        del want
        if window is None and lengths is None:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            mask = flash_valid(S, window, lengths, dev)[:, None]
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        fns = ([lambda: ops.flash_attention(q, k, v, window=window,
                                            lengths=lengths)]
               + [(lambda fn=fn: call(fn, q, k, v, window, lengths))
                  for fn in variants.values()] + [lib])
        names = ["tree"] + list(variants) + ["SDPA"]
        print(f"[variants] {tag} B={B} H={H} K={K} S={S} hd={hd} "
              f"window={window} lengths={ragged}: " + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in zip(names, turns(fns, flush))),
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
