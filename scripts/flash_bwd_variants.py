#!/usr/bin/env python3
"""Time variants of the bf16 flash backward against the tree's on one
NVIDIA card, in turns within one loop, with SDPA's backward beside them.

    python3 scripts/flash_bwd_variants.py

Each variant is ``src/repro_torch/kernels/csrc`` copied into
``build/bwd_variants/<name>`` with one constant of
``flash_attention_bwd.cu`` replaced, built by nvcc with the port's flags
(its ``-Xptxas -v`` register and spill lines printed) and called through
ctypes with the tree's C signature:

* ``bm32-256`` (``kQueries256 = 32``): query steps of 32 rows in the dk/dv
  kernel at HD 256;
* ``bm32`` (``kQueries = 32``): the same below HD 256;
* ``dq-one-wg`` (``kDqGroups = 1``): dq blocks of 64 query rows.

The tree's library is also called at other head-group counts NS than
``cuda_lib.bwd_splits`` picks.  The cases are chip_smoke.py's timed bf16
backward cases (cold L2: a 256 MB write before each call), each with the
lse of one forward launch; every variant and NS is held against
``flash_attention_bwd_ref`` first (2e-2 of max(|grad|, 1)).  Prints one
line per case with the median milliseconds of each, then the tree's
device time by kernel (``torch.profiler``, warm L2, a mean over 5 calls)
and the host's time to enqueue one call of the port's wrapper
(``flash_attention.flash_attention_bwd``: its checks, allocations and
launches) against one bare ctypes call with its allocations, and by part
(the C launcher alone, the allocations, the stream, the checks; each a
median over 50 calls, the card idle); exits non-zero without a CUDA
device.  (Computing half-HD partials of S^T and dP^T in the two dk/dv
warpgroups and adding them through shared memory, and waiting for every
product alone, were both slower at rg: PERF.md.)
"""
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"bm32-256": ("kQueries256 = 64;", "kQueries256 = 32;"),
            "bm32": ("kQueries = 64;", "kQueries = 32;"),
            "dq-one-wg": ("kDqGroups = 2;", "kDqGroups = 1;")}
# (tag, (B, H, K, S, hd), window, lengths): chip_smoke.py's BWD_CASES
CASES = (("demo", (8, 12, 4, 256, 64), None, None),
         ("rg", (1, 16, 1, 4096, 256), 2048, None),
         ("ragged", (8, 12, 4, 1000, 64), None,
          (0, 1000, 517, 1, 999, 64, 700, 333)))


def build_variant(cuda_lib, name, was, now):
    """The variant's flash_attention_bwd entry point, built from a copy."""
    out = ROOT / "build" / "bwd_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, out)
    src = out / "flash_attention_bwd.cu"
    text = src.read_text()
    if text.count(was) != 1:
        raise RuntimeError(f"flash_attention_bwd.cu has no one '{was}'")
    src.write_text(text.replace(was, now))
    so = out / "flash_attention_bwd.so"
    log = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                          str(so), str(src)], check=True, capture_output=True,
                         text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "tcb" in line or "spill" in line or "registers" in line:
            print(f"[build] {name}: {line.strip()}")
    fn = ctypes.CDLL(str(so)).flash_attention_bwd
    fn.argtypes = cuda_lib._ARGTYPES["flash_attention_bwd"]
    fn.restype = ctypes.c_int
    return fn


def bwd_args(q, k, v, o, do, lse, window, lengths, splits):
    """The C launcher's arguments for one bf16 call, and the four outputs
    it allocates (delta, dq, dk, dv)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    out = (torch.empty(B, H, S, dtype=torch.float32, device=q.device),
           torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    part = (torch.empty(splits, 2, B, K, S, hd, dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    args = (1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), 0 if lengths is None else lengths.data_ptr(),
            lse.data_ptr(), *(t.data_ptr() for t in out),
            0 if part is None else part.data_ptr(), B, K, H // K, hd, S,
            window or 0, 0, splits, torch.cuda.current_stream().cuda_stream)
    return args, out, part


def call(fn, *case):
    args, out, _ = bwd_args(*case)
    err = fn(*args)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return out[1:]


def host_us(fn, calls=50):
    """Median host microseconds to enqueue one call of ``fn``."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * sorted(times)[calls // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_us_by_kernel, flash_valid
    from flash_variants import turns
    from repro_torch.kernels import cuda_lib, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    cuda_lib.build(["flash_attention", "flash_attention_bwd"])
    tree = cuda_lib._function("flash_attention_bwd")
    variants = {n: build_variant(cuda_lib, n, *w)
                for n, w in VARIANTS.items()}
    dev = torch.device("cuda")
    F = torch.nn.functional
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev).zero_
    g = torch.Generator().manual_seed(11)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for tag, (B, H, K, S, hd), window, lengths in CASES:
        mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)
        q, k, v, do = mk(B, H, S, hd), mk(B, K, S, hd), mk(B, K, S, hd), \
            mk(B, H, S, hd)
        ln = (None if lengths is None else
              torch.tensor(lengths, dtype=torch.int32, device=dev))
        o, lse = FA._launch(q, k, v, window, ln, with_lse=True)
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           o.float(), do.float(),
                                           window=window, lengths=ln)
        G = H // K
        chosen = cuda_lib.bwd_splits(B, K, S, G)
        runs = {f"tree NS {chosen}": (tree, chosen)}
        for ns in (1, 2, 3, 4, 8, 16):
            if ns <= G and ns != chosen:
                runs[f"tree NS {ns}"] = (tree, ns)
        for name, fn in variants.items():
            runs[name] = (fn, chosen)
        for name, (fn, ns) in runs.items():
            got = call(fn, q, k, v, o, do, lse, window, ln, ns)
            for x, w in zip(got, want):
                err = float((x.float() - w).abs().max())
                if err > 2e-2 * max(float(w.abs().max()), 1.0):
                    raise AssertionError(f"{tag} {name} disagrees: {err:.3e}")
        del want
        valid = flash_valid(S, window, ln, dev)
        qa, ka, va = (t.detach().requires_grad_(True) for t in (q, k, v))
        if window is None and ln is None:
            out = F.scaled_dot_product_attention(qa, ka, va, is_causal=True,
                                                 enable_gqa=True)
        else:
            out = F.scaled_dot_product_attention(
                qa, ka, va, attn_mask=valid[:, None], enable_gqa=True)
        fns = [(lambda fn=fn, ns=ns: call(fn, q, k, v, o, do, lse, window,
                                          ln, ns))
               for fn, ns in runs.values()]
        fns.append(lambda: torch.autograd.grad(out, (qa, ka, va), do,
                                               retain_graph=True))
        names = list(runs) + ["SDPA backward"]
        print(f"[bwd variants] {tag} B={B} H={H} K={K} S={S} hd={hd} "
              f"window={window} lengths={lengths is not None}: " + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in zip(names, turns(fns, flush))),
              flush=True)
        tree_fn = fns[0]
        print(f"[bwd variants] {tag} tree by kernel (us a call, warm L2): "
              + ", ".join(f"{n} {us:.1f}" for n, us in
                          device_us_by_kernel(tree_fn).items()),
              flush=True)
        wrapper = lambda: flash_attention_bwd(q, k, v, o, do, lse=lse,
                                              window=window, lengths=ln)
        print(f"[bwd variants] {tag} host us to enqueue a call: wrapper "
              f"{host_us(wrapper):.1f}, bare ctypes call "
              f"{host_us(tree_fn):.1f}", flush=True)
        args, out, part = bwd_args(q, k, v, o, do, lse, window, ln, chosen)
        parts = {
            "C launcher alone": lambda: tree(*args),
            "four torch.empty": lambda: [torch.empty_like(t) for t in out],
            "current_stream": lambda: torch.cuda.current_stream(
                q.device).cuda_stream,
            "checks": lambda: FA._check(q, k, v, ln, window,
                                        extra=(o, do))}
        print(f"[bwd variants] {tag} host us by part: " + ", ".join(
            f"{n} {host_us(fn):.1f}" for n, fn in parts.items()),
            flush=True)
        del q, k, v, o, do, lse, qa, ka, va, out, part, valid
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
