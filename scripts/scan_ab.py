#!/usr/bin/env python3
"""Time the mamba scan and the RG-LRU scan of two checkouts of the repo in
turns on one card: ``--other`` (for example the parent commit, unpacked
with ``git archive`` into a gitignored directory) and this one, in the
order other, this, this, other.

    python3 scripts/scan_ab.py --other build/parent

Each run is a fresh process that imports that checkout's ``src/`` and
this checkout's ``chip_smoke.py`` (so that both sides are timed by the
same code), and times that checkout's kernels through their wrappers
(``repro_torch.kernels.ops``) on the same seeded inputs: the mamba scan
at falcon-mamba-7b's mixed and decode steps ([8, 32 or 1, 8192], state
16, bf16 and float32 x) and the RG-LRU scan at recurrentgemma-9b's ([8,
32, 16, 8, 3 or 1, 4096]: mixed steps of a whole chunk or of fewer
tokens, a decode step) and at its full-sequence prefill ([4, 4096,
4096]).  Three times a shape: the cold-L2 mean of 30 calls,
``chip_smoke.cuda_ms`` with its 256 MB write before each call; the mean
of 50 calls replayed in one CUDA graph, the device's own time with the
inputs in L2 and no host launch in the window, as a serve's back-to-back
steps see it; and the profiler's device time of the scan kernel, the
mean of 50 eager calls in a row (inputs in L2), as the serves' profiles
(``chip_smoke.profile_round``) read it.  Each run prints one line per
shape; the last lines give each checkout's two runs side by side.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import json, sys
sys.path[:0] = [{root!r} + "/src", {this!r}]
import torch
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import ops
dev = torch.device("cuda")
flush = torch.empty(64 * 2 ** 20, device=dev).zero_
g = torch.Generator(device=dev).manual_seed(7)
rand = lambda *s: torch.randn(*s, generator=g, device=dev)

def graph_ms(fn, n=50):
    s0 = torch.cuda.Stream()
    s0.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s0):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n

def profiled_ms(fn, n=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0.0)
               for e in prof.key_averages()
               if "scan_kernel" in e.key) / n / 1e3

def both(fn):
    return [cs.cuda_ms(fn, flush=flush), graph_ms(fn), profiled_ms(fn)]

out = {{}}
B, D, N = 8, 8192, 16
A = -torch.exp(0.5 * rand(D, N))
Dsk = rand(D)
for S in (32, 1):
    dt = torch.nn.functional.softplus(rand(B, S, D) - 4.0)
    Bm, Cm, x, h0 = rand(B, S, N), rand(B, S, N), rand(B, S, D), rand(B, D, N)
    for mode, xx in (("bf16", x.bfloat16()), ("f32", x)):
        out[f"mamba S {{S}} x {{mode}}"] = both(
            lambda: ops.mamba_scan(dt, Bm, Cm, xx, A, Dsk, h0))
for B, S, W in ((8, 32, 4096), (8, 16, 4096), (8, 8, 4096), (8, 3, 4096),
                (8, 1, 4096), (4, 4096, 4096)):
    a, b, h0 = torch.sigmoid(rand(B, S, W)), rand(B, S, W), rand(B, W)
    out[f"rglru [{{B}}, {{S}}, {{W}}]"] = both(
        lambda: ops.rglru_scan(a, b, h0))
    del a, b
print("RESULT " + json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    args = ap.parse_args()
    other = args.other.resolve()
    for root in (other, ROOT):  # kernels built before any run is timed
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import cuda_lib; cuda_lib.build(['mamba_scan', "
                        "'rglru_scan'])"], cwd=root,
                       env={**os.environ, "PYTHONPATH": str(root / "src")},
                       check=True, timeout=600)
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        out = subprocess.run([sys.executable, "-c", RUN.format(
            root=str(root), this=str(ROOT))], cwd=root, capture_output=True,
            text=True, timeout=600)
        print(f"=== {label} ({root}): exit {out.returncode}", flush=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], flush=True)
            return 1
        res = json.loads(next(line for line in out.stdout.splitlines()
                              if line.startswith("RESULT "))[7:])
        for shape, (cold, graph, prof) in res.items():
            print(f"{label}: {shape}: {cold:.4f} ms cold-L2, {graph:.4f} ms "
                  f"in a graph, {prof:.4f} ms profiled", flush=True)
        runs.append((label, res))
    for i, kind in enumerate(("cold-L2", "graph", "profiled")):
        for shape in runs[0][1]:
            cols = "  ".join(f"{label} {res[shape][i]:.4f}"
                             for label, res in runs)
            print(f"[scan_ab] {kind} {shape}: {cols} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
