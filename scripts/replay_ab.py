#!/usr/bin/env python3
"""Time the paged decode read and each captured serving step's replay
alone, for this checkout and another (for example the parent commit,
unpacked with ``git archive`` into a gitignored directory), in turns:
other, this, this, other.

    python3 scripts/replay_ab.py --other build/parent

Each run is a fresh process that imports that checkout's ``src/`` and this
checkout's ``chip_smoke.py``.  It times the paged decode read as a decode
step makes it, idle batch slot included: the kernel at
reflect_demo_100m's and granite-moe-1b-a400m's decode shapes
(``chip_smoke.make_inputs``: a 128-page table, batch slot 7 idle), plus,
where the checkout has one, the plain-PyTorch fix-up
``attention._unmapped_rows`` that gave idle rows the reference's value
outside the kernel (``chip_smoke.cuda_ms``, 5 x 30 calls, median and
range).  Then it builds both models at full width and depth with seeded
random weights, serves one round of 8 conversations with captured steps
from the paged pool (``chip_smoke.serve``, fp KV), and replays each
captured step shape alone: 5 batches of 20 back-to-back replays timed
with CUDA events, median and range.  Every checkout's kernels are built
before the first run.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import sys
sys.path[:0] = [{root!r} + "/src", {this!r}]
import statistics
import torch
import chip_smoke as cs
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models.registry import get_config
cs.phase_device()
fix = getattr(A, "_unmapped_rows", None)


def spread(xs):
    return (f"{{statistics.median(xs):.4f}} ms "
            f"({{min(xs):.4f}}-{{max(xs):.4f}})")


for name, K, G in (("reflect_demo_100m", 4, 3),
                   ("granite_moe_1b_a400m", 8, 2)):
    q, kp, vp, pt, pos0, _ = cs.make_inputs(3, 8, 1, K, G, 64, 16, 128,
                                            torch.bfloat16, False, "cuda")
    q = q[:, 0].contiguous()
    pool = {{"kp": kp, "vp": vp}}

    def read():
        out = ops.paged_decode_attention(q, kp, vp, pt, pos0)
        return fix(out, pool, pt) if fix is not None else out

    ms = [cs.cuda_ms(read) for _ in range(5)]
    print(f"[ab] {{name}} paged decode read [8, {{K}}, {{G}}, 64], 128 pages, "
          f"slot 7 idle, fix-up outside the kernel {{fix is not None}}: "
          f"{{spread(ms)}}", flush=True)

for arch, seed in (("reflect_demo_100m", 1), ("granite_moe_1b_a400m", 1)):
    model = cs.build_on_card(get_config(arch), 0)
    eng = cs.serve(model, "model", rounds=1, max_new=32, seed=seed,
                   path=("paged_decode", "paged_extend"), aot=True)[0]
    for kind, step in eng._steps.items():
        for shapes, sig in step._sigs.items():
            sig.graph.replay()
            torch.cuda.synchronize()
            ms = []
            for _ in range(5):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                for _ in range(20):
                    sig.graph.replay()
                e.record()
                torch.cuda.synchronize()
                ms.append(s.elapsed_time(e) / 20)
            print(f"[ab] {{arch}} replay {{kind}} "
                  f"[{{eng.scfg.max_batch}}, {{shapes[0][1]}}]: {{spread(ms)}}",
                  flush=True)
    del eng, model
    cs.release()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of another checkout")
    args = ap.parse_args()
    sides = [("other", args.other.resolve()), ("this", ROOT)]
    for _, root in sides:                        # built before any timing
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import cuda_lib; cuda_lib.build()"], cwd=root,
                       env={**os.environ, "PYTHONPATH": str(root / "src")},
                       check=True, timeout=600)
    for label, root in sides + sides[::-1]:
        out = subprocess.run([sys.executable, "-c", RUN.format(
            root=str(root), this=str(ROOT))], cwd=root,
            capture_output=True, text=True, timeout=900)
        print(f"=== {label} ({root}): exit {out.returncode}", flush=True)
        for line in out.stdout.splitlines():
            if line.startswith(("[ab]", "[serve]", "[device]")):
                print(f"{label}: {line}", flush=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
