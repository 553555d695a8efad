#!/usr/bin/env python3
"""Serve reflect_demo_100m and recurrentgemma-9b from the paged pool with
two checkouts of the repo in turns on one card: ``--other`` (for example
the parent commit, unpacked with ``git archive`` into a gitignored
directory) and this one, in the order other, this, this, other.

    python3 scripts/serve_ab.py --other build/parent

Each run is a fresh process that imports that checkout's ``chip_smoke.py``
and ``src/`` and does what its serve phase does for these two models:
full width and depth, seeded random weights, 3 reflection rounds of 8
conversations (``chip_smoke.serve``), then one profiled round and the same
round again without the profiler (``chip_smoke.profile_round``).  Its
``[serve]`` and ``[profile]`` lines (wall and device busy per step, output
tok/s, idle share, kernel times) are printed under the run's label.  Both
checkouts' kernels are built before the first run, so no run's wall
includes a build.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as cs
from repro_torch.models.registry import get_config
cs.phase_device()
for arch, kw, max_new in (
        ("reflect_demo_100m", dict(rounds=3, max_new=64, seed=1), 16),
        ("recurrentgemma_9b", dict(rounds=3, max_new=32, seed=3), 8)):
    model = cs.build_on_card(get_config(arch), 0)
    eng, convos, _ = cs.serve(model, "model",
                              path=("paged_decode", "paged_extend"), **kw)
    cs.profile_round(eng, convos, max_new=max_new)
    del eng, model
    cs.release()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    args = ap.parse_args()
    other = args.other.resolve()
    for root in (other, ROOT):  # kernels built before any run is timed
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import cuda_lib; cuda_lib.build()"], cwd=root,
                       env={**os.environ, "PYTHONPATH": str(root / "src")},
                       check=True, timeout=600)
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        out = subprocess.run([sys.executable, "-c", RUN.format(
            root=str(root))], cwd=root, capture_output=True, text=True,
            timeout=1200)
        print(f"=== {label} ({root}): exit {out.returncode}", flush=True)
        for line in out.stdout.splitlines():
            if line.startswith(("[serve]", "[profile]", "[device]")):
                print(f"{label}: {line}", flush=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
