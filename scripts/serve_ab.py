#!/usr/bin/env python3
"""Serve reflect_demo_100m and recurrentgemma-9b from the paged pool and
from ring caches, and falcon-mamba-7b from the paged pool, in turns on one
card: this checkout eagerly and (``--captured``) with its serving steps
captured as CUDA graphs, and (``--other``) another checkout of the repo
eagerly — for example the parent commit, unpacked with ``git archive``
into a gitignored directory.

    python3 scripts/serve_ab.py --captured
    python3 scripts/serve_ab.py --other build/parent
    python3 scripts/serve_ab.py --other build/parent --captured

The sides run in turns and then in reverse, so that each side runs once
early and once late: this, captured, captured, this with ``--captured``;
other, this, this, other with ``--other``; other, this, captured,
captured, this, other with both.  Each run is a fresh process that imports
that checkout's ``src/`` and this checkout's ``chip_smoke.py`` (so that
every side is served and profiled by the same code) and does what its
serve phase does for these five serves: full width and depth, seeded
random weights, 3 reflection rounds of 8 conversations
(``chip_smoke.serve``), then one profiled round and the same round again
without the profiler (``chip_smoke.profile_round``; for captured steps
also each graph's replay span).  Its ``[serve]`` and ``[profile]`` lines
(wall and device busy per step, output tok/s, idle share, startup and
capture seconds, peak memory, kernel times) are printed under the run's
label.  Every checkout's kernels are built before
the first run, so no run's wall includes a build.
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
import chip_smoke as cs
from repro_torch.models.registry import get_config
cs.phase_device()
for arch, paths, kw, max_new in (
        ("reflect_demo_100m", (("paged_decode", "paged_extend"),
                               ("decode_attention",)),
         dict(rounds=3, max_new=64, seed=1), 16),
        ("recurrentgemma_9b", (("rglru_scan", "paged_decode", "paged_extend"),
                               ("rglru_scan", "decode_attention")),
         dict(rounds=3, max_new=32, seed=3), 8),
        ("falcon_mamba_7b", (("mamba_scan",),),
         dict(rounds=3, max_new=32, seed=3), 8)):
    model = cs.build_on_card(get_config(arch), 0)
    for path, paged in zip(paths, (True, False)):
        eng, convos = cs.serve(model, "model", path=path, paged=paged,
                               aot={aot}, **kw)[:2]
        cs.profile_round(eng, convos, max_new=max_new)
        del eng
        cs.release()
    del model
    cs.release()
"""

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path,
                    help="root of another checkout, served eagerly")
    ap.add_argument("--captured", action="store_true",
                    help="also serve this checkout with captured steps")
    args = ap.parse_args()
    if args.other is None and not args.captured:
        ap.error("give --other, --captured or both")
    sides = [("this", ROOT, False)]
    if args.other is not None:
        sides.insert(0, ("other", args.other.resolve(), False))
    if args.captured:
        sides.append(("captured", ROOT, True))
    for root in {root for _, root, _ in sides}:   # built before any timing
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import cuda_lib; cuda_lib.build()"], cwd=root,
                       env={**os.environ, "PYTHONPATH": str(root / "src")},
                       check=True, timeout=600)
    for label, root, aot in sides + sides[::-1]:
        out = subprocess.run([sys.executable, "-c", RUN.format(
            root=str(root), this=str(ROOT), aot=aot)], cwd=root,
            capture_output=True, text=True, timeout=1200)
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
