#!/usr/bin/env python3
"""Where a serve's host time goes: cProfile over the rounds of
``chip_smoke.serve`` on one card, eagerly or with captured steps.

    python3 scripts/host_profile.py
    python3 scripts/host_profile.py --captured --arch falcon_mamba_7b

For each model (full width and depth, seeded random weights, served from
the paged pool): one short round first (kernel builds, cuBLAS set-up and
the weights' cast copies happen there), then 3 reflection rounds of 8
conversations under ``cProfile``, whose top functions by own time and by
cumulative time are printed.  Time a function spends waiting for the card
(a pageable host-to-device copy or ``.cpu()`` after a replay) counts as
its own time, so a wait stands where the host first needs the device.
"""
import argparse
import cProfile
import io
import pstats
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = {"reflect_demo_100m": (("paged_decode", "paged_extend"), 64, 1),
          "recurrentgemma_9b": (("rglru_scan",), 32, 3),
          "falcon_mamba_7b": (("mamba_scan",), 32, 3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", choices=sorted(MODELS),
                    help="model to serve (repeatable; default all three)")
    ap.add_argument("--captured", action="store_true",
                    help="capture the serving steps (aot_warmup)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.models.registry import get_config

    cs.phase_device()
    for arch in args.arch or list(MODELS):
        path, max_new, seed = MODELS[arch]
        model = cs.build_on_card(get_config(arch), 0)
        cs.serve(model, "model", 1, max_new, seed, path, aot=args.captured)
        cs.release()
        prof = cProfile.Profile()
        prof.enable()
        eng = cs.serve(model, "model", 3, max_new, seed, path,
                       aot=args.captured)[0]
        prof.disable()
        for key in ("tottime", "cumulative"):
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(key).print_stats(
                args.top)
            print(f"[host] {arch} {'captured' if args.captured else 'eager'}"
                  f", top {args.top} by {key}:")
            for line in out.getvalue().splitlines():
                if line.strip() and not line.startswith(("Ordered",
                                                          "   List")):
                    print(f"[host] {line}")
        del eng, model
        cs.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
