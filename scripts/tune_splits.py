#!/usr/bin/env python3
"""Sweep the split count of the three split walks (paged decode, paged
extend, ring decode) on one CUDA card and write the winners into the
tuning table (``repro_torch/kernels/tuning.py``):

    python3 scripts/tune_splits.py [--out PATH]

Shapes are the ones ``chip_smoke.py`` phase 3 times, the serves' (batch
8, 128-page tables of 16 slots, rings of 2048): paged decode and extend
(Sx 5 and 32) at reflect_demo_100m's K 4 G 3 hd 64, granite-moe's K 8
G 2, recurrentgemma-9b's K 1 G 16 hd 256 (window 2048, extend Sx 32);
ring decode at the demo's, granite's and recurrentgemma's; each in the
modes phase 3 times (float32, bfloat16, int8, int8 with bfloat16 q; int8
with bfloat16 q not at recurrentgemma's).  Each candidate count runs in
turns with the heuristic's (heuristic, candidate, candidate, heuristic;
``chip_smoke.cuda_ms``, cold L2, 30 calls a reading), over two passes of
the whole grid.  Shapes that share a table key (the wrapper's
dims, bucketed) are decided together: a count is kept for a key only
where, in every (shape, mode) of that key, its median beats the
heuristic's by more than the larger spread (max - min) of the two; of
those, the count whose bfloat16 medians (the serves' dtype) add up to the
least.  A key where the heuristic wins gets no entry.  Each entry records
``us`` and ``heuristic_us`` (the key's first bfloat16 case in CASES'
order), every case's pair (``by_case``), the spread, the roofline bound
of a full table (``model_us``), the card's name and power limit.  The
card's earlier entries for these kernels are dropped first.
"""
import argparse
import json
import re
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda_lib, ops, tuning  # noqa: E402

MODES = (("float32", torch.float32, False),
         ("bfloat16", torch.bfloat16, False),
         ("int8", torch.float32, True),
         ("int8+bf16", torch.bfloat16, True))
# (tag, kernel, (B, K, G, hd), Sx, window, modes)
CASES = (
    ("demo", "paged_decode", (8, 4, 3, 64), 1, None, MODES),
    ("demo", "paged_extend", (8, 4, 3, 64), 5, None, MODES),
    ("demo", "paged_extend", (8, 4, 3, 64), 32, None, MODES),
    ("granite", "paged_decode", (8, 8, 2, 64), 1, None, MODES),
    ("granite", "paged_extend", (8, 8, 2, 64), 5, None, MODES),
    ("granite", "paged_extend", (8, 8, 2, 64), 32, None, MODES),
    ("rg", "paged_decode", (8, 1, 16, 256), 1, 2048, MODES[:3]),
    ("rg", "paged_extend", (8, 1, 16, 256), 32, 2048, MODES[:3]),
    ("demo", "decode", (8, 4, 3, 64), 1, None, MODES),
    ("granite", "decode", (8, 8, 2, 64), 1, None, MODES),
    ("rg", "decode", (8, 1, 16, 256), 1, 2048, MODES[:3]),
)
GRID = (1, 2, 3, 4, 6, 9, 13, 18, 25, 33, 50, 64)
PASSES = 2
PS, NP, C = 16, 128, 2048


def call(kernel, shape, Sx, window, dtype, quant, dev):
    """The wrapper's call on phase 3's kind of inputs (scattered pages or
    a wrapped ring, an empty batch slot)."""
    B, K, G, hd = shape
    if kernel == "decode":
        q, k, v, tok, pos, sc = cs.ring_inputs(7, B, K, G, hd, C, dtype,
                                               quant, dev)
        return lambda: ops.decode_attention(q, k, v, tok, pos,
                                            window=window, **sc)
    q, kp, vp, pt, pos0, sc = cs.make_inputs(7, B, Sx, K, G, hd, PS, NP,
                                             dtype, quant, dev)
    if kernel == "paged_decode":
        q = q[:, 0].contiguous()
        return lambda: ops.paged_decode_attention(q, kp, vp, pt, pos0,
                                                  window=window, **sc)
    return lambda: ops.paged_extend_attention(q, kp, vp, pt, pos0,
                                              window=window, **sc)


def model_us(kernel, shape, Sx, dtype, quant):
    """The roofline bound of the shape with every slot of the table (or
    ring) attended."""
    B, K, G, hd = shape
    if kernel == "decode":
        return tuning.decode_cost_model_us(B=B, K=K, G=G, hd=hd, ctx=C, C=C,
                                           quant=quant, dtype=dtype)
    return tuning.extend_cost_model_us(B=B, Sx=Sx, K=K, G=G, hd=hd,
                                       ctx=NP * PS, quant=quant, NP=NP,
                                       dtype=dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=tuning.TABLE_PATH,
                    help="table to write (default: the committed one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_splits: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = cs.phase_device()
    name, limit = (s.strip() for s in smi.split(",", 1))
    limit_w = float(re.match(r"[\d.]+", limit).group(0))
    backend = tuning.backend_key(dev)
    cuda_lib.build(["paged_decode", "paged_extend", "decode_attention"])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev).zero_
    real = tuning.splits

    # each (case, mode): its call, the dims the wrapper asks the table
    # for, and the heuristic's count at them
    runs = []
    for tag, kernel, shape, Sx, window, modes in CASES:
        for mode, dtype, quant in modes:
            fn, asked = call(kernel, shape, Sx, window, dtype, quant, dev), []

            def spy(kern, device, **dims):
                asked.append(dims)
                return tuning.HEURISTICS[kern](**dims), "heuristic"

            tuning.splits = spy
            try:
                fn()
            finally:
                tuning.splits = real
            dims = asked[0]
            most = dims["slots"] // cuda_lib.stage_slots(dims["hd"])
            h = tuning.HEURISTICS[kernel](**dims)
            runs.append(dict(
                label=f"{tag} {kernel} Sx={Sx} {mode}", kernel=kernel,
                key=tuning.shape_key(**dims), mode=mode, fn=fn, h=h,
                cands=[c for c in GRID if c <= most and c != h],
                model_us=model_us(kernel, shape, Sx, dtype, quant),
                times={}))
    torch.cuda.synchronize()

    def timed(fn, count):
        tuning.splits = lambda *a, **k: (count, "forced")
        try:
            return cs.cuda_ms(fn, flush=flush) * 1e3
        finally:
            tuning.splits = real

    for p in range(PASSES):
        for r in runs:
            for c in r["cands"]:
                hs, cs_ = r["times"].setdefault(c, ([], []))
                hs.append(timed(r["fn"], r["h"]))
                cs_.append(timed(r["fn"], c))
                cs_.append(timed(r["fn"], c))
                hs.append(timed(r["fn"], r["h"]))
        print(f"[tune] pass {p + 1} of {PASSES} done", flush=True)

    def verdict(r, c):
        hs, ct = r["times"][c]
        spread = max(max(hs) - min(hs), max(ct) - min(ct))
        return (statistics.median(hs), statistics.median(ct), spread,
                statistics.median(hs) - statistics.median(ct) > spread)

    for r in runs:
        h_us = statistics.median(t for c in r["cands"]
                                 for t in r["times"][c][0])
        row = " ".join(f"{c}:{verdict(r, c)[1]:.2f}"
                       f"{'*' if verdict(r, c)[3] else ''}"
                       for c in r["cands"])
        print(f"[tune] {r['label']} ({r['key']}): heuristic {r['h']} "
              f"{h_us:.2f} us; count:us (* beats it) {row}", flush=True)

    path = Path(args.out)
    table = json.loads(path.read_text()) if path.exists() else {}
    for kernel in tuning.DEFAULTS:
        table.get(kernel, {}).pop(backend, None)
        if not table.get(kernel, True):
            del table[kernel]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")

    groups = {}
    for r in runs:
        groups.setdefault((r["kernel"], r["key"]), []).append(r)
    kept = 0
    for (kernel, key), group in groups.items():
        wins = set(group[0]["cands"])
        for r in group:
            wins &= {c for c in r["cands"] if verdict(r, c)[3]}
        serve = [r for r in group if r["mode"] == "bfloat16"] or group
        if not wins:
            print(f"[tune] {kernel} {key}: the heuristic's count stays "
                  f"({group[0]['h']})", flush=True)
            continue
        best = min(wins, key=lambda c: sum(verdict(r, c)[1] for r in serve))
        r0 = serve[0]
        h_us, c_us, spread, _ = verdict(r0, best)
        tuning.record(
            kernel, key, {"splits": best}, us=c_us, model_us=r0["model_us"],
            heuristic_us=round(h_us, 3), heuristic_splits=r0["h"],
            spread_us=round(spread, 3), device=name, power_limit_w=limit_w,
            by_case={r["label"]: [round(verdict(r, best)[1], 3),
                                  round(verdict(r, best)[0], 3)]
                     for r in group},
            backend=backend, path=str(path))
        kept += 1
        print(f"[tune] {kernel} {key}: {best} splits, {c_us:.2f} us against "
              f"the heuristic's {r0['h']} at {h_us:.2f} us (spread "
              f"{spread:.2f}; {name}, {limit})", flush=True)
    print(f"[tune] {kept} entries for {backend} written to {path}",
          flush=True)
    print(path.read_text(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
