#!/usr/bin/env python3
"""Time the two paged attention kernels with their split count forced, at
chip_smoke.py's timed shapes (bf16, page size 16, 128-page tables), beside
the count ``cuda_lib.paged_splits`` picks.  Needs one CUDA card:

    python3 scripts/paged_splits_sweep.py

Times are cold-L2 means of CUDA events (``chip_smoke.cuda_ms``); each
count is timed twice, the grid swept in order both times.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda_lib, ops  # noqa: E402

# (tag, (B, K, G, hd), kernel, Sx, window, split counts)
CASES = (
    ("demo", (8, 4, 3, 64), "paged_extend", 5, None, (1, 3, 5, 9, 13, 18)),
    ("demo", (8, 4, 3, 64), "paged_extend", 32, None, (1, 3, 5, 9, 13)),
    ("rg", (8, 1, 16, 256), "paged_extend", 32, 2048,
     (1, 2, 3, 4, 6, 9, 13)),
    ("demo", (8, 4, 3, 64), "paged_decode", 1, None, (3, 5, 9, 13, 18)),
    ("rg", (8, 1, 16, 256), "paged_decode", 1, 2048, (9, 17, 25, 33, 50)),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_splits_sweep: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cs.phase_device()
    cuda_lib.build(["paged_decode", "paged_extend"])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev).zero_
    real = cuda_lib.paged_splits
    for tag, (B, K, G, hd), name, Sx, window, grid in CASES:
        q, kp, vp, pt, pos0, _ = cs.make_inputs(
            7, B, Sx, K, G, hd, 16, 128, torch.bfloat16, False, dev)
        fn = ops.paged_extend_attention
        if name == "paged_decode":
            q, fn = q[:, 0].contiguous(), ops.paged_decode_attention
        rows = (cuda_lib.decode_rows(G) if name == "paged_decode"
                else cuda_lib.extend_rows(hd, Sx * G, 1))
        picked = real(B, K, -(-Sx * G // rows), 128 * 16, hd)
        times = []
        try:
            for _ in range(2):
                for splits in grid:
                    cuda_lib.paged_splits = lambda *a, s=splits: s
                    ms = cs.cuda_ms(lambda: fn(q, kp, vp, pt, pos0,
                                               window=window), flush=flush)
                    times.append(f"{splits}:{ms:.4f}")
        finally:
            cuda_lib.paged_splits = real
        print(f"[sweep] {tag} {name} Sx={Sx} window={window}: paged_splits "
              f"picks {picked}; splits:ms {' '.join(times)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
