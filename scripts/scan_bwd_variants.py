#!/usr/bin/env python3
"""Time variants of the mamba scan's backward kernel against the tree's on
one NVIDIA card, in turns within one loop.

    python3 scripts/scan_bwd_variants.py [NAME ...]

Each variant is ``src/repro_torch/kernels/csrc`` copied into
``build/scan_bwd_variants/<name>`` with text of ``mamba_scan_bwd.cu`` or
``mamba_tile.cuh`` replaced, built by nvcc with the port's flags (its
``-Xptxas -v`` register and spill lines printed) and called through ctypes
with the tree's C signature:

* ``c64`` (``kChannels = 64``): blocks of 64 channels, 256 threads at N
  16, two blocks an SM, twice the block partials;
* ``t8`` (``kStateTile = 8``): 8-step tiles, twice the kept states;
* ``keep-a`` (``KEEP_A``, ``kChannels = 64``): the tile's a_t kept in
  registers beside its states and read back by the walk (one exponential
  pass, not two), at up to 255 registers and one 256-thread block an SM;
* ``keep-a-t8`` (``KEEP_A`` at 8-step tiles): the same within 128
  registers;
* ``c64-r255``: 64-channel blocks held to one an SM, so up to 255
  registers a thread;
* ``t8-c64-3``, ``t8-c64-4``: 8-step tiles in 64-channel blocks, three
  (24 warps, 85 registers) or four (32 warps, 64 registers) an SM.

Ablations (``ABLATIONS``) take one part out of the tree's walk (the
channel sums, their shuffles alone, the walk's or the recompute's
exponentials, the B and C loads) to show what it costs; their results are
wrong, so they are timed and not checked.  NAMEs pick variants and
ablations (default: all).

The case is falcon-mamba-7b's training shape as ``chip_smoke.py``'s
``scan_bwd_cases`` makes it ([8, 256, 8192] N 16, pad lanes, nonzero h0),
bf16 and float32 x, cold L2 (a 256 MB write before each call).  Every
kernel starts from the plain boundary states at its own tile
(``ref.mamba_scan_states_ref``) and is first held against
``mamba_scan_bwd_ref`` (1e-4 absolute plus 1e-4 of each gradient's
largest, one bf16 rounding more for bf16 dx).  Prints one line per x
dtype with the median milliseconds (and range) of each kernel over the
rounds, then each one's device time by kernel (``torch.profiler``, warm
L2, a mean over 5 calls); exits non-zero without a CUDA device.
"""
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
C64 = ("kChannels = 128;", "kChannels = 64;")
T8 = ("kStateTile = 16;", "kStateTile = 8;")
# the tile's a_t kept beside its states for the walk, one block an SM
KEEP_A = (("float4 hs[kTile];", "float4 hs[kTile], as[kTile];"),
          ("hs[tt] = h;", "hs[tt] = h;\n      as[tt] = a;"),
          ("const float a = ex2(dtv * at(a2, i));",
           "const float a = at(as[tt], i);"),
          ("kMinBlocks = 512 / kThreads;", "kMinBlocks = 1;"))
VARIANTS = {"c64": (C64,),
            "t8": (T8,),
            "keep-a": KEEP_A + (C64,),
            "keep-a-t8": KEEP_A + (T8,),
            "c64-r255": (C64, ("kMinBlocks = 512 / kThreads;",
                               "kMinBlocks = 1;")),
            "t8-c64-3": (T8, C64, ("kMinBlocks = 512 / kThreads;",
                                   "kMinBlocks = 3;")),
            "t8-c64-4": (T8, C64, ("kMinBlocks = 512 / kThreads;",
                                   "kMinBlocks = 4;"))}
# the files a variant's or an ablation's text is looked for in
EDITED = ("mamba_scan_bwd.cu", "mamba_tile.cuh")
# Parts of the tree's walk taken out, to see what each costs: their
# results are wrong, so they are timed and not checked.
ABLATIONS = {
    "drop-channel-sums": (
        ("channel_sums<G::kLanes>(dtx, g, dyv, hs[tt], lane);",
         "dtx * g.x + dyv * hs[tt].x;"),),
    "drop-channel-shuffles": (
        ("__shfl_xor_sync(kAll, g.z * dtx, kLanes)", "(g.z * dtx)"),
        ("__shfl_xor_sync(kAll, g.w * dtx, kLanes)", "(g.w * dtx)"),
        ("__shfl_xor_sync(kAll, h.z * dy, kLanes)", "(h.z * dy)"),
        ("__shfl_xor_sync(kAll, h.w * dy, kLanes)", "(h.w * dy)"),
        ("__shfl_xor_sync(kAll, up ? db0 : db1, 2 * kLanes)", "db1"),
        ("__shfl_xor_sync(kAll, up ? dc0 : dc1, 2 * kLanes)", "dc1"),
        ("__shfl_xor_sync(kAll, up ? bs : cs, 4 * kLanes)", "cs"),
        ("for (int m = 8 * kLanes; m < 32; m *= 2) r += "
         "__shfl_xor_sync(kAll, r, m);", "")),
    "drop-walk-ex2": (("ex2(dtv * at(a2, i))", "(dtv * at(a2, i))"),),
    "drop-recompute-ex2": (
        ("make_float4(ex2(dtv * a2.x), ex2(dtv * a2.y),",
         "make_float4((dtv * a2.x), (dtv * a2.y),"),
        ("ex2(dtv * a2.z), ex2(dtv * a2.w));", "(dtv * a2.z), (dtv * a2.w));")),
    "drop-bc-loads": (
        ("const float4 bq = row_in_order(st.b[tt], j, c0);",
         "const float4 bq = make_float4(dtv, dtv, dtv, dtv);"),
        ("row_in_order(st.b[tt], j, c0), row_in_order(st.c[tt], j, c0)};",
         "make_float4(1.f, 1.f, 1.f, 1.f), make_float4(1.f, 1.f, 1.f, 1.f)};")),
}


def build(cuda_lib, name, edits):
    """(entry point, tile, channels) of a variant built from a copy of
    csrc/ (no edits: the tree's own library).  A variant's text must occur
    once in ``EDITED``; an ablation's is replaced wherever it occurs."""
    src = cuda_lib.CSRC / "mamba_scan_bwd.cu"
    if edits:
        out = ROOT / "build" / "scan_bwd_variants" / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(cuda_lib.CSRC, out)
        texts = {f: (out / f).read_text() for f in EDITED}
        for was, now in edits:
            counts = {f: text.count(was) for f, text in texts.items()}
            if sum(counts.values()) != 1 and not (
                    name in ABLATIONS and sum(counts.values())):
                raise RuntimeError(f"{EDITED} have no one '{was}'")
            for f in texts:
                texts[f] = texts[f].replace(was, now)
        for f, text in texts.items():
            (out / f).write_text(text)
        src = out / "mamba_scan_bwd.cu"
        so = out / "mamba_scan_bwd.so"
        log = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                              str(so), str(src)], check=True,
                             capture_output=True, text=True)
        log = log.stdout + log.stderr
    else:
        log = cuda_lib.build(["mamba_scan_bwd"])["mamba_scan_bwd"]
        so = cuda_lib._library_path("mamba_scan_bwd")
    for line in log.splitlines():
        if "spill" in line or "registers" in line:
            print(f"[build] {name}: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    fn = lib.mamba_scan_bwd
    fn.argtypes = cuda_lib._ARGTYPES["mamba_scan_bwd"]
    fn.restype = ctypes.c_int
    channels = re.search(r"constexpr int kChannels = (\d+);",
                         src.read_text()).group(1)
    return fn, lib.mamba_state_tile(), int(channels)


def caller(fn, tile, channels, args, ref):
    """A no-argument call of one kernel on ``args`` (dt, Bm, Cm, x, A, Dsk,
    h0, dy, dh) with its outputs and scratch allocated once."""
    dt, Bm, Cm, x, A, Dsk, h0, dy, dh = args
    B, S, D = dt.shape
    N = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    states = ref.mamba_scan_states_ref(dt, Bm, x, A, h0, tile).contiguous()
    outs = [torch.empty_like(dt), torch.empty_like(Bm), torch.empty_like(Cm),
            torch.empty_like(x), torch.empty_like(A), torch.empty_like(Dsk),
            torch.empty_like(h0)]
    scratch = [torch.empty(B, S, -(-D // channels), 2, N, **f32),
               torch.empty(B, D, N, **f32), torch.empty(B, D, **f32)]
    ptrs = [t.data_ptr() for t in (dt, Bm, Cm, x, A, Dsk, states, dy, dh,
                                   *outs, *scratch)]
    code = 1 if x.dtype == torch.bfloat16 else 0

    def call():
        err = fn(code, *ptrs, B, S, D, N,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed: CUDA error {err}")
        return outs
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    only = sys.argv[1:]  # names to run (default: all)
    kernels = {"tree": build(cuda_lib, "tree", ())}
    for name, edits in {**VARIANTS, **ABLATIONS}.items():
        if only and name not in only:
            continue
        kernels[name] = build(cuda_lib, name, edits)
    dev = torch.device("cuda")
    flush_buf = torch.empty(64 * 2 ** 20, device=dev)
    flush = lambda: flush_buf.zero_()
    g = torch.Generator(device=dev).manual_seed(12)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    B, S, D, N = 8, 256, 8192, 16
    nv = torch.tensor([S] + [S - 16 * b - 3 for b in range(1, B)],
                      device=dev)
    pad = torch.arange(S, device=dev)[None, :] < nv[:, None]
    dt = torch.nn.functional.softplus(rn(B, S, D) - 4.0) * pad[..., None]
    Bm, Cm, x32 = rn(B, S, N), rn(B, S, N), rn(B, S, D)
    A = -torch.exp(0.5 * rn(D, N))
    Dsk, h0, dy, dh = rn(D), rn(B, D, N), rn(B, S, D), rn(B, D, N)
    for mode, x in (("bfloat16", x32.bfloat16()), ("float32", x32)):
        args = (dt, Bm, Cm, x, A, Dsk, h0, dy, dh)
        want = ref.mamba_scan_bwd_ref(*args)
        calls = {}
        for name, (fn, tile, channels) in kernels.items():
            call = caller(fn, tile, channels, args, ref)
            got = call()
            torch.cuda.synchronize()
            for a, w in zip(got, want if name not in ABLATIONS else ()):
                scale = float(w.float().abs().max())
                tol = 1e-4 + 1e-4 * scale + (2 ** -8 * scale if a.dtype ==
                                              torch.bfloat16 else 0.0)
                if float((a.float() - w.float()).abs().max()) > tol:
                    raise AssertionError(f"{name} x {mode} disagrees with "
                                         "the plain version")
            calls[name] = call
        del want
        times = {name: [] for name in calls}
        order = list(calls)
        for _ in range(10):
            for name in order + order[::-1]:
                flush()
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                calls[name]()
                e.record()
                torch.cuda.synchronize()
                times[name].append(s.elapsed_time(e))
        print(f"[variants] mamba_scan_bwd [{B},{S},{D}] N={N} x {mode}, "
              "cold-L2 medians in turns: " + ", ".join(
                  f"{n} {sorted(t)[len(t) // 2]:.4f} ms ({min(t):.4f}-"
                  f"{max(t):.4f})" for n, t in times.items()))
        for name, call in calls.items():
            print(f"[variants] {name} x {mode} device us a call: " + ", ".join(
                f"{k} {v:.1f}" for k, v in
                cs.device_us_by_kernel(call).items()))
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
