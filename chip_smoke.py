#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit on any error:

1. device  — the card's name and power limit; TF32 off for matmuls and
   cuDNN, so float32 comparisons are float32.
2. build   — compile the six hand-written kernels from ``csrc/`` with
   nvcc (one process per source, in parallel) and print ``-Xptxas -v``.
3. kernels — each kernel against its plain PyTorch version at the main
   paths' shapes, then kernel and plain-version times from CUDA events
   (cold and warm L2) beside the least time the card could take (bytes
   over HBM rate against operations over peak rate):
   * paged decode and extend at reflect_demo_100m's shapes (q [8,4,3,64];
     extend Sx = 32 and 5; page size 16; scattered page tables with
     unmapped tails, positions mid-page, an empty batch slot; window None
     and 48) in float32, bfloat16 and int8 KV;
   * the same at recurrentgemma-9b's local attention (K 1, G 16, hd 256;
     decode and extend Sx = 32; window None, 48 and 2048);
     each paged case logs its route (bf16 extend on the tensor cores),
     its tile and its split count (``cuda_lib.paged_splits``);
   * the mamba scan at falcon-mamba-7b's shapes ([8, 32 or 1, 8192],
     state 16) with float32 and bfloat16 x, and the RG-LRU scan at
     recurrentgemma-9b's ([8, 32 or 1, 4096]), each with a nonzero h0 and
     pad lanes masked to the identity;
   * ring decode at reflect_demo_100m's shape (B 8, K 4, G 3, hd 64, C
     2048; rings wrapped past C, empty slots, slots ahead of pos, an
     empty row; window None and 48; float32, bfloat16, int8 and int8 with
     bfloat16 q) and recurrentgemma-9b's (K 1, G 16, hd 256, window 2048);
   * flash attention at reflect_demo_100m's prefill (B 8, H 12, K 4, hd
     64, S 2048; window None and 48; float32 and bfloat16), at
     recurrentgemma-9b's (B 4, H 16, K 1, hd 256, S 4096, window 2048,
     bfloat16) and at a ragged S 1000 with per-row lengths.
   The two attention kernels are also timed against one PyTorch call
   computing the same function, ``scaled_dot_product_attention`` with
   ``enable_gqa`` (causal, or a boolean mask for windows, lengths and ring
   tokens), in turns within one loop (kernel, library, library, kernel;
   medians and ranges of each); int8 rings have no such call.  Flash
   cases print their achieved TFLOP/s and ring decode its split count;
   the build prints the tensor-core instructions (HGMMA, HMMA) that
   ``cuobjdump -sass`` finds in the flash and paged-extend libraries,
   each of which must hold HGMMA.
4. serve   — three models through the port's ``Engine``, one after the
   other, each freed before the next: 8 conversations of a few hundred
   tokens, 3 reflection rounds with the suffix [99, 98], paged KV or ring
   caches, chunked prefill and the prefix cache; and the full-sequence
   entry points.  Launch counters are reset just before each run and
   read just after; every kernel of the run's path must have launched,
   and rounds 2 and 3 must hit the prefix cache.
   * reflect_demo_100m at full width and depth (12 layers, d_model 768,
     bf16 activations, fp32 parameters), with self-speculative decoding,
     then a shorter int8-KV run: paged decode and extend; the same two
     runs on ring caches (``paged_kv=False``): ring decode; then
     ``prefill`` of 8 prompts of 1500-2048 tokens (ragged lengths), 16
     greedy ``decode_step``s on the primed rings, and ``forward`` on
     [8, 2048]: flash attention and ring decode;
   * falcon-mamba-7b at full width and depth (64 mamba layers, d_model
     4096, fp32 parameters): the mamba scan;
   * recurrentgemma-9b at full width and depth (38 layers, 26 RG-LRU and
     12 local-attention, bf16 parameters): the RG-LRU scan and both paged
     kernels at hd 256; then on the same weights a ring serve (RG-LRU scan
     and ring decode), ``prefill`` of [4, 4096] (past the 2048-slot local
     ring, which wraps) and 16 ``decode_step``s: flash attention with
     window 2048, ring decode and the RG-LRU scan.
   Weights are random from a seeded CUDA generator.  After each serve a
   profiler summary of device time by kernel gives the idle share, and a
   check holds the model's logits on the card against the plain path on
   the CPU, through chunked paged prefill and through ``prefill`` and
   ring ``decode_step`` (the recurrent models at a cut depth).
5. result  — a JSON line of kernel records, the card line, and last the
   JSON status line.

Exits non-zero without a result when no CUDA device is present, or when
the port's sources are not next to this script.
"""
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core bf16
            torch.float32: 67e12}         # float32 outside tensor cores
# exponentials: 16 special-function results a clock per SM (sm_90) on 132
# SMs at the 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
REPLACES = {"paged_decode": "src/repro/kernels/paged_attention.py:102",
            "paged_extend": "src/repro/kernels/paged_extend.py:121",
            "flash_attention": "src/repro/kernels/flash_attention.py:67",
            "decode_attention": "src/repro/kernels/decode_attention.py:87",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:46",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:31"}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
STEP_KINDS = ("mixed_steps", "decode_batch_steps", "verify_steps")


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- 1. device

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[device] allow_tf32: matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


# ---------------------------------------------------------------- 2. build

def phase_build():
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    logs = cuda_lib.build()
    log(f"[build] {len(logs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if line.strip():
                log(f"[build] {name}: {line.strip()}")
    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    for name in ("flash_attention", "paged_extend"):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(cuda_lib._library_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        counts = {op: len(re.findall(rf"\b{op}\.", sass))
                  for op in ("HGMMA", "HMMA")}
        log(f"[build] {name} SASS: {counts['HGMMA']} HGMMA, "
            f"{counts['HMMA']} HMMA instructions")
        if counts["HGMMA"] == 0:
            raise AssertionError(f"the bf16 {name} kernel has no wgmma "
                                 "(HGMMA)")


# -------------------------------------------------------------- 3. kernels

def make_inputs(seed, B, Sx, K, G, hd, ps, NP, dtype, quant, dev):
    """Scattered pages of a full pool, unmapped tails past each row's
    frontier, positions mid-page, and batch slot B-1 empty."""
    from repro_torch.kernels import kv_quant
    g = torch.Generator().manual_seed(seed)
    P = B * NP
    q = torch.randn(B, Sx, K, G, hd, generator=g)
    kp = torch.randn(P, ps, K, hd, generator=g)
    vp = torch.randn(P, ps, K, hd, generator=g)
    pt = torch.randperm(P, generator=g)[:B * NP].view(B, NP).to(torch.int32)
    last = torch.randint(ps * 4, NP * ps - ps, (B,), generator=g)
    last = last - last % ps + ps // 2 - 1          # mid-page frontier
    pos0 = (last - (Sx - 1)).to(torch.int32)
    for b in range(B):
        pt[b, int(last[b]) // ps + 1:] = -1
    pt[B - 1] = -1
    sc = {}
    if quant:
        kp, ks, kz = kv_quant.quantize_k(kp)
        vp, vs = kv_quant.quantize_v(vp)
        sc = {"k_scale": ks.to(dev), "k_zero": kz.to(dev),
              "v_scale": vs.to(dev)}
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return (q.to(dev, dtype), kp.to(dev), vp.to(dev), pt.to(dev),
            pos0.to(dev), sc)


def work(q, kp, pt, pos0, sc, window):
    """Bytes the function must move and operations it must do on this
    data: every valid K/V slot read once (with its int8 sidecars), q read,
    out written, table and positions read; 4 * hd operations per (query
    row, valid slot) for QK^T and PV."""
    B, Sx, K, G, hd = q.shape
    ps = kp.shape[1]
    pt_h, pos_h = pt.cpu().numpy(), pos0.cpu().numpy()
    t = np.arange(pt_h.shape[1] * ps)
    union = pairs = 0
    for b in range(B):
        mapped = np.repeat(pt_h[b] >= 0, ps)
        seen = np.zeros_like(mapped)
        for lane in range(Sx):
            p = pos_h[b] + lane
            v = mapped & (t <= p)
            if window is not None:
                v &= t > p - window
            pairs += int(v.sum())
            seen |= v
        union += int(seen.sum())
    slot_bytes = 2 * K * hd * kp.element_size() + (3 * K * 4 if sc else 0)
    nbytes = (union * slot_bytes + 2 * q.numel() * q.element_size()
              + pt.numel() * 4 + pos0.numel() * 4)
    ops = 4 * hd * G * K * pairs
    return nbytes, ops


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def cuda_ms(fn, n=30, flush=None):
    """Mean milliseconds per call from CUDA events after a warm-up.  With
    ``flush`` (a 256 MB write) before every call, L2 holds none of the
    inputs: the cold-L2 time; without it, the warm-L2 time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n
    total = 0.0
    for _ in range(n):
        flush()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / n


def interleaved_ms(kern, lib, flush, rounds=10):
    """Kernel and library call timed in turns within one loop, cold-L2
    each (kernel, library, library, kernel a round), so that both see the
    same card state: (median, min, max) milliseconds of each."""
    times = {kern: [], lib: []}
    for fn in (kern, lib):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for fn in (kern, lib, lib, kern):
            flush()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times[fn].append(s.elapsed_time(e))
    return [(float(np.median(t)), min(t), max(t))
            for t in (times[kern], times[lib])]


def time_record(kern, plain, flush, nbytes, nops, dtype, err, exps=0,
                lib=None):
    """Kernel cold-L2 / warm-L2 and plain-version cold-L2 times beside
    the bound: bytes over the HBM rate against operations over the peak
    rate for ``dtype`` (and exponentials over the SFU rate).  With a
    library call ``lib``, the kernel's cold-L2 time and the library's are
    medians of ``interleaved_ms``."""
    bms, by = bound_ms(nbytes, nops, dtype)
    if exps / SFU_PER_S * 1e3 > bms:
        bms, by = exps / SFU_PER_S * 1e3, "operations"
    rec = {"warm_ms": cuda_ms(kern),
           "plain_ms": cuda_ms(plain, n=10, flush=flush),
           "bound_ms": bms, "bound_by": by, "max_abs_err": err,
           "bytes": nbytes, "ops": nops, "exps": exps}
    if lib is None:
        rec["ms"] = cuda_ms(kern, flush=flush)
    else:
        (rec["ms"], *rec["ms_range"]), (rec["library_ms"],
                                        *rec["library_range"]) = \
            interleaved_ms(kern, lib, flush)
    return rec


def log_record(label, rec):
    lib = rec.get("library_ms")
    if lib is not None:
        log(f"[kernels] {label}: interleaved cold-L2, kernel median "
            f"{rec['ms']:.4f} ms (range {rec['ms_range'][0]:.4f}-"
            f"{rec['ms_range'][1]:.4f}), library median {lib:.4f} ms (range "
            f"{rec['library_range'][0]:.4f}-{rec['library_range'][1]:.4f}); "
            f"kernel / library {rec['ms'] / lib:.2f}")
    log(f"[kernels] {label}: kernel {rec['ms']:.4f} ms cold-L2 / "
        f"{rec['warm_ms']:.4f} ms warm-L2, plain {rec['plain_ms']:.4f} ms "
        f"cold-L2, library {'none' if lib is None else f'{lib:.4f} ms'} "
        f"cold-L2, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
        f"({rec['bytes']} B, {rec['ops']} ops, {rec['exps']} exp; HBM "
        f"{rec['bytes'] / rec['ms'] / 1e6:.1f} GB/s)")


def check_record(label, got, want, tol, bf16):
    """Hold a kernel's output against its plain version (float32)."""
    err = float((got.float() - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want, atol=tol, rtol=0.0 if bf16 else tol)
    log(f"[kernels] {label}: max_abs_err={err:.3e} (tol {tol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def paged_cases(records, tag, shape, cases, modes, windows, timed_window,
                check_np, dev, flush, seed):
    """Paged kernels at one model's attention shape: every (case, mode,
    window) against the plain version on a table of ``check_np`` pages,
    then times at ``shape`` (the serve's table) with ``timed_window``."""
    from repro_torch.kernels import cuda_lib, ops, ref
    kernels = {"paged_decode": ops.paged_decode_attention,
               "paged_extend": ops.paged_extend_attention}
    plains = {"paged_decode": ref.paged_decode_attention_ref,
              "paged_extend": ref.paged_extend_attention_ref}
    B, K, G, hd, ps, NP = (shape[k] for k in ("B", "K", "G", "hd", "ps",
                                               "NP"))
    fp = (lambda t: t.float() if t.is_floating_point() else t)
    for name, Sx in cases:
        for mode, dtype, quant, tol in modes:
            # the split the wrapper makes of the timed table
            code = cuda_lib.DTYPE_CODES[(dtype, torch.int8 if quant
                                         else dtype)]
            rows = (cuda_lib.decode_rows(G) if name == "paged_decode"
                    else cuda_lib.extend_rows(hd, Sx * G, code))
            tiles = -(-Sx * G // rows)
            splits = cuda_lib.paged_splits(B, K, tiles, NP * ps, hd)
            route = ("tensor cores" if name == "paged_extend"
                     and code in cuda_lib.TC_CODES else "CUDA cores")
            log(f"[kernels] {tag} {name} Sx={Sx} {mode}: {route}, tiles of "
                f"{rows} rows x {tiles}, {splits} splits a tile, "
                f"{B * K * tiles * splits} blocks")
            for window in windows + ("timed",):
                seed += 1
                timed = window == "timed"
                win = timed_window if timed else window
                q, kp, vp, pt, pos0, sc = make_inputs(
                    seed, B, Sx, K, G, hd, ps, NP if timed else check_np,
                    dtype, quant, dev)
                if name == "paged_decode":
                    q = q[:, 0].contiguous()
                kern = lambda: kernels[name](q, kp, vp, pt, pos0,
                                             window=win, **sc)
                got = kern()
                torch.cuda.synchronize()
                # the plain version in float32 on the same (rounded) inputs
                want = plains[name](fp(q), fp(kp), fp(vp), pt, pos0,
                                    window=win, **sc)
                err = check_record(
                    f"{tag} {name} Sx={Sx} K={K} G={G} hd={hd} "
                    f"NP={pt.shape[1]} {mode} window={win}", got, want, tol,
                    dtype == torch.bfloat16)
                if not timed:
                    continue
                plain = lambda: plains[name](q, kp, vp, pt, pos0,
                                             window=win, **sc)
                q5 = q if q.dim() == 5 else q[:, None]
                nbytes, nops = work(q5, kp, pt, pos0, sc, win)
                rec = time_record(kern, plain, flush, nbytes, nops, dtype,
                                  err)
                rec.update(splits=splits, tile=rows)
                log_record(f"{tag} {name} Sx={Sx} {mode} window={win}", rec)
                records[(name, tag, Sx, mode)] = rec
    return seed


def scan_cases(records, dev, flush):
    """The two scans at the serves' shapes (mixed step S = 32, decode
    S = 1): nonzero h0, pad lanes masked to the identity (mamba: dt = 0 on
    the last lanes of all rows but the first; RG-LRU: a = 1, b = 0),
    against the plain versions on the same inputs."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(11)
    B, D, N, W = 8, 8192, 16, 4096
    for S in (32, 1):
        nv = torch.tensor([S] + [max(1, S - 4 * b) for b in range(1, B)],
                          device=dev)
        pad = (torch.arange(S, device=dev)[None, :] < nv[:, None])
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, D, generator=g, device=dev) - 4.0)
        dt = dt * pad[..., None]
        Bm, Cm = (torch.randn(B, S, N, generator=g, device=dev)
                  for _ in range(2))
        x32 = torch.randn(B, S, D, generator=g, device=dev)
        A = -torch.ones(D, N, device=dev)
        Dsk = torch.ones(D, device=dev)
        h0 = torch.randn(B, D, N, generator=g, device=dev)
        for mode, x in (("float32", x32), ("bfloat16", x32.bfloat16())):
            kern = lambda: ops.mamba_scan(dt, Bm, Cm, x, A, Dsk, h0)
            plain = lambda: ref.mamba_scan_ref(dt, Bm, Cm, x, A, Dsk, h0)
            (y, h), (wy, wh) = kern(), plain()
            torch.cuda.synchronize()
            err = max(float((y - wy).abs().max()),
                      float((h - wh).abs().max()))
            ok = (bool(torch.isfinite(y).all())
                  and torch.allclose(y, wy, atol=1e-4, rtol=1e-4)
                  and torch.allclose(h, wh, atol=1e-4, rtol=1e-4))
            log(f"[kernels] mamba_scan [{B},{S},{D}] N={N} x {mode}: "
                f"max_abs_err={err:.3e} (tol 1e-4 abs + 1e-4 rel) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"mamba_scan S={S} {mode} disagrees "
                                     "with its plain version")
            nbytes = (dt.numel() * 4 + x.numel() * x.element_size()
                      + (Bm.numel() + Cm.numel() + A.numel() + Dsk.numel())
                      * 4 + 2 * h0.numel() * 4 + y.numel() * 4)
            exps = B * S * D * N
            # dt * A, two multiply-adds (state, output), and the skip
            rec = time_record(kern, plain, flush, nbytes, 5 * exps,
                              torch.float32, err, exps)
            log_record(f"mamba_scan S={S} x {mode}", rec)
            records[("mamba_scan", S, mode)] = rec
        a = torch.sigmoid(torch.randn(B, S, W, generator=g, device=dev))
        b = torch.randn(B, S, W, generator=g, device=dev)
        a.masked_fill_(~pad[..., None], 1.0)
        b.masked_fill_(~pad[..., None], 0.0)
        h0 = torch.randn(B, W, generator=g, device=dev)
        kern = lambda: ops.rglru_scan(a, b, h0)
        plain = lambda: ref.rglru_scan_ref(a, b, h0)
        (hs, h), (whs, wh) = kern(), plain()
        torch.cuda.synchronize()
        err = max(float((hs - whs).abs().max()), float((h - wh).abs().max()))
        log(f"[kernels] rglru_scan [{B},{S},{W}]: max_abs_err={err:.3e} "
            f"(tol 0: the kernel rounds as the plain version does) "
            f"{'ok' if err == 0 else 'MISMATCH'}")
        if err != 0 or not bool(torch.isfinite(hs).all()):
            raise AssertionError(f"rglru_scan S={S} disagrees with its "
                                 "plain version")
        rec = time_record(kern, plain, flush,
                          (3 * a.numel() + 2 * h0.numel()) * 4,
                          2 * a.numel(), torch.float32, err)
        log_record(f"rglru_scan S={S}", rec)
        records[("rglru_scan", S, "float32")] = rec


def ring_inputs(seed, B, K, G, hd, C, dtype, quant, dev):
    """A wrapped ring per row (positions past C), 10% empty slots, three
    slots holding tokens past pos (a rejected draft's writes), and batch
    row B-1 empty."""
    from repro_torch.kernels import kv_quant
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, K, G, hd, generator=g)
    k = torch.randn(B, C, K, hd, generator=g)
    v = torch.randn(B, C, K, hd, generator=g)
    pos = torch.randint(C // 2, 3 * C, (B,), generator=g)
    c = torch.arange(C)
    tok = pos[:, None] - (pos[:, None] - c[None, :]) % C
    tok[(tok < 0) | (torch.rand(B, C, generator=g) < 0.1)] = -1
    ahead = (c[None, :] - pos[:, None] % C) % C
    tok = torch.where((ahead >= 1) & (ahead <= 3), pos[:, None] + ahead, tok)
    tok[B - 1] = -1
    sc = {}
    if quant:
        k, ks, kz = kv_quant.quantize_k(k)
        v, vs = kv_quant.quantize_v(v)
        sc = {"k_scale": ks.to(dev), "k_zero": kz.to(dev),
              "v_scale": vs.to(dev)}
    else:
        k, v = k.to(dtype), v.to(dtype)
    return (q.to(dev, dtype), k.to(dev), v.to(dev),
            tok.to(dev, torch.int32), pos.to(dev, torch.int32), sc)


def ring_valid(tok, pos, window):
    valid = (tok >= 0) & (tok <= pos[:, None])
    if window is not None:
        valid &= tok > pos[:, None] - window
    return valid


def ring_cases(records, dev, flush):
    """Ring decode at reflect_demo_100m's and recurrentgemma-9b's decode
    shapes, every mode and window against the plain version; timed at
    window None (demo) and 2048 (recurrentgemma), with SDPA on a boolean
    mask built from the tokens as the library yardstick."""
    from repro_torch.kernels import cuda_lib, ops, ref
    F = torch.nn.functional
    fp = (lambda t: t.float() if t.is_floating_point() else t)
    modes = (("float32", torch.float32, False, 1e-4),
             ("bfloat16", torch.bfloat16, False, 2e-2),
             ("int8", torch.float32, True, 1e-4),
             ("int8+bf16", torch.bfloat16, True, 2e-2))
    seed = 100
    for tag, (B, K, G, hd, C), windows, timed, mds in (
            ("demo", (8, 4, 3, 64, 2048), (None, 48), None, modes),
            ("rg", (8, 1, 16, 256, 2048), (None, 48, 2048), 2048,
             modes[:3])):
        splits = cuda_lib.ring_splits(B, K, C, hd)
        log(f"[kernels] {tag} decode_attention B={B} K={K} C={C} hd={hd}: "
            f"{splits} splits of {C // splits}-{-(-C // splits)} slots, "
            f"{B * K * splits} blocks")
        for mode, dtype, quant, tol in mds:
            for window in windows:
                seed += 1
                q, k, v, tok, pos, sc = ring_inputs(seed, B, K, G, hd, C,
                                                    dtype, quant, dev)
                kern = lambda: ops.decode_attention(q, k, v, tok, pos,
                                                    window=window, **sc)
                got = kern()
                torch.cuda.synchronize()
                want = ref.decode_attention_ref(fp(q), fp(k), fp(v), tok,
                                                pos, window=window, **sc)
                err = check_record(
                    f"{tag} decode_attention B={B} K={K} G={G} hd={hd} "
                    f"C={C} {mode} window={window}", got, want, tol,
                    dtype == torch.bfloat16)
                if window != timed:
                    continue
                plain = lambda: ref.decode_attention_ref(
                    q, k, v, tok, pos, window=window, **sc)
                valid = ring_valid(tok, pos, window)
                n = int(valid.sum())
                slot_bytes = (2 * K * hd * k.element_size()
                              + (3 * K * 4 if quant else 0))
                nbytes = (n * slot_bytes + tok.numel() * 4 + pos.numel() * 4
                          + 2 * q.numel() * q.element_size())
                lib = None
                if not quant:
                    qh = q.reshape(B, K * G, 1, hd)
                    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
                    mask = valid[:, None, None, :]
                    lib = lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask, enable_gqa=True)
                rec = time_record(kern, plain, flush, nbytes,
                                  4 * hd * G * K * n, dtype, err, G * K * n,
                                  lib=lib)
                rec["splits"] = splits
                log_record(f"{tag} decode_attention {mode} window={window}",
                           rec)
                records[("decode_attention", tag, mode)] = rec


def flash_valid(S, window, lengths, dev):
    """[B or 1, S, S] mask of the (query, key) pairs flash attends."""
    i = torch.arange(S, device=dev)
    valid = (i[None, :] <= i[:, None])[None]
    if window is not None:
        valid = valid & (i[None, None, :] > i[None, :, None] - window)
    if lengths is not None:
        valid = valid & (i[None, None, :] < lengths.long()[:, None, None])
    return valid


def flash_cases(records, dev, flush):
    """Flash attention at the full-sequence runs' shapes against the plain
    version, timed beside its bound and one SDPA call (causal, or a
    boolean mask for a window or lengths)."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    g = torch.Generator().manual_seed(7)
    for tag, (B, H, K, S, hd), window, dtype, ragged in (
            ("demo", (8, 12, 4, 2048, 64), None, torch.float32, False),
            ("demo", (8, 12, 4, 2048, 64), None, torch.bfloat16, False),
            ("demo", (8, 12, 4, 2048, 64), 48, torch.float32, False),
            ("demo", (8, 12, 4, 2048, 64), 48, torch.bfloat16, False),
            ("rg", (4, 16, 1, 4096, 256), 2048, torch.bfloat16, False),
            ("ragged", (8, 12, 4, 1000, 64), None, torch.bfloat16, True)):
        q = torch.randn(B, H, S, hd, generator=g).to(dev, dtype)
        k = torch.randn(B, K, S, hd, generator=g).to(dev, dtype)
        v = torch.randn(B, K, S, hd, generator=g).to(dev, dtype)
        lengths = (torch.randint(S // 2, S + 1, (B,), generator=g)
                   .to(dev, torch.int32) if ragged else None)
        kern = lambda: ops.flash_attention(q, k, v, window=window,
                                           lengths=lengths)
        got = kern()
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       window=window, lengths=lengths)
        bf16 = dtype == torch.bfloat16
        mode = "bfloat16" if bf16 else "float32"
        label = (f"{tag} flash_attention B={B} H={H} K={K} S={S} hd={hd} "
                 f"{mode} window={window} lengths={ragged}")
        err = check_record(label, got, want, 2e-2 if bf16 else 1e-4, bf16)
        del want
        plain = lambda: ref.flash_attention_ref(q, k, v, window=window,
                                                lengths=lengths)
        valid = flash_valid(S, window, lengths, dev)
        pairs = int(valid.sum()) * (B if valid.shape[0] == 1 else 1) * H
        kv_rows = (B * S if lengths is None
                   else int(lengths.clamp_max(S).sum()))
        nbytes = (2 * q.numel() + 2 * kv_rows * K * hd) * q.element_size()
        if window is None and lengths is None:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            mask = valid[:, None]
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        rec = time_record(kern, plain, flush, nbytes, 4 * hd * pairs, dtype,
                          err, pairs, lib=lib)
        log_record(f"{tag} flash_attention {mode} window={window}", rec)
        log(f"[flash] {tag} {mode} window={window} lengths={ragged}: "
            f"{rec['ops'] / rec['ms'] / 1e9:.1f} TFLOP/s achieved "
            f"({rec['ops']} FLOP in {rec['ms']:.4f} ms), library "
            f"{rec['ops'] / rec['library_ms'] / 1e9:.1f} TFLOP/s")
        records[("flash_attention", tag, mode, window)] = rec
        del q, k, v, valid
        torch.cuda.empty_cache()


def phase_kernels(dev):
    # (label, activation dtype, int8 pool, tolerance)
    modes = (("float32", torch.float32, False, 1e-4),
             ("bfloat16", torch.bfloat16, False, 2e-2),
             ("int8", torch.float32, True, 1e-4),
             ("int8+bf16", torch.bfloat16, True, 2e-2))
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    flush = flush_buf.zero_
    records = {}
    # reflect_demo_100m: max_seq 2048 / page 16; timed at window None
    demo = dict(B=8, K=4, G=3, hd=64, ps=16, NP=128)
    seed = paged_cases(records, "demo", demo,
                       [("paged_decode", 1), ("paged_extend", 32),
                        ("paged_extend", 5)], modes, (None, 48), None, 128,
                       dev, flush, 0)
    # recurrentgemma-9b's local attention: checked on 160 pages so that
    # the 2048-slot window binds; timed on the serve's 128 pages with the
    # window its rg_attn layers pass
    rg = dict(B=8, K=1, G=16, hd=256, ps=16, NP=128)
    paged_cases(records, "rg", rg, [("paged_decode", 1), ("paged_extend",
                                                          32)],
                modes[:3], (None, 48, 2048), 2048, 160, dev, flush, seed)
    scan_cases(records, dev, flush)
    ring_cases(records, dev, flush)
    flash_cases(records, dev, flush)
    return records


# ---------------------------------------------------------------- 4. serve

def serve(model, kv_dtype, rounds, max_new, seed, path, paged=True):
    """Serve ``rounds`` reflection rounds of 8 conversations from a paged
    pool or (``paged=False``) ring caches; ``path`` names the kernels this
    model's steps must launch."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status
    scfg = ServeConfig(max_batch=8, max_seq=2048, page_size=16,
                       spec_decode=True, spec_tokens=4, kv_dtype=kv_dtype,
                       paged_kv=paged)
    eng = Engine(model, scfg, device="cuda")
    rng = np.random.default_rng(seed)
    convos = [[1] + rng.integers(3, model.cfg.vocab_size, n).tolist()
              for n in rng.integers(200, 400, 8)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    hits = []
    t0 = time.perf_counter()
    for _ in range(rounds):
        h0 = eng.prefix_cache.stats["hits"]
        reqs = [Request(prompt=list(c), max_new_tokens=max_new, eos_id=None)
                for c in convos]
        for r in reqs:
            eng.submit(r)
        eng.run()
        if not all(r.status is Status.DONE and len(r.output) == max_new
                   for r in reqs):
            raise AssertionError("a request did not finish")
        hits.append(eng.prefix_cache.stats["hits"] - h0)
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]              # reflection suffix
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if paged:
        eng.pool.check()
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    steps = {k: st[k] for k in ("mixed_steps", "decode_batch_steps",
                                "verify_steps", "prefill_tokens",
                                "extend_tokens", "decode_tokens",
                                "spec_drafted", "spec_accepted",
                                "preemptions")}
    processed = st["prefill_tokens"] + st["extend_tokens"] + \
        st["decode_tokens"]
    n_steps = sum(st[k] for k in STEP_KINDS)
    name = f"{model.cfg.name} kv={kv_dtype} {'paged' if paged else 'ring'}"
    log(f"[serve] {name}: {rounds} rounds x 8 requests in {dt:.3f}s, "
        f"{n_steps} engine steps ({dt / n_steps * 1e3:.2f} ms each); "
        f"{st['decode_tokens'] / dt:.1f} output tok/s, "
        f"{processed / dt:.1f} processed tok/s; steps {steps}")
    kv = (f"pool {st['kv_pool_pages_used']}/{st['kv_pool_pages']} pages"
          if paged else f"rings of {eng._ring_cap} slots, "
          f"{st['resident_kv_bytes']} B")
    log(f"[serve] {name}: prefix hits per round {hits}; launches "
        f"{launches}; peak memory {peak} B; {kv}; speculation {eng.spec}")
    if any(h <= 0 for h in hits[1:]):
        raise AssertionError("reflection rounds missed the prefix cache")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"a kernel of {path} was not launched: "
                             f"{launches}")
    if (st["verify_steps"] > 0) != eng.spec:
        raise AssertionError("speculative verify steps ran iff the engine "
                             f"speculates (spec={eng.spec}, verify steps "
                             f"{st['verify_steps']})")
    return eng, convos, launches


def profile_round(eng, convos, max_new=16):
    """Device time by kernel over one more short round, then the idle
    share.  The profiler's own tracing slows every launch on this card's
    host many times over, so the wall time it is set against is that of
    the same round served again without the profiler (the second pass
    finds one more token of each prompt cached)."""
    from repro_torch.serving.request import Request
    from torch.profiler import ProfilerActivity, profile

    def one_round():
        """Serve the round; returns (engine steps, wall seconds)."""
        steps0 = sum(eng.stats()[k] for k in STEP_KINDS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in convos:
            eng.submit(Request(prompt=list(c), max_new_tokens=max_new,
                               eos_id=None))
        eng.run()
        torch.cuda.synchronize()
        return (sum(eng.stats()[k] for k in STEP_KINDS) - steps0,
                time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps, traced_s = one_round()
    steps2, wall_s = one_round()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    # kernel rows only: CPU-side operator rows repeat their kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows)
    busy_ms, wall_ms = busy / steps / 1e3, wall_s / steps2 * 1e3
    log(f"[profile] {eng.cfg.name}: {len(convos)} requests x {max_new} new "
        f"tokens: {steps} engine "
        f"steps, device busy {busy:.0f} us ({busy_ms:.3f} ms per step; "
        f"{traced_s:.3f} s wall under the profiler); again without the "
        f"profiler: {steps2} steps in {wall_s:.3f} s ({wall_ms:.3f} ms per "
        f"step); idle share {1 - busy_ms / wall_ms:.3f}")
    # the top 15, then the port's own kernels (the split walks' combine
    # among them) that are not in it
    port = re.compile(
        r"void (\(anonymous namespace\)|paged|flash_tc)::\w+_kernel")
    for i, e in enumerate(rows):
        if dev_us(e) > 0 and (i < 15 or port.match(e.key)):
            log(f"[profile] {dev_us(e):10.0f} us {e.count:6d} calls  "
                f"{e.key[:90]}")
    if busy <= 0:
        log("[profile] the profiler saw no device time; kernel times come "
            "from the CUDA events of the kernels phase")


def full_sequence(model, B, S, lengths, steps, forward, path):
    """The full-sequence entry points: ``prefill`` of B seeded prompts
    padded to S (valid up to ``lengths``), ``steps`` greedy
    ``decode_step``s on the primed rings, then (``forward``) teacher
    forcing on all [B, S] tokens.  Every kernel of ``path`` must launch;
    flash once per attention layer and call, ring decode once per
    attention layer and step.  Returns the launch counts."""
    from repro_torch.kernels import ops
    cfg = model.cfg
    dev = model.embed.device
    n_attn = sum(k in ("attn", "rg_attn") for k in cfg.block_pattern)
    g = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(3, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    lens = (torch.full((B,), S) if lengths is None
            else torch.tensor(lengths)).to(dev, torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, lens, max_seq=S)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    outs = [logits]
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    pos = lens.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(cache, nxt, pos)
        outs.append(logits)
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        pos += 1
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    t_fwd = None
    if forward:
        t0 = time.perf_counter()
        lf, _ = model.forward({"tokens": tokens})
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        if lf.shape != (B, S, cfg.vocab_size) or not bool(
                torch.isfinite(lf).all()):
            raise AssertionError("forward logits are not finite [B, S, V]")
        del lf
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rings = sorted({c["k"].shape[1] for c in cache if "tok" in c})
    if not all(o.shape == (B, cfg.vocab_size) and bool(torch.isfinite(o)
                                                       .all()) for o in outs):
        raise AssertionError("prefill / decode logits are not finite [B, V]")
    log(f"[full] {cfg.name}: prefill [{B}, {S}] (lengths "
        f"{lens.min().item()}-{lens.max().item()}) {t_prefill:.3f}s; "
        f"{steps} decode steps {t_decode / steps * 1e3:.2f} ms each; "
        f"forward {'not run' if t_fwd is None else f'{t_fwd:.3f}s'}; "
        f"rings of {rings} slots; launches {launches}; peak memory {peak} B")
    want_flash = n_attn * (1 + bool(forward))
    if launches["flash_attention"] != want_flash:
        raise AssertionError(f"flash launched {launches['flash_attention']} "
                             f"times, not {want_flash}")
    if launches["decode_attention"] != n_attn * steps:
        raise AssertionError("ring decode did not launch once per layer "
                             "and step")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"a kernel of {path} was not launched: "
                             f"{launches}")
    return launches


def _walk(m, prompt, feed):
    """Logits [5, V] of a 45-token prompt prefilled in two chunks (32 +
    13 valid lanes of 32) and four decode steps fed ``feed``, or the
    model's own greedy tokens (appended to ``feed``) when it is empty."""
    d = m.embed.device
    own = not feed
    pt = torch.arange(8, dtype=torch.int32, device=d)[None]
    cache = m.init_cache_paged(8, 16, device=d)
    i32 = dict(dtype=torch.int32, device=d)
    for p0 in (0, 32):
        chunk = prompt[:, p0:p0 + 32]
        blk = torch.zeros(1, 32, dtype=torch.int32)
        blk[:, :chunk.shape[1]] = chunk
        lg, cache = m.prefill_extend(
            cache, blk.to(d), torch.tensor([p0], **i32),
            torch.tensor([chunk.shape[1]], **i32), page_table=pt)
    logits = [lg.float().cpu()]
    for i in range(4):
        if own:
            feed.append(int(logits[-1].argmax()))
        lg, cache = m.decode_step(cache, torch.tensor([[feed[i]]], **i32),
                                  torch.tensor([45 + i], **i32),
                                  page_table=pt)
        logits.append(lg.float().cpu())
    return torch.cat(logits)


def _walk_prefill(m, prompt, feed):
    """Logits [5, V] of the same walk as ``_walk`` through the
    full-sequence entry points: ``prefill`` of the 45-token prompt (its
    length passed as ``lengths``), then four ring ``decode_step``s fed
    ``feed``, or the model's own greedy tokens (appended to ``feed``)."""
    d = m.embed.device
    own = not feed
    i32 = dict(dtype=torch.int32, device=d)
    lg, cache = m.prefill(prompt.to(d), torch.tensor([45], **i32),
                          max_seq=64)
    logits = [lg.float().cpu()]
    for i in range(4):
        if own:
            feed.append(int(logits[-1].argmax()))
        lg, cache = m.decode_step(cache, torch.tensor([[feed[i]]], **i32),
                                  torch.tensor([45 + i], **i32))
        logits.append(lg.float().cpu())
    return torch.cat(logits)


def check_logits(cfg, state, dev, soften=None):
    """The model's entry points on the card against the plain path on the
    CPU, on a small input (chunked paged prefill, and full-sequence
    ``prefill``, each followed by greedy decode steps fed the CPU's
    tokens), at full width; ``state`` is a CPU state dict.

    The seeded weights follow the reference's init recipe, whose q/k
    projections (normal over fan_in = H for wq [d, H, hd]) make attention
    nearly one-hot: a 1e-6 relative change of the weights then moves the
    logits by O(1), so no two implementations could agree.  The check
    prints that sensitivity on the card, for the served weights and, for
    a model with attention, for the weights with wq and wk scaled by
    ``soften`` (scores O(1)), and compares implementations on the scaled
    ones."""
    from repro_torch.models.registry import build_model
    # float32 activations and parameters (bf16-stored weights upcast
    # exactly), so that a 1e-6 change of the weights is not rounded away
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(3, cfg.vocab_size, (1, 45), generator=g)
    variants = [("served", state)]
    if soften is not None:
        state = {k: v * (soften if k.endswith((".wq", ".wk")) else 1.0)
                 for k, v in state.items()}
        variants.append((f"q/k x {soften}", state))
    label = variants[-1][0]

    def run(c, st, d, feed, walk=_walk):
        m = build_model(c)
        m.load_state_dict(st)
        return walk(m.to(d), prompt, feed)

    for name, st in variants:
        noisy = {k: v.float() * (1 + 1e-6 * torch.randn(v.shape,
                                                        generator=g))
                 for k, v in st.items()}
        feed = []
        a = run(cfg32, st, dev, feed)
        b = run(cfg32, noisy, dev, feed)
        del noisy
        log(f"[check] {cfg.name}: sensitivity, {name} weights, cuda fp32: "
            f"a 1e-6 relative weight change moves logits by "
            f"{float((a - b).abs().max()):.3e} (logit scale "
            f"{float(a.abs().max()):.3f})")
    for path, walk in (("chunked paged prefill + paged decode", _walk),
                       ("prefill + ring decode", _walk_prefill)):
        feed = []
        ref = run(cfg32, state, torch.device("cpu"), feed, walk)
        out32 = run(cfg32, state, dev, feed, walk)
        out16 = run(cfg, state, dev, feed, walk)
        if not all(torch.isfinite(v).all() for v in (ref, out32, out16)):
            raise AssertionError("non-finite logits")
        err32 = float((out32 - ref).abs().max())
        err16 = float((out16 - ref).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(out16, ref,
                                                          dim=-1).min())
        log(f"[check] {cfg.name}, {cfg.num_layers} layers, {path}, logits "
            f"[{ref.shape[0]}, {ref.shape[-1]}], {label} weights: cuda fp32 "
            f"vs cpu fp32 max abs err {err32:.3e} (tol 1e-3); cuda "
            f"{cfg.dtype} vs cpu fp32 max abs err {err16:.3e} (tol 0.1), "
            f"min cosine {cos:.6f} (tol 0.999)")
        if err32 > 1e-3 or err16 > 0.1 or cos < 0.999:
            raise AssertionError("logits on the card disagree with the CPU")


def build_on_card(cfg, seed):
    """The model with seeded random weights, made on the card."""
    from repro_torch.models.registry import build_model
    with torch.device("cuda"):
        model = build_model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers "
        f"({' '.join(sorted(set(cfg.block_pattern)))}), d_model "
        f"{cfg.d_model}, {n_params} parameters ({cfg.param_dtype}), "
        f"activations {cfg.dtype}")
    return model


def cut(cfg, n_layers):
    """``cfg`` at full width and the first ``n_layers`` of its pattern."""
    return cfg.replace(num_layers=n_layers,
                       block_pattern=cfg.block_pattern[:n_layers])


def release():
    """Return the freed models' memory to the card before the next one."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(dev):
    """Each model's runs; returns the launch counts read just after each
    run of a kernel's path."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model, get_config
    runs = {}
    paged = ("paged_decode", "paged_extend")
    cfg = get_config("reflect_demo_100m")
    model = build_on_card(cfg, 0)
    eng, convos, runs["reflect_demo_100m"] = serve(
        model, "model", rounds=3, max_new=64, seed=1, path=paged)
    serve(model, "int8", rounds=2, max_new=32, seed=2, path=paged)
    profile_round(eng, convos)
    del eng
    eng, convos, runs["reflect_demo_100m ring"] = serve(
        model, "model", rounds=3, max_new=64, seed=1,
        path=("decode_attention",), paged=False)
    serve(model, "int8", rounds=2, max_new=32, seed=2,
          path=("decode_attention",), paged=False)
    profile_round(eng, convos)
    del eng
    release()
    runs["reflect_demo_100m full-sequence"] = full_sequence(
        model, B=8, S=2048, lengths=np.linspace(1500, 2048, 8).astype(int),
        steps=16, forward=True, path=("flash_attention", "decode_attention"))
    check_logits(cfg, {k: v.cpu() for k, v in model.state_dict().items()},
                 dev, soften=0.125)
    del model
    release()

    # the recurrent families at full width and depth, one at a time; the
    # logits check at a cut depth (one unit of the pattern), whose weights
    # are made on the CPU
    for arch, path, n_cut, soften in (
            ("falcon_mamba_7b", ("mamba_scan",), 2, None),
            ("recurrentgemma_9b", ("rglru_scan", "paged_extend",
                                   "paged_decode"), 3, 1 / 32)):
        cfg = get_config(arch)
        model = build_on_card(cfg, 0)
        eng, convos, runs[arch] = serve(model, "model", rounds=3,
                                        max_new=32, seed=3, path=path)
        profile_round(eng, convos, max_new=8)
        del eng
        release()
        if arch == "recurrentgemma_9b":
            eng, convos, runs[arch + " ring"] = serve(
                model, "model", rounds=3, max_new=32, seed=3,
                path=("rglru_scan", "decode_attention"), paged=False)
            profile_round(eng, convos, max_new=8)
            del eng
            release()
            runs[arch + " full-sequence"] = full_sequence(
                model, B=4, S=4096, lengths=None, steps=16, forward=False,
                path=("flash_attention", "decode_attention", "rglru_scan"))
        del model
        release()
        small = build_model(cut(cfg, n_cut)).init(
            torch.Generator().manual_seed(0))
        check_logits(small.cfg, small.state_dict(), dev, soften)
        del small
    ops.reset_launches()
    return runs


# ---------------------------------------------------------------- main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    records = phase_kernels(dev)
    runs = phase_serve(dev)
    kernels = []
    # each kernel's record at one shape its model's runs give it: paged
    # extend at Sx = 5 (the demo's verify steps make most of its
    # launches), the scans at the 32-lane mixed step with the serve's bf16
    # activations, ring decode and flash at the demo's bf16 shapes
    for name, key, run in (
            ("paged_decode", ("paged_decode", "demo", 1, "bfloat16"),
             "reflect_demo_100m"),
            ("paged_extend", ("paged_extend", "demo", 5, "bfloat16"),
             "reflect_demo_100m"),
            ("flash_attention", ("flash_attention", "demo", "bfloat16",
                                 None), "reflect_demo_100m full-sequence"),
            ("decode_attention", ("decode_attention", "demo", "bfloat16"),
             "reflect_demo_100m ring"),
            ("mamba_scan", ("mamba_scan", 32, "bfloat16"),
             "falcon_mamba_7b"),
            ("rglru_scan", ("rglru_scan", 32, "float32"),
             "recurrentgemma_9b")):
        rec = records[key]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": runs[run][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            "launches_by_run": {r: runs[r][name] for r in runs}})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
