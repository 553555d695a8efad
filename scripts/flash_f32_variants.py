#!/usr/bin/env python3
"""Time variants of the float32 flash kernels (3xTF32 on the tensor cores)
against the tree's on one NVIDIA card, in turns within one loop, with SDPA
beside them.

    python3 scripts/flash_f32_variants.py [NAME ...]

Each variant is ``src/repro_torch/kernels/csrc`` copied into
``build/f32_variants/<name>`` with text of ``flash_tf32.cuh`` or of
``flash_attention_bwd.cu``'s fp32 body replaced (patches this script
carries: none is a switch in the kernels), the libraries it changes built
by nvcc with the port's flags, all at once (their ``-Xptxas -v`` register
and spill lines printed), and called through ctypes with the tree's C
signatures:

* ``fwd-bn32`` (``kFwdKeys64 = 32``): forward key tiles of 32 at HD 64;
* ``dkdv-one-stream`` (``kKvStreams = 1``): one warpgroup a dk/dv block
  walking every query step through two stages, not two warpgroups walking
  alternate steps through one stage each;
* ``dq-bn64`` (``kDqKeys64 = 64``, ``kDqStages64 = 1``): dq key tiles of
  64 at HD 64 through one stage;
* ``dq-bn16`` (``kDqKeys64 = 16``): of 16;
* ``fwd-wg1`` (``kFwdGroups64 = 1``, ``kFwdStages64 = 1``) and ``dq-wg1``
  (``kDqGroups64 = 1``, ``kDqStages64 = 1``): blocks of one warpgroup
  with one stage, small enough that two fit an SM, so that the two
  warpgroups of an SM need not wait for each other at every tile;
* ``dq-wg1-bn64``: ``dq-wg1`` with key tiles of 64 (one block an SM);
* ``dp-4xtf32``: dP = dO V^T (and dP^T) with the lo lo product as a
  fourth, first (a ``score4`` beside ``score3``), the product whose
  difference from D makes dS;
* ``no-promote``: O, dV, dK and dQ summed by the tensor cores over the
  whole walk, not a step's products into zeroed registers added into the
  running sums by fp32 adds (``accum3_step``; the tensor cores' adds
  round toward zero: ``flash_tf32_error.py``); ``promote-all``: summed
  apart also where the tree does not (the forward from HD 128, dk / dv
  at HD 256), whose registers then spill;
* ``kv-dup-scores`` (from HD 128) and ``dq-dup-scores`` (HD 256): each
  column warpgroup computing both score products, S^T and dP^T (S and dP)
  itself, instead of one each swapped through shared memory;
* ``splits-N`` (N 1, 2, 4, 16): the tree's backward with the dk/dv
  kernel's head groups forced to N (``cuda_lib.bwd_splits`` gives 8 at
  the hd 256 case, groups of two heads);

and ablations of ``flash_tf32.cuh``, timed only (their outputs are
wrong), each in all three kernels at once:

* ``ablate-one-product``: the hi hi product alone, not lo hi + hi lo + hi
  hi (what the tensor cores' share of the time is);
* ``ablate-staging``: ``stash`` returns at once, so no tile is loaded,
  split or stored (what moving the tiles in costs);
* ``ablate-split``, ``ablate-trans-stores``, ``ablate-asis-stores``: no
  tf32 rounding (hi = lo = x), no transposed stores, no as-is stores: the
  parts of that cost.

The cases are chip_smoke.py's timed float32 cases: whisper's encoder [8,
6, 1500, 64] with P 1500 (forward and backward), the demo's prefill [8,
12 / 4, 2048, 64] (forward), its training shape [8, 12 / 4, 256, 64]
(backward), and, with only the tree, the variants that change their code,
two ablations and ``splits-N``, internvl2's [1, 64 / 8, 2048, 128] with P 256 and
recurrentgemma's [1, 16 / 1, 4096, 256] with a window of 2048 (forward
and backward), cold L2 (a 256 MB write before each call);
the backward takes the lse of one forward launch.  Every variant is held
against the plain version first (1e-4, of max(|grad|, 1) for the
gradients).  Prints one line per case with the median milliseconds of
each, then, for each backward, the cosine and largest error (over the
largest magnitude) of its gradients against the plain version in float64
with q and k x 0.125 (attention near uniform, as chip_smoke.py's whisper
step has it), and the tree's device time by kernel (``torch.profiler``,
warm L2, a mean over 5 calls); exits non-zero without a CUDA device.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FWD, BWD, TF = "flash_attention.cu", "flash_attention_bwd.cu", "flash_tf32.cuh"
# score3 with lo lo as a fourth product, first (score4), for dp-4xtf32
_SCORE4 = """
template <int HD, int N>
__device__ __forceinline__ void score4(float* d, uint32_t a_hi, uint32_t a_lo,
                                       uint32_t b_hi, uint32_t b_lo) {
  constexpr uint32_t SBO = HD * 32;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const uint32_t o = 256 * kk;
    mma_ss<N>(d, tc::desc(a_lo + o, 128, SBO), tc::desc(b_lo + o, 128, SBO),
              kk > 0);
    mma_ss<N>(d, tc::desc(a_lo + o, 128, SBO), tc::desc(b_hi + o, 128, SBO),
              1);
    mma_ss<N>(d, tc::desc(a_hi + o, 128, SBO), tc::desc(b_lo + o, 128, SBO),
              1);
    mma_ss<N>(d, tc::desc(a_hi + o, 128, SBO), tc::desc(b_hi + o, 128, SBO),
              1);
  }
}

// A [64 x KD] accumulator tile"""
# name -> [(file, was, now, count), ...]
VARIANTS = {
    "fwd-bn32": [(TF, "kFwdKeys64 = 64;", "kFwdKeys64 = 32;", 1)],
    "fwd-wg1": [(TF, "kFwdGroups64 = 2;", "kFwdGroups64 = 1;", 1),
                (TF, "kFwdStages64 = 2;", "kFwdStages64 = 1;", 1)],
    "dkdv-one-stream": [(BWD, "kKvStreams = 2;", "kKvStreams = 1;", 1)],
    "dq-bn64": [(BWD, "kDqKeys64 = 32;", "kDqKeys64 = 64;", 1),
                (BWD, "kDqStages64 = 2;", "kDqStages64 = 1;", 1)],
    "dq-bn16": [(BWD, "kDqKeys64 = 32;", "kDqKeys64 = 16;", 1)],
    "dq-wg1": [(BWD, "kDqGroups64 = 2;", "kDqGroups64 = 1;", 1),
               (BWD, "kDqStages64 = 2;", "kDqStages64 = 1;", 1)],
    "dq-wg1-bn64": [(BWD, "kDqGroups64 = 2;", "kDqGroups64 = 1;", 1),
                    (BWD, "kDqKeys64 = 32;", "kDqKeys64 = 64;", 1),
                    (BWD, "kDqStages64 = 2;", "kDqStages64 = 1;", 1)],
    "dp-4xtf32": [(TF, "\n// A [64 x KD] accumulator tile", _SCORE4, 1),
                  (BWD, "tf::score3<HD, BM>(dpt,", "tf::score4<HD, BM>(dpt,",
                   2),
                  (BWD, "tf::score3<HD, BN>(dp,", "tf::score4<HD, BN>(dp,",
                   1)],
    "no-promote": [(TF, "  if constexpr (!PROMOTE) {",
                    "  if constexpr (true) {", 1)],
    "promote-all": [(TF, "  if constexpr (!PROMOTE) {",
                     "  if constexpr (false) {", 1)],
    "kv-dup-scores": [(BWD, "    if constexpr (CG == 1) {\n      tc::wg_fence();",
                       "    if constexpr (true) {\n      tc::wg_fence();", 1)],
    "dq-dup-scores": [(BWD, "constexpr int dq_cols() { return HD == 256 ? 2 : 1; }",
                       "constexpr int dq_cols() { return 1; }", 1)],
}
# name -> [(file, was, now, count), ...]; timed only
_HI = "tc::desc(a_hi + o, 128, SBO), tc::desc(b_hi + o, 128, SBO)"
_SS3 = ("    mma_ss<N>(d, tc::desc(a_lo + o, 128, SBO), "
        "tc::desc(b_hi + o, 128, SBO),\n"
        "              kk > 0);\n"
        "    mma_ss<N>(d, tc::desc(a_hi + o, 128, SBO), "
        "tc::desc(b_lo + o, 128, SBO),\n"
        "              1);\n"
        f"    mma_ss<N>(d, {_HI},\n"
        "              1);")
_SS1 = f"    mma_ss<N>(d, {_HI},\n              kk > 0);"
ABLATIONS = {
    "ablate-one-product": [
        (TF, _SS3, _SS1, 1),
        (TF, "      rs_n64(d, pl[kk], dh);\n"
             "      rs_n64(d, ph[kk], dl);\n", "", 1),
        (TF, "      rs_n32(d, pl[kk], dh);\n"
             "      rs_n32(d, ph[kk], dl);\n", "", 1)],
    "ablate-staging": [
        (TF, "  const int lane = tid & 31;\n",
         "  return;\n  const int lane = tid & 31;\n", 1),
        (TF, "uint32_t thi, uint32_t tlo) const {\n    if constexpr (kBlocks) {",
         "uint32_t thi, uint32_t tlo) const {\n    return;\n"
         "    if constexpr (kBlocks) {", 1)],
    "ablate-split": [(TF, "float& lo) {\n  hi = tf32_rna(x);\n"
                          "  lo = tf32_rna(x - hi);",
                      "float& lo) {\n  hi = x;\n  lo = x;", 1)],
    "ablate-trans-stores": [
        (TF, "    if constexpr (TRANS) {\n      const int p",
         "    if constexpr (false) {\n      const int p", 1),
        (TF, "        for (int e = 0; e < 4; ++e) {\n"
             "          const uint32_t o = trans_sw_off",
         "        for (int e = 0; e < 0; ++e) {\n"
         "          const uint32_t o = trans_sw_off", 1)],
    "ablate-asis-stores": [
        (TF, "    if constexpr (ASIS) {\n      const uint32_t o",
         "    if constexpr (false) {\n      const uint32_t o", 1),
        (TF, "          if constexpr (ASIS) {\n            const uint32_t o",
         "          if constexpr (false) {\n            const uint32_t o", 1)],
}
# the tree's libraries with the dk/dv kernel's head groups forced, at hd 256
SPLITS = {f"splits-{n}": n for n in (1, 2, 4, 16)}
# (tag, (B, H, K, S, hd), window, prefix, forward, backward, the variants
# timed there: None all but SPLITS)
_WIDE = ("tree", "no-promote", "promote-all", "kv-dup-scores",
         "ablate-one-product", "ablate-staging")
CASES = (("whisper", (8, 6, 6, 1500, 64), None, 1500, True, True, None),
         ("demo", (8, 12, 4, 2048, 64), None, 0, True, False, None),
         ("demo-train", (8, 12, 4, 256, 64), None, 0, False, True, None),
         ("internvl2", (1, 64, 8, 2048, 128), None, 256, True, True, _WIDE),
         ("rg", (1, 16, 1, 4096, 256), 2048, 0, True, True,
          (*_WIDE, "dq-dup-scores", *SPLITS)))


def patched(cuda_lib, name, edits):
    """A copy of the sources at build/f32_variants/<name> with ``edits``
    applied; returns the libraries it changes."""
    out = ROOT / "build" / "f32_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, out)
    touched = set()
    for path, was, now, count in edits:
        src = out / path
        text = src.read_text()
        # in flash_attention_bwd.cu, only the fp32 body (namespace tfb)
        at = text.index("namespace tfb {") if path == BWD else 0
        head, body = text[:at], text[at:]
        if body.count(was) != count:
            raise RuntimeError(f"{name}: {path} has {body.count(was)} of "
                               f"'{was}', not {count}")
        src.write_text(head + body.replace(was, now))
        touched.add(path)
    libs = set()
    if touched & {TF, FWD}:
        libs.add("flash_attention")
    if touched & {TF, BWD}:
        libs.add("flash_attention_bwd")
    return out, sorted(libs)


def build_variants(cuda_lib, names):
    """{name: {library: function}} of each variant, its changed libraries
    built by one nvcc each, all at once (``-Xptxas -v``'s register and
    spill lines printed)."""
    procs = []
    for n in names:
        out, libs = patched(cuda_lib, n, {**VARIANTS, **ABLATIONS}[n])
        for lib in libs:
            so = out / f"{lib}.so"
            procs.append((n, lib, so, subprocess.Popen(
                [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
                 str(out / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    fns = {n: {} for n in names}
    for n, lib, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{n} {lib} does not build:\n{log[-4000:]}")
        for line in log.splitlines():
            if "spill" in line or "registers" in line:
                print(f"[build] {n} {lib}: {line.strip()}")
        fn = getattr(ctypes.CDLL(str(so)), lib)
        fn.argtypes = cuda_lib._ARGTYPES[lib]
        fn.restype = ctypes.c_int
        fns[n][lib] = fn
    return fns


def forward(fn, q, k, v, window, prefix, with_lse=False):
    """One forward call of a library: (out, lse or None)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, S, device=q.device) if with_lse else None)
    err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, out.data_ptr(),
             0 if lse is None else lse.data_ptr(), B, K, H // K, hd, S,
             window or 0, prefix, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"forward launch failed: CUDA error {err}")
    return out, lse


def backward(fn, cuda_lib, q, k, v, o, do, lse, window, prefix, ns=None):
    """One backward call of a library at ``cuda_lib.bwd_splits`` head
    groups (or ``ns``)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    ns = ns or cuda_lib.bwd_splits(B, K, S, H // K,
                                   max_group=2 if hd == 256 else None)
    delta = torch.empty(B, H, S, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty(ns, 2, B, K, S, hd, device=q.device) if ns > 1
            else None)
    err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), 0, lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             0 if part is None else part.data_ptr(), B, K, H // K, hd, S,
             window or 0, prefix, ns, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"backward launch failed: CUDA error {err}")
    return dq, dk, dv


def accuracy(tag, libs, cuda_lib, q, k, v, do, window, P):
    """Each backward's gradients with q and k x 0.125 (attention near
    uniform, where dS = P (dP - D) is a small difference) against the
    plain version in float64: cosine and largest error over the largest
    magnitude; and the tree's forward output."""
    from repro_torch.kernels import ref
    qs, ks = q * 0.125, k * 0.125
    tree = libs["tree"]
    os_, ls = forward(tree["flash_attention"], qs, ks, v, window, P, True)
    d = [x.double() for x in (qs, ks, v, do)]
    want_o = ref.flash_attention_ref(*d[:3], window=window, prefix_len=P)
    err_o = float((os_ - want_o).abs().max() / want_o.abs().max())
    want = ref.flash_attention_bwd_ref(*d[:3], want_o, d[3], window=window,
                                       prefix_len=P)
    del d, want_o
    print(f"[f32 variants] {tag} tree fwd, q/k x 0.125: largest error / "
          f"largest |o| against float64 {err_o:.3e}", flush=True)
    for name, fns in libs.items():
        if name in ABLATIONS:
            continue
        got = backward(fns.get("flash_attention_bwd",
                               tree["flash_attention_bwd"]), cuda_lib, qs,
                       ks, v, os_, do, ls, window, P, SPLITS.get(name))
        cos = [float((x.double() * w).sum() / (x.double().norm() * w.norm()))
               for x, w in zip(got, want)]
        rel = [float((x.double() - w).abs().max() / w.abs().max())
               for x, w in zip(got, want)]
        print(f"[f32 variants] {tag} {name} bwd, q/k x 0.125, against "
              "float64: cosine dq/dk/dv "
              + " ".join(f"{c:.10f}" for c in cos)
              + "; largest error / largest |grad| "
              + " ".join(f"{r:.3e}" for r in rel), flush=True)


def main() -> int:
    names = sys.argv[1:] or [*VARIANTS, *ABLATIONS, *SPLITS]
    unknown = [n for n in names if n not in {**VARIANTS, **ABLATIONS,
                                             **SPLITS}]
    if unknown:
        print(f"flash_f32_variants: no variant {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import device_us_by_kernel, flash_valid
    from flash_variants import turns
    from repro_torch.kernels import cuda_lib, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.build(["flash_attention", "flash_attention_bwd"])
    tree = {lib: cuda_lib._function(lib)
            for lib in ("flash_attention", "flash_attention_bwd")}
    built = build_variants(cuda_lib, [n for n in names if n not in SPLITS])
    libs = {"tree": tree}
    for n in names:
        libs[n] = built.get(n, {})
    dev = torch.device("cuda")
    F = torch.nn.functional
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev).zero_
    g = torch.Generator().manual_seed(7)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for tag, (B, H, K, S, hd), W, P, fwd, bwd, only in CASES:
        mk = lambda *s: torch.randn(*s, generator=g).to(dev)
        q, k, v, do = mk(B, H, S, hd), mk(B, K, S, hd), mk(B, K, S, hd), \
            mk(B, H, S, hd)
        valid = flash_valid(S, W, None, dev, P)
        mask = valid[:, None] if (P or W) else None
        kw = dict(attn_mask=mask) if mask is not None else dict(is_causal=True)
        o, lse = forward(tree["flash_attention"], q, k, v, W, P, True)
        want_o = ref.flash_attention_ref(q, k, v, window=W, prefix_len=P)
        want = (ref.flash_attention_bwd_ref(q, k, v, o, do, window=W,
                                            prefix_len=P) if bwd else None)
        runs = {}
        for name, fns in libs.items():
            checked = name not in ABLATIONS
            # the wide head dims only for the variants that change them
            if name not in (only or [n for n in libs if n not in SPLITS]):
                continue
            f_fwd = fns.get("flash_attention", tree["flash_attention"])
            f_bwd = fns.get("flash_attention_bwd")
            if name == "tree" or name in SPLITS:
                f_bwd = tree["flash_attention_bwd"]
            err = float((forward(f_fwd, q, k, v, W, P)[0] - want_o).abs()
                        .max())
            if checked and err > 1e-4:
                if name == "tree":
                    raise AssertionError(f"{tag} {name} forward disagrees")
                print(f"[f32 variants] {tag} {name} fwd disagrees with the "
                      f"plain version: {err:.3e} (bound 1e-4); not timed",
                      flush=True)
                continue
            if fwd and (name == "tree" or "flash_attention" in fns):
                runs[f"{name} fwd"] = (lambda f=f_fwd: forward(f, q, k, v, W,
                                                               P))
            if bwd and f_bwd is not None:
                ns = SPLITS.get(name)
                errs = [(float((x - w).abs().max()),
                         1e-4 * max(float(w.abs().max()), 1.0))
                        for x, w in zip(backward(f_bwd, cuda_lib, q, k, v, o,
                                                 do, lse, W, P, ns), want)]
                if checked and any(e > b for e, b in errs):
                    if name == "tree":
                        raise AssertionError(f"{tag} {name} backward "
                                             f"disagrees: {errs}")
                    # a variant's (or a forced head-group count's): a
                    # finding, reported and not timed
                    print(f"[f32 variants] {tag} {name} bwd disagrees with "
                          "the plain version (dq / dk / dv largest error, "
                          f"bound): {errs}; not timed", flush=True)
                    continue
                runs[f"{name} bwd"] = (
                    lambda f=f_bwd, ns=ns: backward(f, cuda_lib, q, k, v, o,
                                                    do, lse, W, P, ns))
        del want
        if fwd:
            runs["SDPA fwd"] = lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **kw)
        if bwd:
            qa, ka, va = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qa, ka, va, enable_gqa=True,
                                                 **kw)
            runs["SDPA bwd"] = lambda: torch.autograd.grad(
                out, (qa, ka, va), do, retain_graph=True)
        times = turns(list(runs.values()), flush)
        print(f"[f32 variants] {tag} B={B} H={H} K={K} S={S} hd={hd} "
              f"window={W} prefix={P}: " + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in zip(runs, times)),
              flush=True)
        if bwd:
            accuracy(tag, {n: f for n, f in libs.items()
                           if f"{n} bwd" in runs
                           or (n in SPLITS and n in (only or ()))},
                     cuda_lib,
                     q, k, v, do, W, P)
        for n in ("tree fwd", "tree bwd"):
            if n in runs:
                print(f"[f32 variants] {tag} {n} by kernel (us a call, warm "
                      "L2): " + ", ".join(
                          f"{k_} {us:.1f}" for k_, us in
                          device_us_by_kernel(runs[n]).items()), flush=True)
        del q, k, v, do, o, lse, runs
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
