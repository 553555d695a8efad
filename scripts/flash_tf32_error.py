#!/usr/bin/env python3
"""Where the float32 flash kernels' 3xTF32 products lose accuracy, on the
CPU.

    python3 scripts/flash_tf32_error.py [--batch B] [--step]
                                        [--variants NAME ...]

The float32 bodies of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` (``csrc/flash_tf32.cuh``) compute every
product as three TF32 products: each fp32 input split into ``hi =
tf32(x)`` and ``lo = tf32(x - hi)`` (rounded to nearest on the bits,
``cvt.rna.tf32.f32``), ``lo hi + hi lo + hi hi`` added into one fp32
accumulator a k-step of 8 terms.  This script emulates them in plain
PyTorch, as ``tests/test_torch_flash_tf32.py`` does, product by product
in the kernels' orientation: the forward's S = Q K^T and O = P V; the
dk/dv kernel's S^T = K Q^T and dP^T = V dO^T (P^T from the forward's lse),
dV = P^T dO and dK = dS^T Q; the dq kernel's S = Q K^T, dP = dO V^T and
dQ = dS K.  Besides all three-term products (``3xtf32``, the kernels) it
runs variants that change one product: ``4:<p>`` adds the fourth term
(lo lo, first), ``fp32:<p>`` computes it in plain fp32 (the CUDA-core
version's arithmetic), with <p> one of s (S and S^T, forward and
backward), pv, dp (dP and dP^T), dv, dk, dq; and ``fp32`` (every product
in plain fp32) and ``1xtf32``.  A ``+rz`` suffix adds each TF32 product
of a k-step, exact, into its accumulator rounded toward zero, as tensor
cores have been measured to (Fasi et al., "Numerical behavior of NVIDIA
tensor cores", 2021), not to nearest as fp32 adds do; ``3xtf32+rz-dv-dk``
(any products after the dashes) keeps round-to-nearest for the products
named, as a kernel that adds each step's products into its running sums
by fp32 adds would.  Not emulated: the
hardware ex2 (``ex2.approx``).

Kernel level: whisper-tiny's encoder attention [B, 6, 1500, 64] with the
bidirectional prefix P 1500, seeded inputs, q and k x 0.125 (near-uniform
attention, where dS = P (dP - D) is a small difference: as
``chip_smoke.py``'s whisper step has them); each gradient against float64:
the largest error over the largest magnitude, and the cosine.

Step level (``--step``, instead): whisper-tiny's whole float32 train step on the
CPU as ``chip_smoke.train_card_vs_cpu`` runs it (batch x 256 tokens of the
task corpus, seeded frames, q/k x 0.125, weights from seed 3 on the CPU):
the plain version's gradients against those with flash attention's
forward and backward emulated, for each variant the smallest cosine over
the gradient tensors and its tensor.  Needs no card; about 1 GB at B 2;
the kernel level takes about 5 minutes at B 1 on 8 cores, the step about
2 minutes a variant at B 2 (a ``+rz`` one about 5).
"""
import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634
PRODUCTS = ("s", "pv", "dp", "dv", "dk", "dq")


def tf32(x):
    """fp32 rounded to TF32 to nearest, ties away from zero, on the bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def round_to_zero(t):
    """float64 t to float32, rounded toward zero."""
    f = t.float()
    return torch.where(f.double().abs() > t.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def mm(a, b, terms):
    """a [..., M, n] @ b [..., n, N]: ``terms`` 3 (lo hi, hi lo, hi hi a
    k-step of 8), 4 (lo lo first), 1 (hi hi), "fp32" or "f64"; with a
    "+rz" suffix (3, 4, 1) each k-step product (exact) is added into the
    accumulator rounded toward zero, not to nearest."""
    if terms == "f64":
        return a.double() @ b.double()
    a, b = a.float(), b.float()
    if terms == "fp32":
        return a @ b
    rz = isinstance(terms, str) and terms.endswith("+rz")
    n = int(terms[:-3]) if rz else terms
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    pairs = {1: ((ah, bh),), 3: ((al, bh), (ah, bl), (ah, bh)),
             4: ((al, bl), (al, bh), (ah, bl), (ah, bh))}[n]
    acc = torch.zeros(*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]),
                      a.shape[-2], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        for x, y in pairs:
            if rz:
                acc = round_to_zero(acc.double()
                                    + x[..., s].double() @ y[..., s, :].double())
            else:
                acc = acc + x[..., s] @ y[..., s, :]
    return acc


def variant_terms(name):
    """{product: terms} of a variant's name."""
    if "+rz-" in name:  # rz but for the products named after it
        base, *rn = name.split("-")
        terms = variant_terms(base)
        terms.update(dict.fromkeys(rn, 3))
        return terms
    name, rz = (name[:-3], "+rz") if name.endswith("+rz") else (name, "")
    if name in ("fp32", "f64"):
        return dict.fromkeys(PRODUCTS, name)
    if name.endswith("xtf32"):
        n = int(name[0])
        return dict.fromkeys(PRODUCTS, f"{n}{rz}" if rz else n)
    how, p = name.split(":")
    terms = dict.fromkeys(PRODUCTS, f"3{rz}" if rz else 3)
    terms[p] = how if how == "fp32" else (f"{how}{rz}" if rz else int(how))
    return terms


def _valid(S, window, lengths, prefix):
    from repro_torch.kernels import ref
    return ref._flash_valid(S, window, lengths, torch.device("cpu"),
                            prefix)[:, None, None]          # [B|1,1,1,S,S]


def forward(q, k, v, window, lengths, prefix, terms):
    """(o, lse) as the forward kernel: S = Q K^T, online softmax in the
    log2 domain, O = P V; lse natural, +inf for a row with no key."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    dt = torch.float64 if terms["s"] == "f64" else torch.float32
    scale = hd ** -0.5
    q5 = q.reshape(B, K, H // K, S, hd)
    kt, vt = k[:, :, None], v[:, :, None]
    s = mm(q5, kt.transpose(-1, -2), terms["s"])
    s = s.masked_fill(~_valid(S, window, lengths, prefix), -torch.inf)
    m = s.amax(-1, keepdim=True) * scale * LOG2E
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp2(s * scale * LOG2E - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, vt, terms["pv"]) / torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, (m + torch.log2(l)) / LOG2E,
                      torch.full_like(l, torch.inf))
    return o.to(dt).reshape(B, H, S, hd), lse.reshape(B, H, S)


def backward(q, k, v, o, do, lse, window, lengths, prefix, terms):
    """(dq, dk, dv) as the backward kernels, each product in its kernel's
    orientation, P from the forward's lse."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = hd ** -0.5
    valid = _valid(S, window, lengths, prefix)
    q5, do5 = q.reshape(B, K, G, S, hd), do.reshape(B, K, G, S, hd)
    kt, vt = k[:, :, None], v[:, :, None]
    lse5 = lse.reshape(B, K, G, S, 1)
    o5 = o.reshape(B, K, G, S, hd)
    delta = ((do5.double() * o5.double()) if terms["dp"] == "f64"
             else do5 * o5.float()).sum(-1, keepdim=True)

    def probs(s):
        s = s.masked_fill(~valid, -torch.inf)
        return torch.exp2(s * scale * LOG2E - lse5 * LOG2E)

    # dk / dv kernel: keys as rows
    pt = probs(mm(kt, q5.transpose(-1, -2), terms["s"]).transpose(-1, -2))
    dpt = mm(vt, do5.transpose(-1, -2), terms["dp"]).transpose(-1, -2)
    dst = pt * (dpt - delta)
    dv = mm(pt.transpose(-1, -2), do5, terms["dv"]).sum(2)
    dk = (mm(dst.transpose(-1, -2), q5, terms["dk"]) * scale).sum(2)
    # dq kernel: queries as rows
    p = probs(mm(q5, kt.transpose(-1, -2), terms["s"]))
    ds = p * (mm(do5, vt.transpose(-1, -2), terms["dp"]) - delta)
    dq = mm(ds, kt, terms["dq"]) * scale
    return dq.reshape(B, H, S, hd), dk, dv


def compare(got, want):
    """(largest error / largest |want|, cosine) in float64."""
    g, w = got.double(), want.double()
    err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))
    cos = float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-300))
    return err, cos


VARIANTS = ("fp32", "3xtf32", "1xtf32",
            *(f"4:{p}" for p in PRODUCTS),
            *(f"fp32:{p}" for p in PRODUCTS),
            "3xtf32+rz", "4xtf32+rz",
            *(f"fp32:{p}+rz" for p in PRODUCTS))
STEP_VARIANTS = ("fp32", "3xtf32", "3xtf32+rz", "4xtf32+rz", "fp32:dk+rz",
                 "3xtf32+rz-dv-dk-dq", "3xtf32+rz-dv-dk-dq-pv")


def kernel_level(batch, variants):
    g = torch.Generator().manual_seed(11)
    B, H, S, hd, P = batch, 6, 1500, 64, 1500
    q, k, v, do = (torch.randn(B, H, S, hd, generator=g) for _ in range(4))
    q, k = q * 0.125, k * 0.125
    f64 = variant_terms("f64")
    o64, lse64 = forward(q, k, v, None, None, P, f64)
    want = backward(q, k, v, o64, do, lse64, None, None, P, f64)
    print(f"[tf32 error] kernel level: whisper's encoder attention [{B}, "
          f"{H}, {S}, {hd}] P {P}, q/k x 0.125, against float64; "
          "o: largest error over largest |o|; dq / dk / dv: largest error "
          "over largest |grad|, cosine", flush=True)
    for name in variants:
        terms = variant_terms(name)
        o, lse = forward(q, k, v, None, None, P, terms)
        grads = backward(q, k, v, o, do, lse, None, None, P, terms)
        eo = compare(o, o64)[0]
        rows = [compare(x, w) for x, w in zip(grads, want)]
        print(f"[tf32 error] {name:10s} o {eo:.3e}; " + "; ".join(
            f"{n} {e:.3e} {c:.10f}" for n, (e, c) in
            zip(("dq", "dk", "dv"), rows)), flush=True)


class _Emulated(torch.autograd.Function):
    terms = None

    @staticmethod
    def forward(ctx, q, k, v, window, lengths, prefix):
        o, lse = forward(q, k, v, window, lengths, prefix, _Emulated.terms)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (window, lengths, prefix)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*backward(q, k, v, o, do, lse, *ctx.args, _Emulated.terms),
                None, None, None)


def step_level(batch, variants):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.train.loop import (grads_of, make_loss_fn, params_of,
                                        to_device, trainable)
    from chip_smoke import scaled
    cfg = get_config("whisper_tiny").replace(dtype="float32",
                                             param_dtype="float32")
    data = to_device(dict(next(lm_batches(256, batch, 1))),
                     torch.device("cpu"))
    data["frames"] = torch.randn(batch, cfg.encoder_seq, cfg.d_model,
                                 generator=torch.Generator().manual_seed(4))
    state = scaled(build_model(cfg).init(
        torch.Generator().manual_seed(3)).state_dict(), 0.125)
    plain = fa.plain

    def grads(terms):
        fa.plain = plain if terms is None else (
            lambda q, k, v, window=None, lengths=None, prefix_len=0:
            _Emulated.apply(q, k, v, window, lengths, prefix_len))
        _Emulated.terms = terms
        try:
            m = build_model(cfg)
            m.load_state_dict(state)
            with trainable(m):
                loss, _ = make_loss_fn(m, cfg, TrainConfig(remat=False))(data)
                return float(loss.detach()), {
                    n: x.detach() for n, x in grads_of(
                        loss, params_of(m)).items()}
        finally:
            fa.plain = plain

    base_loss, base = grads(None)
    print(f"[tf32 error] step level: whisper-tiny, all layers, fp32, one "
          f"batch of {batch} x 256, q/k x 0.125; each variant's gradients "
          f"against the plain version's (loss {base_loss:.7f})", flush=True)
    for name in variants:
        loss, got = grads(variant_terms(name))
        cos = {n: compare(got[n], base[n])[1] for n in base}
        worst = sorted(cos, key=cos.get)[:3]
        print(f"[tf32 error] {name:10s} loss relative "
              f"{abs(loss - base_loss) / abs(base_loss):.2e}; smallest "
              "cosines " + ", ".join(f"{n} {cos[n]:.7f}" for n in worst),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--step", action="store_true",
                    help="the whisper step, not the kernel level")
    ap.add_argument("--variants", nargs="*", help="default: at the kernel "
                    f"level all ({', '.join(VARIANTS)}), in the step "
                    f"{', '.join(STEP_VARIANTS)}")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(min(8, torch.get_num_threads()))
    if args.step:
        step_level(args.batch, args.variants or STEP_VARIANTS)
    else:
        with torch.no_grad():
            kernel_level(args.batch, args.variants or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
