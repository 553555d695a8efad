"""The port's CUDA kernels on the card (marked ``gpu``; they skip without
a CUDA device).  This file imports no JAX, so it runs on the machine with
the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(float32 to 1e-4, bfloat16 against the plain version in float32 on the
same rounded inputs to 2e-2, int8 caches to 1e-4; the scans to 1e-4, and
the RG-LRU scan bit for bit), the flash bodies and the split ring and
page walks give bit-equal results from call to call (the flash forward
also with its lse output, which the backward needs in both dtypes; the
float32 bodies, 3xTF32 on the tensor cores, at every head dim with
windows, ragged lengths, empty rows and prefixes) (the paged kernels
also at forced split counts at the split walk's edges), the wrappers
refuse what the kernels do not take, and small engine and model runs on
the card launch the kernels of their models' paths.  The split walks
take the tuning table's count where it has an entry for this card (each
entry held against the plain version at the serves' shapes, the same bits
on a second call) and, with no table, give the bits of the heuristic's
count; a captured engine asks for and gets the eager engine's counts.  Engines whose steps
are captured as CUDA graphs give the eager engines' streams, bills and
launches, and a replay reads the page table it is given; so does the
paper's reflection loop (fixed and routed) over a captured engine; the
loop's backend takes a fault plan, and NaN or inf rows written into a
captured step's logits, with or without quarantine, leave the context
serving.  The MoE FFN gives the CPU's expert ids and outputs on the
card, and the same bits on every call.  The scans' backward kernels
match their written-out plain versions (mamba to 1e-4 absolute plus 1e-4
of each gradient's largest magnitude, the RG-LRU bit for bit) with the
same bits on a second call; the mamba forward keeps the tile states its
backward starts from only when a training call asks, with the same y and
h bits; the scans' autograd functions launch them,
and a 2-layer falcon-mamba-7b and recurrentgemma-9b train step on the
card matches the CPU's.  The flash kernels' bidirectional-prefix mode
(forward, its lse and the backward, bf16 and float32) matches the plain
versions, whisper's and the VLM's captured engines their eager ones, and
their smoke train steps with frames or patches the CPU's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_quant, ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, act, quant, B=3, Sx=6, K=2, G=3, hd=64, ps=16, NP=8,
            seed=0):
    """Scattered pages, unmapped tails, positions mid-page and one empty
    batch slot; returns CUDA operands and float32 CPU copies."""
    g = torch.Generator().manual_seed(seed)
    P = B * NP + 4
    q = torch.randn(B, Sx, K, G, hd, generator=g).to(act)
    kp = torch.randn(P, ps, K, hd, generator=g)
    vp = torch.randn(P, ps, K, hd, generator=g)
    pt = torch.randperm(P, generator=g)[:B * NP].view(B, NP).to(torch.int32)
    pos0 = torch.tensor([37, 90, NP * ps - Sx], dtype=torch.int32)[:B]
    for b in range(B):
        pt[b, (int(pos0[b]) + Sx + ps - 1) // ps:] = -1
    pt[B - 1] = -1
    sc = {}
    if quant:
        kp, ks, kz = kv_quant.quantize_k(kp)
        vp, vs = kv_quant.quantize_v(vp)
        sc = {"k_scale": ks, "k_zero": kz, "v_scale": vs}
    else:
        kp, vp = kp.to(act), vp.to(act)
    cpu = [q, kp, vp, pt, pos0]
    cuda = [t.to(dev) for t in cpu]
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in cpu]
    return cuda, {k: v.to(dev) for k, v in sc.items()}, f32, sc


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8",
                                  "int8+bf16"])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hd", [32, 64, 128, 192])
@pytest.mark.parametrize("ps,NP", [(16, 8), (5, 40)])
def test_kernels_match_plain(dev, mode, window, hd, ps, NP):
    """Page size 5 divides no stage width, so pages straddle stages."""
    act = torch.bfloat16 if "bf" in mode else torch.float32
    quant = mode.startswith("int8")
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    cuda, sc, f32, sc_cpu = _inputs(dev, act, quant, hd=hd, ps=ps, NP=NP)
    q, kp, vp, pt, pos0 = cuda
    fq, fkp, fvp, fpt, fpos = f32
    got = ops.paged_extend_attention(q, kp, vp, pt, pos0, window=window,
                                     **sc)
    want = ref.paged_extend_attention_ref(fq, fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
    got = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0,
                                     window=window, **sc)
    want = ref.paged_decode_attention_ref(fq[:, 0], fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 48, 2048])
def test_kernels_match_plain_mqa_hd256(dev, mode, window):
    """recurrentgemma-9b's local attention: K 1, G 16, hd 256."""
    act = torch.bfloat16 if mode == "bfloat16" else torch.float32
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    cuda, sc, f32, sc_cpu = _inputs(dev, act, mode == "int8", B=3, Sx=32,
                                    K=1, G=16, hd=256, ps=16, NP=160)
    q, kp, vp, pt, pos0 = cuda
    fq, fkp, fvp, fpt, fpos = f32
    got = ops.paged_extend_attention(q, kp, vp, pt, pos0, window=window,
                                     **sc)
    want = ref.paged_extend_attention_ref(fq, fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
    got = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0,
                                     window=window, **sc)
    want = ref.paged_decode_attention_ref(fq[:, 0], fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)


def _split_inputs(dev, act, quant, B, Sx, K, G, hd, NP, case, seed,
                  ps=16):
    """Scattered pages, unmapped tails and an empty last row, positions
    anywhere in the table; ``case`` "holes" unmaps every third page from
    page 2 to the middle (inside every row's range), "first" puts row 0's
    lane 0 at position 0 (a row of one slot).  Returns CUDA operands,
    float32 CPU copies and the int8 sidecars, as ``_inputs``."""
    g = torch.Generator().manual_seed(seed)
    P = B * NP + 4
    q = torch.randn(B, Sx, K, G, hd, generator=g).to(act)
    kp = torch.randn(P, ps, K, hd, generator=g)
    vp = torch.randn(P, ps, K, hd, generator=g)
    pt = torch.randperm(P, generator=g)[:B * NP].view(B, NP).to(torch.int32)
    top = NP * ps - Sx
    pos0 = torch.randint(top // 2, top + 1, (B,), generator=g).to(torch.int32)
    if case == "first":
        pos0[0] = 0
    if case == "holes":
        pt[:, 2:NP // 2:3] = -1
    for b in range(B):
        pt[b, (int(pos0[b]) + Sx + ps - 1) // ps:] = -1
    pt[B - 1] = -1
    sc = {}
    if quant:
        kp, ks, kz = kv_quant.quantize_k(kp)
        vp, vs = kv_quant.quantize_v(vp)
        sc = {"k_scale": ks, "k_zero": kz, "v_scale": vs}
    else:
        kp, vp = kp.to(act), vp.to(act)
    cpu = [q, kp, vp, pt, pos0]
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in cpu]
    return ([t.to(dev) for t in cpu], {k: v.to(dev) for k, v in sc.items()},
            f32, sc)


def _forced(splits):
    """A stand-in for ``tuning.splits`` that forces the count of every
    split walk, as the wrappers ask it for theirs."""
    return lambda kernel, device, **dims: (splits, "forced")


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8",
                                  "int8+bf16"])
@pytest.mark.parametrize("B,Sx,K,G,hd,NP,splits,window,case", [
    (3, 5, 2, 3, 64, 16, 1, None, "plain"),      # one split
    (3, 5, 2, 3, 64, 16, 64, None, "plain"),     # more splits than stages
    (3, 5, 2, 3, 64, 16, 9, None, "first"),      # rows of length 1
    (3, 32, 2, 3, 64, 16, 3, 48, "plain"),       # window edge in a segment
    (3, 32, 2, 3, 64, 24, 4, None, "holes"),     # unmapped pages mid-range
    (2, 32, 1, 16, 256, 24, 5, 100, "holes"),    # 512 rows, hd 256
    (3, 5, 4, 3, 64, 24, 9, None, "holes"),      # a verify step's 15 rows
    (2, 3, 2, 5, 128, 12, 7, None, "first"),     # 15 rows at hd 128
    (2, 7, 2, 4, 32, 12, 6, 20, "holes"),        # 28 rows at hd 32
])
def test_split_paged_kernels(dev, monkeypatch, mode, B, Sx, K, G, hd, NP,
                             splits, window, case):
    """Both paged kernels with a forced split count at the split walk's
    edges (bf16 extend on the tensor cores, float32 on the staged walk),
    against the plain version (float32 1e-4, bfloat16 2e-2, int8 1e-4,
    int8 + bf16 2e-2) and the one-split call, bit-equal across two calls;
    the empty last row is page 0's mean V, as in the TPU kernels."""
    from repro_torch.kernels import tuning
    act = torch.bfloat16 if "bf" in mode else torch.float32
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    cuda, sc, f32, sc_cpu = _split_inputs(dev, act, mode.startswith("int8"),
                                          B, Sx, K, G, hd, NP, case,
                                          seed=NP + splits + Sx)
    q, kp, vp, pt, pos0 = cuda
    fq, fkp, fvp, fpt, fpos = f32
    for fn, plain, qq, fqq in (
            (ops.paged_extend_attention, ref.paged_extend_attention_ref, q,
             fq),
            (ops.paged_decode_attention, ref.paged_decode_attention_ref,
             q[:, 0].contiguous(), fq[:, 0])):
        monkeypatch.setattr(tuning, "splits", _forced(splits))
        got = fn(qq, kp, vp, pt, pos0, window=window, **sc)
        again = fn(qq, kp, vp, pt, pos0, window=window, **sc)
        monkeypatch.setattr(tuning, "splits", _forced(1))
        one = fn(qq, kp, vp, pt, pos0, window=window, **sc)
        want = plain(fqq, fkp, fvp, fpt, fpos, window=window, **sc_cpu)
        torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
        torch.testing.assert_close(got.float(), one.float(), atol=tol,
                                   rtol=0)
        assert torch.equal(got, again)
        v0 = ref._dequant(fkp[0], fvp[0], *(sc_cpu[n][0] if n in sc_cpu
                                            else None for n in (
                                                "k_scale", "k_zero",
                                                "v_scale")))[1]
        torch.testing.assert_close(
            got[B - 1].float().cpu(),
            v0.float().mean(0)[:, None].expand_as(got[B - 1]), atol=tol,
            rtol=0)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8",
                                  "int8+bf16"])
@pytest.mark.parametrize("window", [None, 4])
def test_paged_rows_without_valid_slot(dev, mode, window):
    """Rows with no valid slot get the TPU kernels' value, the mean of the
    V rows their table gathers (page 0's for unmapped entries), in both
    paged kernels: an idle batch slot (no page mapped) and, with window 4,
    lanes whose window holds only an unmapped page while other pages of
    the table are mapped."""
    act = torch.bfloat16 if "bf" in mode else torch.float32
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    quant = mode.startswith("int8")
    cuda, sc, f32, sc_cpu = _inputs(dev, act, quant, B=3, Sx=6)
    if window is not None:
        # row 0's lanes 0..2 (positions 45..47) see only page 2, unmapped;
        # lanes 3..5 reach into page 3, mapped to a free page
        free = min(set(range(f32[1].shape[0]))
                   - set(f32[3].flatten().tolist()))
        for t in (cuda, f32):
            t[4][0] = 45
            t[3][0, 2] = -1
            t[3][0, 3] = free
    q, kp, vp, pt, pos0 = cuda
    fq, fkp, fvp, fpt, fpos = f32
    for fn, plain, qq, fqq in (
            (ops.paged_extend_attention, ref.paged_extend_attention_ref, q,
             fq),
            (ops.paged_decode_attention, ref.paged_decode_attention_ref,
             q[:, 0].contiguous(), fq[:, 0])):
        got = fn(qq, kp, vp, pt, pos0, window=window, **sc)
        want = plain(fqq, fkp, fvp, fpt, fpos, window=window, **sc_cpu)
        torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)


def test_paged_splits_in_use(dev, monkeypatch):
    """The wrappers split reflect_demo_100m's and recurrentgemma-9b's
    decode, verify and chunk shapes (128-page tables) as ``tuning.splits``
    says for their tiles: ``paged_splits``'s count, unless the tuning
    table has an entry for this card and shape."""
    from repro_torch.kernels import cuda_lib, tuning
    real, seen = tuning.splits, []

    def record(kernel, device, **dims):
        n, source = real(kernel, device, **dims)
        tiles = dims.get("tiles", 1)
        heuristic = cuda_lib.paged_splits(dims["b"], dims["k"], tiles,
                                          dims["slots"], dims["hd"])
        seen.append(heuristic)
        if source == "heuristic":
            assert n == heuristic
        else:
            assert n == tuning.lookup(kernel, device, **dims)["splits"]
        return n, source

    monkeypatch.setattr(tuning, "splits", record)
    for act, Sx, K, G, hd in ((torch.bfloat16, 1, 4, 3, 64),
                              (torch.bfloat16, 1, 1, 16, 256),
                              (torch.bfloat16, 5, 4, 3, 64),
                              (torch.bfloat16, 32, 4, 3, 64),
                              (torch.bfloat16, 32, 1, 16, 256),
                              (torch.float32, 32, 4, 3, 64)):
        cuda, sc, _, _ = _split_inputs(dev, act, False, 8, Sx, K, G, hd,
                                       128, "plain", seed=Sx)
        q, kp, vp, pt, pos0 = cuda
        if Sx == 1:
            ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt,
                                       pos0)
        else:
            ops.paged_extend_attention(q, kp, vp, pt, pos0)
    torch.cuda.synchronize()
    assert seen == [9, 33, 9, 9, 9, 2]


def _scan_inputs(B, S, D, N, seed):
    """Mamba scan operands as the model makes them: softplus step sizes,
    a negative A, a nonzero h0, and pad lanes (dt = 0) at the end of every
    row but the first."""
    g = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, S, D, generator=g)
                                      - 2.0)
    n_valid = torch.tensor([S] + [max(1, S - 3 * b) for b in range(1, B)])
    dt = dt * (torch.arange(S)[None, :] < n_valid[:, None])[..., None]
    return (dt, torch.randn(B, S, N, generator=g),
            torch.randn(B, S, N, generator=g),
            torch.randn(B, S, D, generator=g),
            -torch.exp(0.5 * torch.randn(D, N, generator=g)),
            torch.randn(D, generator=g),
            torch.randn(B, D, N, generator=g), n_valid)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N", [(8, 32, 8192, 16), (3, 5, 300, 8),
                                     (2, 70, 256, 4), (8, 1, 8192, 16)])
def test_mamba_scan_matches_plain(dev, x_dtype, B, S, D, N):
    """falcon-mamba-7b's mixed-step and decode shapes, and ragged ones;
    the state after pad lanes is the state after the last valid token."""
    dt, Bm, Cm, x, A, Dsk, h0, n_valid = _scan_inputs(B, S, D, N, 0)
    x = x.to(x_dtype)
    args = [t.to(dev) for t in (dt, Bm, Cm, x, A, Dsk, h0)]
    y, h = ops.mamba_scan(*args)
    want_y, want_h = ref.mamba_scan_ref(dt, Bm, Cm, x.float(), A, Dsk, h0)
    torch.testing.assert_close(y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h.cpu(), want_h, atol=1e-4, rtol=1e-4)
    for b in range(B):                        # pads leave h untouched
        nv = int(n_valid[b])
        _, hb = ref.mamba_scan_ref(dt[b:b + 1, :nv], Bm[b:b + 1, :nv],
                                   Cm[b:b + 1, :nv], x[b:b + 1, :nv].float(),
                                   A, Dsk, h0[b:b + 1])
        torch.testing.assert_close(h[b:b + 1].cpu(), hb, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B,S,D", [(3, 33, 65), (2, 100, 129)])
def test_mamba_scan_layout_edges(dev, x_dtype, N, B, S, D):
    """The lane split's edges: D one channel past a 64-channel block, S
    past one 32-step tile, every state size, pad lanes in every row but
    the first."""
    dt, Bm, Cm, x, A, Dsk, h0, n_valid = _scan_inputs(B, S, D, N, D + N)
    x = x.to(x_dtype)
    y, h = ops.mamba_scan(*[t.to(dev) for t in (dt, Bm, Cm, x, A, Dsk,
                                                 h0)])
    want_y, want_h = ref.mamba_scan_ref(dt, Bm, Cm, x.float(), A, Dsk, h0)
    torch.testing.assert_close(y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h.cpu(), want_h, atol=1e-4, rtol=1e-4)
    for b in range(1, B):                     # pads leave h untouched
        nv = int(n_valid[b])
        assert nv < S
        _, hb = ref.mamba_scan_ref(dt[b:b + 1, :nv], Bm[b:b + 1, :nv],
                                   Cm[b:b + 1, :nv], x[b:b + 1, :nv].float(),
                                   A, Dsk, h0[b:b + 1])
        torch.testing.assert_close(h[b:b + 1].cpu(), hb, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("B,S,W", [(8, 32, 4096), (3, 7, 300), (8, 1, 4096),
                                   (2, 4096, 256), (2, 100, 257),
                                   (3, 70, 1), (2, 31, 300), (2, 33, 300)])
def test_rglru_scan_matches_plain(dev, B, S, W):
    """recurrentgemma-9b's mixed-step and decode shapes, a ragged one, a
    long sequence of many register tiles, widths one channel past a
    256-channel block and below it, and calls one step short of a
    register tile and one step past it, with identity pad lanes: the
    kernel rounds as the plain version does, so the two agree bit for
    bit."""
    g = torch.Generator().manual_seed(1)
    a = torch.sigmoid(torch.randn(B, S, W, generator=g))
    b = torch.randn(B, S, W, generator=g)
    a[1:, S // 2:], b[1:, S // 2:] = 1.0, 0.0
    h0 = torch.randn(B, W, generator=g)
    hs, h = ops.rglru_scan(a.to(dev), b.to(dev), h0.to(dev))
    want_hs, want_h = ref.rglru_scan_ref(a, b, h0)
    torch.testing.assert_close(hs.cpu(), want_hs, atol=0, rtol=0)
    torch.testing.assert_close(h.cpu(), want_h, atol=0, rtol=0)


def test_scan_wrappers_count_launches_and_refuse_bad_operands(dev):
    dt, Bm, Cm, x, A, Dsk, h0, _ = _scan_inputs(2, 4, 256, 8, 2)
    args = [t.to(dev) for t in (dt, Bm, Cm, x, A, Dsk, h0)]
    a = torch.rand(2, 4, 256, device=dev)
    ops.reset_launches()
    ops.mamba_scan(*args)
    ops.rglru_scan(a, a, a[:, 0].contiguous())
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == 1 and ops.LAUNCHES["rglru_scan"] == 1
    with pytest.raises(ValueError):          # state size the kernel lacks
        ops.mamba_scan(*args[:4], args[4][:, :5].contiguous(), args[5],
                       args[6][..., :5].contiguous())
    with pytest.raises(ValueError):          # bf16 step sizes
        ops.mamba_scan(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):          # operands on two devices
        ops.mamba_scan(*args[:6], args[6].cpu())
    x_off = torch.empty(args[3].numel() + 1, device=dev)[1:]
    with pytest.raises(ValueError):          # x not 16-byte aligned
        ops.mamba_scan(*args[:3], x_off.view_as(args[3]), *args[4:])
    with pytest.raises(ValueError):          # non-contiguous decay
        ops.rglru_scan(a.transpose(0, 1), a, a[:, 0].contiguous())
    assert ops.LAUNCHES["mamba_scan"] == 1 and ops.LAUNCHES["rglru_scan"] == 1


def test_wrappers_count_launches_and_refuse_bad_operands(dev):
    (q, kp, vp, pt, pos0), _, _, _ = _inputs(dev, torch.float32, False)
    ops.reset_launches()
    ops.paged_extend_attention(q, kp, vp, pt, pos0)
    ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode"] == 1
    assert ops.LAUNCHES["paged_extend"] == 1
    with pytest.raises(ValueError):          # int64 page table
        ops.paged_extend_attention(q, kp, vp, pt.long(), pos0)
    with pytest.raises(ValueError):          # non-contiguous q
        ops.paged_decode_attention(q[:, 0], kp, vp, pt, pos0)
    with pytest.raises(ValueError):          # pool dtype != q dtype
        ops.paged_extend_attention(q, kp.bfloat16(), vp.bfloat16(), pt,
                                   pos0)
    with pytest.raises(ValueError):          # head_dim the kernels lack
        ops.paged_extend_attention(q[..., :48].contiguous(),
                                   kp[..., :48].contiguous(),
                                   vp[..., :48].contiguous(), pt, pos0)
    with pytest.raises(ValueError):          # operands on two devices
        ops.paged_extend_attention(q, kp.cpu(), vp, pt, pos0)
    assert ops.LAUNCHES["paged_decode"] == 1
    assert ops.LAUNCHES["paged_extend"] == 1


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_engine_on_card_launches_both_kernels(dev, kv_dtype):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status

    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0))
    eng = Engine(m, ServeConfig(max_batch=2, max_seq=128, page_size=16,
                                spec_decode=True, kv_dtype=kv_dtype),
                 device="cuda")
    ops.reset_launches()
    prompt = [1] + list(range(10, 22)) * 3
    reqs = [Request(prompt=list(prompt), max_new_tokens=12, eos_id=None)
            for _ in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.status is Status.DONE and len(r.output) == 12
               for r in reqs)
    assert ops.LAUNCHES["paged_decode"] > 0, ops.LAUNCHES
    assert ops.LAUNCHES["paged_extend"] > 0, ops.LAUNCHES
    eng.pool.check()


@pytest.mark.parametrize("arch,kernels", [
    ("falcon_mamba_7b", ("mamba_scan",)),
    ("recurrentgemma_9b", ("rglru_scan", "paged_extend", "paged_decode"))])
def test_engine_on_card_serves_recurrent_models(dev, arch, kernels):
    """Two reflection rounds of the smoke model on the card: every kernel
    of the model's path launches and round 2 hits the prefix cache."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status

    m = build_model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0))
    eng = Engine(m, ServeConfig(max_batch=2, max_seq=128, page_size=8,
                                prefill_chunk=8), device="cuda")
    ops.reset_launches()
    convo = [1] + list(range(10, 50))
    for _ in range(2):
        r = Request(prompt=list(convo), max_new_tokens=6, eos_id=None)
        eng.submit(r)
        eng.run()
        assert r.status is Status.DONE and len(r.output) == 6
        convo += r.output + [99, 98]
    assert all(ops.LAUNCHES[k] > 0 for k in kernels), ops.LAUNCHES
    assert eng.prefix_cache.stats["hits"] > 0
    eng.pool.check()


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8",
                                  "int8+bf16"])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("Sx", [5, 32])
def test_kernels_match_plain_gqa_hd192(dev, mode, window, Sx):
    """nemotron-4-340b's attention: K 8, G 12, hd 192 (the staged walk's
    three V columns a thread; 16-row fp32 extend tiles; bf16 extend on one
    warpgroup at Sx 5, 60 rows, and two at Sx 32, 384 rows)."""
    act = torch.bfloat16 if "bf" in mode else torch.float32
    quant = mode.startswith("int8")
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    cuda, sc, f32, sc_cpu = _inputs(dev, act, quant, B=3, Sx=Sx, K=8, G=12,
                                    hd=192, ps=16, NP=24, seed=Sx)
    q, kp, vp, pt, pos0 = cuda
    fq, fkp, fvp, fpt, fpos = f32
    got = ops.paged_extend_attention(q, kp, vp, pt, pos0, window=window,
                                     **sc)
    want = ref.paged_extend_attention_ref(fq, fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
    got = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0,
                                     window=window, **sc)
    want = ref.paged_decode_attention_ref(fq[:, 0], fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)


# ------------------------------------------------- ring decode and flash

def _ring_inputs(act, quant, B, K, G, hd, C, seed):
    """A wrapped ring per row (positions past C), empty slots, slots
    holding tokens past pos (a rejected draft's writes), and an empty
    last row; returns (q, k, v, tok, pos, scales) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, K, G, hd, generator=g).to(act)
    k = torch.randn(B, C, K, hd, generator=g)
    v = torch.randn(B, C, K, hd, generator=g)
    pos = torch.randint(C // 2, 3 * C, (B,), generator=g)
    c = torch.arange(C)
    tok = pos[:, None] - (pos[:, None] - c[None, :]) % C  # latest t == c mod C
    tok[(tok < 0) | (torch.rand(B, C, generator=g) < 0.1)] = -1
    ahead = (c[None, :] - pos[:, None] % C) % C
    tok = torch.where((ahead >= 1) & (ahead <= 3), pos[:, None] + ahead, tok)
    tok[B - 1] = -1
    sc = {}
    if quant:
        k, ks, kz = kv_quant.quantize_k(k)
        v, vs = kv_quant.quantize_v(v)
        sc = {"k_scale": ks, "k_zero": kz, "v_scale": vs}
    else:
        k, v = k.to(act), v.to(act)
    return q, k, v, tok.to(torch.int32), pos.to(torch.int32), sc


def _f32(t):
    return t.float() if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8",
                                  "int8+bf16"])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("B,K,G,hd,C", [(8, 4, 3, 64, 2048),
                                        (8, 1, 16, 256, 2048),
                                        (3, 2, 5, 32, 300),
                                        (2, 2, 8, 128, 130),
                                        (8, 8, 12, 192, 2048),
                                        (3, 1, 5, 192, 300)])
def test_ring_decode_matches_plain(dev, mode, window, B, K, G, hd, C):
    """reflect_demo_100m's, recurrentgemma-9b's and nemotron-4-340b's
    decode shapes and three ragged rings (C not a multiple of a stage)."""
    act = torch.bfloat16 if "bf" in mode else torch.float32
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    q, k, v, tok, pos, sc = _ring_inputs(act, mode.startswith("int8"), B, K,
                                         G, hd, C, seed=C + hd)
    got = ops.decode_attention(q.to(dev), k.to(dev), v.to(dev), tok.to(dev),
                               pos.to(dev), window=window,
                               **{n: t.to(dev) for n, t in sc.items()})
    want = ref.decode_attention_ref(_f32(q), _f32(k), _f32(v), tok, pos,
                                    window=window, **sc)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
    assert not got[B - 1].any()                 # the empty row is zeros


def _flash_inputs(act, B, H, K, S, hd, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, S, hd, generator=g).to(act),
            torch.randn(B, K, S, hd, generator=g).to(act),
            torch.randn(B, K, S, hd, generator=g).to(act))


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,hd,window,ragged", [
    (8, 12, 4, 2048, 64, None, False),   # reflect_demo_100m's prefill
    (8, 12, 4, 2048, 64, 48, False),
    (4, 16, 1, 4096, 256, 2048, False),  # recurrentgemma-9b's prefill
    (3, 12, 4, 1000, 64, None, True),    # ragged S and lengths
    (2, 4, 2, 77, 32, 16, True),
    (2, 8, 2, 300, 128, None, False),
    (2, 24, 2, 1000, 192, None, True),   # nemotron-4-340b's G 12, hd 192
    (2, 12, 1, 300, 192, 48, False)])
def test_flash_matches_plain(dev, act, B, H, K, S, hd, window, ragged):
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    q, k, v = _flash_inputs(act, B, H, K, S, hd, seed=S + hd)
    lengths = (torch.tensor([S, S // 2, 1][:B], dtype=torch.int32)
               if ragged else None)
    got = ops.flash_attention(q.to(dev), k.to(dev), v.to(dev), window=window,
                              lengths=None if lengths is None
                              else lengths.to(dev))
    want = ref.flash_attention_ref(_f32(q).to(dev), _f32(k).to(dev),
                                   _f32(v).to(dev), window=window,
                                   lengths=None if lengths is None
                                   else lengths.to(dev))
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("B,H,K,S,hd,window,lengths", [
    (2, 3, 1, 65, 32, None, None),          # S one past a query tile, G 3
    (2, 16, 1, 1000, 256, 48, [1000, 1]),   # G 16, window below a key tile
    (3, 4, 4, 1000, 128, 2048, [517, 1000, 1]),  # G 1
    (2, 6, 2, 1000, 64, None, [1, 999]),
    (2, 6, 2, 65, 64, 48, [65, 33]),
    (1, 16, 1, 65, 256, 2048, None),
    (2, 12, 4, 2048, 32, 2048, None),
    (2, 12, 1, 65, 192, 48, [65, 33]),      # hd 192, G 12
])
def test_flash_bf16_tensor_core_edges(dev, B, H, K, S, hd, window, lengths):
    """The bf16 tensor-core body at ragged S (not a multiple of the 64-row
    query tile or the key tile), every head dim, G 1 / 3 / 16, windows
    below a key tile and of 2048, ragged lengths down to 1; two calls are
    bit-equal."""
    q, k, v = (t.to(dev) for t in _flash_inputs(torch.bfloat16, B, H, K, S,
                                                 hd, seed=S * hd + H))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=dev))
    got = ops.flash_attention(q, k, v, window=window, lengths=lens)
    again = ops.flash_attention(q, k, v, window=window, lengths=lens)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   window=window, lengths=lens)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)
    assert torch.equal(got, again)


def _one_segment(tok, lo, hi):
    tok = tok.clone()
    tok[:, :lo] = -1
    tok[:, hi:] = -1
    return tok


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B,K,G,hd,C,splits,window,segment", [
    (8, 1, 16, 256, 2048, 1, None, None),     # the unsplit walk
    (8, 1, 16, 256, 2048, 64, 2048, None),    # recurrentgemma, many splits
    (3, 2, 5, 32, 300, 7, None, None),        # C not a multiple of splits
    (8, 4, 3, 64, 2048, 9, 48, None),         # window 48: most splits empty
    (2, 2, 8, 128, 512, 8, None, (128, 192)),  # every slot in split 2
])
def test_split_ring_decode(dev, monkeypatch, mode, B, K, G, hd, C, splits,
                           window, segment):
    """The ring walk split into a forced number of segments, against the
    plain version (float32 1e-4, bfloat16 2e-2, int8 1e-4), against the
    one-split walk, and bit-equal across two calls; the empty last row is
    zeros."""
    from repro_torch.kernels import tuning
    act = torch.bfloat16 if mode == "bfloat16" else torch.float32
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    q, k, v, tok, pos, sc = _ring_inputs(act, mode == "int8", B, K, G, hd,
                                         C, seed=C + splits)
    if segment is not None:
        tok = _one_segment(tok, *segment)
    args = [t.to(dev) for t in (q, k, v, tok, pos)]
    kw = {n: t.to(dev) for n, t in sc.items()}
    monkeypatch.setattr(tuning, "splits", _forced(splits))
    got = ops.decode_attention(*args, window=window, **kw)
    again = ops.decode_attention(*args, window=window, **kw)
    monkeypatch.setattr(tuning, "splits", _forced(1))
    one = ops.decode_attention(*args, window=window, **kw)
    want = ref.decode_attention_ref(_f32(q), _f32(k), _f32(v), tok, pos,
                                    window=window, **sc)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
    torch.testing.assert_close(got.float(), one.float(), atol=tol, rtol=0)
    assert torch.equal(got, again)
    assert not got[B - 1].any()


def test_ring_splits_in_use(dev):
    """The wrapper splits recurrentgemma-9b's and reflect_demo_100m's
    rings as ``ring_splits`` says, and the all-empty ring row of a split
    call is zeros."""
    from repro_torch.kernels import cuda_lib
    assert cuda_lib.ring_splits(8, 1, 2048, 256) == 33
    assert cuda_lib.ring_splits(8, 4, 2048, 64) == 9
    q, k, v, tok, pos, _ = _ring_inputs(torch.bfloat16, False, 8, 1, 16, 256,
                                        2048, 3)
    tok[:] = -1
    got = ops.decode_attention(*(t.to(dev) for t in (q, k, v, tok, pos)))
    assert got.shape == (8, 1, 16, 256) and not got.any()


# the serves' split-walk shapes the tuning sweep times (batch 8, 128-page
# tables of 16 slots, rings of 2048): (kernel, K, G, hd, Sx, window)
SERVE_SPLIT_CASES = (
    ("paged_decode", 4, 3, 64, 1, None), ("paged_extend", 4, 3, 64, 5, None),
    ("paged_extend", 4, 3, 64, 32, None), ("paged_decode", 8, 2, 64, 1, None),
    ("paged_extend", 8, 2, 64, 5, None), ("paged_extend", 8, 2, 64, 32, None),
    ("paged_decode", 1, 16, 256, 1, 2048),
    ("paged_extend", 1, 16, 256, 32, 2048),
    ("decode", 4, 3, 64, 1, None), ("decode", 8, 2, 64, 1, None),
    ("decode", 1, 16, 256, 1, 2048))


def test_tuned_entries_match_plain_versions(dev):
    """Every entry the tuning table holds for this card is reached by one
    of the serves' shapes, and there the wrapper launches the table's count
    (clamped) and agrees with its plain version at today's tolerances
    (float32 1e-4, bfloat16 2e-2, int8 1e-4), the same bits on a second
    call; elsewhere it launches the heuristic's count."""
    from repro_torch.kernels import cuda_lib, tuning
    from repro_torch.kernels.decode_attention import split_plan as ring_plan
    from repro_torch.kernels.paged_attention import split_plan as dec_plan
    from repro_torch.kernels.paged_extend import split_plan as ext_plan
    table = tuning.load_table(refresh=True)
    be = tuning.backend_key(dev)
    entries = {(k, key) for k, per in table.items()
               for key in per.get(be, {})}
    reached = set()
    for kernel, K, G, hd, Sx, window in SERVE_SPLIT_CASES:
        for mode in ("float32", "bfloat16", "int8", "int8+bf16"):
            act = torch.bfloat16 if "bf" in mode else torch.float32
            quant = mode.startswith("int8")
            tol = 2e-2 if act == torch.bfloat16 else 1e-4
            code = cuda_lib.DTYPE_CODES[(act, torch.int8 if quant else act)]
            if kernel == "decode":
                n, source = ring_plan(dev, 8, K, 2048, hd)
                dims = dict(b=8, k=K, slots=2048, hd=hd)
            elif kernel == "paged_decode":
                n, source = dec_plan(dev, 8, K, hd, 2048)
                dims = dict(b=8, k=K, slots=2048, hd=hd)
            else:
                n, source = ext_plan(dev, 8, Sx, K, G, hd, 2048, code)
                rows = cuda_lib.extend_rows(hd, Sx * G, code)
                dims = dict(b=8, k=K, tiles=-(-Sx * G // rows), slots=2048,
                            hd=hd)
            if source == "heuristic":
                assert n == tuning.HEURISTICS[kernel](**dims)
                continue
            reached.add((kernel, tuning.shape_key(**dims)))
            assert n == max(1, min(tuning.lookup(kernel, dev, **dims)[
                "splits"], 2048 // cuda_lib.stage_slots(hd)))
            if kernel == "decode":
                q, k, v, tok, pos, sc = _ring_inputs(act, quant, 8, K, G, hd,
                                                     2048, seed=hd + K)
                args = [t.to(dev) for t in (q, k, v, tok, pos)]
                kw = {name: t.to(dev) for name, t in sc.items()}
                got = ops.decode_attention(*args, window=window, **kw)
                again = ops.decode_attention(*args, window=window, **kw)
                want = ref.decode_attention_ref(_f32(q), _f32(k), _f32(v),
                                                tok, pos, window=window, **sc)
            else:
                cuda, kw, f32, sc_cpu = _split_inputs(
                    dev, act, quant, 8, Sx, K, G, hd, 128, "plain",
                    seed=hd + Sx)
                q, kp, vp, pt, pos0 = cuda
                fq, fkp, fvp, fpt, fpos = f32
                fn, plain = ops.paged_extend_attention, \
                    ref.paged_extend_attention_ref
                if kernel == "paged_decode":
                    q, fq = q[:, 0].contiguous(), fq[:, 0]
                    fn, plain = ops.paged_decode_attention, \
                        ref.paged_decode_attention_ref
                got = fn(q, kp, vp, pt, pos0, window=window, **kw)
                again = fn(q, kp, vp, pt, pos0, window=window, **kw)
                want = plain(fq, fkp, fvp, fpt, fpos, window=window,
                             **sc_cpu)
            torch.testing.assert_close(got.float().cpu(), want, atol=tol,
                                       rtol=0)
            assert torch.equal(got, again)
    assert reached == entries, entries - reached


def test_without_a_table_outputs_equal_the_heuristic_counts(dev, monkeypatch,
                                                          tmp_path):
    """With no table file each split walk at the serves' shapes gives the
    bits of the same call with the heuristic's count forced, float32 and
    bfloat16."""
    from repro_torch.kernels import cuda_lib, tuning
    monkeypatch.setattr(tuning, "TABLE_PATH", str(tmp_path / "none.json"))
    tuning.load_table(refresh=True)
    try:
        for kernel, K, G, hd, Sx, window in SERVE_SPLIT_CASES:
            for act in (torch.float32, torch.bfloat16):
                code = cuda_lib.DTYPE_CODES[(act, act)]
                if kernel == "decode":
                    q, k, v, tok, pos, _ = _ring_inputs(act, False, 8, K, G,
                                                        hd, 2048, seed=hd)
                    args = [t.to(dev) for t in (q, k, v, tok, pos)]
                    fn = lambda: ops.decode_attention(*args, window=window)
                    dims = dict(b=8, k=K, slots=2048, hd=hd)
                else:
                    (q, kp, vp, pt, pos0), _, _, _ = _split_inputs(
                        dev, act, False, 8, Sx, K, G, hd, 128, "plain",
                        seed=hd + Sx)
                    if kernel == "paged_decode":
                        q = q[:, 0].contiguous()
                        fn = lambda: ops.paged_decode_attention(
                            q, kp, vp, pt, pos0, window=window)
                        dims = dict(b=8, k=K, slots=2048, hd=hd)
                    else:
                        fn = lambda: ops.paged_extend_attention(
                            q, kp, vp, pt, pos0, window=window)
                        rows = cuda_lib.extend_rows(hd, Sx * G, code)
                        dims = dict(b=8, k=K, tiles=-(-Sx * G // rows),
                                    slots=2048, hd=hd)
                got = fn()
                with monkeypatch.context() as m:
                    m.setattr(tuning, "splits", _forced(
                        tuning.HEURISTICS[kernel](**dims)))
                    want = fn()
                assert torch.equal(got, want), (kernel, K, Sx, act)
    finally:
        monkeypatch.undo()
        tuning.load_table(refresh=True)


def test_captured_engine_uses_the_eager_split_counts(dev, monkeypatch):
    """reflect_demo_100m at full width, one layer, at the serves' shapes
    (batch 8, max_seq 2048, page 16, speculation): the wrappers ask
    ``tuning.splits`` for the same (kernel, dims) and get the same counts
    while the captured engine records its graphs as the eager engine does
    step by step, and the two give the same streams, bills and launches."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import tuning
    from repro_torch.models.registry import build_model, get_config

    real, asked = tuning.splits, [{}]

    def record(kernel, device, **dims):
        got = real(kernel, device, **dims)
        asked[-1][(kernel, tuple(sorted(dims.items())))] = got
        return got

    monkeypatch.setattr(tuning, "splits", record)
    cfg = get_config("reflect_demo_100m")
    cfg = cfg.replace(num_layers=1, block_pattern=cfg.block_pattern[:1])
    with torch.device(dev):
        m = build_model(cfg)
    m.init(torch.Generator(device=dev).manual_seed(0))
    scfg = ServeConfig(max_batch=8, max_seq=2048, page_size=16,
                       spec_decode=True, spec_tokens=4)
    _, outs, usage, launches = _card_serve(m, scfg)
    asked.append({})
    eng, c_outs, c_usage, c_launches = _card_serve(
        m, dataclasses.replace(scfg, aot_warmup=True))
    eager, captured = asked
    assert {k for k, _ in eager} == {"paged_decode", "paged_extend"}
    shared = eager.keys() & captured.keys()
    assert {k for k, _ in shared} == {"paged_decode", "paged_extend"}
    assert all(eager[k] == captured[k] for k in shared)
    assert eng.stats()["step_compiles"] == 0
    assert c_outs == outs and c_usage == usage and c_launches == launches


def test_ring_and_flash_wrappers_count_launches_and_refuse_bad_operands(dev):
    q, k, v, tok, pos, _ = _ring_inputs(torch.float32, False, 2, 2, 3, 64,
                                        256, 0)
    q, k, v, tok, pos = (t.to(dev) for t in (q, k, v, tok, pos))
    fq, fk, fv = (t.to(dev) for t in _flash_inputs(torch.float32, 2, 6, 2,
                                                   100, 64, 0))
    ops.reset_launches()
    ops.decode_attention(q, k, v, tok, pos)
    ops.flash_attention(fq, fk, fv)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 1
    assert ops.LAUNCHES["flash_attention"] == 1
    with pytest.raises(ValueError):          # int64 tokens
        ops.decode_attention(q, k, v, tok.long(), pos)
    with pytest.raises(ValueError):          # ring on another device
        ops.decode_attention(q, k.cpu(), v, tok, pos)
    with pytest.raises(ValueError):          # non-contiguous ring
        ops.decode_attention(q, k.transpose(0, 1).contiguous()
                             .transpose(0, 1), v, tok, pos)
    with pytest.raises(ValueError):          # ring dtype != q dtype
        ops.decode_attention(q, k.bfloat16(), v.bfloat16(), tok, pos)
    with pytest.raises(ValueError):          # float16 is not taken
        ops.flash_attention(fq.half(), fk.half(), fv.half())
    with pytest.raises(ValueError):          # non-contiguous q
        ops.flash_attention(fq.transpose(1, 2), fk, fv)
    with pytest.raises(ValueError):          # int64 lengths
        ops.flash_attention(fq, fk, fv,
                            lengths=torch.full((2,), 50, device=dev))
    with pytest.raises(ValueError):          # H not a multiple of K
        ops.flash_attention(fq[:, :5].contiguous(), fk, fv)
    assert ops.LAUNCHES["decode_attention"] == 1
    assert ops.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_ring_engine_on_card_launches_ring_decode(dev, kv_dtype):
    """The ring engine (paged_kv=False) serves two reflection rounds with
    speculation on: the ring decode kernel launches, no paged kernel
    does, and round 2 hits the prefix cache."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status

    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0))
    eng = Engine(m, ServeConfig(max_batch=2, max_seq=128, paged_kv=False,
                                spec_decode=True, kv_dtype=kv_dtype),
                 device="cuda")
    assert eng.spec
    ops.reset_launches()
    convo = [1] + list(range(10, 22)) * 3
    for _ in range(2):
        r = Request(prompt=list(convo), max_new_tokens=12, eos_id=None)
        eng.submit(r)
        eng.run()
        assert r.status is Status.DONE and len(r.output) == 12
        convo += r.output + [99, 98]
    assert ops.LAUNCHES["decode_attention"] > 0, ops.LAUNCHES
    assert ops.LAUNCHES["paged_decode"] == ops.LAUNCHES["paged_extend"] == 0
    assert eng.prefix_cache.stats["hits"] > 0


@pytest.mark.parametrize("arch", ["reflect_demo_100m", "recurrentgemma_9b"])
def test_prefill_on_card_launches_flash_and_matches_cpu(dev, arch):
    """prefill (ragged lengths, S past recurrentgemma's 32-token window)
    launches the flash kernel once per attention layer, decode_step the
    ring decode kernel; logits agree with the CPU plain path (q/k
    projections softened, as random-init attention is near one-hot)."""
    from repro_torch.models.registry import build_model, get_smoke_config

    cpu = build_model(get_smoke_config(arch).replace(dtype="float32")).init(
        torch.Generator().manual_seed(0))
    cpu.load_state_dict({n: t * (0.25 if n.endswith((".wq", ".wk")) else 1)
                         for n, t in cpu.state_dict().items()})
    card = build_model(cpu.cfg)
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(3, cpu.cfg.vocab_size, (3, 50), generator=g)
    lengths = torch.tensor([50, 41, 7], dtype=torch.int32)
    n_attn = sum(k in ("attn", "rg_attn") for k in cpu.cfg.block_pattern)
    ops.reset_launches()
    got, cache = card.prefill(tokens.to(dev), lengths.to(dev), max_seq=64)
    want, cpu_cache = cpu.prefill(tokens, lengths, max_seq=64)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    assert ops.LAUNCHES["flash_attention"] == n_attn
    nxt = want.argmax(-1, keepdim=True).to(torch.int32)
    got, _ = card.decode_step(cache, nxt.to(dev), lengths.to(dev))
    want, _ = cpu.decode_step(cpu_cache, nxt, lengths)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    assert ops.LAUNCHES["decode_attention"] == n_attn


# ------------------------------------------------------------------ MoE

def _moe(dev, dtype, seed=0, sharpen=8.0):
    """granite-moe-1b-a400m's MoE FFN at full width (32 experts top-8,
    d 1024, ff 512), seeded on the CPU and copied to the card; the router
    sharpened by ``sharpen`` so that no top-k gap of the test's tokens is
    a near tie that float rounding could flip."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models.registry import get_config

    cfg = get_config("granite_moe_1b_a400m").replace(dtype=dtype)
    cpu = L.init_params(MOE.MoE(cfg), torch.Generator().manual_seed(seed))
    cpu.router.data.mul_(sharpen)
    card = MOE.MoE(cfg)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card.to(dev)


@pytest.mark.parametrize("B,S", [(8, 1), (8, 32), (2, 256)],
                         ids=["decode", "mixed", "per-row"])
def test_moe_ffn_on_card_matches_cpu(dev, B, S):
    """fp32, TF32 off: the card routes every lane to the CPU's experts
    (ids and kept slots equal) and its outputs agree to 1e-4."""
    from repro_torch.models import moe as MOE

    cfg, cpu, card = _moe(dev, "float32")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    valid = torch.arange(S)[None, :] < torch.tensor(
        [S - 3 * b for b in range(B)]).clamp_min(0)[:, None]
    v = valid if S > 1 else None
    want, want_aux = MOE.moe_ffn(cfg, cpu, x, v)
    got, aux = MOE.moe_ffn(cfg, card, x.to(dev),
                           None if v is None else v.to(dev))
    x3 = x if S >= 256 else x.reshape(1, -1, cfg.d_model)
    v3 = None if v is None else (v if S >= 256 else v.reshape(1, -1))
    ids, _, _, slot, _ = MOE.route(cfg, cpu, x3, v3)
    c_ids, _, _, c_slot, _ = MOE.route(
        cfg, card, x3.to(dev), None if v3 is None else v3.to(dev))
    assert torch.equal(c_ids.cpu(), ids) and torch.equal(c_slot.cpu(), slot)
    rows = valid if v is not None else torch.ones(B, S, dtype=torch.bool)
    torch.testing.assert_close(got.cpu()[rows], want[rows], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_on_card_is_deterministic(dev, dtype):
    """The combine gathers and sums in a fixed order (no atomic adds), so
    two calls on the same inputs give the same bits: decode, mixed and
    per-row group shapes."""
    from repro_torch.models import moe as MOE

    cfg, _, card = _moe(dev, dtype, sharpen=1.0)
    g = torch.Generator(device=dev).manual_seed(2)
    for B, S in ((8, 1), (8, 32), (2, 512)):
        x = torch.randn(B, S, cfg.d_model, generator=g, device=dev).to(
            getattr(torch, dtype))
        a, aux_a = MOE.moe_ffn(cfg, card, x)
        b, aux_b = MOE.moe_ffn(cfg, card, x)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ------------------------------------------------ captured serving steps

def _card_serve(m, scfg, rounds=2, max_new=12):
    """Reflection rounds of three conversations on the card; returns the
    engine, the streams, the bills and the launches of the rounds."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status

    eng = Engine(m, scfg, device="cuda")
    ops.reset_launches()
    convos = [[1] + list(range(10 + i, 22 + i)) * 3 for i in range(3)]
    outs, usage = [], []
    for _ in range(rounds):
        reqs = [Request(prompt=list(c), max_new_tokens=max_new, eos_id=None)
                for c in convos]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.status is Status.DONE for r in reqs)
        outs += [r.output for r in reqs]
        usage += [dataclasses.asdict(r.usage) for r in reqs]
        for c, r in zip(convos, reqs):
            c += r.output + [99, 98]
    torch.cuda.synchronize()
    return eng, outs, usage, dict(ops.LAUNCHES)


@pytest.mark.parametrize("arch,kw", [
    ("reflect_demo_100m", dict(kv_dtype="model")),
    ("reflect_demo_100m", dict(kv_dtype="int8")),
    ("reflect_demo_100m", dict(paged_kv=False)),
    ("granite_moe_1b_a400m", {}),
    ("falcon_mamba_7b", {}),
    ("recurrentgemma_9b", dict(paged_kv=False)),
    ("whisper_tiny", {}),          # no paged layout: rings, no verify
    ("internvl2_76b", {})])
def test_captured_engine_equals_eager(dev, arch, kw):
    """Full width at a cut depth (one unit of the pattern), speculation
    asked for: the engine with every step captured as a CUDA graph gives
    the eager engine's streams, bills and kernel launches (the graphs add
    the launches their capture recorded on every replay), with no step
    outside its captured shapes."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_config

    cfg = get_config(arch)
    n = 3 if arch == "recurrentgemma_9b" else 2
    cfg = cfg.replace(num_layers=n, block_pattern=cfg.block_pattern[:n])
    with torch.device(dev):
        m = build_model(cfg)
    m.init(torch.Generator(device=dev).manual_seed(0))
    scfg = ServeConfig(max_batch=3, max_seq=256, page_size=16,
                       spec_decode=True, spec_tokens=4, **kw)
    _, outs, usage, launches = _card_serve(m, scfg)
    eng, c_outs, c_usage, c_launches = _card_serve(
        m, dataclasses.replace(scfg, aot_warmup=True))
    st = eng.stats()
    assert st["step_compiles"] == 0, st["step_compiles_by_fn"]
    assert st["aot_warmed"] >= 2
    assert c_outs == outs and c_usage == usage
    assert c_launches == launches and sum(launches.values()) > 0


def test_replay_reads_the_page_table_it_is_given(dev):
    """One captured decode signature replayed with two page tables (the
    rows' pages swapped, then a table with an unmapped tail) gives the
    eager step's logits on a copy of the same cache, bit for bit."""
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.step_graph import StepGraph

    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0)).to(dev)
    B, P, ps, NP = 2, 8, 16, 4
    cache = m.init_cache_paged(P, ps, device=dev)
    step = StepGraph(lambda *a: m.decode_step(cache, *a)[0], dev)
    step.warm((B, 1), (B,), (B, NP))
    assert step.warmed == 1
    i32 = dict(dtype=torch.int32, device=dev)
    toks = torch.randint(3, m.cfg.vocab_size, (B, 40),
                         generator=torch.Generator().manual_seed(1))
    pt = torch.arange(B * NP, **i32).view(B, NP)
    m.prefill_extend(cache, toks.to(dev), torch.zeros(B, **i32),
                     torch.full((B,), 40, **i32), page_table=pt)
    twin = m.init_cache_paged(P, ps, device=dev)
    for a, b in zip(twin, cache):
        for name in a:
            a[name].copy_(b[name])
    swapped = pt.flip(0)
    tail = pt.clone()
    tail[:, 3:] = -1
    nxt = torch.tensor([[5], [7]], dtype=torch.int32)
    for i, table in enumerate((swapped, tail, pt)):
        pos = torch.full((B,), 40 + i, dtype=torch.int32)
        got = step(nxt.numpy(), pos.numpy(), table.cpu().numpy()).clone()
        want, _ = m.decode_step(twin, nxt.to(dev), pos.to(dev),
                                page_table=table)
        assert torch.equal(got, want), i
    assert step.compiles == 0


def test_nothing_is_captured_after_warmup(dev):
    """After warm-up a serve adds no graph; a width that was not warmed
    runs eagerly and counts as a compile without capturing; and a step
    that cannot be captured (a host read) fails its warm-up."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.step_graph import StepGraph

    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0))
    eng, *_ = _card_serve(m, ServeConfig(max_batch=3, max_seq=256,
                                         page_size=16, spec_decode=True,
                                         aot_warmup=True))

    def graphs():
        return {n: len(f._sigs) for n, f in eng._steps.items()}

    before, warmed = graphs(), eng.stats()["aot_warmed"]
    assert sum(before.values()) == warmed >= 3
    B = eng.scfg.max_batch
    z = np.zeros
    logits = eng._steps["mixed"](z((B, 3), np.int32), z(B, np.int32),
                                 z(B, np.int32), eng.page_tables)
    assert logits.shape == (B, m.cfg.vocab_size)
    st = eng.stats()
    assert st["step_compiles_by_fn"] == {"decode": 0, "mixed": 1,
                                         "verify": 0}
    assert graphs() == before and st["aot_warmed"] == warmed

    bad = StepGraph(lambda t: t * int(t.sum().item()), dev)
    with pytest.raises(RuntimeError):
        bad.warm((4,))


def _card_reflect(m, aot):
    """The paper's reflection loop on the card: reflect3 with execution
    feedback, then the routed loop, over 2 SQL tasks on one engine;
    returns each task's rounds, traces and stop reasons, the step
    counters and the launches."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.accounting import CostModel, LatencyModel
    from repro_torch.core.budget import InferenceStrategy
    from repro_torch.core.controller import (ControllerConfig,
                                             SweetSpotController)
    from repro_torch.core.feedback import ExecutionFeedback
    from repro_torch.core.reflection import (EngineBackend,
                                             ReflectionController)
    from repro_torch.data.tasks import make_sql_tasks
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.engine import Engine

    eng = Engine(m, ServeConfig(max_batch=2, max_seq=1536, page_size=32,
                                spec_decode=True, aot_warmup=aot),
                 device="cuda")
    ops.reset_launches()
    backend = EngineBackend(eng, ByteTokenizer(), max_new_tokens=16)
    router = SweetSpotController(CostModel.for_model("nova_micro"),
                                 LatencyModel.for_model("nova_micro"),
                                 ControllerConfig(max_rounds=3))
    tasks = make_sql_tasks(2, seed=0)
    out = []
    for rt in (None, router):
        ctrl = ReflectionController(InferenceStrategy(3, feedback="exec"),
                                    feedback=ExecutionFeedback(), router=rt)
        for task in tasks:
            res = ctrl.run_task(backend, task)
            out.append(([(r.response, dataclasses.asdict(r.usage),
                          r.correct) for r in res.rounds],
                        [d.key() for d in res.trace], res.stop_reason))
    torch.cuda.synchronize()
    st = eng.stats()
    return eng, out, {k: st[k] for k in ("mixed_steps", "decode_batch_steps",
                                         "verify_steps", "decode_tokens",
                                         "spec_drafted", "spec_accepted")}, \
        dict(ops.LAUNCHES)


def test_captured_reflection_loop_equals_eager(dev):
    """reflect_demo_100m at full width and two layers: the reflection
    loop (fixed and routed) with every step captured gives the eager
    loop's responses, per-round bills, decision traces, stop reasons,
    step counters and launches, and bills cache reads in every reflection
    round."""
    from repro_torch.models.registry import build_model, get_config

    cfg = get_config("reflect_demo_100m")
    cfg = cfg.replace(num_layers=2, block_pattern=cfg.block_pattern[:2])
    with torch.device(dev):
        m = build_model(cfg)
    m.init(torch.Generator(device=dev).manual_seed(0))
    _, out, steps, launches = _card_reflect(m, aot=False)
    eng, c_out, c_steps, c_launches = _card_reflect(m, aot=True)
    assert eng.stats()["step_compiles"] == 0
    assert c_out == out and c_steps == steps and c_launches == launches
    assert launches["paged_decode"] > 0 and launches["paged_extend"] > 0
    for rounds, _, _ in out:
        assert all(u["cache_read_tokens"] > 0 for _, u, _ in rounds[1:])


def test_engine_backend_refuses_a_fault_plan_on_card(dev):
    """The backend takes a fault plan on the card now: under a rate-0
    plan at both backend sites it serves what it serves without one."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.budget import InferenceStrategy
    from repro_torch.core.reflection import (EngineBackend,
                                             ReflectionController)
    from repro_torch.data.tasks import make_sql_tasks
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.faults import FaultPlan, FaultSpec

    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0))
    task = make_sql_tasks(1, seed=0)[0]
    out = []
    for plan in (FaultPlan([FaultSpec("backend.transient"),
                            FaultSpec("backend.garbage")]), None):
        eng = Engine(m, ServeConfig(max_batch=1, max_seq=1024, page_size=16),
                     device=dev)
        backend = EngineBackend(eng, ByteTokenizer(), max_new_tokens=8,
                                faults=plan)
        res = ReflectionController(InferenceStrategy(1)).run_task(backend,
                                                                  task)
        out.append([(r.response, dataclasses.asdict(r.usage))
                    for r in res.rounds])
    assert out[0] == out[1]


def _nan_serve(m, dev, plan, temperature, **kw):
    """Two rows of two rounds on a captured engine under ``plan``; returns
    (streams, stop reasons, bills, the engine's counters)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    eng = Engine(m, ServeConfig(max_batch=2, max_seq=256, page_size=16,
                                spec_decode=True, aot_warmup=True, **kw),
                 device=dev, faults=plan)
    convos = [[1] + list(range(10, 40)), [1] + list(range(50, 70))]
    reqs = []
    for _ in range(2):
        rnd = [Request(prompt=list(c), max_new_tokens=12, eos_id=None,
                       temperature=temperature) for c in convos]
        for r in rnd:
            eng.submit(r)
        eng.run()
        for c, r in zip(convos, rnd):
            c += r.output + [99, 98]
        reqs += rnd
    torch.cuda.synchronize()
    eng.pool.check()
    assert eng.stats()["step_compiles"] == 0
    return ([r.output for r in reqs], [r.stop_reason for r in reqs],
            [dataclasses.asdict(r.usage) for r in reqs], eng.model_steps)


@pytest.mark.parametrize("quarantine", [True, False],
                         ids=["quarantine", "no-quarantine"])
def test_hot_nan_row_on_captured_step(dev, quarantine):
    """NaN and inf rows written into a captured step's logits, with and
    without quarantine, temperature rows included: no device-side assert
    (``torch.multinomial`` never sees them), the CUDA context serves on,
    and with quarantine the greedy replay gives the clean run's streams
    and bills."""
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.faults import FaultPlan, FaultSpec

    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0))

    def plan():
        return FaultPlan([FaultSpec("engine.logits", rate=0.1),
                          FaultSpec("engine.logits", rate=0.1,
                                    payload={"value": "inf"})], seed=1)

    kw = dict(nan_quarantine=quarantine, nan_retry_limit=20)
    for temperature in (0.7, 0.0):
        p = plan()
        outs, stops, usage, steps = _nan_serve(m, dev, p, temperature, **kw)
        assert p.stats["engine.logits"] > 0
        assert set(stops) <= {"max_tokens", "error"}
        assert steps["nan_quarantines"] == (p.stats["engine.logits"]
                                            if quarantine else 0)
    clean = _nan_serve(m, dev, None, 0.0)
    if quarantine:
        assert (outs, stops, usage) == clean[:3]
    x = torch.arange(8.0, device=dev)
    assert float((x * 2).sum()) == 56.0


# ------------------------------------------------------------- training

@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,K,S,hd,window,lengths", [
    (2, 6, 2, 97, 64, None, None),
    (1, 16, 1, 300, 256, 100, None),
    (3, 4, 4, 77, 128, 2048, [77, 0, 30]),    # an empty row
    (2, 8, 2, 200, 32, 20, [200, 61]),        # rows past the window's reach
])
def test_flash_forward_lse(dev, act, B, H, K, S, hd, window, lengths):
    """The forward (bf16 and fp32 bodies) with an lse pointer gives the
    output of the launch without one, bit for bit, and each row's lse of
    the plain version (``flash_attention_ref(..., return_lse=True)``) to
    1e-3 absolute (fp32 sums in another order, ``ex2.approx``), +inf for a
    row with no key."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = (t.to(dev) for t in _flash_inputs(act, B, H, K, S, hd,
                                                 seed=S + hd))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=dev))
    bare, none = FA._launch(q, k, v, window, lens)
    out, lse = FA._launch(q, k, v, window, lens, with_lse=True)
    assert none is None and torch.equal(out, bare)
    _, want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      window=window, lengths=lens,
                                      return_lse=True)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert bool((lse[torch.isinf(want)] > 0).all())
    fin = torch.isfinite(want)
    assert float((lse[fin] - want[fin]).abs().max()) <= 1e-3
    if lengths is not None and 0 in lengths:
        assert bool(torch.isinf(lse[lengths.index(0)]).all())


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("B,H,K,S,window,lengths", [
    (2, 6, 2, 97, None, None),            # G 3, S past a tile
    (2, 4, 1, 130, 40, None),             # window below a tile's reach
    (3, 4, 4, 77, None, [77, 0, 30]),     # G 1, an empty row
    (2, 8, 2, 200, 50, [200, 61]),        # window and ragged lengths
    (1, 8, 1, 300, 100, [290]),           # K 1, G 8: bf16 head groups
])
def test_flash_backward_matches_plain(dev, act, hd, B, H, K, S, window,
                                      lengths):
    """``flash_attention_bwd`` (csrc/flash_attention_bwd.cu) against
    ``flash_attention_bwd_ref`` in float32 on the same inputs: 1e-4
    (float32) or 2e-2 (bfloat16, its outputs rounded) of the largest
    gradient magnitude; zero gradients for an empty row; two calls
    bit-equal.  Both dtypes take the forward launch's lse and, at K 1 and
    G 8, split the heads into groups (``cuda_lib.bwd_splits`` > 1)."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v = (t.to(dev) for t in _flash_inputs(act, B, H, K, S, hd,
                                                 seed=S + hd + H))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(hd)) \
        .to(dev, act)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=dev))
    o, lse = FA._launch(q, k, v, window, lens, with_lse=True)
    if K == 1:
        assert cuda_lib.bwd_splits(B, K, S, H // K) > 1
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, window=window,
                              lengths=lens)
    again = flash_attention_bwd(q, k, v, o, do, lse=lse, window=window,
                                lengths=lens)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), do.float(), window=window,
                                       lengths=lens)
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    for x, y, w in zip(got, again, want):
        assert x.dtype == act and x.shape == w.shape
        assert float((x.float() - w).abs().max()) <= \
            tol * max(float(w.abs().max()), 1.0)
        assert torch.equal(x, y)
    if lengths is not None and 0 in lengths:
        b = lengths.index(0)
        assert not any(bool(x[b].any()) for x in got)


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,hd,P,window,lengths", [
    (2, 6, 6, 150, 64, 150, None, None),        # whisper's encoder: P = S
    (2, 8, 2, 300, 128, 64, None, [300, 200]),  # the VLM's: P a tile
    (2, 4, 1, 130, 32, 45, 40, None),           # P mid-tile, a window
    (3, 4, 2, 97, 256, 1, None, [97, 0, 30]),   # P 1, an empty row
    (2, 4, 2, 200, 64, 150, 20, [200, 100]),    # P past a length, window
    (2, 4, 4, 300, 64, 200, None, [300, 299]),  # P past a block, G 1
])
def test_flash_prefix_matches_plain(dev, act, B, H, K, S, hd, P, window,
                                    lengths):
    """The prefix mode (``prefix_len`` P: tokens below P attend each other
    both ways) of the flash forward and backward kernels against their
    plain versions on the same inputs, to the tolerances of the causal
    tests; the lse against the plain lse over the same keys (1e-3);
    two calls of each bit-equal; an empty row's gradients zero."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v = (t.to(dev) for t in _flash_inputs(act, B, H, K, S, hd,
                                                 seed=S + hd + P))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(P)) \
        .to(dev, act)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=dev))
    kw = dict(window=window, lengths=lens, prefix_len=P)
    f32 = [t.float() for t in (q, k, v)]
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    o, lse = FA._launch(q, k, v, window, lens, with_lse=True, prefix_len=P)
    again = ops.flash_attention(q, k, v, **kw)
    want, want_lse = ref.flash_attention_ref(*f32, return_lse=True, **kw)
    torch.testing.assert_close(o.float(), want, atol=tol, rtol=0)
    assert torch.equal(o, again)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-3
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    got2 = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    want = ref.flash_attention_bwd_ref(*f32, o.float(), do.float(), **kw)
    for x, y, w in zip(got, got2, want):
        assert float((x.float() - w).abs().max()) <= \
            tol * max(float(w.abs().max()), 1.0)
        assert torch.equal(x, y)
    if lengths is not None and 0 in lengths:
        assert not any(bool(x[lengths.index(0)].any()) for x in got)
    with pytest.raises(ValueError, match="prefix_len"):
        ops.flash_attention(q, k, v, prefix_len=S + 1)
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention_bwd(q, k, v, o, do, lse=lse, prefix_len=-1)


@pytest.mark.parametrize("P", [0, 300, 600])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_fp32_tensor_core_bodies(dev, hd, P):
    """The float32 bodies of both flash kernels (3xTF32 on the tensor
    cores, ``csrc/flash_tf32.cuh``) at every head dim, with a window,
    ragged lengths and an empty row, and a prefix of 0, 300 and S: the
    output, its lse and the gradients against the plain versions (1e-4;
    the gradients 1e-4 of max(|grad|, 1)), the same bits on a second call
    of each, zeros for the empty row; the backward from the forward's
    lse."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    B, H, K, S, window, lengths = 3, 6, 2, 600, 200, [600, 0, 450]
    q, k, v = (t.to(dev) for t in _flash_inputs(torch.float32, B, H, K, S,
                                                 hd, seed=hd + P))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(P)) \
        .to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(window=window, lengths=lens, prefix_len=P)
    o, lse = FA._launch(q, k, v, window, lens, with_lse=True, prefix_len=P)
    o2, lse2 = FA._launch(q, k, v, window, lens, with_lse=True, prefix_len=P)
    want, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-4
    assert not o[1].any() and bool(torch.isinf(lse[1]).all())
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    again = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
    for x, y, w in zip(got, again, want):
        assert x.dtype == torch.float32 and x.shape == w.shape
        assert float((x - w).abs().max()) <= \
            1e-4 * max(float(w.abs().max()), 1.0)
        assert torch.equal(x, y)
        assert not x[1].any()


@pytest.mark.parametrize("P", [0, 300, 600])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
def test_flash_hd192_forward(dev, act, P):
    """Both forward bodies at hd 192 (the backward is not built there:
    ROADMAP B3), with a window, ragged lengths, an empty row and a prefix
    of 0, 300 and S: the output and its lse against the plain versions
    (1e-4 in float32, 2e-2 in bfloat16; lse 1e-3), the same bits on a
    second call, zeros for the empty row."""
    from repro_torch.kernels import flash_attention as FA
    B, H, K, S, window, lengths = 3, 12, 1, 600, 200, [600, 0, 450]
    q, k, v = (t.to(dev) for t in _flash_inputs(act, B, H, K, S, 192,
                                                 seed=192 + P))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(window=window, lengths=lens, prefix_len=P)
    o, lse = FA._launch(q, k, v, window, lens, with_lse=True, prefix_len=P)
    again = ops.flash_attention(q, k, v, **kw)
    want, want_lse = ref.flash_attention_ref(
        *(t.float() for t in (q, k, v)), return_lse=True, **kw)
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), want, atol=tol,
                               rtol=0 if act == torch.bfloat16 else tol)
    assert torch.equal(o, again)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-3
    assert not o[1].any()


def test_flash_autograd_refuses_hd192_under_grad(dev):
    """hd 192 has no backward kernel yet (ROADMAP B3): a call that needs a
    gradient raises ValueError at the forward and launches nothing, on the
    autograd path and on ``flash_attention_bwd``; without a gradient the
    forward launches."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v = (t.to(dev) for t in _flash_inputs(torch.bfloat16, 2, 12, 1,
                                                 64, 192, seed=4))
    qa = q.clone().requires_grad_(True)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="3b at hd 192"):
        ops.flash_attention(qa, k, v)
    o = torch.zeros_like(q)
    with pytest.raises(ValueError, match="3b at hd 192"):
        flash_attention_bwd(q, k, v, o, o,
                            lse=torch.zeros(2, 12, 64, device=dev))
    assert sum(cuda_lib.LAUNCHES.values()) == 0
    with torch.no_grad():
        out = ops.flash_attention(qa, k, v)
    assert out.grad_fn is None
    assert cuda_lib.LAUNCHES["flash_attention"] == 1


def test_flash_autograd_on_card_launches_the_backward(dev):
    """Grad mode on a CUDA tensor goes through the autograd function: the
    forward kernel once and the backward kernel once, giving the plain
    version's gradients; without a gradient the call is the bare forward
    launch."""
    from repro_torch.kernels import cuda_lib
    q, k, v = (t.to(dev) for t in _flash_inputs(torch.float32, 2, 6, 2, 64,
                                                 64, seed=3))
    do = torch.randn_like(q)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    cuda_lib.reset_launches()
    ops.flash_attention(qa, ka, va, window=16).backward(do)
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert cuda_lib.LAUNCHES["flash_attention_bwd"] == 1
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref.flash_attention_ref(qb, kb, vb, window=16).backward(do)
    for a, b in zip((qa, ka, va), (qb, kb, vb)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        out = ops.flash_attention(qa, ka, va)
    assert out.grad_fn is None
    assert cuda_lib.LAUNCHES["flash_attention_bwd"] == 1


def test_flash_backward_lse_by_dtype(dev):
    """The backward on the card needs the forward's lse in both dtypes,
    and an operand off a 16-byte boundary is refused, each with
    ValueError and nothing launched; the autograd
    function in bfloat16 launches the forward (with lse) and the backward
    once each and gives the plain version's gradients to 2e-2."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v = (t.to(dev) for t in _flash_inputs(torch.bfloat16, 2, 6, 2, 64,
                                                 64, seed=5))
    do = torch.randn_like(q)
    o = ops.flash_attention(q, k, v)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="takes the forward's lse"):
        flash_attention_bwd(q, k, v, o, do)
    f = [t.float() for t in (q, k, v, o, do)]
    with pytest.raises(ValueError, match="takes the forward's lse"):
        flash_attention_bwd(*f)
    # the D pass reads o and its gradient in 16-byte chunks
    shifted = torch.empty(do.numel() + 1, dtype=do.dtype,
                          device=dev)[1:].view(do.shape)
    shifted.copy_(do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(q, k, v, o, shifted,
                            lse=torch.zeros(2, 6, 64, device=dev))
    assert cuda_lib.LAUNCHES["flash_attention_bwd"] == 0
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    ops.flash_attention(qa, ka, va, window=16).backward(do)
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert cuda_lib.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(
        q.float(), k.float(), v.float(),
        ops.flash_attention(q, k, v, window=16).float(), do.float(),
        window=16)
    for a, w in zip((qa, ka, va), want):
        assert float((a.grad.float() - w).abs().max()) <= \
            2e-2 * max(float(w.abs().max()), 1.0)


def test_kernels_without_backward_refuse_gradients_on_card(dev):
    """The paged and ring-decode wrappers raise on CUDA inputs that need a
    gradient instead of returning detached outputs."""
    (q, kp, vp, pt, pos0), _, _, _ = _inputs(dev, torch.float32, False)
    qd = q[:, 0].contiguous()
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.rand(*s, generator=g).to(dev)
    calls = {
        "paged_decode": lambda t: ops.paged_decode_attention(
            t(qd), kp, vp, pt, pos0),
        "paged_extend": lambda t: ops.paged_extend_attention(
            t(q), kp, vp, pt, pos0),
        "decode_attention": lambda t: ops.decode_attention(
            t(qd), f(3, 64, 2, 64), f(3, 64, 2, 64),
            torch.arange(64, dtype=torch.int32, device=dev).repeat(3, 1),
            torch.full((3,), 63, dtype=torch.int32, device=dev)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(lambda x: x.clone().requires_grad_(True))
        call(lambda x: x)                              # launches as before
        with torch.no_grad():
            call(lambda x: x.clone().requires_grad_(True))


def _mamba_bwd_case(dev, B, S, D, N, x_dtype, seed):
    """Mamba operands and output gradients on the card."""
    dt, Bm, Cm, x, A, Dsk, h0, _ = _scan_inputs(B, S, D, N, seed)
    g = torch.Generator().manual_seed(seed + 1)
    dy, dh = (torch.randn(B, S, D, generator=g),
              torch.randn(B, D, N, generator=g))
    args = [t.to(dev) for t in (dt, Bm, Cm, x.to(x_dtype), A, Dsk, h0, dy,
                                dh)]
    return args


def _close_to_plain_mamba(got, want):
    """1e-4 absolute + 1e-4 of each gradient's largest magnitude (the
    kernel's exponentials are ex2.approx); a bf16 dx also one bf16
    rounding of its largest magnitude (each side rounds once)."""
    for name, a, w in zip(("d_dt", "dBm", "dCm", "dx", "dA", "dDsk", "dh0"),
                          got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        scale = float(w.float().abs().max())
        tol = 1e-4 + 1e-4 * scale + (2 ** -8 * scale if a.dtype ==
                                      torch.bfloat16 else 0.0)
        err = float((a.float() - w.float()).abs().max())
        assert bool(torch.isfinite(a).all()) and err <= tol, (name, err, tol)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N", [(3, 37, 200, 4), (3, 37, 200, 8),
                                     (3, 37, 65, 16), (2, 16, 64, 16),
                                     (2, 1, 130, 8), (3, 37, 150, 4),
                                     (3, 37, 150, 8), (3, 37, 150, 16),
                                     (8, 256, 8192, 16)])
def test_mamba_scan_bwd_matches_plain(dev, x_dtype, B, S, D, N):
    """Every state size, S past, at and below one 16-step tile, D past and
    below one 128-channel block (D 150, 65, 130: not a multiple of 8, so
    dt, x and dy are staged through registers), pad lanes and a nonzero
    h0, and falcon-mamba-7b's training shape, on the states the forward
    kernel keeps, which the card's call requires; the same bits on a
    second call (no atomics)."""
    from repro_torch.kernels import mamba_scan as MS
    args = _mamba_bwd_case(dev, B, S, D, N, x_dtype, seed=S + N)
    states = MS._launch(*args[:7], keep_states=True)[2]
    got = MS.mamba_scan_bwd(*args, states=states)
    again = MS.mamba_scan_bwd(*args, states=states)
    want = ref.mamba_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    _close_to_plain_mamba(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="tile states"):
        MS.mamba_scan_bwd(*args)       # on the card it needs the states


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N", [(3, 37, 150, 4), (3, 37, 150, 8),
                                     (3, 37, 150, 16), (2, 40, 256, 16),
                                     (8, 256, 8192, 16)])
def test_mamba_forward_keeps_states_with_the_same_bits(dev, x_dtype, B, S,
                                                       D, N):
    """The forward kernel asked for its tile states gives the same bits
    of y and h as without; entry 0 is h0 exactly, and every entry is the
    plain boundary state (``ref.mamba_scan_states_ref``) to the scan's
    tolerance."""
    from repro_torch.kernels import mamba_scan as MS
    args = _mamba_bwd_case(dev, B, S, D, N, x_dtype, seed=S + D)[:7]
    y, h = MS._launch(*args)
    y2, h2, states = MS._launch(*args, keep_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert states.shape == (B, -(-S // MS.BWD_TILE), D, N)
    assert torch.equal(states[:, 0], args[6])
    dt, Bm, _, x, A, _, h0 = args
    torch.testing.assert_close(
        states, ref.mamba_scan_states_ref(dt, Bm, x, A, h0, MS.BWD_TILE),
        atol=1e-4, rtol=1e-4)


def test_mamba_serving_call_keeps_no_states(dev, monkeypatch):
    """Without a gradient the scan is one bare forward launch whose states
    pointer is null, as before; a training call passes one, then launches
    the backward once."""
    from repro_torch.kernels import cuda_lib
    calls = []
    real = cuda_lib.launch

    def spy(name, *a):
        calls.append((name, a))
        return real(name, *a)

    monkeypatch.setattr(cuda_lib, "launch", spy)
    args = _mamba_bwd_case(dev, 2, 37, 256, 16, torch.bfloat16, seed=3)[:7]
    cuda_lib.reset_launches()
    with torch.no_grad():
        ops.mamba_scan(*[t.clone().requires_grad_(i < 6)
                         for i, t in enumerate(args)])
    ops.mamba_scan(*args)
    assert [n for n, _ in calls] == ["mamba_scan"] * 2
    assert all(a[10] == 0 for _, a in calls)      # states: after y and h
    assert cuda_lib.LAUNCHES["mamba_scan"] == 2
    calls.clear()
    leaves = [t.clone().requires_grad_(i < 6) for i, t in enumerate(args)]
    y, h = ops.mamba_scan(*leaves)
    torch.autograd.grad(y.sum() + h.sum(), leaves[:6])
    assert [n for n, _ in calls] == ["mamba_scan", "mamba_scan_bwd"]
    assert calls[0][1][10] != 0
    assert cuda_lib.LAUNCHES["mamba_scan"] == 3
    assert cuda_lib.LAUNCHES["mamba_scan_bwd"] == 1


@pytest.mark.parametrize("B,S,W", [(3, 37, 300), (2, 1, 257), (2, 16, 256),
                                   (8, 256, 4096)])
def test_rglru_scan_bwd_matches_plain(dev, B, S, W):
    """Bit for bit with the plain version (S past, at and below one
    16-step register tile; W past one 256-channel block; identity pad
    lanes; recurrentgemma-9b's training shape), and on a second call."""
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    g = torch.Generator().manual_seed(S + W)
    a = torch.sigmoid(torch.randn(B, S, W, generator=g))
    b = torch.randn(B, S, W, generator=g)
    a[1:, S // 2:], b[1:, S // 2:] = 1.0, 0.0
    h0, dhs, dh = (torch.randn(B, W, generator=g),
                   torch.randn(B, S, W, generator=g),
                   torch.randn(B, W, generator=g))
    hs, _ = ref.rglru_scan_ref(a, b, h0)
    args = [t.to(dev) for t in (a, hs, h0, dhs, dh)]
    got, again = rglru_scan_bwd(*args), rglru_scan_bwd(*args)
    want = ref.rglru_scan_bwd_ref(a, hs, h0, dhs, dh)
    for x, y, w in zip(got, again, want):
        torch.testing.assert_close(x.cpu(), w, atol=0, rtol=0)
        assert torch.equal(x, y)


def test_scan_autograd_on_card_launches_the_backward(dev):
    """Grad mode on CUDA tensors goes through the scans' autograd
    functions: each forward kernel once and each backward kernel once,
    the written-out plain gradients (mamba to the kernel tolerance, the
    RG-LRU bit for bit), with the state tensor passed as h0 overwritten
    after the call as the mixers do; without a gradient the call is the
    bare forward launch."""
    from repro_torch.kernels import cuda_lib
    dt, Bm, Cm, x, A, Dsk, h0, dy, dh = _mamba_bwd_case(
        dev, 2, 37, 130, 16, torch.bfloat16, seed=7)
    leaves = [t.clone().requires_grad_(True) for t in (dt, Bm, Cm, x, A,
                                                        Dsk)]
    state = h0.clone()
    cuda_lib.reset_launches()
    y, h = ops.mamba_scan(*leaves, state)
    state.copy_(h)
    grads = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    assert cuda_lib.LAUNCHES["mamba_scan"] == 1
    assert cuda_lib.LAUNCHES["mamba_scan_bwd"] == 1
    _close_to_plain_mamba(grads, ref.mamba_scan_bwd_ref(
        dt, Bm, Cm, x, A, Dsk, h0, dy, dh)[:6])
    g = torch.Generator().manual_seed(8)
    a, b, r0, dhs, dr = (torch.rand(*s, generator=g).to(dev) for s in (
        (2, 37, 300), (2, 37, 300), (2, 300), (2, 37, 300), (2, 300)))
    al, bl = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    state = r0.clone()
    hs, hl = ops.rglru_scan(al, bl, state)
    state.copy_(hl)
    got = torch.autograd.grad((hs * dhs).sum() + (hl * dr).sum(), (al, bl))
    want = ref.rglru_scan_bwd_ref(a, ref.rglru_scan_ref(a, b, r0)[0], r0,
                                  dhs, dr)
    assert cuda_lib.LAUNCHES["rglru_scan"] == 1
    assert cuda_lib.LAUNCHES["rglru_scan_bwd"] == 1
    for x_, w in zip(got, want):
        assert torch.equal(x_, w)
    with torch.no_grad():
        y2, _ = ops.mamba_scan(*leaves, h0)
        hs2, _ = ops.rglru_scan(al, bl, r0)
    assert y2.grad_fn is None and hs2.grad_fn is None
    assert cuda_lib.LAUNCHES["mamba_scan_bwd"] == 1
    assert cuda_lib.LAUNCHES["rglru_scan_bwd"] == 1


@pytest.mark.parametrize("arch,kernels", [
    ("falcon_mamba_7b", ("mamba_scan", "mamba_scan_bwd")),
    ("recurrentgemma_9b", ("rglru_scan", "rglru_scan_bwd"))])
def test_recurrent_train_step_on_card_matches_cpu(dev, arch, kernels):
    """One float32 loss and gradient of the 2-layer full-width cut (2 x
    256 tokens of the task corpus) on the card and on the CPU: loss within
    1e-4 relative, every gradient tensor's cosine at least 0.9999, the
    scan and its backward launched once a layer."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.train.loop import (grads_of, make_loss_fn, params_of,
                                        to_device, trainable)
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=2, block_pattern=cfg.block_pattern[:2],
                      dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(remat=False)
    batch = next(lm_batches(256, 2, 1))
    state = build_model(cfg).init(torch.Generator().manual_seed(3)) \
        .state_dict()
    out = []
    for d in (torch.device("cpu"), dev):
        m = build_model(cfg)
        m.load_state_dict(state)
        m.to(d)
        cuda_lib.reset_launches()
        with trainable(m):
            loss, _ = make_loss_fn(m, cfg, tcfg)(to_device(batch, d))
            grads = grads_of(loss, params_of(m))
        out.append((float(loss.detach()), {k: v.detach().cpu().double()
                                  for k, v in grads.items()}))
        del m, grads, loss
    assert all(cuda_lib.LAUNCHES[k] == 2 for k in kernels)
    (c_loss, c_g), (g_loss, g_g) = out
    assert abs(g_loss - c_loss) <= 1e-4 * abs(c_loss)
    for k in c_g:
        cos = float((c_g[k] * g_g[k]).sum()
                    / (c_g[k].norm() * g_g[k].norm()).clamp_min(1e-300))
        assert cos >= 0.9999, (k, cos)


@pytest.mark.parametrize("arch,kind,kernel", [
    ("falcon_mamba_7b", "mamba", "mamba_scan"),
    ("recurrentgemma_9b", "rglru", "rglru_scan")])
def test_recurrent_smoke_train_step_launches_scan_kernels(dev, arch, kind,
                                                          kernel):
    """One AdamW step of a recurrent smoke config on the card with remat:
    finite metrics, the scan's forward launched twice a layer (remat runs
    it again in the backward pass) and its backward once, and the
    recurrence's own parameters (mamba's A_log, the RG-LRU's lam)
    moved."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.train import build
    from repro_torch.models.registry import get_smoke_config
    from repro_torch.train.loop import init_opt_state, make_train_step
    cfg = get_smoke_config(arch)
    model = build(cfg, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = TrainConfig(remat=True)
    cuda_lib.reset_launches()
    m = make_train_step(model, cfg, tcfg)(init_opt_state(model, cfg, tcfg),
                                          next(lm_batches(64, 4, 1)))
    assert all(np.isfinite(float(v)) for v in m.values())
    n = cfg.block_pattern.count(kind)
    assert cuda_lib.LAUNCHES[kernel] == 2 * n
    assert cuda_lib.LAUNCHES[kernel + "_bwd"] == n
    decay = [k for k in before if k.endswith(("A_log", ".lam"))]
    assert len(decay) == n
    assert all(not torch.equal(model.state_dict()[k], before[k])
               for k in decay)


def test_train_step_on_card_launches_both_flash_kernels(dev):
    """One AdamW step of the demo's smoke config on the card: finite
    metrics under the reference's keys, the flash forward and backward
    launched once a layer, parameters moved."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.train import build
    from repro_torch.models.registry import get_smoke_config
    from repro_torch.train.loop import init_opt_state, make_train_step
    cfg = get_smoke_config("reflect_demo_100m")
    model = build(cfg, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = TrainConfig(remat=True)
    cuda_lib.reset_launches()
    m = make_train_step(model, cfg, tcfg)(init_opt_state(model, cfg, tcfg),
                                          next(lm_batches(64, 4, 1)))
    assert set(m) == {"loss", "xent", "accuracy", "lr", "grad_norm"}
    assert all(np.isfinite(float(v)) for v in m.values())
    # remat runs each block's forward again in the backward pass
    assert cuda_lib.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    assert cuda_lib.LAUNCHES["flash_attention_bwd"] == cfg.num_layers
    assert all(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_76b"])
def test_prefix_model_train_step_on_card_matches_cpu(dev, arch):
    """One float32 loss and gradient of whisper's and the VLM's smoke
    configs with seeded frames or patch embeddings, on the card and on the
    CPU: loss within 1e-4 relative, every gradient's cosine at least
    0.9999; flash forward and backward launched once an attention layer
    (whisper's encoder layers, in the prefix mode, included)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.registry import (build_model, get_smoke_config,
                                             model_inputs)
    from repro_torch.train.loop import (grads_of, make_loss_fn, params_of,
                                        to_device, trainable)
    cfg = get_smoke_config(arch).replace(dtype="float32")
    tcfg = TrainConfig(remat=False)
    batch = dict(next(lm_batches(32, 2, 1)))
    extra = model_inputs(cfg, 2, 32)
    batch.update({k: v for k, v in extra.items()
                  if k in ("frames", "patch_embeds")})
    state = build_model(cfg).init(torch.Generator().manual_seed(3)) \
        .state_dict()
    out = []
    for d in (torch.device("cpu"), dev):
        m = build_model(cfg)
        m.load_state_dict(state)
        m.to(d)
        cuda_lib.reset_launches()
        with trainable(m):
            loss, _ = make_loss_fn(m, cfg, tcfg)(to_device(batch, d))
            grads = grads_of(loss, params_of(m))
        out.append((float(loss.detach()), {k: v.detach().cpu().double()
                                           for k, v in grads.items()}))
        del m, grads, loss
    n = cfg.num_layers + (cfg.encoder_layers if arch == "whisper_tiny"
                          else 0)
    assert cuda_lib.LAUNCHES["flash_attention"] == n
    assert cuda_lib.LAUNCHES["flash_attention_bwd"] == n
    (c_loss, c_g), (g_loss, g_g) = out
    assert np.isfinite(c_loss)
    assert abs(g_loss - c_loss) <= 1e-4 * abs(c_loss)
    for k in c_g:
        cos = float((c_g[k] * g_g[k]).sum()
                    / (c_g[k].norm() * g_g[k].norm()).clamp_min(1e-300))
        assert cos >= 0.9999, (k, cos)
