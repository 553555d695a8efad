"""The port's CUDA kernels on the card (marked ``gpu``; they skip without
a CUDA device).  This file imports no JAX, so it runs on the machine with
the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(float32 to 1e-4, bfloat16 against the plain version in float32 on the
same rounded inputs to 2e-2, int8 caches to 1e-4; the scans to 1e-4, and
the RG-LRU scan bit for bit), the bf16 flash body and the split ring and
page walks give bit-equal results from call to call (the paged kernels
also at forced split counts at the split walk's edges), the wrappers
refuse what the kernels do not take, and small engine and model runs on
the card launch the kernels of their models' paths.
"""
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
@pytest.mark.parametrize("hd", [32, 64, 128])
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
    the empty last row is zeros."""
    from repro_torch.kernels import cuda_lib
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
        monkeypatch.setattr(cuda_lib, "paged_splits", lambda *a: splits)
        got = fn(qq, kp, vp, pt, pos0, window=window, **sc)
        again = fn(qq, kp, vp, pt, pos0, window=window, **sc)
        monkeypatch.setattr(cuda_lib, "paged_splits", lambda *a: 1)
        one = fn(qq, kp, vp, pt, pos0, window=window, **sc)
        want = plain(fqq, fkp, fvp, fpt, fpos, window=window, **sc_cpu)
        torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
        torch.testing.assert_close(got.float(), one.float(), atol=tol,
                                   rtol=0)
        assert torch.equal(got, again)
        assert not got[B - 1].any()


def test_paged_splits_in_use(dev, monkeypatch):
    """The wrappers split reflect_demo_100m's and recurrentgemma-9b's
    decode, verify and chunk shapes (128-page tables) as ``paged_splits``
    says for their tiles."""
    from repro_torch.kernels import cuda_lib
    real, seen = cuda_lib.paged_splits, []

    def record(*a):
        seen.append(real(*a))
        return seen[-1]

    monkeypatch.setattr(cuda_lib, "paged_splits", record)
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


@pytest.mark.parametrize("B,S,W", [(8, 32, 4096), (3, 7, 300), (8, 1, 4096)])
def test_rglru_scan_matches_plain(dev, B, S, W):
    """recurrentgemma-9b's mixed-step and decode shapes and a ragged one,
    with identity pad lanes: the kernel rounds as the plain version does,
    so the two agree bit for bit."""
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
                                        (2, 2, 8, 128, 130)])
def test_ring_decode_matches_plain(dev, mode, window, B, K, G, hd, C):
    """reflect_demo_100m's and recurrentgemma-9b's decode shapes and two
    ragged rings (C not a multiple of a stage)."""
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
    (2, 8, 2, 300, 128, None, False)])
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
    from repro_torch.kernels import cuda_lib
    act = torch.bfloat16 if mode == "bfloat16" else torch.float32
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    q, k, v, tok, pos, sc = _ring_inputs(act, mode == "int8", B, K, G, hd,
                                         C, seed=C + splits)
    if segment is not None:
        tok = _one_segment(tok, *segment)
    args = [t.to(dev) for t in (q, k, v, tok, pos)]
    kw = {n: t.to(dev) for n, t in sc.items()}
    monkeypatch.setattr(cuda_lib, "ring_splits", lambda *a: splits)
    got = ops.decode_attention(*args, window=window, **kw)
    again = ops.decode_attention(*args, window=window, **kw)
    monkeypatch.setattr(cuda_lib, "ring_splits", lambda *a: 1)
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
